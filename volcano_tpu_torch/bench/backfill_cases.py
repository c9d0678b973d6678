"""Crafted inputs of K11 (``evict_backfill``: csrc/evict_backfill.cu), each
built from a numpy seed, for the tests here and on the card and for
chip_smoke.py's eviction phase.

A case is (name, check_pod_count, arrays): the backfill encode's arrays
as ``ops/evict.py``'s ``_BackfillPlan`` builds them (``sig_mask`` bool
[S, N], ``node_cnt`` and ``node_max`` int32 [N], ``b_sig`` int32 [T],
``b_has_pod`` and ``b_real`` bool [T]). Each reaches one edge of the
kernel's cursor design:

- nodes filled by pod tasks, so the cursors move;
- tasks with no pod placed past ``node_max``;
- signatures that share nodes, their tasks interleaved;
- a task with no pod on a node that runs of pods fill around it;
- an all-false signature row (argmax 0 fails: -1, nothing bumped);
- pad tasks, and the bucket's pad signature rows (all false);
- ``check_pod_count`` off (every task takes its row's first node);
- cfg4's shape: one row, 2,000 pods in one run across nodes and chunks;
- nodes whose count starts at or past ``node_max``;
- N = 8,001, not a multiple of 32 (cfg4's S = 16, T = 2,048);
- N = 40,000 with S = 64, whose state does not fit shared memory.

``widen_nodes`` appends all-false node columns, which no task can take,
so the same tasks reach the kernel's global placement with the same
result.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

Case = Tuple[str, bool, Dict[str, np.ndarray]]


def spec(check_pod: bool):
    """The port's backfill spec of a case (``EvictSpec``)."""
    from volcano_tpu_torch.ops.evict import EvictSpec

    return EvictSpec(kind="backfill", job_order_keys=(), victim_fns=(),
                     check_pod_count=check_pod, use_nodeorder=False,
                     use_binpack=False, use_gang_pipelined=False)


def _arrays(sig_mask, node_cnt, node_max, b_sig, b_has_pod, b_real):
    return dict(sig_mask=np.ascontiguousarray(sig_mask, bool),
                node_cnt=np.asarray(node_cnt, np.int32),
                node_max=np.asarray(node_max, np.int32),
                b_sig=np.asarray(b_sig, np.int32),
                b_has_pod=np.asarray(b_has_pod, bool),
                b_real=np.asarray(b_real, bool))


def random_case(seed: int, n: int, s: int, t: int, density: float = 0.6,
                max_pods: Tuple[int, int] = (2, 6), start: Tuple[int, int] = (0, 3),
                pod_share: float = 0.8, real: float = 1.0, runs: int = 8
                ) -> Dict[str, np.ndarray]:
    """S signature rows of the given density over N nodes, per-node pod
    limits in ``max_pods`` and starting counts in ``start`` (both
    inclusive), and T tasks in runs of one signature (about ``runs``
    long, as a job's tasks come), a share ``pod_share`` with a pod and a
    share ``real`` real."""
    rng = np.random.default_rng(seed)
    sig = rng.random((s, n)) < density
    node_max = rng.integers(max_pods[0], max_pods[1] + 1, n)
    node_cnt = rng.integers(start[0], start[1] + 1, n)
    b_sig = np.empty(t, np.int64)
    i = 0
    while i < t:
        k = int(rng.integers(1, 2 * runs))
        b_sig[i:i + k] = rng.integers(0, s)
        i += k
    return _arrays(sig, node_cnt, node_max, b_sig, rng.random(t) < pod_share,
                   rng.random(t) < real)


def cases() -> List[Case]:
    out: List[Case] = []
    # pod tasks fill the first nodes of every row, the cursors move past them
    out.append(("filled by pods", True,
                random_case(1, 300, 4, 512, density=0.5, pod_share=1.0)))
    # tasks with no pod on two-pod nodes: counts go past node_max
    a = random_case(2, 64, 2, 256, density=0.9, max_pods=(2, 2), start=(0, 0),
                    pod_share=0.5)
    out.append(("no pod past node_max", True, a))
    # eight rows over overlapping bands of nodes, their tasks interleaved
    rng = np.random.default_rng(3)
    n, s, t = 500, 8, 1024
    sig = np.zeros((s, n), bool)
    for r in range(s):
        lo = 40 * r
        sig[r, lo:lo + 180] = rng.random(180) < 0.8
    out.append(("shared nodes", True, _arrays(
        sig, rng.integers(0, 2, n), rng.integers(1, 4, n), rng.integers(0, s, t),
        rng.random(t) < 0.85, np.ones(t, bool))))
    # one row, six pods of room a node: a task with no pod takes the row's
    # first node between runs of pods that fill it (its headroom changes
    # under it between the two)
    t = 512
    pattern = np.array([False, True, True, True, True, False, True, True])
    out.append(("singles between runs", True, _arrays(
        np.ones((2, 200), bool), np.zeros(200), np.full(200, 6), np.zeros(t),
        np.tile(pattern, t // len(pattern)), np.ones(t, bool))))
    # row 1 all false: its pod and no-pod tasks stay unplaced
    a = random_case(4, 200, 4, 256, pod_share=0.6)
    a["sig_mask"][1] = False
    a["b_sig"][::3] = 1
    out.append(("empty row", True, a))
    # a bucket: 5 real rows of 8 (the pad rows all false), 700 real tasks
    # of 1,024, pads at the end and between
    a = random_case(5, 256, 8, 1024, pod_share=0.9)
    a["sig_mask"][5:] = False
    a["b_sig"] = np.where(a["b_sig"] >= 5, a["b_sig"] - 5, a["b_sig"]).astype(np.int32)
    a["b_real"][700:] = False
    a["b_real"][::17] = False
    a["b_sig"][700:] = 0
    a["b_has_pod"][700:] = False
    out.append(("pad tasks and rows", True, a))
    # without the pod check every task takes its row's first node
    out.append(("no pod check", False, random_case(6, 300, 4, 512, density=0.3)))
    # most nodes start at or past node_max
    out.append(("full at the start", True,
                random_case(7, 400, 6, 768, max_pods=(1, 4), start=(1, 6))))
    # cfg4's shape: one real row of 16, every node in it, 2,000 pods and 48
    # pads, about 60 pods of room a node (each run spans nodes and chunks)
    a = random_case(10, 8000, 16, 2048, density=1.0, max_pods=(110, 110),
                    start=(49, 51), pod_share=1.0, runs=4096)
    a["sig_mask"][1:] = False
    a["b_sig"][:] = 0
    a["b_real"][2000:] = False
    out.append(("one row of pods", True, a))
    # N not a multiple of 32, at cfg4's S and T, cfg4's pod limits
    out.append(("N=8001", True,
                random_case(8, 8001, 16, 2048, density=0.7, max_pods=(100, 110),
                            start=(90, 115), pod_share=0.95, runs=64)))
    # past shared memory: 64 rows of 40,000 nodes
    out.append(("N=40000 S=64", True,
                random_case(9, 40000, 64, 1024, density=0.02, max_pods=(1, 3),
                            start=(0, 3), pod_share=0.9, runs=16)))
    return out


def state_bytes(n: int, s: int) -> int:
    """The bytes of K11's state at these sizes (csrc/evict_backfill.cu
    ``layout``): the headroom, the room bitset, each row's first node and
    cursor, and the row bitsets."""
    nw = (n + 31) // 32
    return 4 * (nw * 32 + nw + 2 * s + s * nw)


def widen_nodes(arrays: Dict[str, np.ndarray], n: int) -> Dict[str, np.ndarray]:
    """``arrays`` with all-false node columns appended up to ``n`` nodes
    (count 0, limit 1): no task can take them, so every result stays."""
    extra = n - arrays["sig_mask"].shape[1]
    if extra < 0:
        raise ValueError(f"widen_nodes: {n} is narrower than the case")
    out = dict(arrays)
    out["sig_mask"] = np.concatenate(
        [arrays["sig_mask"], np.zeros((arrays["sig_mask"].shape[0], extra), bool)], 1)
    out["node_cnt"] = np.concatenate([arrays["node_cnt"], np.zeros(extra, np.int32)])
    out["node_max"] = np.concatenate([arrays["node_max"], np.ones(extra, np.int32)])
    return out


def global_width(s: int, smem_bytes: int = 232448) -> int:
    """The least node count (a multiple of 32) whose state, at S rows,
    passes ``smem_bytes`` of shared memory (the H100's opt-in limit a
    block)."""
    n = 32
    while state_bytes(n, s) <= smem_bytes:
        n += 32
    return n
