"""K11 backfill on bench/backfill_cases.py's crafted inputs: the port's
plain version (``evict_kernels.backfill_plain``, what the wrapper runs on
CPU tensors) and a numpy model of the kernel's cursor-and-bitset design
(csrc/evict_backfill.cu), each against the jitted JAX ``solve_backfill``.

The model keeps the kernel's state as the kernel keeps it: per-row
bitsets of 32-bit words, the headroom clamped to [0, T + 1] with its room
bitset, each row's static first node and cursor word, and the warp's
registers (the current row's cursor word, the last placed node's
headroom); it takes 32 tasks at a time and places a run of one row's pod
tasks a cursor word at a time by a prefix sum and the kernel's binary
search. Its agreement with the reference on every case shows on the
CPU that the invariant the kernel rests on (a row's first node with pod
room never moves back) is exact. Tolerance: exact equality of the int32
assignment.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volcano_tpu.ops import evict as jevict

from volcano_tpu_torch.bench import backfill_cases
from volcano_tpu_torch.ops import evict_kernels as tk

CASES = backfill_cases.cases()
IDS = [c[0] for c in CASES]


def jax_assign(check_pod, arrays) -> np.ndarray:
    enc = {k: jnp.asarray(v) for k, v in arrays.items()}
    spec = jevict.EvictSpec(**backfill_cases.spec(check_pod)._asdict())
    return np.asarray(jevict.solve_backfill(spec, enc))


def _first_bit(x: int) -> int:
    return (x & -x).bit_length() - 1


def cursor_model(check_pod, arrays) -> np.ndarray:
    """csrc/evict_backfill.cu's algorithm in numpy, step for step: 32 tasks
    at a time, single tasks one by one, runs of one row's pod tasks placed
    a cursor word at a time by a prefix sum and a 5-step binary search."""
    sig = arrays["sig_mask"]
    s_rows, n = sig.shape
    t_total = arrays["b_sig"].shape[0]
    real = arrays["b_real"]
    runner = real & arrays["b_has_pod"] & bool(check_pod)
    rows = arrays["b_sig"]
    nw = (n + 31) // 32
    padded = np.zeros((s_rows, nw * 32), bool)
    padded[:, :n] = sig
    weights = (1 << np.arange(32, dtype=np.uint64)).astype(np.uint64)
    bits = (padded.reshape(s_rows, nw, 32).astype(np.uint64) * weights).sum(-1)
    bits = [[int(x) for x in row] for row in bits]
    d = arrays["node_max"].astype(np.int64) - arrays["node_cnt"].astype(np.int64)
    h = [0] * (nw * 32)
    h[:n] = np.clip(d, 0, t_total + 1).tolist()
    room = [sum(1 << b for b in range(32) if h[w * 32 + b] > 0) for w in range(nw)]
    first = []
    for r in range(s_rows):
        nz = [w for w in range(nw) if bits[r][w]]
        first.append(nz[0] * 32 + _first_bit(bits[r][nz[0]]) if nz else -1)
    cur = [nw if f < 0 else f >> 5 for f in first]
    cs, cw, word = -1, nw, 0
    hn, hval = -1, 0
    assign = np.full(t_total, -1, np.int32)
    for t0 in range(0, t_total, 32):
        lanes = range(t0, min(t_total, t0 + 32))
        todo = [k for k in lanes if real[k]]
        while todo:
            i = todo[0]
            si = int(rows[i])
            if not runner[i]:
                node = first[si]
                if node >= 0:
                    hv = (hval if node == hn else h[node]) - 1
                    hn, hval, h[node] = node, hv, hv
                    if hv == 0:
                        room[node >> 5] &= ~(1 << (node & 31))
                        if node >> 5 == cw:
                            word &= ~(1 << (node & 31))
                assign[i] = node
                todo.pop(0)
                continue
            members = []
            for k in range(i, lanes.stop):
                same = runner[k] and rows[k] == si
                if real[k] and not same:
                    break
                if same:
                    members.append(k)
            if si != cs:
                if cs >= 0:
                    cur[cs] = cw
                cs, cw = si, cur[si]
                word = bits[si][cw] & room[cw] if cw < nw else 0
            done = 0
            while done < len(members):
                if word == 0 and cw < nw:
                    cw += 1
                    while cw < nw and not bits[si][cw] & room[cw]:
                        cw += 1
                    word = bits[si][cw] & room[cw] if cw < nw else 0
                if word == 0:
                    break
                hb = [h[cw * 32 + b] if word >> b & 1 else 0 for b in range(32)]
                pre = np.cumsum(hb).tolist()
                take = min(len(members) - done, pre[31])
                for q in range(take):
                    lo = 0
                    for step in (16, 8, 4, 2, 1):
                        if pre[lo + step - 1] <= q:
                            lo += step
                    assign[members[done + q]] = cw * 32 + lo
                spent = 0
                for b in range(32):
                    tb = min(max(take - (pre[b] - hb[b]), 0), hb[b])
                    if tb > 0:
                        h[cw * 32 + b] -= tb
                        if tb == hb[b]:
                            spent |= 1 << b
                room[cw] &= ~spent
                word &= ~spent
                done += take
            hn = -1
            todo = [k for k in todo if k not in members]
    return assign


@pytest.fixture(scope="module")
def reference():
    """The jitted JAX solve_backfill's assignment of every case."""
    return {name: jax_assign(cp, arrays) for name, cp, arrays in CASES}


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_matches_reference(case, reference):
    name, check_pod, arrays = case
    enc = {k: torch.from_numpy(v) for k, v in arrays.items()}
    got = tk.backfill(backfill_cases.spec(check_pod), enc)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), reference[name])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_cursor_model_matches_reference(case, reference):
    name, check_pod, arrays = case
    want = reference[name]
    assert np.array_equal(cursor_model(check_pod, arrays), want)


def test_cases_reach_every_edge(reference):
    """Each case shows what it was built for."""
    by = {name: (cp, arrays) for name, cp, arrays in CASES}
    # pods filled nodes: some task found no room where an earlier one did
    cp, a = by["filled by pods"]
    cnt = a["node_cnt"].copy()
    np.add.at(cnt, reference["filled by pods"][reference["filled by pods"] >= 0], 1)
    assert (cnt >= a["node_max"]).sum() > 10
    # tasks with no pod went past node_max
    cp, a = by["no pod past node_max"]
    cnt = a["node_cnt"].copy()
    np.add.at(cnt, reference["no pod past node_max"][reference["no pod past node_max"] >= 0], 1)
    assert (cnt > a["node_max"]).any()
    # the empty row's tasks are unplaced, the others placed
    cp, a = by["empty row"]
    got = reference["empty row"]
    assert (got[a["b_sig"] == 1] == -1).all() and (got[a["b_sig"] != 1] >= 0).any()
    # pads stay unplaced
    cp, a = by["pad tasks and rows"]
    assert (reference["pad tasks and rows"][~a["b_real"]] == -1).all()
    # without the pod check each task takes its row's first node
    cp, a = by["no pod check"]
    assert not cp
    firsts = np.where(a["sig_mask"].any(1), a["sig_mask"].argmax(1), -1)
    assert np.array_equal(reference["no pod check"], firsts[a["b_sig"]])
    # nodes full at the start take only tasks with no pod
    cp, a = by["full at the start"]
    full = a["node_cnt"] >= a["node_max"]
    got = reference["full at the start"]
    assert full.sum() > 100
    assert not (a["b_has_pod"] & (got >= 0) & full[np.maximum(got, 0)]).any()
    # one run of 2,000 pods over about 34 nodes
    cp, a = by["one row of pods"]
    got = reference["one row of pods"]
    assert (got[:2000] >= 0).all() and len(set(got[:2000].tolist())) > 30
    # the ragged and the wide cases
    assert by["N=8001"][1]["sig_mask"].shape == (16, 8001)
    n, s = by["N=40000 S=64"][1]["sig_mask"].shape
    assert backfill_cases.state_bytes(n, s) > 232448
    assert backfill_cases.state_bytes(8001, 16) <= 232448


def test_widened_nodes_keep_the_result(reference):
    """All-false columns appended (what takes a case to the kernel's global
    placement on the card) change no assignment."""
    name, cp, arrays = CASES[0]
    s = arrays["sig_mask"].shape[0]
    n = backfill_cases.global_width(s)
    assert backfill_cases.state_bytes(n, s) > 232448 >= backfill_cases.state_bytes(n - 32, s)
    wide = backfill_cases.widen_nodes(arrays, n)
    assert np.array_equal(jax_assign(cp, wide), reference[name])
    assert np.array_equal(cursor_model(cp, wide), reference[name])
