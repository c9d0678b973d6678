"""K2 window_topk, K14 express_place and K9 evict_preempt on a CUDA card,
each against its plain version on the same inputs.

K2 on crafted rows: signed zeros either way round, all tied, all -inf,
-inf ties ahead of a feasible tail, last-bit neighbours; N not a power of
two; k = N/2, k = 1 and k = N; cfg5's shape (K=16, N=10000, k=1024: a row
spread over a cluster of CTAs) and cfg6's (K=512, N=1000: one CTA a row);
float32 and float64. K14 on a batch whose window holds only zero scores,
on node axes past its shared memory and not a multiple of its clusters,
in float64, with no window, with pad rows between valid ones, with no
feasible node, with ties across the window's boundary, and on gangs it
strips. K13 on the carried states of fused cfg4 sessions (0.05 and full
scale), of a ten-queue cluster, and on push lists larger than its shared
memory.
K9 on the preempt machines of small cfg4 and reclaim-path sessions,
per-action and fused (the packed result and every carry tensor); on real
slots laid out other than as a prefix; on nodes of more than 256 victims;
on node axes whose slices do not fit shared memory.

This file imports nothing of JAX, so it runs where the card is:

    python -m pytest -m gpu --noconftest tests/test_torch_kernels_gpu.py

Without a card its tests skip. Tolerance: exact equality (torch.equal;
values compared by their bits, so -0.0 and +0.0 differ).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from volcano_tpu_torch.ops import rounds_kernels as RK

pytestmark = pytest.mark.gpu

DTYPES = [torch.float32, torch.float64]
INF = float("inf")


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels build and run only there)")


def _bits(t):
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def _same_window(scores, k):
    got_s, got_i = RK.window_topk(scores, k)
    want_s, want_i = RK.window_topk_plain(scores, k)
    torch.cuda.synchronize()
    assert torch.equal(got_i, want_i), (got_i != want_i).nonzero()[:8].tolist()
    assert torch.equal(_bits(got_s), _bits(want_s))
    return got_s, got_i


def crafted_rows(dt):
    """[16, 16] rows of signed zeros, ties, -inf and last-bit neighbours."""
    f = np.float64 if dt == torch.float64 else np.float32
    one, zero, tiny = f(1.0), f(0.0), np.finfo(f).tiny
    up, down = np.nextafter(one, f(2.0)), np.nextafter(one, zero)
    rows = [
        [-0.0, 0.0, -0.0, 0.0, 1.0, -INF] + [-INF] * 10,
        [0.0, -0.0, 0.0, -0.0, -INF, 1.0] + [-0.0, 0.0] * 5,
        [-0.0] * 8 + [0.0] * 8,
        [0.0] * 8 + [-0.0] * 8,
        [-0.0, 0.0] * 8,
        [3.0] * 16,
        [-INF] * 16,
        [-INF] * 12 + [1.0, -0.0, 0.0, 1.0],
        [-INF] * 4 + [-0.0] * 6 + [0.0] * 6,
        [one, up, down, one, tiny, -tiny, -zero, zero, up,
         np.nextafter(tiny, one), -zero, -INF, zero, down, -tiny, one],
        [2.5, -0.0, 2.5, 0.0, -1.0, -0.0, 0.0, 2.5, -1.0, 0.0, -0.0, 7.0,
         -INF, 0.0, -0.0, 2.5],
    ]
    rng = np.random.default_rng(7)
    for _ in range(5):
        rows.append(rng.choice([-0.0, 0.0, 1.0, -INF], 16))
    return torch.tensor(np.asarray(rows, dtype=f), device="cuda")


@pytest.mark.parametrize("k", [1, 3, 8, 16])
@pytest.mark.parametrize("dt", DTYPES, ids=["float32", "float64"])
def test_window_topk_crafted_rows(dt, k):
    _cuda()
    _, idx = _same_window(crafted_rows(dt), k)
    if k == 16:
        assert idx[0, :6].tolist() == [4, 1, 3, 0, 2, 5]


def scheduler_like(rows, n, dt, seed, levels=40, p_inf=0.3):
    """Scores as a solve has them: a few dozen distinct values (most nodes
    tie with many others) and a share of -inf (infeasible)."""
    rng = np.random.default_rng(seed)
    f = np.float64 if dt == torch.float64 else np.float32
    vals = np.floor(rng.random((rows, n)) * levels) * 2.5
    vals[rng.random((rows, n)) < p_inf] = -np.inf
    zero = rng.random((rows, n)) < 0.05
    vals[zero] = np.where(rng.random(zero.sum()) < 0.5, -0.0, 0.0)
    return torch.tensor(vals.astype(f), device="cuda")


# (K, N, k): cfg5, cfg6, N odd, k = N/2, k = N, a wide row of one tied value
SHAPES = [(16, 10000, 1024), (512, 1000, 256), (16, 10007, 1024),
          (16, 10000, 5000), (4, 3001, 3001), (3, 20000, 16), (2, 777, 1)]


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{k}x{n}k{w}" for k, n, w in SHAPES])
@pytest.mark.parametrize("dt", DTYPES, ids=["float32", "float64"])
def test_window_topk_shapes(dt, shape):
    _cuda()
    rows, n, k = shape
    scores = scheduler_like(rows, n, dt, seed=rows + n + k)
    scores[0] = 2.5                        # every entry tied
    scores[-1, : n // 2] = -INF            # -inf ties ahead of a feasible tail
    _same_window(scores.contiguous(), k)


@pytest.mark.parametrize("dt", DTYPES, ids=["float32", "float64"])
def test_window_topk_distinct_and_random(dt):
    _cuda()
    gen = torch.Generator(device="cuda").manual_seed(3)
    scores = torch.randn((16, 10000), generator=gen, device="cuda", dtype=dt)
    _same_window(scores, 1024)
    _same_window(-scores.abs(), 64)


def test_window_topk_counts_one_launch():
    _cuda()
    from volcano_tpu_torch import device as devmod

    scores = scheduler_like(16, 10000, torch.float32, seed=1)
    before = devmod.LAUNCHES["window_topk"]
    RK.window_topk(scores, 1024)
    assert devmod.LAUNCHES["window_topk"] == before + 1


def test_window_topk_graph_capture():
    """K2 inside a CUDA graph replays to the plain version's answer on new
    inputs copied into the captured buffer."""
    _cuda()
    scores = scheduler_like(16, 10000, torch.float32, seed=5)
    RK.window_topk(scores, 1024)           # build and load outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_s, out_i = RK.window_topk(scores, 1024)
    fresh = scheduler_like(16, 10000, torch.float32, seed=6)
    scores.copy_(fresh)
    graph.replay()
    torch.cuda.synchronize()
    want_s, want_i = RK.window_topk_plain(fresh, 1024)
    assert torch.equal(out_i, want_i) and torch.equal(_bits(out_s), _bits(want_s))


def express_zero_batch(dt, n=600, tb=16, tasks=12, window_k=64, seed=0):
    """An express batch whose weights are zero, so every feasible score is
    +0.0 and the window is a block of zero ties."""
    from volcano_tpu_torch.express import place as tplace

    rng = np.random.default_rng(seed)
    gi, mi = float(2 ** 30), float(2 ** 20)
    alloc = np.stack([rng.choice([4000.0, 8000.0], n),
                      rng.choice([8 * gi, 16 * gi], n)], 1)
    idle = alloc - np.stack([rng.integers(0, 8, n) * 250.0,
                             rng.integers(0, 16, n) * 256 * mi], 1)
    jb = tplace.task_bucket(tasks)
    req = np.zeros((tb, 2))
    req[:tasks] = [[500.0, 512 * mi]] * tasks
    valid = np.zeros(tb, bool)
    valid[:tasks] = True
    task_job = np.zeros(tb, np.int32)
    task_job[:tasks] = np.arange(tasks)
    job_need = np.full(jb, 2 ** 31 - 1, np.int32)
    job_need[:tasks] = 1
    arrays = (idle, alloc, rng.integers(0, 4, n).astype(np.int32),
              rng.random(n) > 0.15, np.full(n, 110, np.int32), req.copy(), req,
              np.full(tb, 500.0), np.full(tb, 512 * mi), valid, task_job,
              np.ones(tb, bool), job_need, np.zeros(2))
    ft = dt
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a))
        out.append((t.to(ft) if t.dtype == torch.float64 else t).cuda())
    return tplace.ExpressSpec(tb=tb, jb=jb, window_k=window_k), out


@pytest.mark.parametrize("dt", DTYPES, ids=["float32", "float64"])
def test_express_place_zero_window(dt):
    _cuda()
    from volcano_tpu_torch.express import place as tplace

    spec, args = express_zero_batch(dt)
    got = tplace.solve_express(spec, *args)
    want = tplace.solve_express_plain(spec, *args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert int(got[spec.tb]) > 0       # zero ties never prove coverage


def express_batch(dt, n=10000, tb=16, tasks=12, window_k=64, seed=0, valid=None,
                  ok_p=0.85, shapes=3, gang=1):
    """An express batch of ``tasks`` one-pod jobs (``gang`` tasks a job, each
    job needing all of them) on ``n`` nodes of ``shapes`` shapes (few shapes:
    many equal scores), weights (1, 1); ``valid`` the valid rows (default
    the first ``tasks``)."""
    from volcano_tpu_torch.express import place as tplace

    rng = np.random.default_rng(seed)
    gi, mi = float(2 ** 30), float(2 ** 20)
    cpus = rng.choice([4000.0, 8000.0, 16000.0][:shapes], n)
    alloc = np.stack([cpus, cpus / 1000.0 * 2 * gi], 1)
    idle = alloc - np.stack([rng.integers(0, 4, n) * 500.0,
                             rng.integers(0, 4, n) * 512 * mi], 1)
    rows = np.arange(tasks) if valid is None else np.asarray(valid)
    jobs = (np.arange(len(rows)) // gang).astype(np.int32)
    jb = tplace.task_bucket(int(jobs.max()) + 1)
    req = np.zeros((tb, 2))
    req[rows] = np.stack([rng.choice([100.0, 250.0, 500.0], len(rows)),
                          rng.choice([128.0, 256.0, 512.0], len(rows)) * mi], 1)
    vmask = np.zeros(tb, bool)
    vmask[rows] = True
    task_job = np.zeros(tb, np.int32)
    task_job[rows] = jobs
    job_need = np.full(jb, 2 ** 31 - 1, np.int32)
    job_need[:int(jobs.max()) + 1] = gang
    arrays = (idle, alloc, rng.integers(0, 4, n).astype(np.int32),
              rng.random(n) < ok_p, np.full(n, 110, np.int32), req.copy(), req,
              req[:, 0].copy(), req[:, 1].copy(), vmask, task_job,
              np.ones(tb, bool), job_need, np.ones(2))
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a))
        out.append((t.to(dt) if t.dtype == torch.float64 else t).cuda())
    return tplace.ExpressSpec(tb=tb, jb=jb, window_k=window_k), out


def _same_express(spec, args):
    from volcano_tpu_torch.express import place as tplace

    got = tplace.solve_express(spec, *args)
    want = tplace.solve_express_plain(spec, *args)
    torch.cuda.synchronize()
    assert torch.equal(got, want), (got.tolist(), want.tolist())
    return got


# (id, dtype, batch keywords)
EXPRESS_CASES = [
    ("f32-10000", torch.float32, {}),
    ("f64-10000", torch.float64, {}),
    ("window-0", torch.float32, dict(n=600, window_k=0)),
    ("pads-64", torch.float32, dict(tb=64, window_k=256, valid=list(range(0, 64, 3)))),
    ("n-10007", torch.float32, dict(n=10007, seed=3)),
    ("n-999", torch.float64, dict(n=999, tb=32, tasks=30, window_k=128, seed=4)),
    ("n-5000", torch.float32, dict(n=5000, tasks=16, seed=5)),
    ("gangs", torch.float32, dict(n=40, tb=64, tasks=64, window_k=0, gang=4, seed=6)),
]


@pytest.mark.parametrize("case", EXPRESS_CASES, ids=[c[0] for c in EXPRESS_CASES])
def test_express_place_matches_plain(case):
    _cuda()
    _, dt, kw = case
    spec, args = express_batch(dt, **kw)
    got = _same_express(spec, args)
    assert int(got[-1]) > 0                       # something placed


@pytest.mark.parametrize("dt", DTYPES, ids=["float32", "float64"])
def test_express_place_past_shared_memory(dt):
    """A node axis whose window slices do not fit a CTA's shared memory
    (64 task rows: four CTAs a row) takes the global-scratch path."""
    _cuda()
    from volcano_tpu_torch import _build
    from volcano_tpu_torch.express import place as tplace

    n = 240_000 if dt == torch.float32 else 120_000
    plan = (__import__("ctypes").c_longlong * 3)()
    lib = _build.library("express_place")
    tplace._lib_fns(lib)[2](n, 64, 256, int(dt == torch.float64), plan)
    assert plan[0] > 0 and plan[1] == 4 and plan[2] == 16
    spec, args = express_batch(dt, n=n, tb=64, tasks=64, window_k=256, seed=7)
    _same_express(spec, args)


def test_express_place_no_feasible_node():
    """Every score row all -inf (no node ok): every task deferred, every
    step a full sweep on node 0."""
    _cuda()
    spec, args = express_batch(torch.float32, ok_p=0.0)
    got = _same_express(spec, args)
    assert (got[:spec.tb] == -1).all() and int(got[spec.tb]) == 12


def test_express_place_ties_across_the_window():
    """One node shape, one request: the window's last score equals scores
    outside it, so no step is covered and each sweeps."""
    _cuda()
    spec, args = express_batch(torch.float32, shapes=1, seed=8)
    args[0] = args[1].clone()                    # every node idle
    args[6][:12] = args[6][0].clone()            # one request
    args[5][:12] = args[6][0].clone()
    args[7][:12] = args[6][0, 0]
    args[8][:12] = args[6][0, 1]
    got = _same_express(spec, args)
    assert int(got[spec.tb]) == 12


def test_express_place_one_launch_a_call():
    _cuda()
    from volcano_tpu_torch import device as devmod
    from volcano_tpu_torch.express import place as tplace

    spec, args = express_batch(torch.float32)
    before = devmod.LAUNCHES["express_place"]
    tplace.solve_express(spec, *args)
    tplace.solve_express(spec, *args)
    assert devmod.LAUNCHES["express_place"] == before + 2


# -- K9: the preempt machine on a thread-block cluster --------------------------

# cfg4's conf (gang decides), a tier where gang and proportion decide, and
# one where gang, drf and conformance decide
TIER_SETS = [
    (["priority", "gang"], ["drf", "predicates", "proportion", "nodeorder"]),
    (["priority"], ["gang", "proportion", "predicates", "nodeorder"]),
    (["gang", "drf", "conformance", "proportion", "predicates"],),
]


def overcommit_cluster(seed, nodes=6, running_jobs=12, tasks_per_job=4, queues=2,
                       hi_jobs=4, pods=128):
    """A dense running fill bound round-robin (PDB overrides, a share of
    critical pods), pending high-priority gangs that preempt, and mixed
    jobs whose heap keys move in the heap (tests/test_torch_evict.py's
    cluster, with the port's objects)."""
    import random

    from volcano_tpu_torch.api import objects
    from volcano_tpu_torch.bench.clusters import make_cache
    from volcano_tpu_torch.scheduler.util import test_utils as tu

    rng = random.Random(seed)
    c = make_cache()
    for q in range(queues):
        c.add_queue(tu.build_queue(f"q{q}", weight=1 + q))
    cpu = running_jobs * tasks_per_job // nodes + 1
    for n in range(nodes):
        c.add_node(tu.build_node(
            f"node-{n:03d}",
            tu.build_resource_list_with_pods(str(cpu), f"{cpu * 2}Gi", pods=pods)))
    slot = 0
    for g in range(running_jobs):
        pg = f"run-{g:03d}"
        c.add_pod_group(tu.build_pod_group(
            pg, namespace="ev", min_member=rng.choice([1, 1, 2, tasks_per_job]),
            queue=f"q{g % queues}"))
        if rng.random() < 0.25:
            c.add_pdb(objects.PodDisruptionBudget(
                metadata=objects.ObjectMeta(name=pg, namespace="ev"),
                min_available=rng.choice([1, 2, tasks_per_job])))
        for i in range(tasks_per_job):
            pod = tu.build_pod(
                "ev", f"{pg}-t{i}", f"node-{slot % nodes:03d}",
                objects.POD_PHASE_RUNNING,
                {"cpu": "1000m", "memory": rng.choice(["1Gi", "2Gi"])},
                pg, priority=rng.choice([0, 1, 5]))
            if rng.random() < 0.1:
                pod.spec.priority_class_name = objects.SYSTEM_CLUSTER_CRITICAL
            c.add_pod(pod)
            slot += 1
    for g in range(hi_jobs):
        pg = f"hi-{g:02d}"
        c.add_pod_group(tu.build_pod_group(
            pg, namespace="ev", min_member=rng.choice([1, 1, 2]),
            queue=f"q{g % queues}"))
        for i in range(2):
            c.add_pod(tu.build_pod(
                "ev", f"{pg}-t{i}", "", objects.POD_PHASE_PENDING,
                {"cpu": f"{rng.choice([3000, 4000])}m",
                 "memory": rng.choice(["4Gi", "8Gi"])}, pg, priority=100))
    return c


def preempt_plan(cache, tiers, dtype):
    """The port's preempt plan of a session on ``cache`` after allocate and
    backfill, and its arrays staged on the card."""
    from volcano_tpu_torch.bench.clusters import make_tiers
    from volcano_tpu_torch.ops import evict as tevict
    from volcano_tpu_torch.ops.solver import from_numpy_encoded
    from volcano_tpu_torch.scheduler import framework
    import volcano_tpu_torch.scheduler.actions  # noqa: F401
    import volcano_tpu_torch.scheduler.plugins  # noqa: F401

    ssn = framework.open_session(cache, make_tiers(
        ["tpuscore"], *tiers, arguments={"tpuscore": {
            "tpuscore.device": "cuda", "tpuscore.dtype": dtype}}))
    try:
        for action in ("allocate", "backfill"):
            framework.get_action(action).execute(ssn)
        plan = tevict.build(ssn, "preempt")
    finally:
        framework.close_session(ssn)
    assert plan is not None and not plan.trivial
    return plan.spec, from_numpy_encoded(plan.arrays, device="cuda", dtype=dtype)


def _same_machine(spec, enc):
    from volcano_tpu_torch.ops import evict_kernels as EK

    got = EK.solve_packed(spec, enc)
    want = EK.solve_plain(spec, enc)
    torch.cuda.synchronize()
    assert torch.equal(got, want), ((got != want).nonzero()[:8].tolist(),
                                    got[-6:].tolist(), want[-6:].tolist())
    return got


# (nodes, running jobs): 6 nodes of 16 victims (most of the cluster's CTAs
# own no node), 3 nodes of 24 (V=32), 40 nodes of 3
SHAPES_K9 = [(6, 24), (3, 18), (40, 30)]


@pytest.mark.parametrize("shape", SHAPES_K9, ids=["n6", "n3-v32", "n40"])
@pytest.mark.parametrize("tiers", TIER_SETS, ids=["cfg4", "prop", "drf"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_evict_preempt_cluster_matches_plain(dtype, tiers, shape):
    _cuda()
    nodes, jobs = shape
    attempts = 0
    for seed in (0, 1, 2):
        spec, enc = preempt_plan(overcommit_cluster(seed, nodes, jobs), tiers, dtype)
        attempts += int(_same_machine(spec, enc)[-3])
    assert attempts > 0                            # some walk took a cut


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_evict_preempt_cfg4_per_action_and_fused(dtype):
    """A cfg4 session at 0.1 scale (800 nodes, a 352-node window): the
    per-action K9 and the fused K9 (the packed result and every carry
    tensor) against their plain versions on the inputs the session gave."""
    _cuda()
    import os

    from volcano_tpu_torch.bench.clusters import CONFIGS, build_config, make_tiers
    from volcano_tpu_torch.ops import evict_kernels as EK
    from volcano_tpu_torch.scheduler.framework import (
        close_session, open_session, run_actions)

    seen = {}
    real = {n: getattr(EK, n) for n in ("solve_packed", "preempt_fused")}

    def keep(name):
        def fn(spec, enc):
            seen.setdefault((name, spec.kind), (spec, {k: v.clone() for k, v in enc.items()}))
            return real[name](spec, enc)
        return fn

    prev = os.environ.get("VOLCANO_TPU_FUSE")
    EK.solve_packed, EK.preempt_fused = keep("solve_packed"), keep("preempt_fused")
    try:
        for fuse in ("0", "1"):
            os.environ["VOLCANO_TPU_FUSE"] = fuse
            cache, _, _, actions, _ = build_config(4, 0.1)
            ssn = open_session(cache, make_tiers(["tpuscore"], *CONFIGS[4].tiers, arguments={
                "tpuscore": {"tpuscore.mode": "rounds", "tpuscore.device": "cuda",
                             "tpuscore.dtype": dtype}}))
            try:
                run_actions(ssn, list(actions))
            finally:
                close_session(ssn)
    finally:
        EK.solve_packed, EK.preempt_fused = real["solve_packed"], real["preempt_fused"]
        if prev is None:
            os.environ.pop("VOLCANO_TPU_FUSE", None)
        else:
            os.environ["VOLCANO_TPU_FUSE"] = prev
    spec, enc = seen[("solve_packed", "preempt")]
    _same_machine(spec, enc)
    spec, enc = seen[("preempt_fused", "preempt")]
    got, carry = EK.preempt_fused(spec, enc)
    want, carry_p = EK.preempt_fused_plain(spec, enc)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert sorted(carry) == sorted(carry_p)
    for k in carry_p:
        assert torch.equal(carry[k], carry_p[k]), k


def _layout(enc, kind):
    """node_real and real_n laid out other than as the prefix [0, real_n)
    (real_n stays within the node axis: the reference's candidate argmin
    takes N as its sentinel position)."""
    enc = dict(enc)
    real = enc["node_real"].clone()
    n = real.shape[0]
    real_n = n
    if kind == "first-pad":                        # the pad ahead of the real slots
        real[0] = False
    elif kind == "scattered":                      # every third slot a pad
        real = torch.arange(n, device=real.device) % 3 != 1
        real_n = int(real.sum())
    elif kind == "real-n-short":                   # real_n below the real count
        real_n = n - 3
    enc["node_real"] = real
    enc["real_n"] = torch.tensor(real_n, dtype=torch.int32, device=real.device)
    return enc


@pytest.mark.parametrize("kind", ["first-pad", "scattered", "real-n-short"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_evict_preempt_any_real_layout_matches_plain(dtype, kind):
    """Real slots other than the prefix [0, real_n) take the reference's
    own window arithmetic on the card (nodes that share a circular
    position included), equal to the plain version."""
    _cuda()
    attempts = 0
    for seed in (0, 1):
        spec, enc = preempt_plan(overcommit_cluster(seed, nodes=12, running_jobs=30),
                                 TIER_SETS[0], dtype)
        got = _same_machine(spec, _layout(enc, kind))
        assert int(got[-2]) == 0                   # no fail: the kernel took it
        attempts += int(got[-3])
    assert attempts > 0


@pytest.mark.parametrize("tiers", TIER_SETS, ids=["cfg4", "prop", "drf"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_evict_preempt_wide_rows_match_plain(dtype, tiers):
    """Nodes of more than 256 victims (V = 512) fold from global scratch
    rows, equal to the plain version."""
    _cuda()
    spec, enc = preempt_plan(overcommit_cluster(0, nodes=2, running_jobs=130, pods=1024),
                             tiers, dtype)
    assert enc["vic_job"].shape[1] == 512
    got = _same_machine(spec, enc)
    assert int(got[-3]) > 0


def _tiled(enc, n):
    """The plan's node axis repeated to n nodes (every copy real, its
    victims those of the node it copies), a window of 4096 nodes and an
    op log long enough for every walk."""
    n0 = enc["node_real"].shape[0]
    reps = -(-n // n0)
    out = dict(enc)
    for k, t in enc.items():
        if t.dim() >= 1 and k.startswith(("node_", "vic_")) and t.shape[0] == n0:
            out[k] = t.repeat((reps,) + (1,) * (t.dim() - 1))[:n].contiguous()
        elif k in ("affinity_score", "sig_mask"):
            out[k] = t.repeat(1, reps)[:, :n].contiguous()
    dev = enc["node_real"].device
    out["real_n"] = torch.tensor(n, dtype=torch.int32, device=dev)
    out["num_to_find"] = torch.tensor(4096, dtype=torch.int32, device=dev)
    out["log0"] = torch.zeros((1 << 16, 3), dtype=torch.int32, device=dev)
    return out


@pytest.mark.parametrize("n", [105_000, 140_000], ids=["spill", "spill-long-runs"])
def test_evict_preempt_large_node_axis_matches_plain(n):
    """Node slices too large for a CTA's shared memory (V = 16, float32:
    about 103k nodes) live in a global buffer; past 131,072 nodes a
    thread's window run is longer than one bit mask. Equal to the plain
    version, with the layout the launcher reports."""
    _cuda()
    from volcano_tpu_torch.ops import evict_kernels as EK

    spec, enc = preempt_plan(overcommit_cluster(0, nodes=12, running_jobs=30),
                             TIER_SETS[0], "float32")
    enc = _tiled(enc, n)
    cluster, smem, spill = EK.preempt_layout(n, enc["vic_job"].shape[1], torch.float32)
    assert (cluster, smem) == (16, 0) and spill > 0
    got = _same_machine(spec, enc)
    assert int(got[-2]) == 0 and int(got[-3]) > 0


def test_evict_preempt_layout_is_one_cluster_of_16():
    """Every shape launches one cluster of 16 CTAs: cfg4's (8000 nodes,
    V = 16) from shared memory, in float32 and float64."""
    _cuda()
    from volcano_tpu_torch.ops import evict_kernels as EK

    for dt in DTYPES:
        cluster, smem, spill = EK.preempt_layout(8000, 16, dt)
        assert cluster == 16 and smem > 0 and spill == 0


# -- K10: the reclaim machine on K9's cluster -------------------------------------


def reclaim_inputs(cache, dtype, device="cuda", tiers=None):
    """K10's inputs of a session on ``cache`` (the reclaim path's tiers and
    actions): per-action (VOLCANO_TPU_FUSE=0, from solve_packed) and fused
    (from reclaim_fused), each {"per_action" | "fused": (spec, enc)}."""
    import os

    from volcano_tpu_torch.bench.clusters import make_tiers
    from volcano_tpu_torch.bench.reclaim_path import EVICT_ACTIONS, RECLAIM_TIERS
    from volcano_tpu_torch.ops import evict_kernels as EK
    from volcano_tpu_torch.scheduler.framework import (
        close_session, open_session, run_actions)
    import volcano_tpu_torch.scheduler.actions  # noqa: F401
    import volcano_tpu_torch.scheduler.plugins  # noqa: F401

    seen = {}
    real = {n: getattr(EK, n) for n in ("solve_packed", "reclaim_fused")}

    def keep(name, key):
        def fn(spec, enc):
            if spec.kind == "reclaim":
                seen.setdefault(key, (spec, {k: v.clone() for k, v in enc.items()}))
            return real[name](spec, enc)
        return fn

    prev = os.environ.get("VOLCANO_TPU_FUSE")
    EK.solve_packed = keep("solve_packed", "per_action")
    EK.reclaim_fused = keep("reclaim_fused", "fused")
    try:
        for fuse in ("0", "1"):
            os.environ["VOLCANO_TPU_FUSE"] = fuse
            c = cache() if callable(cache) else cache
            ssn = open_session(c, make_tiers(["tpuscore"], *(tiers or RECLAIM_TIERS), arguments={
                "tpuscore": {"tpuscore.mode": "rounds", "tpuscore.device": device,
                             "tpuscore.dtype": dtype}}))
            try:
                run_actions(ssn, list(EVICT_ACTIONS))
            finally:
                close_session(ssn)
    finally:
        EK.solve_packed, EK.reclaim_fused = real["solve_packed"], real["reclaim_fused"]
        if prev is None:
            os.environ.pop("VOLCANO_TPU_FUSE", None)
        else:
            os.environ["VOLCANO_TPU_FUSE"] = prev
    return seen


def _same_reclaim(spec, enc, fused=False):
    from volcano_tpu_torch.ops import evict_kernels as EK

    got = EK.reclaim_fused(spec, enc) if fused else EK.solve_packed(spec, enc)
    want = EK.reclaim_plain(spec, enc)
    torch.cuda.synchronize()
    assert torch.equal(got, want), ((got != want).nonzero()[:8].tolist(),
                                    got[-6:].tolist(), want[-6:].tolist())
    return got


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_evict_reclaim_path_per_action_and_fused(dtype):
    """Small reclaim-path sessions (160 nodes, 24 pending gangs): the
    per-action and the fused K10 against reclaim_plain on the inputs the
    sessions gave; reclaim evicts."""
    _cuda()
    from volcano_tpu_torch.bench.reclaim_path import reclaim_path_cluster

    seen = reclaim_inputs(lambda: reclaim_path_cluster(0.02)[0], dtype)
    for key in ("per_action", "fused"):
        spec, enc = seen[key]
        got = _same_reclaim(spec, enc, fused=key == "fused")
        assert int(got[-6]) > 0 and int(got[-2]) == 0, key   # ops logged, no fail


@pytest.mark.parametrize("kind", ["first-pad", "scattered", "real-n-short"])
def test_evict_reclaim_any_real_layout_matches_plain(kind):
    """Real slots other than the prefix [0, real_n): K10 walks nodes by
    the signature mask alone, equal to the plain version."""
    _cuda()
    from volcano_tpu_torch.bench.reclaim_path import reclaim_path_cluster

    spec, enc = reclaim_inputs(lambda: reclaim_path_cluster(0.02)[0], "float32")["per_action"]
    got = _same_reclaim(spec, _layout(enc, kind))
    assert int(got[-6]) > 0


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_evict_reclaim_wide_rows_match_plain(dtype):
    """Nodes of more than 256 victims (V = 512) fold from global scratch
    rows, per-action and fused, equal to the plain version."""
    _cuda()
    from volcano_tpu_torch.bench.reclaim_path import dense_reclaim_cluster

    seen = reclaim_inputs(dense_reclaim_cluster, dtype)
    for key in ("per_action", "fused"):
        spec, enc = seen[key]
        assert enc["vic_job"].shape[1] == 512
        got = _same_reclaim(spec, enc, fused=key == "fused")
        assert int(got[-6]) > 0, key


def test_evict_reclaim_large_node_axis_matches_plain():
    """Node slices too large for a CTA's shared memory (float64: about
    177k nodes) live in a global buffer; equal to the plain version, with
    the layout the launcher reports."""
    _cuda()
    from volcano_tpu_torch.bench.reclaim_path import reclaim_path_cluster
    from volcano_tpu_torch.ops import evict_kernels as EK

    spec, enc = reclaim_inputs(lambda: reclaim_path_cluster(0.02)[0], "float64")["per_action"]
    n = 180_000
    enc = _tiled(enc, n)
    cluster, smem, spill = EK.reclaim_layout(n, enc["vic_job"].shape[1], torch.float64)
    assert (cluster, smem) == (16, 0) and spill > 0
    got = _same_reclaim(spec, enc)
    assert int(got[-2]) == 0 and int(got[-6]) > 0


def test_evict_reclaim_budget_trip_matches_plain():
    """An op log of two rows trips the fail bit at its third entry, as
    the reference's log budget does; the kernel stops where the plain
    version stops."""
    _cuda()
    from volcano_tpu_torch.bench.reclaim_path import reclaim_path_cluster

    spec, enc = reclaim_inputs(lambda: reclaim_path_cluster(0.02)[0], "float32")["per_action"]
    enc = dict(enc, log0=torch.zeros((2, 3), dtype=torch.int32, device=enc["log0"].device))
    got = _same_reclaim(spec, enc)
    assert int(got[-2]) == 1


def test_evict_reclaim_layout_is_one_cluster_of_16():
    """The reclaim path's shape (8000 nodes, V = 16) launches one cluster of
    16 CTAs from shared memory, in float32 and float64."""
    _cuda()
    from volcano_tpu_torch.ops import evict_kernels as EK

    for dt in DTYPES:
        cluster, smem, spill = EK.reclaim_layout(8000, 16, dt)
        assert cluster == 16 and smem > 0 and spill == 0


# -- K15: the parity scan ----------------------------------------------------------


def cfg_parity(cfg, scale, dtype="float32"):
    from volcano_tpu_torch.bench.clusters import CONFIGS, build_config
    from volcano_tpu_torch.bench.parity_cases import parity_inputs

    cache, _, _, _, _ = build_config(cfg, scale)
    return parity_inputs(cache, CONFIGS[cfg].tiers, dtype)


def _same_parity(spec, enc, rr0, ntf):
    from volcano_tpu_torch.ops import parity_kernels as PK

    got = PK._solve_cuda(spec, enc, rr0, ntf)
    want = PK.solve_allocate_plain(spec, enc, rr0, ntf)
    torch.cuda.synchronize()
    assert torch.equal(got, want), ((got != want).nonzero()[:8].tolist(),
                                    got[-1].item(), want[-1].item())
    return got


def test_parity_scan_crafted_windows():
    """cfg2 at 0.05 (50 nodes: N is no multiple of the block): the cursor
    at real_n - 1 and at 0; num_to_find <= 0, 1, and above the feasible
    count; pad nodes inside the rotation."""
    _cuda()
    from volcano_tpu_torch.bench.parity_cases import pads_inside, windows

    spec, enc, rr0, ntf = cfg_parity(2, 0.05)
    for e in (enc, pads_inside(enc)):
        for r0, k in windows(enc, rr0, ntf):
            _same_parity(spec, e, r0, k)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_parity_scan_cfg2_full_scale(dtype):
    """cfg2 at full scale (1000 nodes) gives the plain version's assign and
    cursor."""
    _cuda()
    spec, enc, rr0, ntf = cfg_parity(2, 1.0, dtype)
    got = _same_parity(spec, enc, rr0, ntf)
    assert int((got[:-1] >= 0).sum()) > 0


def test_parity_scan_cfg5_shape():
    """cfg5's node axis at 0.2 (2000 nodes, 10k tasks)."""
    _cuda()
    spec, enc, rr0, ntf = cfg_parity(5, 0.2)
    _same_parity(spec, enc, rr0, ntf)


def test_parity_scan_gang_rolls_back():
    """Gangs whose visit places several tasks, then rolls them back: the
    restored rows give the plain version's later placements."""
    _cuda()
    from volcano_tpu_torch.bench.parity_cases import TIERS, gang_rollback_cluster, parity_inputs

    spec, enc, rr0, ntf = parity_inputs(gang_rollback_cluster(), TIERS)
    got = _same_parity(spec, enc, rr0, ntf)
    placed = int((got[:-1] >= 0).sum())
    assert 0 < placed < 30


def test_parity_scan_many_namespaces_and_queues():
    """S and Q above 32 take the block argmins."""
    _cuda()
    from volcano_tpu_torch.bench.parity_cases import TIERS, parity_inputs, wide_visit_cluster

    spec, enc, rr0, ntf = parity_inputs(wide_visit_cluster(), TIERS)
    assert enc["ns_active0"].shape[0] > 32 and enc["queue_deserved"].shape[0] > 32
    _same_parity(spec, enc, rr0, ntf)


# -- K13: the fused chain's heap rebuilds ----------------------------------------


def fused_heap_calls(cache, tiers, dtype="float32"):
    """K13's calls of a fused session on ``cache`` (allocate, backfill,
    preempt, reclaim on the card): {kind: (spec, enc, st, args, kwargs)}."""
    import os

    from volcano_tpu_torch.bench.clusters import make_tiers
    from volcano_tpu_torch.ops import evict_kernels as EK
    from volcano_tpu_torch.scheduler import framework
    import volcano_tpu_torch.scheduler.actions  # noqa: F401
    import volcano_tpu_torch.scheduler.plugins  # noqa: F401

    seen = {}
    real = EK.fuse_heaps

    def keep(kind, spec, enc, st, *args, **kw):
        seen.setdefault(kind, (spec, {k: v.clone() for k, v in enc.items()},
                               {k: v.clone() for k, v in st.items()}, args, kw))
        return real(kind, spec, enc, st, *args, **kw)

    prev = os.environ.get("VOLCANO_TPU_FUSE")
    os.environ["VOLCANO_TPU_FUSE"] = "1"
    EK.fuse_heaps = keep
    try:
        ssn = framework.open_session(cache, make_tiers(["tpuscore"], *tiers, arguments={
            "tpuscore": {"tpuscore.mode": "rounds", "tpuscore.device": "cuda",
                         "tpuscore.dtype": dtype}}))
        try:
            framework.run_actions(ssn, ["allocate", "backfill", "preempt", "reclaim"])
        finally:
            framework.close_session(ssn)
    finally:
        EK.fuse_heaps = real
        if prev is None:
            os.environ.pop("VOLCANO_TPU_FUSE", None)
        else:
            os.environ["VOLCANO_TPU_FUSE"] = prev
    return seen


def _same_heaps(kind, spec, enc, st, args, kw):
    from volcano_tpu_torch.ops import evict_kernels as EK

    got = EK.fuse_heaps(kind, spec, enc, st, *args, **kw)
    want = EK.fuse_heaps_plain(kind, spec, enc, st, *args, **kw)
    torch.cuda.synchronize()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), (kind, k, (got[k] != want[k]).nonzero()[:8].tolist())
    return got


@pytest.mark.parametrize("scale", [0.05, 1.0])
def test_fuse_heaps_cfg4_matches_plain(scale):
    """Both K13 entries on the carried state of a fused cfg4 session."""
    _cuda()
    from volcano_tpu_torch.bench.clusters import CONFIGS, build_config

    cache = build_config(4, scale)[0]
    calls = fused_heap_calls(cache, CONFIGS[4].tiers)
    assert sorted(calls) == ["preempt", "reclaim"]
    got = _same_heaps("preempt", *calls["preempt"])
    assert int(got["hsize"].sum()) > 0
    _same_heaps("reclaim", *calls["reclaim"])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("tiers", TIER_SETS, ids=["cfg4", "prop", "drf"])
def test_fuse_heaps_ten_queues_matches_plain(tiers, dtype):
    """Both K13 entries on a fused session of ten queues: pushes in many
    rows, the queue heap's order at the carried queue shares."""
    _cuda()
    calls = fused_heap_calls(overcommit_cluster(13, nodes=12, running_jobs=40,
                                                queues=10, hi_jobs=12), tiers, dtype)
    got = _same_heaps("preempt", *calls["preempt"])
    assert int((got["hsize"] > 0).sum()) > 1
    _same_heaps("reclaim", *calls["reclaim"])


def synthetic_heap_call(kind, dt, jobs=20000, rows=6, seed=0):
    """K13's inputs with a push list of about 0.9 x ``jobs`` pushes, past
    the pushes a CTA's shared memory holds: random keys (few priorities,
    equal shares, ready on both sides of min_available), every job in the
    push order once."""
    from volcano_tpu_torch.ops import evict as tevict

    rng = np.random.default_rng(seed)
    dev = "cuda"

    def t(a, dtype=None):
        x = torch.from_numpy(np.ascontiguousarray(a))
        return (x.to(dtype) if dtype is not None else x).to(dev)

    n, v = 64, 4
    min_av = rng.integers(1, 4, jobs).astype(np.int32)
    enc = dict(
        job_prio=t(rng.integers(0, 3, jobs).astype(np.int32)),
        job_min_av=t(min_av),
        job_tie=t(rng.permutation(jobs).astype(np.int32)),
        drf_total=t(np.array([64000.0, 0.0]), dt),
        queue_deserved=t(rng.integers(0, 3, (rows, 2)) * 1000.0, dt),
        queue_tie=t(rng.permutation(rows).astype(np.int32)),
        f_push_jobs=t(np.where(rng.random(jobs) < 0.02, -1,
                               rng.permutation(jobs)).astype(np.int32)),
        f_push_row=t(rng.integers(0, rows, jobs).astype(np.int32)),
        f_ev_jobs=t(np.where(rng.random(jobs) < 0.02, -1,
                             rng.permutation(jobs)).astype(np.int32)),
        f_ev_qrow=t(rng.integers(0, rows, jobs).astype(np.int32)),
        f_elig0=t(rng.random(jobs) < 0.95),
        f_vtn0=t((min_av + rng.integers(0, 2, jobs)).astype(np.int32)),
        vic_job=t(rng.integers(0, jobs, (n, v)).astype(np.int32)),
        vic_valid=t(rng.random((n, v)) < 0.9))
    st = dict(
        live_job=t(rng.random(jobs) < 0.95),
        ready=t((min_av + rng.integers(-1, 2, jobs)).astype(np.int32)),
        job_alloc=t(rng.integers(0, 8, (jobs, 2)) * 500.0, dt),
        queue_alloc=t(rng.integers(0, 3, (rows, 2)) * 1000.0, dt),
        alive=t(rng.random((n, v)) < 0.5))
    spec = tevict.EvictSpec(kind=kind, job_order_keys=("priority", "gang", "drf"),
                            victim_fns=(), check_pod_count=True, use_nodeorder=True,
                            use_binpack=False, use_gang_pipelined=False,
                            use_prop_queue_order=True)
    args = (rows, 8192) if kind == "preempt" else (rows, 8192, rows, True)
    return spec, enc, st, args, {}


@pytest.mark.parametrize("dt", DTYPES, ids=["float32", "float64"])
@pytest.mark.parametrize("kind", ["preempt", "reclaim"])
def test_fuse_heaps_spill_matches_plain(kind, dt):
    """A push list larger than the shared memory spills its keys and heaps
    to global scratch, with the same heaps."""
    _cuda()
    import ctypes

    from volcano_tpu_torch import _build
    from volcano_tpu_torch.ops import evict_kernels as EK

    spec, enc, st, args, kw = synthetic_heap_call(kind, dt)
    plan = (ctypes.c_longlong * 4)()
    EK._fh_lib(_build.library("fuse_heaps"))[2](20000, args[0], int(dt == torch.float64), plan)
    assert 0 < plan[1] < 18000 and plan[3] > 0        # the list outgrows shared memory
    got = _same_heaps(kind, spec, enc, st, args, kw)
    assert int(got["hsize"].sum()) > plan[1]


def test_fuse_heaps_one_launch_a_call():
    _cuda()
    from volcano_tpu_torch import device as devmod
    from volcano_tpu_torch.ops import evict_kernels as EK

    spec, enc, st, args, kw = synthetic_heap_call("preempt", torch.float32, jobs=500)
    before = devmod.LAUNCHES["fuse_heaps_preempt"]
    EK.fuse_heaps("preempt", spec, enc, st, *args, **kw)
    assert devmod.LAUNCHES["fuse_heaps_preempt"] == before + 1
