"""The port's kernel plain versions against the JAX reference functions.

Each case builds its inputs with numpy from a seed and feeds the same
values to the JAX function (float64, CPU) and to the port's wrapper on CPU
tensors, where the wrapper runs its plain version — the function the CUDA
kernel is held against on the card (chip_smoke.py). Tolerance: exact
equality (bit for bit for floats, including -inf).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from volcano_tpu.ops import kernels as jkernels
from volcano_tpu.ops import rounds as jrounds

from volcano_tpu_torch.ops import kernels as tkernels
from volcano_tpu_torch.ops import rounds as trounds
from volcano_tpu_torch.ops import rounds_kernels as tk


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _spec(mod, **kw):
    base = dict(job_order_keys=("priority", "gang"), use_drf_ns_order=False,
                use_prop_queue_order=False, use_prop_overused=True,
                check_pod_count=False, use_binpack=False,
                use_nodeorder=False, use_exclusion=False)
    base.update(kw)
    return mod.SolveSpec(**base)


def _score_inputs(seed, k=12, n=50, s=3, g=2):
    """Class rows and node columns with non-dyadic quantities (so inexact
    products and the fused multiply-add rounding show)."""
    rng = np.random.default_rng(seed)
    mi = 1024.0 * 1024.0
    alloc = np.stack([
        rng.choice([4000.0, 6000.0, 12345.0, 32000.0, 0.0], n, p=[.3, .3, .2, .15, .05]),
        rng.choice([8192.0, 24000.0, 65536.0], n) * mi,
        rng.choice([0.0, 4000.0, 8000.0], n)], axis=1)
    used = np.floor(alloc * rng.random((n, 3)) / 7.0) * 7.0
    over = rng.random(n) < 0.1
    used[over, 0] = alloc[over, 0] + 1e3  # over-committed nodes
    idle = alloc - used
    req = np.stack([
        rng.choice([0.0, 100.0, 300.0, 700.0, 1100.0, 2500.0], k),
        rng.choice([0.0, 300.0, 700.0, 1500.0], k) * mi,
        rng.choice([0.0, 0.0, 5.0, 1000.0, 2000.0], k)], axis=1)
    initreq = req.copy()
    initreq[0] = req[0] + 50.0
    enc = {
        "eps": np.array([10.0, 10.0 * mi, 10.0]),
        "is_scalar": np.array([False, False, True]),
        "node_alloc": alloc,
        "affinity_score": rng.choice([0.0, 1.0, 3.0, 7.0], (s, n)),
        "sig_mask": rng.random((s, n)) < 0.85,
        "node_max_tasks": rng.integers(1, 6, n).astype(np.int32),
        "binpack_w": np.array([1.0, 3.0, 2.0]),
        "binpack_weight": np.float64(3.0),
        "least_req_weight": np.float64(1.0),
        "balanced_weight": np.float64(2.0),
        "node_affinity_weight": np.float64(3.0),
        "cls_req": req,
        "cls_initreq": initreq,
        "cls_sig": rng.integers(0, s, k).astype(np.int32),
        "cls_nz_cpu": np.where(req[:, 0] > 0, req[:, 0], 100.0),
        "cls_nz_mem": np.where(req[:, 1] > 0, req[:, 1], 200.0 * mi),
        "cls_has_pod": rng.random(k) < 0.8,
        "cls_excl": rng.choice([-1, 0, 1], k).astype(np.int32),
    }
    state = {
        "idle": idle, "used": used,
        "cnt": rng.integers(0, 5, n).astype(np.int32),
        "occ": rng.random((g, n)) < 0.3,
    }
    return enc, state


def _torch_dict(d):
    return {k: torch.from_numpy(np.ascontiguousarray(np.asarray(v))) for k, v in d.items()}


FLAGS = [
    dict(use_nodeorder=True),
    dict(use_binpack=True),
    dict(use_nodeorder=True, use_binpack=True, check_pod_count=True),
    dict(use_binpack=True, use_exclusion=True, check_pod_count=True),
    dict(use_nodeorder=True, use_exclusion=True),
    dict(),
]


@pytest.mark.parametrize("gathered", [False, True], ids=["full", "cols"])
@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "-".join(sorted(f)) or "mask-only")
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_score_block_matches_reference(seed, flags, gathered):
    enc, st = _score_inputs(seed)
    jspec, tspec = _spec(jkernels, **flags), _spec(tkernels, **flags)
    n = st["idle"].shape[0]
    cols = (np.random.default_rng(seed + 100).choice(n, 17, replace=False)
            .astype(np.int32) if gathered else np.arange(n, dtype=np.int32))
    if gathered:
        cols[-3:] = 0  # padding slots alias column 0, as the dirty gather does
    je = {k: jnp.asarray(v) for k, v in enc.items()}
    # jitted, as solve_rounds runs it: XLA's CPU backend then fuses the
    # multiply-adds the port reproduces with its exact FMA
    ref = jax.jit(functools.partial(jrounds._score_block, jspec))(
        je, je["cls_req"], je["cls_initreq"], je["cls_sig"],
        je["cls_nz_cpu"], je["cls_nz_mem"], je["cls_has_pod"],
        je["cls_excl"] if flags.get("use_exclusion") else None,
        jnp.asarray(st["idle"][cols]), jnp.asarray(st["used"][cols]),
        jnp.asarray(st["cnt"][cols]),
        jnp.asarray(st["occ"][:, cols]) if flags.get("use_exclusion") else None,
        je["sig_mask"][:, cols], je["node_max_tasks"][cols],
        je["node_alloc"][cols], je["affinity_score"][:, cols])
    ref = np.asarray(ref)
    te, ts = _torch_dict(enc), _torch_dict(st)
    k = enc["cls_req"].shape[0]
    base = np.full((k, n), 123.0)
    out = torch.from_numpy(base.copy())
    if gathered:
        # the round's entry on a dirty round: the columns of the list (the
        # padding's column 0 among them) marked dirty, within the budget
        dirty = torch.zeros(n, dtype=torch.bool)
        dirty[torch.from_numpy(cols).long()] = True
        n_feas = torch.zeros(k, dtype=torch.int32)
        tkernels.score_round(tspec._replace(dirty_k=len(cols)), te, ts["idle"],
                             ts["used"], ts["cnt"], ts["occ"], out, dirty,
                             dirty.sum().to(torch.int32), n_feas)
        assert torch.equal(n_feas, (out > float("-inf")).sum(-1).to(torch.int32))
    else:
        tkernels.score_block(tspec, te, ts["idle"], ts["used"], ts["cnt"],
                             ts["occ"], out)
    got = out.numpy()
    np.testing.assert_array_equal(got[:, cols], ref)
    untouched = np.ones(n, bool)
    untouched[cols] = False
    np.testing.assert_array_equal(got[:, untouched], base[:, untouched])
    assert np.isfinite(ref).any() and np.isneginf(ref).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_scores_matches_reference(seed):
    enc, st = _score_inputs(seed)
    spec_kw = dict(use_nodeorder=True, use_binpack=True)
    je = {k: jnp.asarray(v) for k, v in enc.items()}
    te = _torch_dict(enc)
    ref = jax.jit(functools.partial(jkernels.fused_scores,
                                    _spec(jkernels, **spec_kw)))(
        je, jnp.asarray(st["used"]), je["cls_req"],
        je["cls_nz_cpu"], je["cls_nz_mem"], je["cls_sig"])
    got = tkernels.fused_scores(
        _spec(tkernels, **spec_kw), te, torch.from_numpy(st["used"]),
        te["cls_req"], te["cls_nz_cpu"], te["cls_nz_mem"], te["cls_sig"].long())
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_fma_is_single_rounded():
    """The balanced term's 10 - |d| * 10 rounds once, as XLA's CPU backend
    contracts it; a separate multiply and subtract rounds twice and
    differs on a fraction of these inputs."""
    rng = np.random.default_rng(7)
    d = np.round(rng.random(4000), 2) - np.round(rng.random(4000), 1)
    ref = np.asarray(jax.jit(lambda x: jnp.floor(10.0 - jnp.abs(x) * 10.0))(
        jnp.asarray(d)))
    t = torch.from_numpy(d)
    ten = torch.tensor(10.0, dtype=torch.float64)
    got = torch.floor(tkernels._fma(-torch.abs(t), ten, ten)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (np.floor(10.0 - np.abs(d) * 10.0) != ref).any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_window_topk_matches_lax_top_k(seed):
    rng = np.random.default_rng(seed)
    rows, n, k = 9, 300, 40
    vals = rng.choice([0.0, 1.5, 2.0, 7.25, 10.0], (rows, n))
    vals[rng.random((rows, n)) < 0.35] = -np.inf
    vals[0] = -np.inf          # an all-infeasible row
    vals[1] = 3.0              # an all-tied row
    vals[2, :] = -np.inf
    vals[2, 250:] = 1.0        # feasible tail, -inf ties ahead of it
    ref_s, ref_i = lax.top_k(jnp.asarray(vals), k)
    got_s, got_i = tk.window_topk(torch.from_numpy(vals), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))
    assert got_i.dtype == torch.int32


def _resolve_inputs(seed, t=300, n=20, r=3):
    rng = np.random.default_rng(seed)
    mi = 1024.0 * 1024.0
    enc = {
        "is_scalar": np.array([False, False, True]),
        "res_unit": np.array([1.0, mi, 1.0]),
        "eps": np.array([10.0, 10.0 * mi, 10.0]),
        "task_req": np.stack([
            rng.choice([100.0, 250.0, 999.5, 2000.0], t),
            rng.choice([256.0, 511.3, 2048.0], t) * mi,
            rng.choice([0.0, 4.0, 1000.0], t)], axis=1),
        "task_has_pod": rng.random(t) < 0.9,
        "node_max_tasks": rng.integers(2, 30, n).astype(np.int32),
        "queue_deserved": np.stack([
            rng.choice([2e4, 2e5], 4), rng.choice([5e4, 3e5], 4) * mi,
            rng.choice([2e3, 5e4], 4)], axis=1),
    }
    idle = np.stack([rng.choice([3000.0, 16000.5], n),
                     rng.choice([4096.0, 30000.7], n) * mi,
                     rng.choice([0.0, 8000.0], n)], axis=1)
    idle[0] = -5.0  # an over-committed node
    choice = rng.integers(-1, n, t).astype(np.int32)
    rank = rng.permutation(t).astype(np.int32)
    cnt = rng.integers(0, 5, n).astype(np.int32)
    task_queue = rng.integers(0, 4, t).astype(np.int32)
    task_job = (task_queue * 100 + rng.integers(0, 6, t)).astype(np.int32)
    queue_alloc = rng.choice([0.0, 1e4, 3e4], (4, 3)) * np.array([1.0, mi, 0.0])
    accept = rng.random(t) < 0.7
    return enc, idle, choice, rank, cnt, task_queue, task_job, queue_alloc, accept


@pytest.mark.parametrize("check_pod", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resolve_matches_reference(seed, check_pod):
    enc, idle, choice, rank, cnt, *_ = _resolve_inputs(seed)
    je = {k: jnp.asarray(v) for k, v in enc.items()}
    ref = jrounds._resolve(_spec(jkernels, check_pod_count=check_pod), je,
                           jnp.asarray(idle), jnp.asarray(cnt),
                           jnp.asarray(choice), jnp.asarray(rank))
    got = trounds._resolve(_spec(tkernels, check_pod_count=check_pod),
                           _torch_dict(enc), torch.from_numpy(idle),
                           torch.from_numpy(cnt), torch.from_numpy(choice),
                           torch.from_numpy(rank))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.any() and not got.all()


def job_major_ranks(task_job, seed):
    """Task ranks as a round makes them: a job's rank x T + the task's
    place in its job (volcano_tpu/ops/rounds.py round_body), the jobs in a
    seeded random order; K5 takes a job's tasks to lie together."""
    rng = np.random.default_rng(seed + 100)
    t = task_job.shape[0]
    jobs = np.unique(task_job)
    job_rank = dict(zip(jobs, rng.permutation(len(jobs))))
    in_job = np.zeros(t, np.int64)
    seen = {}
    for i in rng.permutation(t):
        in_job[i] = seen.get(task_job[i], 0)
        seen[task_job[i]] = in_job[i] + 1
    return (np.array([job_rank[j] for j in task_job]) * t + in_job).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_queue_budget_matches_reference(seed):
    enc, _, _, _, _, task_queue, task_job, queue_alloc, accept = \
        _resolve_inputs(seed)
    rank = job_major_ranks(task_job, seed)
    je = {k: jnp.asarray(v) for k, v in enc.items()}
    ref = jrounds._queue_budget(je, jnp.asarray(queue_alloc),
                                jnp.asarray(accept), jnp.asarray(rank),
                                jnp.asarray(task_queue), jnp.asarray(task_job))
    got = trounds._queue_budget(_torch_dict(enc), torch.from_numpy(queue_alloc),
                                torch.from_numpy(accept), torch.from_numpy(rank),
                                torch.from_numpy(task_queue),
                                torch.from_numpy(task_job))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.any() and (accept & ~got.numpy()).any()


def test_queue_budget_exact_past_int32():
    """tests/test_rounds.py TestInt32OverflowExactness: 70 one-task jobs
    of 36k cores in one queue; the cumulative sum passes 2^31 units."""
    t = 70
    enc = {"is_scalar": np.array([False]), "res_unit": np.array([1.0]),
           "eps": np.array([10.0]), "task_req": np.full((t, 1), 36_000_000.0),
           "queue_deserved": np.array([[2.0e9]])}
    args = (np.zeros((1, 1)), np.ones(t, bool), np.arange(t, dtype=np.int32),
            np.zeros(t, np.int32), np.arange(t, dtype=np.int32))
    ref = np.asarray(jrounds._queue_budget(
        {k: jnp.asarray(v) for k, v in enc.items()}, *map(jnp.asarray, args)))
    got = trounds._queue_budget(_torch_dict(enc), *map(torch.from_numpy, args)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.sum() == 56 and not got[60]


def test_resolve_exact_past_int32():
    t = 70
    enc = {"is_scalar": np.array([False]), "res_unit": np.array([1.0]),
           "eps": np.array([10.0]), "task_req": np.full((t, 1), 36_000_000.0),
           "task_has_pod": np.zeros(t, bool),
           "node_max_tasks": np.array([100], np.int32)}
    args = (np.array([[40_000_000.0]]), np.zeros(1, np.int32),
            np.zeros(t, np.int32), np.arange(t, dtype=np.int32))
    ref = np.asarray(jrounds._resolve(
        _spec(jkernels), {k: jnp.asarray(v) for k, v in enc.items()},
        *map(jnp.asarray, args)))
    got = trounds._resolve(_spec(tkernels), _torch_dict(enc),
                           *map(torch.from_numpy, args)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.sum() == 1 and got[0]


def test_segment_scans_exact_past_int32():
    """70k rows of 64-core requests in one node segment and one queue
    (tests/test_rounds.py test_seg_limbs_exact_past_lo_limb_wrap): the
    int64 scans of both plain versions stay exact where the sums pass
    2^31. K4: a node whose bound saturates at 2^31 - 1 units takes the
    first 33,554 rows (33,554 x 64,000 < 2^31 - 1 < 33,555 x 64,000); K5:
    70k one-task jobs of one queue, whose budget is every job but the
    last."""
    t = 70_000
    req = torch.full((t, 1), 64_000, dtype=torch.int64)
    order = torch.arange(t, dtype=torch.int64)
    choice = torch.zeros(t, dtype=torch.int32)
    unit = torch.ones(1, dtype=torch.float64)
    eps = torch.zeros(1, dtype=torch.int32)
    for idle, took in ((2.0**40, 33_554), (64_000.0 * 20_000 + 1, 20_000)):
        acc = tk.resolve_prefix(order, choice, req, torch.zeros(t, dtype=torch.bool),
                                torch.tensor([[idle]], dtype=torch.float64), unit, eps,
                                torch.tensor([False]), torch.zeros(1, dtype=torch.int32),
                                torch.ones(1, dtype=torch.int32), False)
        assert bool(acc[:took].all()) and not bool(acc[took:].any())
    ok = tk.queue_budget(torch.ones(t, dtype=torch.bool), torch.arange(t, dtype=torch.int32),
                         req, torch.arange(t, dtype=torch.int64),
                         torch.zeros(t, dtype=torch.int32),
                         torch.zeros((1, 1), dtype=torch.float64), unit,
                         torch.tensor([[(t - 1) * 64_000]], dtype=torch.int64),
                         torch.tensor([False]))
    assert bool(ok[:-1].all()) and not bool(ok[-1])
