"""K2b (``cap_walk``, the capacity walk) and K6 (``job_rank``, the job
ranks) of the port: their plain versions against the JAX package's
``_cap_walk``, ``_nominate_full`` and ``_job_rank``, jitted, bit for bit.

The inputs are made with numpy from a seed (volcano_tpu_torch/bench/
round_cases.py ``walk_inputs``, ``rank_inputs``) and fed to the JAX function
and to the port on CPU tensors: to the plain versions the CUDA kernels are
held against on the card (tests/test_torch_rounds_gpu.py, chip_smoke.py),
and to the round's dispatchers (``rounds._cap_walk``, ``_nominate_full``,
``_job_rank``). Float64, and float32 with the reference run without x64.
The walk's crafted rows hold ties of +0.0 and -0.0, all -inf rows, -inf
ahead of a feasible tail, zero requests, binpack shares, exclusion classes,
pod room zero or negative, prefixes saturating at t_cap, W = 1, odd W and
W past one of the kernel's chunks; the ranks run under every order of the
priority, gang and drf tiers over ties, signed-zero shares, zero totals,
absent dimensions and all-equal keys. The calls of port solves (cfg2, cfg5
with its cover, cfg6) are held too. Tolerance: exact equality.
"""

from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volcano_tpu.ops import kernels as jkernels
from volcano_tpu.ops import rounds as jrounds

from tests.test_torch_rounds import encoded_arrays, port_spec
from volcano_tpu_torch.bench import round_cases as RC
from volcano_tpu_torch.ops import rounds as trounds
from volcano_tpu_torch.ops import rounds_kernels as RK
from volcano_tpu_torch.ops import solver as tsolver

DTYPES = {"float64": (np.float64, torch.float64), "float32": (np.float32, torch.float32)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _x64(dt):
    """float64 runs the reference with x64 (the tests' default); float32
    without it, as a float32 solve runs."""
    return contextlib.nullcontext() if dt == "float64" else jax.enable_x64(False)


def _jspec(spec):
    return jkernels.SolveSpec(**spec._asdict())


@functools.lru_cache(maxsize=None)
def _walk_ref(jspec, t_cap, dt):
    return jax.jit(functools.partial(jrounds._cap_walk, jspec, t_cap=t_cap))


@functools.lru_cache(maxsize=None)
def _nominate_ref(jspec, t_cap, dt):
    return jax.jit(functools.partial(jrounds._nominate_full, jspec, t_cap=t_cap))


@functools.lru_cache(maxsize=None)
def _rank_ref(jspec, dt):
    return jax.jit(functools.partial(jrounds._job_rank, jspec))


def _cast(a, npdt):
    return a.astype(npdt) if a.dtype == np.float64 else a


# -- K2b ---------------------------------------------------------------------------

def walk_both(inp, dt):
    """(the reference's walk, cap_walk_plain's, rounds._cap_walk's) on one
    walk_inputs input, as numpy."""
    npdt, tdt = DTYPES[dt]
    flags, a, t_cap = inp
    args = RC.walk_args(inp, "cpu", tdt)
    spec = args[0]
    a = {k: _cast(v, npdt) for k, v in a.items()}
    with _x64(dt):
        ref = _walk_ref(_jspec(spec), t_cap, dt)(
            {"eps": jnp.asarray(a["eps"]), "node_max_tasks": jnp.asarray(a["node_max_tasks"])},
            jnp.asarray(a["order"]), jnp.asarray(a["score_ord"]), jnp.asarray(a["req"]),
            jnp.asarray(a["exl"]) if spec.use_exclusion else None,
            jnp.asarray(a["has_pod"]),
            jnp.asarray(a["frac"]) if spec.use_binpack else None,
            jnp.asarray(a["idle"]), jnp.asarray(a["cnt"]))
        ref = [np.asarray(x) for x in ref]
    plain = [x.numpy() for x in RK.cap_walk_plain(*args)]
    enc = {"eps": args[10], "node_max_tasks": args[9]}
    via_round = [x.numpy() for x in trounds._cap_walk(spec, enc, *args[1:9], t_cap)]
    return ref, plain, via_round


def _assert_walk(ref, *ours, what=""):
    for got in ours:
        for name, g, r in zip(("ccap", "g_start", "g_size", "ccap_before"), got, ref):
            assert g.dtype == np.int32, (what, name)
            np.testing.assert_array_equal(g, r, err_msg=f"{what} {name}")


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("label", [c[0] for c in RC.WALK_CASES])
def test_cap_walk_plain_matches_reference_on_crafted_inputs(label, dt):
    inp = RC.walk_inputs(**dict(RC.WALK_CASES)[label])
    ref, plain, via_round = walk_both(inp, dt)
    _assert_walk(ref, plain, via_round, what=label)


def test_crafted_walks_reach_their_edges():
    """The crafted rows do what their labels say: prefixes saturate at
    t_cap, an all -inf row has no capacity and is one group, a tied row is
    one group."""
    ref, plain, _ = walk_both(RC.walk_inputs(**dict(RC.WALK_CASES)["saturating at t_cap"]),
                              "float64")
    ccap = plain[0]
    assert (ccap == 37).any() and (ccap[:, -1] == 37).any()
    ref, plain, _ = walk_both(RC.walk_inputs(**dict(RC.WALK_CASES)["ties and signed zeros"]),
                              "float64")
    g_size = plain[2]
    w = g_size.shape[1]
    assert (g_size[3] == w).all(), "the one-group row is one group of W"
    assert (g_size[1] == w).all(), "an all -inf row is one group of W"
    assert (plain[0][1] == 0).all(), "an all -inf row has no capacity"


@pytest.mark.parametrize("dt", list(DTYPES))
def test_walk_shapes_match_reference(dt):
    """Random rows at the widths of the window and the cover of cfg5, cfg2
    and cfg6 (rows cut to 4 here: rows are independent)."""
    for i, (label, rows, w, n) in enumerate(RC.WALK_SHAPES):
        inp = RC.walk_inputs(20 + i, min(rows, 4), w, n, binpack=i % 2 == 0, excl=i >= 4)
        ref, plain, via_round = walk_both(inp, dt)
        _assert_walk(ref, plain, via_round, what=label)


def nominate_inputs(seed, k, n):
    """A [K, N] score matrix of tied, signed-zero and -inf entries and the
    encode fields the full-width nomination reads."""
    g = np.random.default_rng(seed)
    scores = g.choice([7.0, 3.5, 3.5, 0.0, -0.0, -1.0, -np.inf], (k, n))
    scores[0] = -np.inf
    enc = {"cls_req": g.choice([0.0, 100.0, 1000.0], (k, 3)),
           "cls_excl": g.integers(-1, 3, k).astype(np.int32),
           "cls_has_pod": g.random(k) < 0.8, "eps": np.array([10.0, 10.0, 10.0]),
           "node_max_tasks": g.integers(0, 6, n).astype(np.int32)}
    idle = g.choice([-10.0, 0.0, 500.0, 4000.0], (n, 3))
    cnt = g.integers(0, 6, n).astype(np.int32)
    frac = g.choice([0.25, 0.5, 1.0], k)
    return scores, enc, idle, cnt, frac


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("k,binpack,excl", [(7, False, False), (256, True, True),
                                            (256, False, True)])
def test_nominate_full_one_walk_matches_the_chunked_reference(k, binpack, excl, dt):
    """``_nominate_full`` walks every class row in one K2b call; the
    reference chunks them by 128 (lax.map at K = 256): the same result."""
    npdt, tdt = DTYPES[dt]
    scores, enc, idle, cnt, frac = nominate_inputs(k, k, 50)
    spec = RC._spec(binpack, excl)
    t_cap = 400
    scores, idle, frac = (x.astype(npdt) for x in (scores, idle, frac))
    enc = {kk: _cast(v, npdt) for kk, v in enc.items()}
    with _x64(dt):
        ref = _nominate_ref(_jspec(spec), t_cap, dt)(
            {kk: jnp.asarray(v) for kk, v in enc.items()}, jnp.asarray(scores),
            jnp.asarray(idle), jnp.asarray(cnt), jnp.asarray(frac) if binpack else None)
        ref = [np.asarray(x) for x in ref]
    got = trounds._nominate_full(
        spec, {kk: torch.from_numpy(v) for kk, v in enc.items()}, torch.from_numpy(scores),
        torch.from_numpy(idle), torch.from_numpy(cnt),
        torch.from_numpy(frac) if binpack else None, t_cap)
    assert len(got) == 5
    for name, g, r in zip(("order", "ccap", "g_start", "g_size", "ccap_before"), got, ref):
        np.testing.assert_array_equal(g.numpy(), r, err_msg=name)


# -- K6 ------------------------------------------------------------------------------

def rank_both(inp, keys, dt):
    """(the reference's rank, job_rank_plain's (rank, order), the round's
    _job_rank's) on one rank_inputs input, as numpy."""
    npdt, tdt = DTYPES[dt]
    cols, placed, alloc = inp
    args = RC.rank_args(inp, keys, "cpu", tdt)
    spec = args[0]
    with _x64(dt):
        jenc = {k: jnp.asarray(_cast(v, npdt)) for k, v in cols.items()}
        ref = np.asarray(_rank_ref(_jspec(spec), dt)(
            jenc, jnp.asarray(placed), jnp.asarray(alloc.astype(npdt))))
    rank, order = RK.job_rank_plain(*args)
    via_round = trounds._job_rank(spec, args[1], args[2], args[3])
    return ref, (rank.numpy(), order.numpy()), (via_round[0].numpy(), via_round[1].numpy())


def _assert_rank(ref, *ours, what=""):
    for rank, order in ours:
        assert rank.dtype == np.int32 and order.dtype == np.int64, what
        np.testing.assert_array_equal(rank, ref, err_msg=what)
        np.testing.assert_array_equal(order, np.argsort(ref), err_msg=what)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("keys", RC.RANK_KEY_ORDERS,
                         ids=["-".join(k) or "tie-rank-only" for k in RC.RANK_KEY_ORDERS])
def test_job_rank_plain_matches_reference_on_crafted_inputs(keys, dt):
    for i, kind in enumerate(RC.RANK_KINDS):
        inp = RC.rank_inputs(30 + i, 700, kind)
        ref, plain, via_round = rank_both(inp, keys, dt)
        _assert_rank(ref, plain, via_round, what=f"{kind} {keys}")


def test_crafted_ranks_reach_their_edges():
    """The signed-zero shares hold both zeros (and tie), the zero totals
    give share 1, all-equal keys rank by index."""
    from volcano_tpu_torch.ops.kernels import _share

    cols, placed, alloc = RC.rank_inputs(31, 700, "signed-zero shares")
    share = _share(torch.tensor(alloc), torch.tensor(cols["drf_total"])[None],
                   torch.tensor(cols["drf_present"])[None])
    assert (share == 0).sum() > 100 and torch.signbit(share[share == 0]).any()
    cols, placed, alloc = RC.rank_inputs(32, 700, "zero totals")
    share = _share(torch.tensor(alloc), torch.tensor(cols["drf_total"])[None],
                   torch.tensor(cols["drf_present"])[None])
    assert (share == 1.0).any()
    ref, plain, _ = rank_both(RC.rank_inputs(34, 700, "all equal"), ("priority", "gang", "drf"),
                              "float64")
    assert (ref == np.arange(700)).all()


@pytest.mark.parametrize("dt", list(DTYPES))
def test_job_rank_shapes_match_reference(dt):
    """The job counts of cfg5, cfg2 and cfg6 under the three tiers."""
    for i, (label, j) in enumerate(RC.RANK_SHAPES):
        ref, plain, via_round = rank_both(RC.rank_inputs(40 + i, j), RC.RANK_KEY_ORDERS[0], dt)
        _assert_rank(ref, plain, via_round, what=label)


# -- the calls of port solves -----------------------------------------------------

# (cfg, scale): cfg2 (binpack), cfg5 (the window and its cover: a narrow
# window where the solver would sweep the full width at this size), cfg6
# (exclusion groups)
SOLVES = ((2, 0.04), (5, 0.01), (6, 0.06))


@functools.lru_cache(maxsize=None)
def _recorded(cfg, scale):
    from volcano_tpu.ops import solver as jsolver

    arrays, jspec = encoded_arrays(cfg, scale)
    wf = jsolver._window_fields(arrays)
    if wf["window_k"] == 0:
        n = arrays["node_idle"].shape[0]
        wf = {"window_k": max(1, n // 4), "dirty_k": max(1, n // 2)}
    enc = tsolver.from_numpy_encoded(arrays, device="cpu", dtype=torch.float64)
    return RC.record_solve(port_spec(jspec._replace(**wf)), enc, limit=12,
                           kinds=("walk", "ranks"))


@pytest.mark.parametrize("cfg,scale", SOLVES, ids=[f"cfg{c}" for c, _ in SOLVES])
def test_walk_and_ranks_match_reference_on_recorded_rounds(cfg, scale):
    seen = _recorded(cfg, scale)
    assert seen["walk"] and seen["ranks"]
    widths = set()
    for i, (args, _) in enumerate(seen["walk"]):
        spec, order, score_ord, req, exl, has_pod, frac, idle, cnt, nmax, eps, t_cap = args
        widths.add(order.shape[1])
        ref = _walk_ref(_jspec(spec), t_cap, "float64")(
            {"eps": jnp.asarray(eps.numpy()), "node_max_tasks": jnp.asarray(nmax.numpy())},
            *(None if x is None else jnp.asarray(x.numpy())
              for x in (order, score_ord, req, exl, has_pod, frac, idle, cnt)))
        _assert_walk([np.asarray(x) for x in ref],
                     [x.numpy() for x in RK.cap_walk_plain(*args)], what=f"cfg{cfg} walk {i}")
    if cfg == 5:
        assert len(widths) == 2, "the cfg5 solve must walk its window and its cover"
    for i, (args, _) in enumerate(seen["ranks"]):
        spec, cols, placed, alloc = args
        ref = _rank_ref(_jspec(spec), "float64")(
            {k: jnp.asarray(v.numpy()) for k, v in cols.items()},
            jnp.asarray(placed.numpy()), jnp.asarray(alloc.numpy()))
        rank, order = RK.job_rank_plain(*args)
        _assert_rank(np.asarray(ref), (rank.numpy(), order.numpy()), what=f"cfg{cfg} ranks {i}")
