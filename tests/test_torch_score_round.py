"""K1's round entry (``score_round``: the carried scores rescored on a full
or a dirty round, decided from the dirty count, and each class row's
feasible count ``n_feas``, in one launch on the card) and the step machine
in the solve graph's layout (K7a first in the loop body, then the step it
chose), against the jitted JAX reference, on the CPU.

The plain version (``score_round_plain``, what the wrapper runs on CPU
tensors) is held against the reference's round code
(volcano_tpu/ops/rounds.py:708-723: the lax.cond between
``_refresh_scores`` and ``_rescore_dirty`` on n_dirty > dirty_k, then the
sum of scores > -inf), on numpy-seeded inputs whose carried scores were
computed from the state the clean columns still hold. Tolerance: exact
equality, bit for bit (scores by their bits, -inf included; counts
exact), in float64 and in float32 (the reference then runs without x64,
as a float32 solve runs). tests/test_torch_rounds_gpu.py holds the kernel
against this plain version on the card.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from volcano_tpu.ops import kernels as jkernels
from volcano_tpu.ops import rounds as jrounds
from volcano_tpu.ops import solver as jsolver

from tests.test_torch_kernels import _score_inputs, _spec
from tests.test_torch_rounds import assert_same, encoded_arrays, port_spec, run_both
from volcano_tpu_torch.ops import kernels as tkernels
from volcano_tpu_torch.ops import rounds as trounds
from volcano_tpu_torch.ops import solver as tsolver


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


K, N, DIRTY_K = 12, 50, 8
DTYPES = {"float64": (np.float64, torch.float64), "float32": (np.float32, torch.float32)}
FLAGS = {
    "binpack-nodeorder-pods": dict(use_binpack=True, use_nodeorder=True,
                                   check_pod_count=True),
    # cfg6's shape: binpack, anti-affinity exclusion groups, the pod check
    "cfg6-exclusion": dict(use_binpack=True, use_exclusion=True, check_pod_count=True),
    "nodeorder-exclusion": dict(use_nodeorder=True, use_exclusion=True),
}


def _x64(dt):
    return contextlib.nullcontext() if dt == "float64" else jax.enable_x64(False)


@functools.lru_cache(maxsize=None)
def _reference(jspec):
    """The reference round's scoring, jitted as solve_rounds runs it."""

    def fn(enc, idle, used, cnt, occ, scores, dirty):
        neg = jnp.array(-jnp.inf, idle.dtype)
        if jspec.dirty_k > 0:
            n_dirty = jnp.sum(dirty.astype(jnp.int32))
            scores = lax.cond(
                n_dirty > jnp.int32(jspec.dirty_k),
                lambda _: jrounds._refresh_scores(jspec, enc, idle, used, cnt, occ),
                lambda _: jrounds._rescore_dirty(jspec, enc, idle, used, cnt, occ,
                                                 scores, dirty),
                None)
        else:
            scores = jrounds._refresh_scores(jspec, enc, idle, used, cnt, occ)
        return scores, jnp.sum((scores > neg).astype(jnp.int32), axis=-1)

    return jax.jit(fn)


def _moved(st, cols, rng):
    """The state after a commit or rollback that touched ``cols``: their
    idle, used, pod count and exclusion occupancy changed (some of them
    by nothing, as a touched column may end where it was)."""
    out = {k: v.copy() for k, v in st.items()}
    for c in cols:
        if rng.random() < 0.2:
            continue
        delta = np.floor(out["idle"][c] * rng.random(3) / 3.0)
        out["idle"][c] -= delta
        out["used"][c] += delta
        out["cnt"][c] += 1
        out["occ"][:, c] = rng.random(out["occ"].shape[0]) < 0.5
    return out


# (name, dirty_k, how the dirty set is drawn, the first round after the head)
CASES = [
    ("n_dirty-0", DIRTY_K, "none", False),
    ("below-col0-clean", DIRTY_K, "below", False),
    ("below-col0-dirty", DIRTY_K, "below0", False),
    ("at-budget", DIRTY_K, "at", False),
    ("above-budget", DIRTY_K, "above", False),
    ("no-dirty-path", 0, "below0", False),
    ("head-full", DIRTY_K, "all", True),
    ("head-dirty-covers-all", 2 * N, "all", True),
]


def _dirty_set(how, rng):
    if how == "none":
        return np.zeros(0, np.int64)
    if how == "all":
        return np.arange(N)
    size = {"below": DIRTY_K - 3, "below0": DIRTY_K - 3, "at": DIRTY_K,
            "above": DIRTY_K + 1}[how]
    cols = rng.choice(np.arange(1, N), size, replace=False)
    if how == "below0":
        cols[0] = 0
    return np.sort(cols)


def round_inputs(seed, flags, dirty_k, how, first, dt):
    """(enc, state, carried scores, dirty mask) of one round: the scores
    the previous round left (a full refresh on the state before the touch;
    zero after the head), the state after it touched the dirty columns."""
    npt = DTYPES[dt][0]
    enc, st0 = _score_inputs(seed, k=K, n=N)
    rng = np.random.default_rng(seed + 1000)
    cols = _dirty_set(how, rng)
    jspec = _spec(jkernels, **flags)._replace(dirty_k=dirty_k)
    enc = {k: (v.astype(npt) if np.asarray(v).dtype.kind == "f" else v)
           for k, v in enc.items()}
    st0 = {k: (v.astype(npt) if v.dtype.kind == "f" else v) for k, v in st0.items()}
    if first:
        scores = np.zeros((K, N), npt)
        st = st0
    else:
        with _x64(dt):
            full = jspec._replace(dirty_k=0)
            scores = np.array(_reference(full)(
                {k: jnp.asarray(v) for k, v in enc.items()},
                *(jnp.asarray(st0[k]) for k in ("idle", "used", "cnt", "occ")),
                jnp.zeros((K, N), npt), jnp.zeros(N, bool))[0])
        st = _moved(st0, cols, rng)
    dirty = np.zeros(N, bool)
    dirty[cols] = True
    return jspec, enc, st, scores, dirty


def _bits(a):
    return a.view(np.int64 if a.dtype == np.float64 else np.int32)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("flags", sorted(FLAGS))
@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_score_round_plain_equals_the_reference_round(case, flags, dt):
    _, dirty_k, how, first = next(c for c in CASES if c[0] == case)
    jspec, enc, st, scores, dirty = round_inputs(3, FLAGS[flags], dirty_k, how, first, dt)
    with _x64(dt):
        ref_s, ref_n = _reference(jspec)(
            {k: jnp.asarray(v) for k, v in enc.items()},
            *(jnp.asarray(st[k]) for k in ("idle", "used", "cnt", "occ")),
            jnp.asarray(scores), jnp.asarray(dirty))
        ref_s, ref_n = np.asarray(ref_s), np.asarray(ref_n)
    tdt = DTYPES[dt][1]
    te = {k: torch.from_numpy(np.ascontiguousarray(np.asarray(v))) for k, v in enc.items()}
    ts = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    got_s = torch.from_numpy(scores.copy())
    n_feas = torch.full((K,), -7, dtype=torch.int32)
    n_dirty = torch.tensor(int(dirty.sum()), dtype=torch.int32)
    out = tkernels.score_round(
        port_spec(jspec), te, ts["idle"], ts["used"], ts["cnt"], ts["occ"], got_s,
        torch.from_numpy(dirty), n_dirty, n_feas)
    assert out is n_feas and got_s.dtype == tdt
    np.testing.assert_array_equal(_bits(got_s.numpy()), _bits(ref_s))
    np.testing.assert_array_equal(n_feas.numpy(), ref_n.astype(np.int32))
    # the case exercises what it names
    full = tkernels.round_is_full(port_spec(jspec), int(dirty.sum()))
    assert full == (dirty_k == 0 or int(dirty.sum()) > dirty_k)
    assert np.isneginf(ref_s).any() and np.isfinite(ref_s).any()
    if not full and not first:
        clean = ~dirty
        np.testing.assert_array_equal(_bits(got_s.numpy()[:, clean]),
                                      _bits(scores[:, clean]))


def test_score_round_plain_counts_carried_columns_as_they_are():
    """On a dirty round the clean columns are counted from the carried
    scores: a clean column carried at -inf stays infeasible, one carried
    at 0 (the head's zero) counts."""
    jspec, enc, st, scores, dirty = round_inputs(5, FLAGS["cfg6-exclusion"], DIRTY_K,
                                                 "below", False, "float64")
    scores[:, ~dirty] = 0.0
    scores[0, ~dirty] = -np.inf
    te = {k: torch.from_numpy(np.ascontiguousarray(np.asarray(v))) for k, v in enc.items()}
    ts = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    got = torch.from_numpy(scores.copy())
    n_feas = torch.zeros(K, dtype=torch.int32)
    tkernels.score_round(port_spec(jspec), te, ts["idle"], ts["used"], ts["cnt"],
                         ts["occ"], got, torch.from_numpy(dirty),
                         torch.tensor(int(dirty.sum()), dtype=torch.int32), n_feas)
    fresh = (got.numpy()[:, dirty] > -np.inf).sum(axis=1)
    assert n_feas[0] == fresh[0]
    assert (n_feas[1:].numpy() == fresh[1:] + int((~dirty).sum())).all()


def run_graph_layout(spec, enc):
    """The machine as the solve graph runs it, driven on the CPU: the head
    without a decision, then passes of the WHILE body (K7a, then the step
    it chose) until K7a chooses none. Returns (raw, packed, passes)."""
    m = trounds.StepMachine(spec, enc, "cpu")
    m.head(control=False)
    passes = 0
    while True:
        m.loop_body()
        passes += 1
        if m.done():
            break
    raw, packed = m.finish()
    assert passes == int(m.ctl[trounds.RK.C_STEPS]) + 1
    return raw, packed, passes


@pytest.mark.parametrize("capped", [False, True], ids=["uncapped", "capped"])
@pytest.mark.parametrize("cfg,scale", [(2, 0.04), (6, 0.06)], ids=["cfg2", "cfg6"])
def test_graph_layout_machine_equals_the_reference(cfg, scale, capped):
    """K7a first in the loop body, then the step's body (the graph's
    layout), with the windowed round's dirty-column rescoring: the jitted
    JAX solve_rounds' result, bit for bit, as the host order gives it."""
    arrays, jspec = encoded_arrays(cfg, scale)
    n = arrays["node_idle"].shape[0]
    wf = jsolver._window_fields(arrays)
    jspec = jspec._replace(window_k=wf["window_k"] or max(1, n // 4),
                           dirty_k=wf["dirty_k"] or max(1, n // 2))
    if capped:
        jspec = jspec._replace(round_min_progress=40, straggler_rounds=2)
    raw_j, raw_t, packed_j, packed_t = run_both(arrays, jspec)
    assert_same(raw_j, raw_t, packed_j, packed_t)
    enc = tsolver.from_numpy_encoded(arrays, device="cpu", dtype=torch.float64)
    raw_g, packed_g, passes = run_graph_layout(port_spec(jspec), enc)
    assert_same(raw_j, raw_g, packed_j, packed_g.numpy())
    assert passes > int(raw_g[1])


def _struct_fields(source, struct):
    """The field names of ``struct`` in csrc/``source``, in order (comments
    dropped)."""
    import os
    import re

    path = os.path.join(os.path.dirname(tkernels.__file__), "..", "csrc", source)
    with open(path) as fh:
        text = fh.read()
    body = text[text.index(f"struct {struct} {{"):]
    body = re.sub(r"//[^\n]*", "", body[:body.index("};")].split("{", 1)[1])
    for word in ("const", "void", "int32_t", "unsigned long long", "int"):
        body = body.replace(word, " ")
    return re.findall(r"(\w+)\s*[,;]", body.replace("*", " "))


def test_argument_blocks_match_the_cuda_structs():
    """K1's ctypes argument block names csrc/score_block.cu's ScoreArgs
    fields in order, and K7a's graph block csrc/rounds_ctl.cu's GraphCtl;
    the hit counters K7a bumps are the graph's bodies in BODIES' order."""
    from volcano_tpu_torch.ops import rounds_kernels as RK

    assert _struct_fields("score_block.cu", "ScoreArgs") == [
        name for name, _ in tkernels._ScoreArgs._fields_]
    assert _struct_fields("rounds_ctl.cu", "GraphCtl") == [
        name for name, _ in RK._GraphCtl._fields_]
    assert [trounds.BODIES.index(b) for b in ("step", "round", "cover", "rollback", "tail")] \
        == [RK.H_STEP, RK.H_ROUND, RK.H_COVER, RK.H_ROLLBACK, RK.H_TAIL]
