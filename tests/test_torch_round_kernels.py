"""The round's select (K3 ``round_select``, with K6's in-class and
exclusion-group ranks and the window's coverage test), its commit and the
rollback's undo (K7c ``round_commit``, ``round_rollback``): the port's
plain versions against the jitted JAX reference, bit for bit.

Select: the JAX package's ``_rank_in_class``, ``_excl_grank`` and
``_select`` under ``jax.jit`` (the class-liveness scatter and the coverage
test written as ``round_body`` writes them, volcano_tpu/ops/rounds.py
:733-786); commit: ``round_body``'s scatter-adds and updates
(:838-870); rollback: ``rollback``'s (:895-921); all jitted. Inputs:
every select, commit and rollback call of the port's own solves of cfg2
(binpack, a GPU scalar dimension), cfg3 (ten queues), cfg5 (the window
and the full-width cover) and cfg6 (exclusion groups, and a capped run
with straggler rounds) at small scale, of the contended cluster of
tests/test_torch_rounds.py (rollbacks that retire gangs), and the crafted
cases of volcano_tpu_torch/bench/round_cases.py. Float64 on the CPU;
tolerance: exact equality of every output (the commit's float state
by its bits: -0.0 is not +0.0).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volcano_tpu.ops import kernels as jkernels
from volcano_tpu.ops import rounds as jrounds
from volcano_tpu.ops import solver as jsolver

from tests.test_torch_rounds import encoded_arrays, port_spec
from volcano_tpu_torch.bench import round_cases as RC
from volcano_tpu_torch.ops import rounds_kernels as RK
from volcano_tpu_torch.ops import solver as tsolver


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return jnp.asarray(x.numpy())


# -- the JAX reference ---------------------------------------------------------

@functools.lru_cache(maxsize=None)
def select_ref(jspec, coverage):
    def f(task_cls, active, n_feas, cls_excl, order, ccap, g_start, g_size,
          ccap_before):
        k_total = cls_excl.shape[0]
        enc = {"cls_excl": cls_excl}
        cls_live = jnp.zeros(k_total, bool).at[task_cls].max(active)
        grank = jrounds._excl_grank(enc, cls_live) if jspec.use_exclusion else None
        rank = jrounds._rank_in_class(task_cls, active)
        out = jrounds._select(jspec, enc, task_cls, active, rank, n_feas, grank,
                              order, ccap, g_start, g_size, ccap_before)
        if not coverage:
            return out
        _, _, slot_w, final_w = out
        k_eff = order.shape[1]
        all_in = n_feas <= k_eff
        if jspec.use_binpack and not jspec.use_exclusion:
            safe_end = jnp.full(k_total, k_eff, jnp.int32)
        elif jspec.use_binpack:
            safe_end = jnp.where(cls_excl >= 0, g_start[:, k_eff - 1],
                                 jnp.int32(k_eff))
        else:
            safe_end = g_start[:, k_eff - 1]
        safe_end = jnp.where(all_in, jnp.int32(k_eff), safe_end)
        exact = all_in[task_cls] | (
            (slot_w < safe_end[task_cls]) & (final_w < safe_end[task_cls]))
        uncovered = jnp.zeros(k_total, bool).at[task_cls].max(active & ~exact)
        return out + (uncovered,)
    return jax.jit(f)


@functools.lru_cache(maxsize=None)
def commit_ref(use_exclusion):
    def f(st, choice, accept, task_req, task_job, task_queue, task_ns, task_excl):
        node = jnp.clip(choice, 0, st["idle"].shape[0] - 1)
        dreq = jnp.where(accept[:, None], task_req, 0.0).astype(st["idle"].dtype)
        acc = accept.astype(jnp.int32)
        out = dict(
            idle=st["idle"].at[node].add(-dreq), used=st["used"].at[node].add(dreq),
            cnt=st["cnt"].at[node].add(acc),
            assign=jnp.where(accept, choice, st["assign"]),
            active=st["active"] & ~accept,
            job_placed=st["job_placed"].at[task_job].add(acc),
            job_alloc=st["job_alloc"].at[task_job].add(dreq),
            queue_alloc=st["queue_alloc"].at[task_queue].add(dreq),
            ns_alloc=st["ns_alloc"].at[task_ns].add(dreq),
            dirty=jnp.zeros_like(st["dirty"]).at[node].max(accept))
        if use_exclusion:
            out["excl_occ"] = st["excl_occ"].at[jnp.maximum(task_excl, 0), node].max(
                accept & (task_excl >= 0))
        counters = jnp.stack([jnp.sum(acc), jnp.sum(out["active"].astype(jnp.int32)),
                              jnp.sum(out["dirty"].astype(jnp.int32))])
        return out, counters
    return jax.jit(f)


@functools.lru_cache(maxsize=None)
def rollback_ref(use_exclusion):
    def f(st, roll_job, task_req, task_job, task_queue, task_ns, task_excl):
        roll = roll_job[task_job] & (st["assign"] >= 0)
        node = jnp.clip(st["assign"], 0, st["idle"].shape[0] - 1)
        dreq = jnp.where(roll[:, None], task_req, 0.0).astype(st["idle"].dtype)
        dead_task = roll_job[task_job]
        out = dict(
            idle=st["idle"].at[node].add(dreq), used=st["used"].at[node].add(-dreq),
            cnt=st["cnt"].at[node].add(-roll.astype(jnp.int32)),
            assign=jnp.where(roll, -1, st["assign"]),
            active=st["active"] & ~dead_task,
            job_placed=jnp.where(roll_job, 0, st["job_placed"]),
            job_alloc=st["job_alloc"].at[task_job].add(-dreq),
            queue_alloc=st["queue_alloc"].at[task_queue].add(-dreq),
            ns_alloc=st["ns_alloc"].at[task_ns].add(-dreq),
            dirty=st["dirty"] | jnp.zeros_like(st["dirty"]).at[node].max(roll))
        if use_exclusion:
            out["excl_occ"] = st["excl_occ"].at[jnp.maximum(task_excl, 0), node].min(
                ~(roll & (task_excl >= 0)))
        counters = jnp.stack([jnp.sum(out["active"].astype(jnp.int32)),
                              jnp.sum(out["dirty"].astype(jnp.int32))])
        return out, counters
    return jax.jit(f)


def jspec_of(spec):
    return jkernels.SolveSpec(**spec._asdict())


def check_select(args, kw, what):
    spec, corder, active, n_feas, order, walk = args
    got = RK.round_select_plain(*args, **kw)
    coverage = kw.get("coverage", False)
    want = select_ref(jspec_of(spec), coverage)(
        _np(corder["task_cls"]), _np(active), _np(n_feas), _np(corder["cls_excl"]),
        _np(order), *(_np(w) for w in walk))
    names = ("choice", "cons_choice", "slot", "final", "uncovered")
    assert (got[4] is None) == (not coverage)
    for name, a, b in zip(names, got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{what} {name}")


STATE = ("idle", "used", "cnt", "assign", "active", "job_placed", "job_alloc",
         "queue_alloc", "ns_alloc", "dirty")


def assert_same_bits(got, want, what):
    """Equal, with the sign of a float zero told apart."""
    np.testing.assert_array_equal(got, want, err_msg=what)
    if np.issubdtype(got.dtype, np.floating):
        np.testing.assert_array_equal(np.signbit(got), np.signbit(want),
                                      err_msg=f"{what}: signs of zero")


def check_commit(args, what):
    spec, tc, st, choice, accept, did_full, ctl = args
    names = STATE + (("excl_occ",) if spec.use_exclusion else ())
    jst = {k: _np(st[k]) for k in names}
    want, counters = commit_ref(bool(spec.use_exclusion))(
        jst, _np(choice), _np(accept), _np(tc["task_req"]), _np(tc["task_job"]),
        _np(tc["task_queue"]), _np(tc["task_ns"]), _np(tc["task_excl"]))
    st_p, ctl_p = RC._clone(st), ctl.clone()
    RK.round_commit_plain(spec, tc, st_p, choice, accept, did_full, ctl_p)
    for k in names:
        assert_same_bits(st_p[k].numpy(), np.asarray(want[k]), f"{what} {k}")
    np.testing.assert_array_equal(
        ctl_p[RK.C_PLACED:RK.C_NDIRTY_NEXT + 1].numpy(), np.asarray(counters))
    assert int(ctl_p[RK.C_DID_FULL]) == int(did_full)


def check_rollback(args, what):
    spec, tc, st, roll_job, any_cand, ctl = args
    names = STATE + (("excl_occ",) if spec.use_exclusion else ())
    jst = {k: _np(st[k]) for k in names}
    want, counters = rollback_ref(bool(spec.use_exclusion))(
        jst, _np(roll_job), _np(tc["task_req"]), _np(tc["task_job"]),
        _np(tc["task_queue"]), _np(tc["task_ns"]), _np(tc["task_excl"]))
    st_p, ctl_p = RC._clone(st), ctl.clone()
    RK.round_rollback_plain(spec, tc, st_p, roll_job, any_cand, ctl_p)
    for k in names:
        assert_same_bits(st_p[k].numpy(), np.asarray(want[k]), f"{what} {k}")
    np.testing.assert_array_equal(
        ctl_p[RK.C_STILL:RK.C_NDIRTY_NEXT + 1].numpy(), np.asarray(counters))
    assert int(ctl_p[RK.C_DID_FULL]) == 0
    assert int(ctl_p[RK.C_ANY_CAND]) == int(any_cand)


# -- the port's own solves ------------------------------------------------------

# (cfg, scale, how the solve runs): "window" with the candidate window (a
# narrow one where the solver would sweep the full width at this size, so
# that the cover runs too), "full" without, "capped" with a progress floor
# above most rounds' yield (straggler rounds)
SOLVES = ((2, 0.04, "window"), (3, 0.02, "window"), (5, 0.01, "window"),
          (5, 0.01, "full"), (6, 0.06, "window"), (6, 0.06, "capped"))


@functools.lru_cache(maxsize=None)
def recorded(cfg, scale, how):
    arrays, jspec = encoded_arrays(cfg, scale)
    if how == "window":
        wf = jsolver._window_fields(arrays)
        if wf["window_k"] == 0:
            n = arrays["node_idle"].shape[0]
            wf = {"window_k": max(1, n // 4), "dirty_k": max(1, n // 2)}
        jspec = jspec._replace(**wf)
    elif how == "full":
        jspec = jspec._replace(window_k=0, dirty_k=0)
    else:
        jspec = jspec._replace(round_min_progress=40, straggler_rounds=2,
                               window_k=0, dirty_k=0)
    enc = tsolver.from_numpy_encoded(arrays, device="cpu", dtype=torch.float64)
    return RC.record_solve(port_spec(jspec), enc, limit=12)


IDS = [f"cfg{c}-{h}" for c, _, h in SOLVES]


@pytest.mark.parametrize("case", SOLVES, ids=IDS)
def test_select_plain_matches_reference_on_recorded_rounds(case):
    seen = recorded(*case)
    assert seen["select"]
    for i, (args, kw) in enumerate(seen["select"]):
        check_select(args, kw, f"{case} call {i}")
    if case[2] == "window" and case[0] == 5:
        assert any(not kw.get("coverage") for _, kw in seen["select"]), \
            "the windowed cfg5 solve must run the cover"


@pytest.mark.parametrize("case", SOLVES, ids=IDS)
def test_commit_plain_matches_reference_on_recorded_rounds(case):
    seen = recorded(*case)
    assert seen["commit"]
    for i, (args, _) in enumerate(seen["commit"]):
        check_commit(args, f"{case} call {i}")


# the solves with a rollback step (the capped run exits without one): most
# find no candidate; the contended cluster retires gangs
ROLLBACK_SOLVES = tuple(c for c in SOLVES if c[2] != "capped") + (
    ("contended", 0, "window"), ("contended", 0, "full"))


@pytest.mark.parametrize("case", ROLLBACK_SOLVES,
                         ids=[f"cfg{c}-{h}" if c != "contended" else f"contended-{h}"
                              for c, _, h in ROLLBACK_SOLVES])
def test_rollback_plain_matches_reference_on_recorded_steps(case):
    if case[0] == "contended":
        from tests.test_torch_rounds import contended_arrays

        arrays, jspec = contended_arrays()
        w = 8 if case[2] == "window" else 0
        jspec = jspec._replace(window_k=w, dirty_k=16 if w else 0)
        enc = tsolver.from_numpy_encoded(arrays, device="cpu", dtype=torch.float64)
        seen = RC.record_solve(port_spec(jspec), enc, limit=12)
        assert any(bool(a[3].any()) for a, _ in seen["rollback"]), \
            "the contended solve must retire a gang"
    else:
        seen = recorded(*case)
    assert seen["rollback"]
    for i, (args, _) in enumerate(seen["rollback"]):
        check_rollback(args, f"{case} call {i}")


@pytest.mark.parametrize("label", [c[0] for c in RC.COMMIT_CASES] + ["no-candidate"])
def test_rollback_plain_matches_reference_on_crafted_inputs(label):
    cases = dict(RC.rollback_cases())
    check_rollback(cases[label if label != "no-candidate" else "random-no-candidate"], label)


@pytest.mark.parametrize("label", [c[0] for c in RC.SELECT_CASES])
def test_select_plain_matches_reference_on_crafted_inputs(label):
    args, kw = RC.select_case(**dict(RC.SELECT_CASES)[label])
    check_select(args, kw, label)


@pytest.mark.parametrize("label", [c[0] for c in RC.COMMIT_CASES])
def test_commit_plain_matches_reference_on_crafted_inputs(label):
    check_commit(RC.commit_case(**dict(RC.COMMIT_CASES)[label]), label)


def test_class_order_is_computed_once_a_solve(monkeypatch):
    """The head sorts the tasks by class once; every round reuses it."""
    from volcano_tpu_torch.ops import rounds as trounds

    calls = []
    real = RK.class_order
    monkeypatch.setattr(RK, "class_order", lambda *a: calls.append(1) or real(*a))
    arrays, jspec = encoded_arrays(2, 0.04)
    enc = tsolver.from_numpy_encoded(arrays, device="cpu", dtype=torch.float64)
    raw = trounds.solve_rounds(port_spec(jspec._replace(window_k=0, dirty_k=0)), enc)
    assert int(raw[1]) > 1 and len(calls) == 1
