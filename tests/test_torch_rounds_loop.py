"""K7, the rounds solve's loop, as the port runs it: the flat step machine
(volcano_tpu_torch/ops/rounds.py StepMachine), its controller K7a
(``rounds_ctl_plain``), its tail pass K7b (``tail_pass_plain``) and the
graph cache (ops/rounds_graph.py), against the jitted JAX reference.

Everything on the CPU in float64 (the plain versions). Tolerance: exact
equality of assign, round count, tail_placed, full-sweep count, capped
flag, placed-per-round histogram, touched-node mask and the packed result.
tests/test_torch_rounds_gpu.py holds K7a, K7b and the graph replay against
the plain versions on a card.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from volcano_tpu.ops import solver as jsolver

from tests.test_torch_rounds_gpu import prepared
from tests.test_torch_rounds import (
    CASES as ROUNDS_CASES,
    assert_same,
    contended_arrays,
    encoded_arrays,
    port_spec,
    run_both,
)
from volcano_tpu_torch.ops import kernels as tkernels
from volcano_tpu_torch.ops import rounds as trounds
from volcano_tpu_torch.ops import rounds_graph
from volcano_tpu_torch.ops import rounds_kernels as RK
from volcano_tpu_torch.ops import solver as tsolver


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def capped_case():
    """cfg6 with a progress floor above most rounds' yield: it caps, runs
    straggler rounds and places tasks in the tail pass."""
    arrays, jspec = encoded_arrays(6, 0.06)
    return arrays, jspec._replace(round_min_progress=40, straggler_rounds=2,
                                  window_k=0, dirty_k=0)


def windowed_case():
    arrays, jspec = contended_arrays()
    return arrays, jspec._replace(window_k=8, dirty_k=16)


CASES = {"capped": capped_case, "windowed": windowed_case}


@functools.lru_cache(maxsize=None)
def reference(case):
    """(arrays, JAX spec, run_both's result) of a case, computed once."""
    arrays, jspec = CASES[case]()
    return arrays, jspec, run_both(arrays, jspec)


def staged(arrays):
    return tsolver.from_numpy_encoded(arrays, device="cpu", dtype=torch.float64)


def run_chunked(spec, enc, chunk: int):
    """The machine in chunks of ``chunk`` gated steps, the result packed
    after every chunk, continued while a step is pending (what a graph of
    ``chunk`` steps replayed until the packed result says done would do).
    Returns (raw, packed, continuations, steps run)."""
    m = trounds.StepMachine(spec, enc, "cpu")
    m.head()
    continuations = 0
    while True:
        for _ in range(chunk):
            m.step()
        raw, packed = m.finish()
        if m.done():
            return raw, packed, continuations, int(m.ctl[RK.C_STEPS])
        continuations += 1


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("chunk", [1, 3, 64])
def test_chunked_machine_equals_unchunked_and_reference(case, chunk):
    arrays, jspec, (raw_j, raw_t, packed_j, packed_t) = reference(case)
    assert_same(raw_j, raw_t, packed_j, packed_t)
    raw_c, packed_c, conts, steps = run_chunked(port_spec(jspec), staged(arrays),
                                                chunk)
    assert_same(raw_j, raw_c, packed_j, packed_c.numpy())
    assert torch.equal(packed_c, torch.from_numpy(packed_t))
    # a continuation after every chunk that ended before the last step
    assert steps > int(raw_t[1])
    assert conts == -(-steps // chunk) - 1


@pytest.mark.parametrize("windowed", [True, False], ids=["window", "full"])
@pytest.mark.parametrize("cfg,scale", ROUNDS_CASES,
                         ids=[f"cfg{c}" for c, _ in ROUNDS_CASES])
def test_chunked_machine_on_every_rounds_case(cfg, scale, windowed):
    """tests/test_torch_rounds.py's cases, the machine run in chunks of 3
    steps with continuations: JAX's result, bit for bit."""
    arrays, jspec = encoded_arrays(cfg, scale)
    if windowed:
        n = arrays["node_idle"].shape[0]
        wf = jsolver._window_fields(arrays)
        jspec = jspec._replace(window_k=wf["window_k"] or max(1, n // 4),
                               dirty_k=wf["dirty_k"] or max(1, n // 2))
    else:
        jspec = jspec._replace(window_k=0, dirty_k=0)
    raw_j, _, packed_j, _ = run_both(arrays, jspec)
    raw_c, packed_c, _, _ = run_chunked(port_spec(jspec), staged(arrays), 3)
    assert_same(raw_j, raw_c, packed_j, packed_c.numpy())


def test_a_finished_machine_steps_as_a_no_op():
    arrays, jspec = capped_case()
    m = trounds.StepMachine(port_spec(jspec), staged(arrays), "cpu")
    m.run()
    ctl = m.ctl.clone()
    st = {k: v.clone() for k, v in m.st.items()}
    m.step()
    assert torch.equal(m.ctl, ctl)
    assert all(torch.equal(m.st[k], st[k]) for k in st)


def record_steps(spec, enc):
    """Run the machine, recording each step's kind and the counters it
    handed the controller."""
    m = trounds.StepMachine(spec, enc, "cpu")
    m.head()
    remaining0 = int(m.ctl[RK.C_REMAINING])
    steps = []
    while not m.done():
        kind, cons = int(m.ctl[RK.C_LAST]), bool(m.ctl[RK.C_CONS])
        m.step()
        counters = m.ctl[RK.C_PLACED:RK.C_ANY_CAND + 1].tolist()
        steps.append((kind, cons, counters))
    return remaining0, steps, m


def nested_loops(remaining, steps, params):
    """The reference's loop nest (volcano_tpu/ops/rounds.py:925-975 and the
    lax.cond at :1101) written as nested host loops, fed the recorded
    counters in order: the sequence of steps it takes and its round count,
    histogram, full sweeps and capped flag."""
    budget, rmp, sr = params[:3]
    feed = iter(c for _, _, c in steps)
    seq, hist = [], [0] * RK.PROF_SLOTS
    rounds, progress, tried, dead, capped, full = 0, True, False, False, False, 0

    def round_body(kind):
        nonlocal rounds, progress, tried, capped, full, remaining
        cons = not progress
        seq.append((kind, cons))
        placed, still, _, did_full, _ = next(feed)
        if rmp > 1 and 0 < placed < rmp and 0 < still <= 8 * rmp:
            capped = True
        hist[min(rounds, RK.PROF_SLOTS - 1)] += placed
        rounds += 1
        progress = placed > 0
        tried = cons and not progress
        full += did_full
        remaining = still

    while not dead and rounds < budget:
        while (progress or not tried) and remaining > 0 and rounds < budget \
                and not capped:
            round_body(RK.ST_ROUND)
        if capped:
            dead = True
        else:
            seq.append((RK.ST_ROLLBACK, False))
            still, _, _, any_cand = next(feed)[1:]
            progress, dead, remaining = True, not any_cand, still
        tried = False
    if rmp > 1 and sr > 0:
        extra, progress = 0, True
        while capped and progress and remaining > 0 and extra < sr \
                and rounds < budget:
            round_body(RK.ST_STRAG)
            extra += 1
    if rmp > 1 and capped:
        seq.append((RK.ST_TAIL, False))
    return seq, rounds, hist, full, capped


@pytest.mark.parametrize("case", sorted(CASES))
def test_controller_fed_recorded_counters_reproduces_the_loop(case):
    """rounds_ctl_plain alone, fed the counters a recorded solve's steps
    produced, takes the reference loop nest's sequence of rounds,
    rollbacks, straggler rounds and tail, and ends on JAX's round count,
    histogram, full sweeps and capped flag."""
    arrays, jspec, (raw_j, _, _, _) = reference(case)
    spec, enc = port_spec(jspec), staged(arrays)
    remaining, steps, _ = record_steps(spec, enc)
    params = RK.ctl_params(spec, enc["task_cls"].shape[0],
                           enc["job_tie_rank"].shape[0],
                           enc["node_idle"].shape[0])
    ctl = torch.zeros(RK.CTL_LEN, dtype=torch.int32)
    pred = torch.zeros(RK.NPRED, dtype=torch.bool)
    ctl[RK.C_REMAINING] = remaining
    p = RK.rounds_ctl_plain(ctl, pred, params)
    seq = []
    for _, _, counters in steps:
        assert p[RK.P_ACTIVE]
        seq.append((int(ctl[RK.C_LAST]), bool(ctl[RK.C_CONS])))
        ctl[RK.C_PLACED:RK.C_ANY_CAND + 1] = torch.tensor(counters)
        p = RK.rounds_ctl_plain(ctl, pred, params)
    assert p[RK.P_DONE] and not p[RK.P_ACTIVE] and not int(ctl[RK.C_ERR])
    want_seq, rounds, hist, full, capped = nested_loops(remaining, steps, params)
    assert seq == want_seq
    kinds = {k for k, _ in seq}
    # the contended case retires gangs; the capped exit is terminal (no
    # rollback) and hands its remainder to the stragglers and the tail
    assert ({RK.ST_STRAG, RK.ST_TAIL} <= kinds if case == "capped"
            else RK.ST_ROLLBACK in kinds)
    assert int(ctl[RK.C_ROUNDS]) == rounds == int(raw_j[1])
    assert ctl[RK.C_HIST:].tolist() == hist == np.asarray(raw_j[5]).tolist()
    assert int(ctl[RK.C_FULL_SWEEPS]) == full == int(raw_j[3])
    assert bool(ctl[RK.C_CAPPED]) == capped == bool(raw_j[4])


def test_controller_step_cap_stops_the_machine():
    params = (10, 0, 0, 0, 4, 3)
    ctl = torch.zeros(RK.CTL_LEN, dtype=torch.int32)
    pred = torch.zeros(RK.NPRED, dtype=torch.bool)
    ctl[RK.C_REMAINING] = 5
    RK.rounds_ctl_plain(ctl, pred, params)
    for _ in range(3):
        assert bool(pred[RK.P_ROUND])
        ctl[RK.C_PLACED:RK.C_ANY_CAND + 1] = torch.tensor([1, 5, 1, 1, 0])
        RK.rounds_ctl_plain(ctl, pred, params)
    assert int(ctl[RK.C_ERR]) == 1 and bool(pred[RK.P_DONE])
    assert int(ctl[RK.C_STEPS]) == 3


def test_tail_pass_plain_matches_reference_tail():
    """The capped case's tail, by the plain K7b inside the machine, gives
    JAX's tail (assign, tail_placed and the rest of the packed result)."""
    arrays, jspec, (raw_j, raw_t, packed_j, packed_t) = reference("capped")
    assert bool(raw_t[4]) and int(raw_t[2]) > 0
    assert_same(raw_j, raw_t, packed_j, packed_t)


def test_tail_row_is_the_class_row_of_score_block():
    """K7b scores one class row; the plain version's row is row c of the
    full K1 block, bit for bit, on the tail's own state."""
    arrays, jspec = capped_case()
    spec = port_spec(jspec)
    m = trounds.StepMachine(spec, staged(arrays), "cpu")
    seen = {}
    real = RK.tail_pass_plain

    def tail(spec, enc, st, ctl):
        seen.update(enc=enc, st={k: v.clone() for k, v in st.items()})
        return real(spec, enc, st, ctl)

    RK.tail_pass_plain = tail
    try:
        m.run()
    finally:
        RK.tail_pass_plain = real
    enc, st = seen["enc"], seen["st"]
    k_total, n_total = enc["cls_req"].shape[0], st["idle"].shape[0]
    block = torch.empty((k_total, n_total), dtype=torch.float64)
    tkernels.score_block(spec, enc, st["idle"], st["used"], st["cnt"],
                         st["excl_occ"], block)
    live = sorted(set(enc["task_cls"][st["active"]].tolist()))
    assert live
    for c in live[:8] + [0, k_total - 1]:
        row = RK.tail_row_plain(spec, enc, c, st["idle"], st["used"], st["cnt"],
                                st["excl_occ"])
        assert torch.equal(row.view(torch.int64), block[c].view(torch.int64)), c


def test_graph_key_is_stable_under_same_bucket_churn():
    """Sessions of one padded bucket share a graph; a padded extent that
    moves (here the task axis) keys a new one."""
    spec, enc = prepared(5, 0.01)
    spec2, enc2 = prepared(5, 0.01, extra_pods=3)
    assert enc2["task_cls"].shape == enc["task_cls"].shape
    assert not torch.equal(enc2["task_job"], enc["task_job"])
    assert rounds_graph.graph_key(spec, enc) == rounds_graph.graph_key(spec2, enc2)
    t_b = enc["task_cls"].shape[0]
    spec3, enc3 = prepared(5, 0.01, extra_pods=t_b)
    assert enc3["task_cls"].shape[0] > t_b
    assert rounds_graph.graph_key(spec, enc) != rounds_graph.graph_key(spec3, enc3)
    wide = dict(enc, node_idle=torch.zeros(enc["node_idle"].shape[0] * 2, 2,
                                           dtype=torch.float64))
    assert rounds_graph.graph_key(spec, enc) != rounds_graph.graph_key(spec, wide)
    f32 = dict(enc, cls_req=enc["cls_req"].to(torch.float32))
    assert rounds_graph.graph_key(spec, enc) != rounds_graph.graph_key(spec, f32)


def test_dispatch_on_the_cpu_is_the_packed_solve():
    """On the CPU the scheduler's dispatch binds nothing ahead and gives the
    packed solve's tensor, which the one fetch reads as it is."""
    from volcano_tpu_torch.utils import devprof

    spec, enc = prepared(5, 0.01)
    assert trounds.bind_packed(spec, enc) is None
    got = trounds.dispatch_packed(spec, enc)
    want = trounds.solve_rounds_packed(spec, enc)
    assert isinstance(got, torch.Tensor) and torch.equal(got, want)
    assert np.array_equal(devprof.fetch(got), want.numpy())
