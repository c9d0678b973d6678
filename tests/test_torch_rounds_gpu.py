"""K7 on a CUDA card: K1's round entry (``score_round``), K7a
(``rounds_ctl``, and the graph's layout around it), K7b (``tail_pass``), K3
(``round_select``, with K6's ranks), K2b (``cap_walk``), K6's job ranks
(``job_rank``), K4 (``resolve_prefix``), K5 (``queue_budget``) and K7c
(``round_commit``) against their plain versions, and the graph-replayed
solve against the host-driven step machine (``loop="host"``) and against
the CPU's solve of the same encode, on encodes the port's own session
prepares and on crafted inputs (volcano_tpu_torch/bench/round_cases.py).

This file imports nothing of JAX, so it runs where the card is:

    python -m pytest -m gpu --noconftest tests/test_torch_rounds_gpu.py

Without a card its tests skip. Tolerance: exact equality (torch.equal)
of every state tensor, the control vector, the predicates and the packed
result; K7c's and K1's float state by its bits (-0.0 is not +0.0). K7c's plain
version runs on CPU copies of the inputs, on one thread: its serial CPU
semantics (each row's float updates added one after another in task
order, to the row's value, as XLA's scatter adds them) are the ones the
kernel keeps.
"""

from __future__ import annotations

import pytest
import torch

from volcano_tpu_torch.bench import round_cases as RC
from volcano_tpu_torch.ops import kernels as tkernels
from volcano_tpu_torch.ops import rounds as trounds
from volcano_tpu_torch.ops import rounds_kernels as RK


def prepared(cfg, scale, extra_pods=0, device="cpu", dtype="float64"):
    """(spec, staged encode) of the allocate solve a port session of
    ``cfg`` prepares; ``extra_pods`` adds one job of that many small pods
    in an existing namespace and queue."""
    from volcano_tpu_torch.api import objects
    from volcano_tpu_torch.bench.clusters import CONFIGS, build_config, make_tiers
    from volcano_tpu_torch.scheduler.framework import close_session, open_session
    from volcano_tpu_torch.scheduler.util.test_utils import build_pod, build_pod_group
    import volcano_tpu_torch.scheduler.actions  # noqa: F401
    import volcano_tpu_torch.scheduler.plugins  # noqa: F401

    cache, *_ = build_config(cfg, scale)
    if extra_pods:
        ns = next(iter(cache.jobs.values())).namespace
        cache.add_pod_group(build_pod_group("churn", namespace=ns, min_member=1))
        for i in range(extra_pods):
            cache.add_pod(build_pod(ns, f"churn-{i}", "",
                                    objects.POD_PHASE_PENDING,
                                    {"cpu": "100m", "memory": "128Mi"}, "churn"))
    tiers = make_tiers(["tpuscore"], *CONFIGS[cfg].tiers, arguments={
        "tpuscore": {"tpuscore.mode": "rounds", "tpuscore.device": device,
                     "tpuscore.dtype": dtype}})
    ssn = open_session(cache, tiers)
    try:
        prep = ssn.batch_allocator._prepare(ssn)
    finally:
        close_session(ssn)
    return prep["spec"], prep["staged"]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels build and run only there)")


def _capped(dtype):
    """cfg6 with a progress floor above most rounds' yield: it caps, runs
    straggler rounds and the tail pass."""
    spec, enc = prepared(6, 0.3, device="cuda", dtype=dtype)
    return spec._replace(round_min_progress=40, straggler_rounds=2), enc


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_gpu_controller_and_tail_kernels_equal_plain(dtype):
    _cuda()
    spec, enc = _capped(dtype)
    m = trounds.StepMachine(spec, enc, "host")
    seen = {"ctl": []}
    real_tail, real_ctl = RK.tail_pass_plain, RK._ctl_fold_decide

    def tail(spec, enc, st, ctl):
        seen.update(enc=enc, st={k: v.clone() for k, v in st.items()},
                    c=ctl.clone())
        return real_tail(spec, enc, st, ctl)

    def ctl(c, params):
        seen["ctl"].append(list(c))
        return real_ctl(c, params)

    RK.tail_pass_plain, RK._ctl_fold_decide = tail, ctl
    try:
        m.run()
    finally:
        RK.tail_pass_plain, RK._ctl_fold_decide = real_tail, real_ctl
    assert "st" in seen, "the solve must reach the tail pass"
    st_k = {k: v.clone() for k, v in seen["st"].items()}
    ctl_k = seen["c"].clone()
    RK.tail_pass(spec, seen["enc"], st_k, ctl_k)
    st_p = {k: v.clone() for k, v in seen["st"].items()}
    ctl_p = seen["c"].clone()
    RK.tail_pass_plain(spec, seen["enc"], st_p, ctl_p)
    for k in st_k:
        assert torch.equal(st_k[k], st_p[k]), k
    assert torch.equal(ctl_k, ctl_p) and int(ctl_p[RK.C_TAIL_PLACED]) > 0
    for c in seen["ctl"]:
        got = torch.tensor(c, dtype=torch.int32, device="cuda")
        pred = torch.zeros(RK.NPRED, dtype=torch.bool, device="cuda")
        RK.rounds_ctl(got, pred, m.params)
        want = list(c)
        want_p = RK._ctl_fold_decide(want, m.params)
        assert got.tolist() == want and pred.tolist() == want_p


@pytest.mark.gpu
@pytest.mark.parametrize("cfg,scale,capped", [(2, 0.2, False), (6, 0.3, True)])
def test_gpu_graph_replay_equals_host_loop(cfg, scale, capped):
    """The graph solve (K7a first in each pass of its WHILE body, setting
    the step kinds' IF nodes) equals the host-driven machine, and runs
    K7a once a pass (the host run's controller calls) and K1 once a
    round."""
    from volcano_tpu_torch import device as devmod
    from volcano_tpu_torch.utils import devprof

    _cuda()
    spec, enc = prepared(cfg, scale, device="cuda", dtype="float32")
    if capped:
        spec = spec._replace(round_min_progress=40, straggler_rounds=2)
    calls = []
    real = RK._ctl_fold_decide
    RK._ctl_fold_decide = lambda c, params: calls.append(1) or real(c, params)
    try:
        raw_h, host = trounds.solve(spec, enc, loop="host")
    finally:
        RK._ctl_fold_decide = real
    for warm in (False, True):
        # the first solve captures the graph (its eager pass launches too)
        devmod.reset_launches()
        got = trounds.solve_rounds_packed(spec, enc)
        devprof.fetch(got)
        assert torch.equal(got, host)
        launches = devmod.launches()
        if warm:
            assert launches["rounds_ctl"] == len(calls)
            assert launches["score_round"] == int(raw_h[1])
            assert launches["score_block"] == 0


def _to(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_to(v, device) for v in x)
    return x


def assert_select_equal(args, kw, what):
    got = RK.round_select(*args, **kw)
    want = RK.round_select_plain(*args, **kw)
    names = ("choice", "cons_choice", "slot", "final", "uncovered")
    for name, a, b in zip(names, got, want):
        if b is None:
            assert a is None, (what, name)
            continue
        assert torch.equal(a, b), (what, name, int((a != b).sum()))


def assert_commit_equal(args, what, rollback=False):
    """K7c (the commit, or with ``rollback`` the rollback's undo) on the
    card against its plain version on CPU copies of the inputs."""
    spec, tc, st, *rest, ctl = args
    kernel, plain = ((RK.round_rollback, RK.round_rollback_plain) if rollback
                     else (RK.round_commit, RK.round_commit_plain))
    st_k, ctl_k = RC._clone(st), ctl.clone()
    kernel(spec, tc, st_k, *rest, ctl_k)
    tc_p, st_p, rest_p, ctl_p = _to((tc, RC._clone(st), tuple(rest), ctl.clone()), "cpu")
    # one thread: torch's CPU index_put_ adds float32 rows with atomics from
    # several threads past 32k elements, in no fixed order
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        plain(spec, tc_p, st_p, *rest_p, ctl_p)
    finally:
        torch.set_num_threads(threads)
    for name in st_p:
        got = st_k[name].cpu()
        assert RC.bit_equal(got, st_p[name]), (what, name, int((got != st_p[name]).sum()))
    assert torch.equal(ctl_k.cpu(), ctl_p), what


@pytest.mark.gpu
@pytest.mark.parametrize("cfg,scale,dtype", [
    (2, 0.2, "float32"), (3, 0.1, "float32"), (5, 0.05, "float32"),
    (6, 0.3, "float32"), (6, 0.3, "float64")])
def test_gpu_round_kernels_equal_plain_on_recorded_rounds(cfg, scale, dtype):
    """K3 and K7c on every select, commit and rollback call of a
    host-driven solve (the wrappers launch the kernels there), window and
    cover widths."""
    _cuda()
    spec, enc = prepared(cfg, scale, device="cuda", dtype=dtype)
    seen = RC.record_solve(spec, enc, limit=12)
    assert seen["select"] and seen["commit"]
    for i, (args, kw) in enumerate(seen["select"]):
        assert_select_equal(args, kw, f"cfg{cfg} select {i}")
    for i, (args, _) in enumerate(seen["commit"]):
        assert_commit_equal(args, f"cfg{cfg} commit {i}")
    for i, (args, _) in enumerate(seen["rollback"]):
        assert_commit_equal(args, f"cfg{cfg} rollback {i}", rollback=True)
    assert seen["resolve"] and (seen["budget"] or not spec.use_prop_overused)
    for i, (args, _) in enumerate(seen["resolve"]):
        assert_resolve_equal(args, f"cfg{cfg} resolve {i}")
    for i, (args, _) in enumerate(seen["budget"]):
        assert_budget_equal(args, f"cfg{cfg} budget {i}")
    assert seen["walk"] and seen["ranks"]
    for i, (args, _) in enumerate(seen["walk"]):
        assert_walk_equal(args, f"cfg{cfg} walk {i}")
    for i, (args, _) in enumerate(seen["ranks"]):
        assert_rank_equal(args, f"cfg{cfg} ranks {i}")


def _crafted_dirty(args, how):
    """A recorded round's call with its dirty set, dirty count or budget
    replaced: column 0 clean or dirty, no dirty column, the count at or
    past the budget, no dirty path (dirty_k 0), every column dirty."""
    spec, enc, idle, used, cnt, occ, scores, dirty, n_dirty, *rest = RC._clone(args)
    n = dirty.shape[0]
    g = torch.Generator().manual_seed(len(how))
    budget = max(spec.dirty_k, 8)
    want = {"col0-clean": budget // 2, "col0-dirty": budget // 2, "none": 0,
            "at-budget": budget, "past-budget": budget + 1, "no-dirty-path": budget // 2,
            "all": n}[how]
    pick = torch.randperm(n - 1, generator=g)[:min(want, n - 1)] + 1
    mask = torch.zeros(n, dtype=torch.bool)
    mask[pick] = True
    if how in ("col0-dirty", "all", "no-dirty-path") or want > n - 1:
        mask[0] = True
    dirty.copy_(mask)
    n_dirty.fill_(int(mask.sum()))
    spec = spec._replace(dirty_k=0 if how == "no-dirty-path" else
                         (n if how == "all" else budget))
    return (spec, enc, idle, used, cnt, occ, scores, dirty, n_dirty, *rest)


DIRTY_SETS = ("col0-clean", "col0-dirty", "none", "at-budget", "past-budget",
              "no-dirty-path", "all")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("cfg,scale", [(2, 0.2), (5, 0.05), (6, 0.3)])
def test_gpu_score_round_equals_plain_on_recorded_rounds(cfg, scale, dtype):
    """K1's round entry on every round of a host-driven solve (full rounds
    and dirty ones), then on crafted dirty sets around one of them."""
    _cuda()
    spec, enc = prepared(cfg, scale, device="cuda", dtype=dtype)
    seen = RC.record_solve(spec, enc, limit=24, kinds=("score",))
    assert seen["score"]
    for i, (args, _) in enumerate(seen["score"]):
        RC.hold_score_round(args, f"cfg{cfg} round {i}")
    args = seen["score"][-1][0]
    for how in DIRTY_SETS:
        RC.hold_score_round(_crafted_dirty(args, how), f"cfg{cfg} {how}")


@pytest.mark.gpu
def test_gpu_score_round_repeats_and_replays_in_a_graph():
    """The count scratch is reused launch after launch with no memset (the
    last CTA zeroes it): eager launches in a row, then a CUDA graph of one
    launch replayed on new state and dirty sets copied in, each equal to
    the plain version."""
    _cuda()
    spec, enc = prepared(6, 0.3, device="cuda", dtype="float32")
    seen = RC.record_solve(spec, enc, limit=3, kinds=("score",))
    args = _crafted_dirty(seen["score"][-1][0], "col0-dirty")
    for _ in range(3):
        RC.hold_score_round(args, "eager")
    spec, enc, idle, used, cnt, occ, scores, dirty, n_dirty, n_feas = args[:10]
    ins = RC._clone((idle, used, cnt, scores, dirty, n_dirty))
    acc = torch.zeros(n_feas.shape[0] + 1, dtype=torch.int32, device="cuda")
    out_feas = torch.zeros_like(n_feas)
    weights = tkernels.score_weights(enc)
    run = ins[3].clone()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        with torch.cuda.graph(graph, stream=stream):
            tkernels.score_round(spec, enc, ins[0], ins[1], ins[2], occ, run, ins[4],
                                 ins[5], out_feas, weights, acc)
    torch.cuda.current_stream().wait_stream(stream)
    g = torch.Generator().manual_seed(3)
    for i in range(4):
        ins[0].copy_(idle * (0.5 + 0.25 * i))
        mask = (torch.rand(dirty.shape, generator=g) < (0.05 if i % 2 else 0.5)).cuda()
        ins[4].copy_(mask)
        ins[5].fill_(int(mask.sum()))
        run.copy_(scores)
        graph.replay()
        torch.cuda.synchronize()
        want_s, want_f = scores.clone(), torch.zeros_like(n_feas)
        tkernels.score_round_plain(spec, enc, ins[0], ins[1], ins[2], occ, want_s,
                                   ins[4], ins[5], want_f)
        assert RC.bit_equal(run, want_s), i
        assert torch.equal(out_feas, want_f), i
        assert not acc.any(), i


@pytest.mark.gpu
def test_gpu_score_round_raises_instead_of_falling_back():
    """A CUDA tensor K1's round entry does not take raises; nothing runs
    the plain version instead."""
    _cuda()
    spec, enc = prepared(2, 0.2, device="cuda", dtype="float32")
    seen = RC.record_solve(spec, enc, limit=1, kinds=("score",))
    spec, enc, idle, used, cnt, occ, scores, dirty, n_dirty, n_feas = seen["score"][0][0][:10]
    with pytest.raises(TypeError):
        tkernels.score_round(spec, enc, idle, used, cnt, occ, scores, dirty, n_dirty,
                             n_feas.to(torch.int64))
    with pytest.raises(TypeError):
        tkernels.score_round(spec, enc, idle, used, cnt, occ, scores, dirty.to(torch.int32),
                             n_dirty, n_feas)
    with pytest.raises(ValueError):
        tkernels.score_round(spec, enc, idle, used, cnt, occ, scores, dirty, n_dirty,
                             n_feas, scratch=torch.zeros(3, dtype=torch.int32, device="cuda"))
    with pytest.raises(ValueError):
        tkernels.score_round(spec, enc, idle, used, cnt, occ, scores[:, :-1].contiguous(),
                             dirty, n_dirty, n_feas)


@pytest.mark.gpu
def test_gpu_graph_round_has_one_k1_launch_and_two_control_kernels():
    """A warm cfg2 graph replay under the profiler, as bench/round_split.py
    reads it: K1's group is its kernel alone, once a round (no sort of the
    dirty columns, no stack of the weights, no count of the feasible
    columns beside it), and a round step runs at most two one-thread
    kernels: K7a, once a pass of the loop, and the coverage fallback's
    setter."""
    from volcano_tpu_torch.bench import round_split

    _cuda()
    rec = round_split.split_config(2, 0.2, "test")
    assert rec["profiler_device_time"], "the profiler recorded no device time"
    rounds = rec["rounds"]
    assert rounds > 1 and rec["graph_equals_host"]
    for side in ("graph_split", "host_run_split"):
        k1 = rec[side]["K1"]
        assert set(k1) == {"kernel"}, (side, k1)
        assert abs(k1["kernel"][0] - 1.0) < 1e-9, (side, k1)
    control = rec["graph_control_kernels"]
    assert set(control) <= {"rounds_ctl", "set_cond"}
    assert control.get("set_cond", 0) <= rounds, control
    assert control["rounds_ctl"] > rounds, control


def assert_walk_equal(args, what):
    got = RK.cap_walk(*args)
    want = RK.cap_walk_plain(*args)
    for name, a, b in zip(("ccap", "g_start", "g_size", "ccap_before"), got, want):
        assert torch.equal(a, b), (what, name, int((a != b).sum()))


def assert_rank_equal(args, what):
    got = RK.job_rank(*args)
    want = RK.job_rank_plain(*args)
    for name, a, b in zip(("rank", "order"), got, want):
        assert torch.equal(a, b), (what, name, int((a != b).sum()))


def assert_resolve_equal(args, what):
    got = RK.resolve_prefix(*args)
    want = RK.resolve_prefix_plain(*args)
    assert torch.equal(got, want), (what, int((got != want).sum()))


def assert_budget_equal(args, what):
    got = RK.queue_budget(*args)
    want = RK.queue_budget_plain(*args)
    assert torch.equal(got, want), (what, int((got != want).sum()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gpu_resolve_prefix_equals_plain_on_crafted_inputs(dtype):
    """K4 on a segment over several tiles (tiles with no segment start),
    every task on one node, the infeasible tail from inside a tile, sums
    past 2^31, a rejection then rows that fit through the scalar skip, one
    and five dimensions; with and without the pod check."""
    _cuda()
    cases = RC.resolve_cases("cuda", dtype)
    assert len(cases) == 2 * len(RC.RESOLVE_CASES)
    for label, args in cases:
        assert_resolve_equal(args, label)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gpu_queue_budget_equals_plain_on_crafted_inputs(dtype):
    """K5 on one queue of 8,192 jobs, ten queues, padding tasks and jobs,
    70,000 64-core jobs past 2^31, the scalar skip edge, one and five
    dimensions."""
    _cuda()
    for label, args in RC.budget_cases("cuda", dtype):
        assert_budget_equal(args, label)


@pytest.mark.gpu
def test_gpu_resolve_and_budget_repeat_and_replay_in_a_graph():
    """K4's tile status and K5's job rows are reused launch after launch
    with no memset between (K4 stamps its status with the launch's epoch,
    K5's last CTA zeroes what it summed): eager launches in a row, then a
    CUDA graph of both replayed on inputs copied in, each equal to the
    plain version."""
    _cuda()
    r_args = RC.resolve_args(RC.resolve_inputs(**dict(RC.RESOLVE_CASES)["multi-tile segment"]),
                             True, "cuda", torch.float32)
    b_args = RC.budget_args(RC.budget_inputs(**dict(RC.BUDGET_CASES)["ten queues"]),
                            "cuda", torch.float32)
    for _ in range(3):
        assert_resolve_equal(r_args, "eager")
        assert_budget_equal(b_args, "eager")
    r_in = [x.clone() if isinstance(x, torch.Tensor) else x for x in r_args]
    b_in = [x.clone() for x in b_args]
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        with torch.cuda.graph(graph, stream=stream):
            r_out = RK.resolve_prefix(*r_in)
            b_out = RK.queue_budget(*b_in)
    torch.cuda.current_stream().wait_stream(stream)
    g = torch.Generator().manual_seed(5)
    for i in range(3):
        # new idle and new acceptances each replay
        r_in[4].copy_(r_args[4] * (0.5 + i * 0.25))
        b_in[0].copy_((torch.rand(b_in[0].shape, generator=g) < 0.6).cuda())
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(r_out, RK.resolve_prefix_plain(*r_in)), i
        assert torch.equal(b_out, RK.queue_budget_plain(*b_in)), i


@pytest.mark.gpu
def test_gpu_dispatch_fetches_what_the_solve_gives():
    """The scheduler's dispatch (rounds.dispatch_packed: the result's copy
    to the host started, no device copy of it kept; with the encode bound
    ahead by bind_packed, one call) fetches what the host-driven solve
    gives: two encodes of one bucket in flight at once each read their
    own result, a dispatch dropped unread gives its pinned block back to
    later ones, and the step counts are added once a fetch."""
    import gc

    import numpy as np

    from volcano_tpu_torch import device as devmod
    from volcano_tpu_torch.ops import rounds_graph
    from volcano_tpu_torch.utils import devprof

    _cuda()
    spec, enc = prepared(2, 0.2, device="cuda", dtype="float32")
    spec2, enc2 = prepared(2, 0.2, extra_pods=3, device="cuda", dtype="float32")
    assert rounds_graph.graph_key(spec, enc) == rounds_graph.graph_key(spec2, enc2)
    want = trounds.solve_rounds_packed(spec, enc, loop="host").cpu().numpy()
    want2 = trounds.solve_rounds_packed(spec2, enc2, loop="host").cpu().numpy()
    assert not np.array_equal(want, want2)
    first = trounds.dispatch_packed(spec, enc)        # captures the bucket's graph
    assert np.array_equal(devprof.fetch(first), want)
    bound, bound2 = trounds.bind_packed(spec, enc), trounds.bind_packed(spec2, enc2)
    assert bound is not None and bound2 is not None
    devmod.reset_launches()
    a = trounds.dispatch_packed(spec, enc, bound)
    b = trounds.dispatch_packed(spec2, enc2, bound2)
    assert not isinstance(a, torch.Tensor)
    assert np.array_equal(devprof.fetch(b), want2)
    assert np.array_equal(devprof.fetch(a), want)
    twice = devmod.launches()
    assert twice["rounds_ctl"] > 0
    dropped = trounds.dispatch_packed(spec2, enc2, bound2)
    del dropped
    gc.collect()
    for _ in range(3):
        assert np.array_equal(devprof.fetch(trounds.dispatch_packed(spec, enc, bound)), want)
    devmod.reset_launches()
    devprof.fetch(trounds.dispatch_packed(spec, enc, bound))
    devprof.fetch(trounds.dispatch_packed(spec2, enc2))
    assert devmod.launches() == twice


@pytest.mark.gpu
@pytest.mark.parametrize("cfg,scale", [(2, 0.2), (3, 0.1)])
def test_gpu_rounds_solve_equals_cpu_copies(cfg, scale):
    """A float64 rounds solve on the card, by graph and by the host-driven
    machine, gives the same result as the CPU's solve (every plain version)
    of the same encode."""
    _cuda()
    spec, enc = prepared(cfg, scale, device="cuda", dtype="float64")
    want = trounds.solve_rounds_packed(spec, {k: v.cpu() for k, v in enc.items()})
    for loop in (None, "host"):
        got = trounds.solve_rounds_packed(spec, enc, loop=loop)
        assert torch.equal(got.cpu(), want), loop


@pytest.mark.gpu
@pytest.mark.parametrize("label", [c[0] for c in RC.SELECT_CASES])
def test_gpu_round_select_equals_plain_on_crafted_inputs(label):
    _cuda()
    kw = dict(RC.SELECT_CASES)[label]
    args, kwargs = RC.select_case(device="cuda", dtype=torch.float32, **kw)
    assert_select_equal(args, kwargs, label)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("label", [c[0] for c in RC.COMMIT_CASES])
def test_gpu_round_commit_equals_plain_on_crafted_inputs(label, dtype):
    _cuda()
    kw = dict(RC.COMMIT_CASES)[label]
    assert_commit_equal(RC.commit_case(device="cuda", dtype=dtype, **kw), label)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gpu_round_rollback_equals_plain_on_crafted_inputs(dtype):
    _cuda()
    for label, args in RC.rollback_cases(device="cuda", dtype=dtype):
        assert_commit_equal(args, label, rollback=True)


@pytest.mark.gpu
def test_gpu_round_kernels_raise_instead_of_falling_back():
    """A CUDA tensor the kernel does not take raises; nothing runs the
    plain version instead."""
    _cuda()
    args, kw = RC.select_case(device="cuda", dtype=torch.float32,
                              **dict(RC.SELECT_CASES)["window"])
    bad = list(args)
    bad[3] = bad[3].to(torch.int64)           # n_feas
    with pytest.raises(TypeError):
        RK.round_select(*bad, **kw)
    spec, tc, st, choice, accept, did_full, ctl = RC.commit_case(
        device="cuda", dtype=torch.float32, **dict(RC.COMMIT_CASES)["random"])
    with pytest.raises(TypeError):
        RK.round_commit(spec, tc, st, choice.to(torch.int64), accept, did_full, ctl)
    r_args = list(RC.resolve_cases("cuda", torch.float32)[0][1])
    r_args[1] = r_args[1].to(torch.int64)     # choice
    with pytest.raises(TypeError):
        RK.resolve_prefix(*r_args)
    b_args = list(RC.budget_cases("cuda", torch.float32)[0][1])
    b_args[3] = b_args[3].to(torch.int32)     # jq
    with pytest.raises(TypeError):
        RK.queue_budget(*b_args)


@pytest.mark.gpu
def test_gpu_index_put_sums_duplicates_first_unlike_the_commit():
    """torch's CUDA index_put_(accumulate=True) adds a row's duplicate
    updates up first and the sum to the row (1 + (2^24 - 2^24) = 1); the
    CPU, like XLA's scatter, adds them one after another ((1 + 2^24) -
    2^24 = 0 in float32). K7c keeps the sequential order on the card."""
    _cuda()
    big = 2.0 ** 24
    idx = [0, 0]
    vals = [[big, big], [-big, -big]]
    for dev, want in (("cpu", 0.0), ("cuda", 1.0)):
        row = torch.ones((1, 2), device=dev)
        row.index_put_((torch.tensor(idx, device=dev),),
                       torch.tensor(vals, device=dev), accumulate=True)
        assert row.tolist() == [[want, want]], dev
    spec, tc, st, choice, accept, did_full, ctl = RC.commit_case(
        device="cuda", dtype=torch.float32, **dict(RC.COMMIT_CASES)["random"])
    t = choice.shape[0]
    choice.zero_()
    accept.zero_()
    accept[:2] = True
    st["active"][:2] = True
    tc["task_req"][:2] = torch.tensor(vals, device="cuda")
    tc["task_queue"].fill_(0)
    st["used"][0] = 1.0
    st["queue_alloc"][0] = 1.0
    assert t > 2
    RK.round_commit(spec, tc, st, choice, accept, did_full, ctl)
    assert st["used"][0].tolist() == [0.0, 0.0]
    assert st["queue_alloc"][0].tolist() == [0.0, 0.0]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gpu_cap_walk_equals_plain_on_crafted_inputs(dtype):
    """K2b on rows of signed-zero ties, all -inf, -inf ahead of a feasible
    tail, zero requests, binpack, exclusion, pod room zero or negative,
    saturating prefixes, W = 1, odd W, W past a chunk, one and five
    dimensions, and at the window's and the cover's widths of cfg5, cfg2
    and cfg6."""
    _cuda()
    cases = RC.walk_cases("cuda", dtype)
    assert len(cases) == len(RC.WALK_CASES) + len(RC.WALK_SHAPES)
    for label, args in cases:
        assert_walk_equal(args, label)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gpu_job_rank_equals_plain_on_crafted_inputs(dtype):
    """K6 under every order of the tiers over ties, signed-zero shares,
    zero totals, absent dimensions and all-equal keys, and at the job
    counts of cfg5, cfg2 and cfg6."""
    _cuda()
    for label, args in RC.rank_cases("cuda", dtype):
        assert_rank_equal(args, label)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gpu_walk_and_ranks_replay_in_a_graph(dtype):
    """K2b (at cfg5's cover width) and K6 (at cfg5's job count) captured
    into one CUDA graph and replayed 20 times on inputs copied in before
    each replay (new scores and idle, new placed counts and allocations),
    each replay equal to the plain version, as an eager call is."""
    _cuda()
    w_args = RC.walk_args(RC.walk_inputs(21, 16, 10000, 10000, binpack=True), "cuda", dtype)
    r_args = RC.rank_args(RC.rank_inputs(40, 8192), RC.RANK_KEY_ORDERS[0], "cuda", dtype)
    assert_walk_equal(w_args, "eager")
    assert_rank_equal(r_args, "eager")
    w_in = RC._clone(w_args)
    r_in = RC._clone(r_args)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        with torch.cuda.graph(graph, stream=stream):
            w_out = RK.cap_walk(*w_in)
            r_out = RK.job_rank(*r_in)
    torch.cuda.current_stream().wait_stream(stream)
    g = torch.Generator().manual_seed(9)
    for i in range(20):
        # the score rows stay sorted: a random shift keeps their ties
        w_in[2].copy_(w_args[2] + float(i % 3) - 1.0)
        w_in[7].copy_(w_args[7] * (0.25 + 0.125 * i))
        r_in[2].copy_(torch.randint(0, 4, r_in[2].shape, generator=g,
                                    dtype=torch.int32).cuda())
        r_in[3].copy_((torch.rand(r_in[3].shape, generator=g, dtype=torch.float64)
                       .round(decimals=1) * 1000.0).to(dtype).cuda())
        graph.replay()
        torch.cuda.synchronize()
        for name, a, b in zip(("ccap", "g_start", "g_size", "ccap_before"), w_out,
                              RK.cap_walk_plain(*w_in)):
            assert torch.equal(a, b), (i, name)
        for name, a, b in zip(("rank", "order"), r_out, RK.job_rank_plain(*r_in)):
            assert torch.equal(a, b), (i, name)


@pytest.mark.gpu
def test_gpu_walk_and_ranks_raise_instead_of_falling_back():
    """A CUDA tensor K2b or K6 does not take raises; nothing runs the plain
    version instead."""
    _cuda()
    w_args = list(RC.walk_cases("cuda", torch.float32)[0][1])
    w_args[1] = w_args[1].to(torch.int64)     # order
    with pytest.raises(TypeError):
        RK.cap_walk(*w_args)
    r_args = list(RC.rank_cases("cuda", torch.float32)[0][1])
    r_args[2] = r_args[2].to(torch.int64)     # job_placed
    with pytest.raises(TypeError):
        RK.job_rank(*r_args)
