"""The continuous pipeline of the port (volcano_tpu_torch/pipeline) against
its serial loop and against the JAX package's driver.

Twins of tests/test_continuous_pipeline.py on the port, on the CPU in
float64: for the same per-cycle delta trace the pipelined loop (double-
buffered snapshots, speculative solve-ahead sealed by a fingerprint and a
read set) lands exactly the end state the serial open -> actions -> close
loop lands, whether speculation is on, off, committed or discarded, and
an invalidated stage is never applied (the accounting). One more test
holds the port's pipelined end state and driver stats to the JAX
package's driver on the same trace. The reference's mesh-change test has
no twin: the port's fingerprint has no mesh item (one device). Tolerance:
exact equality of the signatures and stats.
"""

from __future__ import annotations

import os
import random
import time

import pytest
import torch

from volcano_tpu.bench import clusters as jclusters
from volcano_tpu.api import objects as jobjects
from volcano_tpu.scheduler.util import test_utils as jtu
import volcano_tpu.scheduler.actions  # noqa: F401  (register actions)

from volcano_tpu_torch.api import objects
from volcano_tpu_torch.bench.clusters import make_cache, make_tiers
from volcano_tpu_torch.scheduler import degrade as tdegrade
from volcano_tpu_torch.scheduler.framework import close_session, open_session, run_actions
from volcano_tpu_torch.scheduler.util import test_utils as ttu
import volcano_tpu_torch.scheduler.actions  # noqa: F401  (register actions)
import volcano_tpu_torch.scheduler.plugins  # noqa: F401  (register plugins)

ACTIONS = ["enqueue", "allocate", "backfill"]
# rounds mode forced: the clusters sit below the auto threshold, and the
# pipeline only solves ahead when allocate runs the packed rounds dispatch
ARGS = {"tpuscore": {"tpuscore.mode": "rounds", "tpuscore.device": "cpu",
                     "tpuscore.dtype": "float64"}}
J_ARGS = {"tpuscore": {"tpuscore.mode": "rounds"}}
TIERS_SPEC = (["tpuscore"], ["priority", "gang"],
              ["drf", "predicates", "proportion", "nodeorder"])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _fresh_port_ladder():
    tdegrade.reset()
    yield
    tdegrade.reset()


def _mk_driver(cache, tiers, spec=True, intake=None):
    from volcano_tpu_torch.pipeline import PipelineDriver
    from volcano_tpu_torch.scheduler.degrade import DegradeLadder

    return PipelineDriver(
        cache, lambda: (ACTIONS, tiers), degrade=DegradeLadder(),
        spec=spec, intake=intake)


# -- deterministic cluster + delta trace (both packages) ---------------------


class _Port:
    objects, tu, make_cache = objects, ttu, staticmethod(make_cache)


class _Jax:
    objects, tu, make_cache = jobjects, jtu, staticmethod(jclusters.make_cache)


def _cluster(seed, pkg=_Port):
    rng = random.Random(seed)
    cache = pkg.make_cache()
    cache.add_queue(pkg.tu.build_queue("default"))
    state = {"cache": cache, "rng": rng, "pods": {}, "n": 0, "pkg": pkg}
    # CPU-overcommitted: a pending backlog persists across cycles, so every
    # cycle re-runs the packed solve — the regime the solve-ahead seals
    for n in range(rng.choice([2, 3])):
        cache.add_node(pkg.tu.build_node(
            f"n{n:02d}", pkg.tu.build_resource_list_with_pods("4", "12Gi", pods=64)))
    for _ in range(rng.choice([8, 10])):
        _add_gang(state)
    return state


def _add_gang(state):
    i, rng, cache, pkg = state["n"], state["rng"], state["cache"], state["pkg"]
    state["n"] += 1
    pg = f"pg-{i:04d}"
    tasks = rng.choice([2, 3, 4])
    cache.add_pod_group(pkg.tu.build_pod_group(
        pg, namespace="pl", min_member=max(1, tasks - 1),
        phase=pkg.objects.PodGroupPhase.PENDING))
    for t in range(tasks):
        pod = pkg.tu.build_pod(
            "pl", f"{pg}-t{t}", "", pkg.objects.POD_PHASE_PENDING,
            {"cpu": f"{rng.choice([500, 1000, 2000])}m", "memory": "1Gi"}, pg)
        cache.add_pod(pod)
        state["pods"][f"pl/{pg}-t{t}"] = pod


def _del_pod(state):
    pods = state["pods"]
    if not pods:
        return
    key = sorted(pods)[state["rng"].randrange(len(pods))]
    state["cache"].delete_pod(pods.pop(key))


def _schedule(seed, cycles):
    rng = random.Random(seed * 7919)
    kinds = ["none", "none", "gang", "none", "del", "none"]
    return [rng.choice(kinds) for _ in range(cycles)]


def _apply_delta(state, kind):
    if kind == "gang":
        _add_gang(state)
    elif kind == "del":
        _del_pod(state)


def _signature(cache):
    """tests/test_continuous_pipeline.py's end-state signature."""
    jobs = {}
    for uid in sorted(cache.jobs):
        job = cache.jobs[uid]
        jobs[uid] = {
            "phase": str(job.pod_group.status.phase)
            if job.pod_group is not None else None,
            "tasks": {t: (int(job.tasks[t].status), job.tasks[t].node_name)
                      for t in sorted(job.tasks)},
        }
    nodes = {}
    for name in sorted(cache.nodes):
        node = cache.nodes[name]
        nodes[name] = (round(node.used.milli_cpu, 6),
                       round(node.idle.milli_cpu, 6),
                       round(node.used.memory, 3))
    return {"jobs": jobs, "nodes": nodes,
            "binds": dict(cache.binder.binds),
            "evicts": list(getattr(cache.evictor, "evicts", []))}


def _drive(seed, cycles, pipeline, spec=True):
    state = _cluster(seed)
    cache = state["cache"]
    tiers = make_tiers(*TIERS_SPEC, arguments=ARGS)
    drv = _mk_driver(cache, tiers, spec=spec) if pipeline else None
    for kind in _schedule(seed, cycles):
        _apply_delta(state, kind)
        if drv is None:
            ssn = open_session(cache, tiers)
            try:
                run_actions(ssn, ACTIONS)
            finally:
                close_session(ssn)
        else:
            drv.run_cycle()
    if drv is not None:
        drv.abandon()
    cache.flush_mirror()
    return _signature(cache), (dict(drv.stats) if drv else None)


def _check_accounting(stats):
    """Every dispatched stage is applied or discarded, every
    non-abandoned discard re-ran the cycle, and the apply-time re-check
    never caught a stale fingerprint."""
    assert stats["stale_commits"] == 0, stats
    discards = stats["spec_discards"]
    assert stats["spec_applied"] + stats["spec_discarded"] \
        == stats["spec_dispatched"], stats
    non_abandoned = sum(n for reason, n in discards.items()
                        if reason != "abandoned")
    assert non_abandoned == stats["spec_reruns"], stats


@pytest.mark.parametrize("seed", [3, 17])
def test_pipeline_parity_fuzz(seed):
    want, _ = _drive(seed, 10, pipeline=False)
    got_spec, stats = _drive(seed, 10, pipeline=True, spec=True)
    got_nospec, nstats = _drive(seed, 10, pipeline=True, spec=False)
    assert got_spec == want, seed
    assert got_nospec == want, seed
    _check_accounting(stats)
    assert nstats["spec_dispatched"] == 0, nstats


@pytest.mark.slow
@pytest.mark.parametrize("seed", list(range(400, 410)))
def test_pipeline_parity_wide(seed):
    want, _ = _drive(seed, 14, pipeline=False)
    got, stats = _drive(seed, 14, pipeline=True, spec=True)
    assert got == want, seed
    _check_accounting(stats)


def test_speculation_commits_on_quiet_cycles():
    state = _cluster(5)
    cache = state["cache"]
    tiers = make_tiers(*TIERS_SPEC, arguments=ARGS)
    drv = _mk_driver(cache, tiers)
    for _ in range(4):
        drv.run_cycle()
    assert drv.stats["spec_applied"] >= 1, drv.stats
    assert drv.stats["spec_commits"].get("quiet", 0) >= 1, drv.stats
    _add_gang(state)  # a new gang on sealed state is a phantom row
    drv.run_cycle()
    assert drv.stats["spec_discards"].get("readset:phantom", 0) >= 1, drv.stats
    drv.abandon()
    _check_accounting(drv.stats)


# -- read-set-scoped speculation ---------------------------------------------


_WIDE_N = 96


def _wide_cluster(anchors=4, pkg=_Port):
    """96 nodes (windowed rounds nomination, so the touched-node mask is
    a strict subset of the axis) and a standing backlog of unplaceable
    gangs (8-cpu tasks on 4-cpu nodes)."""
    cache = pkg.make_cache()
    cache.add_queue(pkg.tu.build_queue("default"))
    state = {"cache": cache, "rng": random.Random(0), "pods": {}, "n": 0,
             "pkg": pkg}
    for n in range(_WIDE_N):
        cache.add_node(pkg.tu.build_node(
            f"w{n:02d}", pkg.tu.build_resource_list_with_pods("4", "12Gi", pods=64)))
    for i in range(anchors):
        pg = f"anchor-{i}"
        cache.add_pod_group(pkg.tu.build_pod_group(
            pg, namespace="pl", min_member=1,
            phase=pkg.objects.PodGroupPhase.PENDING))
        for t in range(2):
            pod = pkg.tu.build_pod(
                "pl", f"{pg}-t{t}", "", pkg.objects.POD_PHASE_PENDING,
                {"cpu": "8000m", "memory": "1Gi"}, pg)
            cache.add_pod(pod)
            state["pods"][f"pl/{pg}-t{t}"] = pod
    return state


def _echo_node(cache, name, tu=ttu):
    """A value-neutral node status echo: same name, same capacity."""
    cache.add_node(tu.build_node(
        name, tu.build_resource_list_with_pods("4", "12Gi", pods=64)))


def test_readset_echo_on_untouched_node_commits():
    state = _wide_cluster()
    cache = state["cache"]
    tiers = make_tiers(*TIERS_SPEC, arguments=ARGS)
    drv = _mk_driver(cache, tiers)
    drv.run_cycle()
    st = drv._inflight
    assert st is not None and st.readset is not None
    read = drv._read_node_set(st)
    assert read is not None
    untouched = sorted(set(cache.nodes) - read)
    assert untouched, "window covered the whole axis; widen _WIDE_N"
    _echo_node(cache, untouched[0])
    drv.run_cycle()
    assert drv.stats["spec_commits"].get("readset", 0) == 1, drv.stats
    assert drv.stats["spec_discarded"] == 0, drv.stats
    assert drv.stats["stale_commits"] == 0, drv.stats
    audit = drv.readset_audit[-1]
    assert audit["delta_nodes"] == [untouched[0]], audit
    assert untouched[0] not in audit["read_nodes"], audit
    drv.abandon()
    _check_accounting(drv.stats)


def test_readset_capacity_change_on_read_node_discards():
    state = _wide_cluster()
    cache = state["cache"]
    tiers = make_tiers(*TIERS_SPEC, arguments=ARGS)
    drv = _mk_driver(cache, tiers)
    drv.run_cycle()
    st = drv._inflight
    assert st is not None and st.readset is not None
    read = drv._read_node_set(st)
    assert read, "empty node read set; the solve read nothing?"
    target = sorted(read)[0]
    cache.add_node(ttu.build_node(  # capacity grows 4 -> 16 cpu
        target, ttu.build_resource_list_with_pods("16", "48Gi", pods=64)))
    drv.run_cycle()
    assert drv.stats["spec_discards"].get("readset:node", 0) >= 1, drv.stats
    assert drv.stats["spec_commits"].get("readset", 0) == 0, drv.stats
    drv.abandon()
    _check_accounting(drv.stats)


def _drive_mixed(seed, readset_on, cycles=8):
    prev = os.environ.get("VOLCANO_TPU_READSET")
    os.environ["VOLCANO_TPU_READSET"] = "1" if readset_on else "0"
    try:
        state = _wide_cluster()
        state["rng"] = random.Random(seed)
        trace_rng = random.Random(seed * 104729)
        cache = state["cache"]
        tiers = make_tiers(*TIERS_SPEC, arguments=ARGS)
        drv = _mk_driver(cache, tiers)
        kinds = ["none", "echo", "echo", "gang", "del", "echo"]
        for _ in range(cycles):
            kind = trace_rng.choice(kinds)
            if kind == "echo":
                _echo_node(cache, f"w{trace_rng.randrange(_WIDE_N):02d}")
            else:
                _apply_delta(state, kind)
            drv.run_cycle()
        drv.abandon()
        cache.flush_mirror()
        return _signature(cache), dict(drv.stats)
    finally:
        if prev is None:
            os.environ.pop("VOLCANO_TPU_READSET", None)
        else:
            os.environ["VOLCANO_TPU_READSET"] = prev


def test_readset_mixed_churn_parity_ten_seeds():
    total_readset_commits = 0
    for seed in range(60, 70):
        got_on, stats_on = _drive_mixed(seed, True)
        got_off, stats_off = _drive_mixed(seed, False)
        assert got_on == got_off, (seed, stats_on, stats_off)
        _check_accounting(stats_on)
        _check_accounting(stats_off)
        assert stats_off["spec_commits"].get("readset", 0) == 0, stats_off
        total_readset_commits += stats_on["spec_commits"].get("readset", 0)
    assert total_readset_commits >= 1


def test_readset_off_restores_whole_fingerprint_scope(monkeypatch):
    monkeypatch.setenv("VOLCANO_TPU_READSET", "0")
    state = _cluster(5)
    cache = state["cache"]
    tiers = make_tiers(*TIERS_SPEC, arguments=ARGS)
    drv = _mk_driver(cache, tiers)
    for _ in range(2):
        drv.run_cycle()
    _add_gang(state)
    drv.run_cycle()
    assert drv.stats["spec_discards"].get("watch_delta", 0) >= 1, drv.stats
    drv.abandon()
    _check_accounting(drv.stats)


def test_abandon_never_applies():
    from volcano_tpu_torch.utils import devprof

    state = _cluster(9)
    cache = state["cache"]
    tiers = make_tiers(*TIERS_SPEC, arguments=ARGS)
    drv = _mk_driver(cache, tiers)
    drv.run_cycle()
    assert drv._inflight is not None  # solve-ahead left dispatched
    staged = drv._inflight.dev
    assert any(t is staged for t, _ in devprof._inflight)
    before = _signature(cache)
    drv.abandon()
    assert _signature(cache) == before
    assert drv.stats["spec_discards"].get("abandoned") == 1
    # discarded without a fetch: nothing of the stage stays in flight
    assert not any(t is staged for t, _ in devprof._inflight)
    devprof.drain()
    assert devprof._inflight == []


def test_express_commit_discards_and_tokens_drain():
    """A token minted after the seal moves the lane's commit epoch and
    discards the stage; the re-run session drains it through
    reconciliation; speculation refuses to seal while tokens are
    outstanding."""
    from volcano_tpu_torch.express.trigger import ExpressToken

    state = _cluster(11)
    cache = state["cache"]
    tiers = make_tiers(*TIERS_SPEC, arguments=ARGS)
    drv = _mk_driver(cache, tiers)

    class _Lane:
        outstanding = {}
        commit_epoch = 0
        session_seq = 0
        last_reverts = []
        counters = {"terminal": 0, "reconciled": 0, "reverted": 0,
                    "batches": 0}
        denylist = set()

        def set_tiers(self, tiers):
            pass

        def _count(self, key, n):
            self.counters[key] += n

    lane = cache.express_lane = _Lane()
    drv.run_cycle()
    assert drv._inflight is not None
    lane.commit_epoch += 1
    lane.outstanding["ghost/job"] = ExpressToken(
        job_uid="ghost/job", binds={}, seq=lane.session_seq, epoch=1)
    info = {}
    drv._speculate(ACTIONS, ACTIONS, tiers, info)
    assert drv.stats["spec_skips"].get("express_tokens") == 1, drv.stats
    drv.run_cycle()
    assert drv.stats["spec_discards"].get("express_commit", 0) >= 1, drv.stats
    assert not lane.outstanding
    assert lane.counters["terminal"] == 1
    drv.abandon()
    _check_accounting(drv.stats)


def test_express_lane_on_cpu_commits_between_cycles():
    """The port's own lane (on the CPU) placing an arrival between two
    pipelined cycles: its commit moves the epoch, the sealed stage is
    discarded (express_commit under whole-fingerprint scope, or a
    read-set verdict), the next session confirms the token, and the end
    state equals the serial loop fed the same trace."""
    from volcano_tpu_torch.express import ExpressLane

    def arm(pipeline):
        state = _wide_cluster(anchors=2)
        cache = state["cache"]
        lane = ExpressLane(cache, device="cpu", dtype=torch.float64)
        tiers = make_tiers(*TIERS_SPEC, arguments=ARGS)
        drv = _mk_driver(cache, tiers) if pipeline else None

        def cycle():
            if drv is not None:
                drv.run_cycle()
            else:
                ssn = open_session(cache, tiers)
                try:
                    run_actions(ssn, ACTIONS)
                finally:
                    close_session(ssn)

        cycle()
        cache.add_pod_group(ttu.build_pod_group(
            "svc", namespace="xp", min_member=1,
            phase=objects.PodGroupPhase.INQUEUE))
        cache.add_pod(ttu.build_pod(
            "xp", "svc-t0", "", objects.POD_PHASE_PENDING,
            {"cpu": "250m", "memory": "256Mi"}, "svc"))
        rep = lane.run_once()
        assert rep["placed"] == 1, rep
        assert lane.outstanding
        for _ in range(3):
            cycle()
        assert not lane.outstanding
        assert lane.counters["reconciled"] == 1, lane.counters
        if drv is not None:
            drv.abandon()
        cache.flush_mirror()
        return _signature(cache), (dict(drv.stats) if drv else None)

    want, _ = arm(False)
    got, stats = arm(True)
    assert got == want
    assert stats["spec_discarded"] >= 1, stats
    assert stats["spec_skips"].get("express_tokens", 0) == 0, stats
    _check_accounting(stats)


def test_fence_epoch_discards_speculation():
    state = _cluster(13)
    cache = state["cache"]
    tiers = make_tiers(*TIERS_SPEC, arguments=ARGS)
    drv = _mk_driver(cache, tiers)
    drv.run_cycle()
    assert drv._inflight is not None
    cache.set_fence_epoch(7)
    drv.run_cycle()
    assert drv.stats["spec_discards"].get("fence_epoch", 0) >= 1, drv.stats
    drv.abandon()
    _check_accounting(drv.stats)


def test_policy_meta_delta_discards_speculation():
    state = _cluster(19)
    cache = state["cache"]
    tiers = make_tiers(*TIERS_SPEC, arguments=ARGS)
    drv = _mk_driver(cache, tiers)
    drv.run_cycle()
    assert drv._inflight is not None
    cache.add_queue(ttu.build_queue("default", weight=7))  # spec update
    drv.run_cycle()
    assert drv.stats["spec_discards"].get("readset:queue", 0) >= 1, drv.stats
    drv.abandon()
    _check_accounting(drv.stats)


def test_conf_change_discards_speculation():
    from volcano_tpu_torch.pipeline import PipelineDriver
    from volcano_tpu_torch.scheduler.degrade import DegradeLadder

    state = _cluster(15)
    cache = state["cache"]
    tiers_box = {"tiers": make_tiers(*TIERS_SPEC, arguments=ARGS)}
    drv = PipelineDriver(
        cache, lambda: (ACTIONS, tiers_box["tiers"]),
        degrade=DegradeLadder(), spec=True)
    drv.run_cycle()
    assert drv._inflight is not None
    tiers_box["tiers"] = make_tiers(*TIERS_SPEC, arguments=ARGS)
    drv.run_cycle()
    assert drv.stats["spec_discards"].get("conf_changed", 0) >= 1, drv.stats
    drv.abandon()


def test_intake_keeps_speculation_valid():
    state = _cluster(21)
    cache = state["cache"]
    tiers = make_tiers(*TIERS_SPEC, arguments=ARGS)
    pending = []

    def intake():
        while pending:
            _apply_delta(state, pending.pop(0))

    drv = _mk_driver(cache, tiers, intake=intake)
    trace = ["none", "gang", "none", "gang", "none", "none"]
    for kind in trace:
        pending.append(kind)
        drv.run_cycle()
    drv.abandon()
    cache.flush_mirror()
    got = _signature(cache)
    stats = dict(drv.stats)
    assert stats["spec_discards"].get("watch_delta", 0) == 0, stats
    assert stats["spec_applied"] >= 2, stats

    state2 = _cluster(21)
    cache2 = state2["cache"]
    for kind in trace:
        _apply_delta(state2, kind)
        ssn = open_session(cache2, tiers)
        try:
            run_actions(ssn, ACTIONS)
        finally:
            close_session(ssn)
    cache2.flush_mirror()
    assert got == _signature(cache2)


def test_pipeline_disabled_rung_falls_back():
    from volcano_tpu_torch.scheduler.degrade import DegradeLadder

    ladder = DegradeLadder(pipeline_threshold=3)
    assert ladder.pipeline_allowed()
    for _ in range(3):
        ladder.note_pipeline_error()
    assert not ladder.pipeline_allowed()
    assert ladder.rung() == "pipeline_disabled"
    ladder.note_pipeline_ok()
    assert ladder.pipeline_allowed()


def test_crashed_cycle_abandons_and_meters():
    state = _cluster(23)
    cache = state["cache"]
    tiers = make_tiers(*TIERS_SPEC, arguments=ARGS)
    drv = _mk_driver(cache, tiers)
    drv.run_cycle()
    assert drv._inflight is not None

    def boom(*a, **k):
        raise RuntimeError("policy exploded")

    drv.policy_fn = boom
    with pytest.raises(RuntimeError):
        drv.run_cycle()
    assert drv._inflight is None
    assert drv.stats["spec_discards"].get("abandoned") == 1
    assert drv.degrade.pipeline.stats["failures"] >= 1


_CPU_TPU_CONF = """
actions: "enqueue, allocate, backfill"
tiers:
- plugins:
  - name: tpuscore
    arguments:
      tpuscore.mode: rounds
      tpuscore.device: cpu
      tpuscore.dtype: float64
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
"""


def test_scheduler_pipeline_mode(monkeypatch):
    """Scheduler(pipeline=True) drives cycles through the driver;
    VOLCANO_TPU_PIPELINE=0 keeps the serial loop (driver never built)."""
    from volcano_tpu_torch.scheduler.scheduler import Scheduler

    monkeypatch.delenv("VOLCANO_TPU_PIPELINE", raising=False)
    state = _cluster(31)
    cache = state["cache"]
    s = Scheduler(cache, _CPU_TPU_CONF, schedule_period=0.05, pipeline=True)
    s.run()
    try:
        assert cache.binder.wait_for_binds(1, timeout=10.0)
        assert s.pipeline_driver is not None
        deadline = time.time() + 10.0
        while s.pipeline_driver.stats["committed"] == 0 \
                and time.time() < deadline:
            time.sleep(0.01)
        assert s.pipeline_driver.stats["committed"] >= 1
    finally:
        s.stop()
    assert s.pipeline_driver._inflight is None  # abandoned at stop

    monkeypatch.setenv("VOLCANO_TPU_PIPELINE", "0")
    state2 = _cluster(31)
    s2 = Scheduler(state2["cache"], _CPU_TPU_CONF, schedule_period=0.05,
                   pipeline=True)
    s2.run()
    try:
        assert state2["cache"].binder.wait_for_binds(1, timeout=10.0)
        assert s2.pipeline_driver is None
    finally:
        s2.stop()


# -- the port against the JAX package's driver --------------------------------


def _drive_jax(seed, cycles):
    from volcano_tpu.pipeline import PipelineDriver
    from volcano_tpu.scheduler.degrade import DegradeLadder

    state = _cluster(seed, pkg=_Jax)
    cache = state["cache"]
    tiers = jclusters.make_tiers(*TIERS_SPEC, arguments=J_ARGS)
    drv = PipelineDriver(cache, lambda: (ACTIONS, tiers),
                         degrade=DegradeLadder(), spec=True)
    for kind in _schedule(seed, cycles):
        _apply_delta(state, kind)
        drv.run_cycle()
    drv.abandon()
    cache.flush_mirror()
    return _signature(cache), dict(drv.stats)


_STAT_KEYS = ("cycles", "committed", "fallback_cycles", "spec_dispatched",
              "spec_applied", "spec_discarded", "spec_reruns",
              "stale_commits", "spec_discards", "spec_skips", "spec_commits")


@pytest.mark.parametrize("seed", [3, 17])
def test_pipelined_cycles_match_the_jax_driver(seed):
    """The port's pipelined loop and the JAX package's, on the same trace:
    the same end state (task statuses and placements, node accounting,
    PodGroup phases, binds, evictions) and the same speculation outcome
    per category (dispatched, committed by kind, discarded by reason,
    skipped by reason)."""
    want, jstats = _drive_jax(seed, 10)
    got, tstats = _drive(seed, 10, pipeline=True, spec=True)
    assert got == want, seed
    assert {k: tstats[k] for k in _STAT_KEYS} == \
        {k: jstats[k] for k in _STAT_KEYS}
    assert tstats["spec_applied"] >= 1
