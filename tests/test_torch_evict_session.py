"""Whole eviction sessions: the port against the JAX package, and the
port's batched path against its own serial walk.

Twin clusters (built from one seed with each package's own objects) run
allocate, backfill, preempt and reclaim one by one through each package's
session (the port on the CPU in float64, JAX in float64 under the test
conftest). Tolerance: exact equality of the session signature (task
states and placements, node vectors, job readiness, drf and proportion
shares, fit errors), the binds, the evictions in effector order, and the
preemption metrics. The envelope twins of tests/test_evict_kernel.py hold
the port's gates: outside the modeled envelope ``build`` refuses and the
serial walk runs.
"""

from __future__ import annotations

import pytest
import torch

from tests.test_torch_evict import (
    PKGS,
    TIER_SETS,
    _mods,
    overcommit_cluster,
    reclaim_cluster,
)
from volcano_tpu.scheduler import metrics as jmetrics

from volcano_tpu_torch.ops import evict as tevict
from volcano_tpu_torch.ops import victimview as tvictimview
from volcano_tpu_torch.scheduler import metrics as tmetrics

ACTIONS = ("allocate", "backfill", "preempt", "reclaim")
CPU64 = {"tpuscore.device": "cpu", "tpuscore.dtype": "float64"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _res_tuple(r):
    return (round(r.milli_cpu, 6), round(r.memory, 3),
            tuple(sorted((r.scalar_resources or {}).items())))


def session_signature(ssn):
    """Everything the parity contract covers: task statuses/placements,
    node accounting, job readiness, plugin shares, fit errors."""
    tasks = sorted(
        (t.uid, int(t.status), t.node_name)
        for job in ssn.jobs.values() for t in job.tasks.values())
    nodes = sorted(
        (n.name, _res_tuple(n.idle), _res_tuple(n.used),
         _res_tuple(n.releasing), len(n.tasks))
        for n in ssn.nodes.values())
    jobs = sorted(
        (j.uid, j.ready_task_num(), j.waiting_task_num())
        for j in ssn.jobs.values())
    drf = ssn.plugins.get("drf")
    shares = sorted(
        (uid, a.share, _res_tuple(a.allocated))
        for uid, a in drf.job_attrs.items()) if drf is not None else []
    prop = ssn.plugins.get("proportion")
    qshares = sorted(
        (q, a.share, _res_tuple(a.allocated))
        for q, a in prop.queue_opts.items()) if prop is not None else []
    fit_errors = sorted(
        (uid, fe.error()) for job in ssn.jobs.values()
        for uid, fe in job.nodes_fit_errors.items())
    return dict(tasks=tasks, nodes=nodes, jobs=jobs, shares=shares,
                qshares=qshares, fit_errors=fit_errors)


def run(pkg, build, tiers, monkeypatch, tpu_args=None, evict_on=True):
    """One session of the four actions, one by one, on ``build``'s cluster
    in package ``pkg``; returns (signature, binds, evicts, profile)."""
    clusters, framework = PKGS[pkg]
    metrics = jmetrics if pkg == "jax" else tmetrics
    monkeypatch.setenv("VOLCANO_TPU_EVICT", "1" if evict_on else "0")
    args = dict(CPU64 if pkg == "torch" else {}, **(tpu_args or {}))
    reg = metrics.registry()
    m0 = (reg.preemption_victims.get(), reg.preemption_attempts.get())
    cache = build(clusters)
    ssn = framework.open_session(cache, clusters.make_tiers(
        ["tpuscore"], *tiers, arguments={"tpuscore": args}))
    try:
        for name in ACTIONS:
            framework.get_action(name).execute(ssn)
        sig = session_signature(ssn)
        prof = dict(ssn.plugins["tpuscore"].profile)
    finally:
        framework.close_session(ssn)
    sig["metrics"] = (reg.preemption_victims.get() - m0[0],
                      reg.preemption_attempts.get() - m0[1])
    return sig, dict(cache.binder.binds), list(cache.evictor.evicts), prof


def assert_same(got, want):
    assert got[0] == want[0]
    assert got[1] == want[1]          # binds
    assert got[2] == want[2]          # evictions, in effector order


def assert_batched(prof, kinds=("backfill", "preempt", "reclaim")):
    for kind in kinds:
        assert f"evict_{kind}" in prof, prof.get(f"evict_{kind}_fallback", prof)
        assert f"evict_{kind}_fallback" not in prof


@pytest.mark.parametrize("seed", [11, 42, 7])
@pytest.mark.parametrize("tiers", TIER_SETS, ids=["cfg4", "prop", "drf"])
def test_fuzzed_session_matches_reference(tiers, seed, monkeypatch):
    def build(c):
        return overcommit_cluster(c, seed)

    want = run("jax", build, tiers, monkeypatch)
    got = run("torch", build, tiers, monkeypatch)
    assert_same(got, want)
    assert_batched(got[3])
    if tiers is not TIER_SETS[2]:
        assert got[2], "under the gang-deciding confs these clusters evict"


@pytest.mark.parametrize("tiers", TIER_SETS, ids=["cfg4", "prop", "drf"])
def test_reclaim_session_matches_reference(tiers, monkeypatch):
    def build(c):
        return reclaim_cluster(c, 42)

    want = run("jax", build, tiers, monkeypatch)
    got = run("torch", build, tiers, monkeypatch)
    assert_same(got, want)
    assert_batched(got[3])
    assert got[3]["evict_reclaim"]["ops"] > 0


def test_cfg4_session_matches_reference(monkeypatch):
    """cfg4 at scale 0.02 in rounds mode: the slice's main path (rounds
    allocate, then the three machines) gives the reference's session."""
    def build(c):
        cache = c.make_cache()
        c.CONFIGS[4].populate(cache, 0.02)
        return cache

    tiers = PKGS["jax"][0].CONFIGS[4].tiers
    args = {"tpuscore.mode": "rounds"}
    want = run("jax", build, tiers, monkeypatch, args)
    got = run("torch", build, tiers, monkeypatch, args)
    assert_same(got, want)
    assert got[3]["mode"] == "rounds"
    assert_batched(got[3], ("backfill", "preempt"))
    for key in ("ops", "victims", "attempts"):
        assert got[3]["evict_preempt"][key] == want[3]["evict_preempt"][key]
    assert got[3]["evict_preempt"]["ops"] > 0 and got[2]


@pytest.mark.parametrize("seed", [11, 7])
@pytest.mark.parametrize("tiers", TIER_SETS, ids=["cfg4", "prop", "drf"])
def test_batched_path_matches_serial_walk(tiers, seed, monkeypatch):
    """The port's batched actions against the port's own serial walk
    (VOLCANO_TPU_EVICT=0, victim batching engaged on it too)."""
    monkeypatch.setattr(tvictimview.VictimSelector, "MIN_BATCH", 1)

    def build(c):
        return overcommit_cluster(c, seed)

    got = run("torch", build, tiers, monkeypatch)
    want = run("torch", build, tiers, monkeypatch, evict_on=False)
    assert_same(got, want)
    assert_batched(got[3])
    assert "evict_preempt_fallback" in want[3]


def _open(cache, tiers):
    from volcano_tpu_torch.bench import clusters as tclusters
    from volcano_tpu_torch.scheduler import framework as tframework

    return tframework.open_session(cache, tclusters.make_tiers(
        ["tpuscore"], *tiers, arguments={"tpuscore": CPU64}))


def test_env_flag_forces_old_path(monkeypatch):
    from volcano_tpu_torch.bench import clusters as tclusters
    from volcano_tpu_torch.scheduler import framework as tframework

    cache = overcommit_cluster(tclusters, 11)
    monkeypatch.setenv("VOLCANO_TPU_EVICT", "0")
    ssn = _open(cache, TIER_SETS[0])
    try:
        assert tevict.build(ssn, "preempt") is None
        assert tevict.build(ssn, "reclaim") is None
        assert tevict.build(ssn, "backfill") is None
    finally:
        tframework.close_session(ssn)


def test_scalar_resources_fall_back(monkeypatch):
    """Scalar dims leave the modeled envelope: build refuses, and the
    actions still run end to end by the serial walk."""
    from volcano_tpu_torch.bench import clusters as tclusters
    from volcano_tpu_torch.scheduler import framework as tframework
    from volcano_tpu_torch.scheduler.util.test_utils import (
        build_node, build_resource_list_with_pods)

    cache = overcommit_cluster(tclusters, 11)
    rl = build_resource_list_with_pods("8", "16Gi", pods=64)
    rl["nvidia.com/gpu"] = "4"
    cache.add_node(build_node("node-gpu", rl))
    monkeypatch.setenv("VOLCANO_TPU_EVICT", "1")
    ssn = _open(cache, TIER_SETS[0])
    try:
        assert tevict.build(ssn, "preempt") is None
        prof = ssn.plugins["tpuscore"].profile
        assert "scalar" in prof["evict_preempt_fallback"]
        for name in ACTIONS:
            tframework.get_action(name).execute(ssn)
    finally:
        tframework.close_session(ssn)


def test_custom_victim_plugin_falls_back(monkeypatch):
    from volcano_tpu_torch.bench import clusters as tclusters
    from volcano_tpu_torch.scheduler import framework as tframework

    cache = overcommit_cluster(tclusters, 11)
    monkeypatch.setenv("VOLCANO_TPU_EVICT", "1")
    ssn = _open(cache, TIER_SETS[0])
    try:
        ssn.add_preemptable_fn("priority", lambda c, cs: cs)
        assert tevict.build(ssn, "preempt") is None
        # the reclaimable registry is untouched: still batchable
        assert tevict.build(ssn, "reclaim") is not None
    finally:
        tframework.close_session(ssn)


def test_consecutive_sessions_match_reference(monkeypatch):
    """Two back-to-back sessions on one cache: the second one's snapshot
    is delta-maintained from the SnapshotKeeper dirty sets the eviction
    effectors marked; both packages must still agree."""
    out = {}
    for pkg in ("jax", "torch"):
        clusters, framework = PKGS[pkg]
        monkeypatch.setenv("VOLCANO_TPU_EVICT", "1")
        cache = overcommit_cluster(clusters, 21)
        args = CPU64 if pkg == "torch" else {}
        sigs = []
        for _ in range(2):
            ssn = framework.open_session(cache, clusters.make_tiers(
                ["tpuscore"], *TIER_SETS[0], arguments={"tpuscore": args}))
            try:
                for name in ACTIONS:
                    framework.get_action(name).execute(ssn)
                sigs.append(session_signature(ssn))
            finally:
                framework.close_session(ssn)
        out[pkg] = (sigs, dict(cache.binder.binds), list(cache.evictor.evicts))
    assert out["torch"] == out["jax"]


def test_evictions_mark_snapshot_dirty_sets(monkeypatch):
    """Replayed evictions go through cache.evict, so the keeper's dirty
    sets cover every evicted task's job and node."""
    from volcano_tpu_torch.api.types import TaskStatus
    from volcano_tpu_torch.bench import clusters as tclusters
    from volcano_tpu_torch.scheduler import framework as tframework

    cache = overcommit_cluster(tclusters, 11)
    monkeypatch.setenv("VOLCANO_TPU_EVICT", "1")
    ssn = _open(cache, TIER_SETS[0])
    try:
        for name in ACTIONS:
            tframework.get_action(name).execute(ssn)
        evicted = [t for job in ssn.jobs.values() for t in job.tasks.values()
                   if t.status == TaskStatus.RELEASING]
        assert evicted
        assert cache.snap_keeper.stats.get("evict_marks", 0) > 0
        for t in evicted:
            assert t.job in cache.snap_keeper.dirty_jobs
            assert t.node_name in cache.snap_keeper.dirty_nodes
    finally:
        tframework.close_session(ssn)


def _backfill_failure_cluster(clusters, failing: int):
    """Zero-request pods whose node selector matches nothing: every one
    fails, exercising the bounded diagnostics replay."""
    objects, tu = _mods(clusters)
    c = clusters.make_cache()
    c.add_queue(tu.build_queue("default"))
    for n in range(3):
        c.add_node(tu.build_node(
            f"node-{n:03d}", tu.build_resource_list_with_pods("8", "16Gi", pods=16),
            labels={"zone": "a"}))
    for g in range(failing):
        pg = f"bf-{g:03d}"
        c.add_pod_group(tu.build_pod_group(pg, namespace="bf", min_member=1,
                                           queue="default"))
        c.add_pod(tu.build_pod("bf", f"{pg}-t0", "", objects.POD_PHASE_PENDING,
                               {}, pg, node_selector={"zone": "nowhere"}))
    return c


@pytest.mark.parametrize("evict_on", [True, False])
def test_backfill_replay_budget_matches_reference(evict_on, monkeypatch):
    """More failing backfill tasks than the replay budget (8): the first 8
    get the serial walk's per-node reasons, the rest the summary error, on
    the batched path and the dense-view path alike — and the same fit
    errors as the JAX package's."""
    monkeypatch.setenv("VOLCANO_TPU_EVICT", "1" if evict_on else "0")
    errors = {}
    for pkg in ("jax", "torch"):
        clusters, framework = PKGS[pkg]
        cache = _backfill_failure_cluster(clusters, 12)
        ssn = framework.open_session(cache, clusters.make_tiers(
            ["tpuscore"], ["gang"], ["predicates"],
            arguments={"tpuscore": CPU64 if pkg == "torch" else {}}))
        try:
            framework.get_action("backfill").execute(ssn)
            errors[pkg] = sorted(
                (uid, fe.error(), len(fe.nodes)) for job in ssn.jobs.values()
                for uid, fe in job.nodes_fit_errors.items())
            prof = dict(ssn.plugins["tpuscore"].profile)
        finally:
            framework.close_session(ssn)
    assert errors["torch"] == errors["jax"]
    assert len(errors["torch"]) == 12
    assert sum(1 for _, _, n in errors["torch"] if n == 3) == 8
    assert ("evict_backfill" in prof) == evict_on
