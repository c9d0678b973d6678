"""The express lane (volcano_tpu_torch/express) against the JAX package's
lane (volcano_tpu/express).

- K14's plain version ``solve_express_plain`` equals the jitted JAX
  ``solve_express`` bit for bit (the packed int32 result) on inputs made
  from numpy seeds: small and wide node axes, both task buckets, windowed
  and full-width, tie-heavy node shapes (windows that cannot prove
  coverage, so ``fulls > 0``), pod caps, gang strips and pad jobs.
- Twin clusters, each built with its own package's objects, take the same
  arrival sequence through each package's ``ExpressLane`` (the port on the
  CPU in float64, the JAX lane in float64 under the test conftest): the
  same reports, counters, state stats, binds and end state, before and
  after the reconciling session.
- Twins of every test in tests/test_express.py, on the port.

Tolerance: none; every comparison is exact.
"""

from __future__ import annotations

import importlib
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volcano_tpu.scheduler.actions  # noqa: F401 (register actions)
import volcano_tpu.scheduler.plugins  # noqa: F401 (register plugins)
from volcano_tpu.bench import clusters as jclusters
from volcano_tpu.express import ExpressLane as JExpressLane
from volcano_tpu.express import place as jplace
from volcano_tpu.scheduler import framework as jframework

import volcano_tpu_torch.scheduler.actions  # noqa: F401 (register actions)
import volcano_tpu_torch.scheduler.plugins  # noqa: F401 (register plugins)
from volcano_tpu_torch import _build
from volcano_tpu_torch import device as devmod
from volcano_tpu_torch.api import objects
from volcano_tpu_torch.api.types import TaskStatus
from volcano_tpu_torch.bench import clusters as tclusters
from volcano_tpu_torch.bench.clusters import DEFAULT_TIERS, make_cache, make_tiers
from volcano_tpu_torch.express import ExpressLane
from volcano_tpu_torch.express import place as tplace
from volcano_tpu_torch.scheduler import framework as tframework
from volcano_tpu_torch.scheduler.framework import (
    close_session,
    open_session,
    run_actions,
)
from volcano_tpu_torch.scheduler.util.test_utils import (
    build_node,
    build_pod,
    build_pod_group,
    build_queue,
    build_resource_list_with_pods,
)

ACTIONS = ("enqueue", "allocate", "backfill")
CPU64 = dict(device="cpu", dtype=torch.float64)
INT32_MAX = np.iinfo(np.int32).max
PKGS = {"jax": (jclusters, jframework), "torch": (tclusters, tframework)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# K14: plain version == jitted JAX solve_express
# ---------------------------------------------------------------------------

GI = float(2 ** 30)
MI = float(2 ** 20)


def express_case(seed, n, tb, n_tasks, window_k, ties=False, pod_cap=False,
                 tight=False, gang=1):
    """numpy inputs of one express batch: node columns, then the padded
    task/job arrays as trigger.py builds them (jobs of ``gang`` tasks,
    pad jobs at INT32_MAX need, pad tasks invalid)."""
    rng = np.random.default_rng(seed)
    if ties:
        alloc = np.tile([8000.0, 16 * GI], (n, 1))
        idle = alloc.copy()
    else:
        alloc = np.stack([rng.choice([4000.0, 8000.0, 16000.0], n),
                          rng.choice([8 * GI, 16 * GI, 32 * GI], n)], 1)
        used = np.stack([rng.integers(0, 12, n) * 250.0,
                         rng.integers(0, 24, n) * 256 * MI], 1)
        idle = np.maximum(alloc - used, 0.0)
    if tight:
        idle = idle * 0.1
    cnt = rng.integers(0, 4, n).astype(np.int32)
    maxt = (rng.integers(1, 5, n) if pod_cap
            else np.full(n, 110)).astype(np.int32)
    ok = rng.random(n) > 0.15
    n_jobs = -(-n_tasks // gang)
    jb = tplace.task_bucket(n_jobs)
    req = np.zeros((tb, 2))
    req[:n_tasks, 0] = rng.choice([100.0, 250.0, 500.0, 1000.0, 3000.0],
                                  n_tasks)
    req[:n_tasks, 1] = rng.choice([128 * MI, 256 * MI, 1 * GI, 4 * GI],
                                  n_tasks)
    initreq = req.copy()
    initreq[:n_tasks, 0] += rng.choice([0.0, 0.0, 100.0], n_tasks)
    valid = np.zeros(tb, bool)
    valid[:n_tasks] = True
    task_job = np.zeros(tb, np.int32)
    task_job[:n_tasks] = np.arange(n_tasks) // gang
    job_need = np.full(jb, INT32_MAX, np.int32)
    job_need[:n_jobs] = np.bincount(task_job[:n_tasks], minlength=n_jobs)
    has_pod = np.ones(tb, bool)
    nzc = np.where(req[:, 0] != 0, req[:, 0], 100.0)
    nzm = np.where(req[:, 1] != 0, req[:, 1], 200.0 * MI)
    weights = np.array([1.0, 1.0])
    arrays = (idle, alloc, cnt, ok, maxt, initreq, req, nzc, nzm, valid,
              task_job, has_pod, job_need, weights)
    return dict(tb=tb, jb=jb, window_k=window_k), arrays


def solve_both(spec_kw, arrays):
    jout = np.asarray(jplace.solve_express(
        jplace.ExpressSpec(**spec_kw), *[jnp.asarray(a) for a in arrays]))
    tout = tplace.solve_express(
        tplace.ExpressSpec(**spec_kw),
        *[torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])
    return jout, tout.numpy()


# (id, n, tb, tasks, window_k, ties, pod_cap, tight, gang)
KCASES = [
    ("n40-full", 40, 16, 5, 0, False, False, False, 1),
    ("n40-full-podcap", 40, 16, 16, 0, False, True, False, 1),
    ("n40-window16", 40, 16, 12, 16, False, False, False, 1),
    ("n40-window16-ties", 40, 16, 16, 16, True, False, False, 1),
    ("n40-gang-strip", 40, 16, 12, 0, False, False, True, 3),
    ("n40-window-gang-strip", 40, 64, 40, 16, False, True, True, 4),
    ("n600-window64", 600, 16, 9, 64, False, False, False, 1),
    ("n600-window64-ties", 600, 16, 16, 64, True, False, False, 2),
    ("n600-window256", 600, 64, 60, 256, False, True, False, 3),
    ("n600-window256-ties", 600, 64, 64, 256, True, True, False, 4),
    ("n600-full-tb64", 600, 64, 33, 0, False, False, True, 3),
    ("n600-window256-strip", 600, 64, 64, 256, False, False, True, 4),
]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", KCASES, ids=[c[0] for c in KCASES])
def test_plain_solve_matches_jitted_reference(case, seed):
    _, n, tb, tasks, w, ties, cap, tight, gang = case
    spec_kw, arrays = express_case(seed, n, tb, tasks, w, ties, cap, tight,
                                   gang)
    jout, tout = solve_both(spec_kw, arrays)
    assert np.array_equal(jout, tout), (jout, tout)
    if w and ties:
        # the window cannot prove a strict winner over equal shapes
        assert tout[tb] > 0
    if tight:
        placed = tout[:tb][tout[:tb] >= 0].size
        assert tout[tb + 1] == placed


def test_window_for_matches_reference():
    for n in (10, 40, 128, 600, 10000):
        for b in (1, 8, 16, 33, 64):
            assert tplace.window_for(n, b) == jplace.window_for(n, b)
            assert tplace.task_bucket(b) == jplace.task_bucket(b)
    assert tplace.PROF_TAIL == jplace.PROF_TAIL
    assert tplace.EXPRESS_MAX_BATCH == jplace.EXPRESS_MAX_BATCH


def test_strip_and_pad_jobs_exercised():
    """The gang-strip cases really strip (a placed task revoked), and pad
    jobs (need INT32_MAX) never strip a real task."""
    spec_kw, arrays = express_case(3, 40, 16, 12, 0, tight=True, gang=3)
    _, tout = solve_both(spec_kw, arrays)
    # run the walk without the strip: some job placed short of its need
    arrays2 = list(arrays)
    arrays2[12] = np.zeros_like(arrays[12])
    _, loose = solve_both(spec_kw, tuple(arrays2))
    assert (loose[:16] >= 0).sum() > (tout[:16] >= 0).sum()
    assert loose[17] > tout[17]


def test_solve_express_uses_plain_version_on_cpu_only():
    devmod.reset_launches()
    spec_kw, arrays = express_case(0, 40, 16, 4, 0)
    tplace.solve_express(tplace.ExpressSpec(**spec_kw),
                         *[torch.from_numpy(np.ascontiguousarray(a))
                           for a in arrays])
    assert devmod.launches()["express_place"] == 0
    assert "express_place" in _build.KERNELS


# ---------------------------------------------------------------------------
# port lane == JAX lane on the same event sequences
# ---------------------------------------------------------------------------

def _mods(clusters):
    pkg = clusters.__name__.split(".")[0]
    return (importlib.import_module(pkg + ".api.objects"),
            importlib.import_module(pkg + ".scheduler.util.test_utils"))


def twin_cluster(pkg, n_nodes, seed):
    clusters, _ = PKGS[pkg]
    _, tu = _mods(clusters)
    rng = random.Random(seed)
    cache = clusters.make_cache()
    for n in range(n_nodes):
        cache.add_node(tu.build_node(
            f"node-{n:03d}", tu.build_resource_list_with_pods(
                rng.choice(["4", "8", "16"]), rng.choice(["8Gi", "16Gi", "32Gi"]),
                pods=rng.choice([3, 64])),
            labels={"zone": f"zone-{n % 2}"}))
    cache.add_queue(tu.build_queue("default"))
    return cache


def twin_submit(pkg, cache, name, tasks=1, min_member=1, cpu="500m",
                mem="512Mi"):
    objects_mod, tu = _mods(PKGS[pkg][0])
    cache.add_pod_group(tu.build_pod_group(
        name, namespace="xp", min_member=min_member,
        phase=objects_mod.PodGroupPhase.INQUEUE))
    for i in range(tasks):
        cache.add_pod(tu.build_pod(
            "xp", f"{name}-t{i}", "", objects_mod.POD_PHASE_PENDING,
            {"cpu": cpu, "memory": mem}, name))


def twin_session(pkg, cache):
    clusters, framework = PKGS[pkg]
    ssn = framework.open_session(cache, clusters.make_tiers(
        *clusters.DEFAULT_TIERS))
    try:
        framework.run_actions(ssn, list(ACTIONS))
    finally:
        framework.close_session(ssn)


def _report(rep):
    return {k: rep[k] for k in ("queued", "placed", "deferred", "batches",
                                "full_sweep_steps", "reasons")}


def end_state(cache):
    tasks = {}
    for uid in sorted(cache.jobs):
        job = cache.jobs[uid]
        for tuid in sorted(job.tasks):
            t = job.tasks[tuid]
            tasks[t.key] = (int(t.status), t.node_name)
    nodes = {name: (cache.nodes[name].used.milli_cpu,
                    cache.nodes[name].used.memory)
             for name in sorted(cache.nodes)}
    return tasks, nodes


def _summary(lane):
    s = lane.summary()
    return s["counters"], s["state"], s["outstanding"], s["breaker"]


@pytest.mark.parametrize("seed,n_nodes", [(0, 5), (1, 12), (2, 300), (3, 300)])
def test_port_lane_matches_jax_lane(seed, n_nodes):
    """Waves of arrivals through both lanes (between them a session):
    every report, the counters, the state stats, the binds and the end
    state agree. Wide axes (300 nodes) take the windowed path."""
    rng = random.Random(seed)
    caches = {pkg: twin_cluster(pkg, n_nodes, seed) for pkg in PKGS}
    lanes = {"jax": JExpressLane(caches["jax"]),
             "torch": ExpressLane(caches["torch"], **CPU64)}
    seq = 0
    for wave in range(3):
        shapes = []
        for _ in range(rng.randint(1, 9)):
            gang = rng.random() < 0.4
            shapes.append(dict(
                name=f"job-{seq:03d}", tasks=rng.choice([2, 3]) if gang else 1,
                min_member=2 if gang else 1,
                cpu=rng.choice(["250m", "500m", "2000m", "6000m"]),
                mem=rng.choice(["256Mi", "1Gi", "6Gi"])))
            seq += 1
        for s in shapes:
            for pkg in PKGS:
                twin_submit(pkg, caches[pkg], **s)
        reps = {pkg: lanes[pkg].run_once() for pkg in PKGS}
        assert _report(reps["torch"]) == _report(reps["jax"]), wave
        assert _summary(lanes["torch"]) == _summary(lanes["jax"]), wave
        assert caches["torch"].binder.binds == caches["jax"].binder.binds
        assert end_state(caches["torch"]) == end_state(caches["jax"])
        if wave == 1:
            for pkg in PKGS:
                twin_session(pkg, caches[pkg])
            assert _summary(lanes["torch"]) == _summary(lanes["jax"])
            assert end_state(caches["torch"]) == end_state(caches["jax"])
    for pkg in PKGS:
        twin_session(pkg, caches[pkg])
    assert _summary(lanes["torch"]) == _summary(lanes["jax"])
    assert lanes["torch"].denylist == lanes["jax"].denylist
    assert end_state(caches["torch"]) == end_state(caches["jax"])
    assert lanes["torch"].counters["placed"] > 0


# ---------------------------------------------------------------------------
# twins of tests/test_express.py
# ---------------------------------------------------------------------------

def build_cluster(n_nodes=6, rng=None):
    cache = make_cache()
    rng = rng or random.Random(0)
    for n in range(n_nodes):
        cpu = rng.choice(["4", "8", "16"])
        mem = rng.choice(["8Gi", "16Gi", "32Gi"])
        cache.add_node(build_node(
            f"node-{n:03d}", build_resource_list_with_pods(cpu, mem,
                                                           pods=64),
            labels={"zone": f"zone-{n % 2}"}))
    cache.add_queue(build_queue("default"))
    return cache


def submit_job(cache, name, tasks=1, min_member=1, cpu="500m", mem="512Mi",
               ns="xp", priority=None, phase=objects.PodGroupPhase.INQUEUE,
               request_extra=None, node_selector=None):
    cache.add_pod_group(build_pod_group(
        name, namespace=ns, min_member=min_member, phase=phase))
    req = {"cpu": cpu, "memory": mem}
    if request_extra:
        req.update(request_extra)
    for i in range(tasks):
        cache.add_pod(build_pod(
            ns, f"{name}-t{i}", "", objects.POD_PHASE_PENDING, req, name,
            node_selector=node_selector, priority=priority))
    return f"{ns}/{name}"


def run_session(cache, actions=ACTIONS):
    ssn = open_session(cache, make_tiers(*DEFAULT_TIERS))
    try:
        run_actions(ssn, list(actions))
    finally:
        close_session(ssn)


def lane_of(cache):
    return ExpressLane(cache, **CPU64)


class TestExpressFastPath:
    def test_single_arrival_places_and_confirms(self):
        cache = build_cluster()
        lane = lane_of(cache)
        submit_job(cache, "svc-1")
        assert lane.has_pending()
        rep = lane.run_once()
        assert rep["placed"] == 1 and rep["deferred"] == 0
        job = cache.jobs["xp/svc-1"]
        (task,) = job.tasks.values()
        assert task.status == TaskStatus.BINDING and task.node_name
        assert cache.binder.binds["xp/svc-1-t0"] == task.node_name
        assert "xp/svc-1" in lane.outstanding
        run_session(cache)
        assert lane.outstanding == {}
        assert lane.counters["reconciled"] == 1
        assert lane.counters["reverted"] == 0
        assert job.tasks[task.uid].node_name == task.node_name

    def test_tiny_gang_places_all_or_nothing(self):
        cache = build_cluster()
        lane = lane_of(cache)
        submit_job(cache, "gang-1", tasks=2, min_member=2)
        rep = lane.run_once()
        assert rep["placed"] == 2
        job = cache.jobs["xp/gang-1"]
        assert all(t.status == TaskStatus.BINDING for t in job.tasks.values())

    def test_oversized_arrival_defers_whole_gang(self):
        cache = make_cache()
        cache.add_node(build_node(
            "only", build_resource_list_with_pods("2", "4Gi", pods=64)))
        cache.add_queue(build_queue("default"))
        lane = lane_of(cache)
        submit_job(cache, "big", tasks=3, min_member=3, cpu="1000m")
        rep = lane.run_once()
        assert rep["placed"] == 0
        job = cache.jobs["xp/big"]
        assert all(t.status == TaskStatus.PENDING
                   for t in job.tasks.values())
        assert lane.outstanding == {}


class TestReconciliationParity:
    @pytest.mark.parametrize("seed", [1, 2, 3, 4])
    def test_express_plus_session_equals_session_only(self, seed):
        rng = random.Random(seed)
        shapes = []
        for i in range(rng.randint(2, 6)):
            gang = rng.random() < 0.4
            shapes.append(dict(
                name=f"job-{i:03d}",
                tasks=2 if gang else 1,
                min_member=2 if gang else 1,
                cpu=rng.choice(["250m", "500m", "1000m"]),
                mem=rng.choice(["256Mi", "512Mi", "1Gi"]),
            ))
        node_rng_a = random.Random(100 + seed)
        node_rng_b = random.Random(100 + seed)
        a = build_cluster(n_nodes=rng.randint(3, 8), rng=node_rng_a)
        b = build_cluster(n_nodes=len([n for n in a.nodes]),
                          rng=node_rng_b)
        lane = lane_of(a)
        for s in shapes:
            submit_job(a, **s)
            submit_job(b, **s)
        rep = lane.run_once()
        assert rep["placed"] > 0
        run_session(a)
        run_session(b)
        assert lane.counters["reverted"] == 0, lane.counters
        assert end_state(a) == end_state(b)

    def test_confirmed_binds_follow_serial_node_choice(self):
        cache_a = make_cache()
        cache_b = make_cache()
        for c in (cache_a, cache_b):
            c.add_node(build_node(
                "small", build_resource_list_with_pods("2", "4Gi", pods=64)))
            c.add_node(build_node(
                "big", build_resource_list_with_pods("32", "64Gi", pods=64)))
            c.add_queue(build_queue("default"))
        lane = lane_of(cache_a)
        submit_job(cache_a, "pick-1")
        submit_job(cache_b, "pick-1")
        assert lane.run_once()["placed"] == 1
        run_session(cache_a)
        run_session(cache_b)
        assert end_state(cache_a) == end_state(cache_b)


class TestRevertHygiene:
    def test_broken_gang_reverts_with_zero_residue(self):
        """A gang that loses a member in the optimistic window is reverted
        by the next session through the real evict machinery, and the
        reverted bind leaves no residue in cache, mirror, or dirty-sets.
        The port has no store: the member dies through cache.delete_pod,
        and the evicted survivor completes its termination the same way."""
        cache = make_cache()
        for n in range(3):
            cache.add_node(build_node(
                f"node-{n}", build_resource_list_with_pods("8", "16Gi",
                                                           pods=64)))
        cache.add_queue(build_queue("default"))
        lane = lane_of(cache)
        cache.add_pod_group(build_pod_group("gang-x", namespace="xp",
                                            min_member=2))
        pods = [build_pod("xp", f"gang-x-t{i}", "",
                          objects.POD_PHASE_PENDING,
                          {"cpu": "500m", "memory": "512Mi"}, "gang-x")
                for i in range(2)]
        for pod in pods:
            cache.add_pod(pod)
        rep = lane.run_once()
        assert rep["placed"] == 2
        # the optimistic window: one member dies before the next session
        cache.delete_pod(pods[0])
        run_session(cache)
        assert lane.counters["reverted"] == 1
        assert "xp/gang-x" in lane.denylist
        assert lane.outstanding == {}
        assert cache.evictor.evicts == ["xp/gang-x-t1"]
        # eviction completes: the evicted pod terminates
        cache.delete_pod(pods[1])
        job = cache.jobs.get("xp/gang-x")
        live = list(job.tasks.values()) if job is not None else []
        assert not [t for t in live if t.node_name], live
        cache.flush_mirror()
        for name in sorted(cache.nodes):
            node = cache.nodes[name]
            assert not node.tasks, (name, sorted(node.tasks))
            used = node.used
            assert used.milli_cpu == 0 and used.memory == 0
        # a denylisted job never re-enters the lane
        lane.note_arrival("xp/gang-x")
        rep = lane.run_once()
        assert rep["placed"] == 0

    def test_queue_overuse_is_reverted(self):
        cache = make_cache()
        cache.add_node(build_node(
            "n0", build_resource_list_with_pods("4", "8Gi", pods=64)))
        cache.add_queue(build_queue("greedy", weight=1))
        cache.add_queue(build_queue("other", weight=1))
        lane = lane_of(cache)
        cache.add_pod_group(build_pod_group(
            "resident", namespace="xp", min_member=1, queue="greedy"))
        cache.add_pod(build_pod(
            "xp", "resident-t0", "n0", objects.POD_PHASE_RUNNING,
            {"cpu": "3000m", "memory": "6Gi"}, "resident"))
        cache.add_pod_group(build_pod_group(
            "waiting", namespace="xp", min_member=1, queue="other"))
        cache.add_pod(build_pod(
            "xp", "waiting-t0", "", objects.POD_PHASE_PENDING,
            {"cpu": "2000m", "memory": "4Gi"}, "waiting"))
        cache.add_pod_group(build_pod_group(
            "burst", namespace="xp", min_member=1, queue="greedy"))
        cache.add_pod(build_pod(
            "xp", "burst-t0", "", objects.POD_PHASE_PENDING,
            {"cpu": "500m", "memory": "512Mi"}, "burst"))
        rep = lane.run_once()
        assert rep["placed"] >= 1
        run_session(cache, actions=("allocate",))
        assert lane.counters["reverted"] >= 1
        assert "xp/burst" in lane.denylist


class TestWarmPath:
    def test_repeat_arrivals_do_not_rebuild(self, monkeypatch):
        """After two warm batches no kernel library is built again, and
        each batch is one express_place call and one fetch (on the CPU
        the wrapper takes the plain version: the launch counter stays 0
        and the plain version is called once a batch)."""
        cache = build_cluster()
        lane = lane_of(cache)
        for i in range(2):
            submit_job(cache, f"warm-{i}")
            assert lane.run_once()["placed"] == 1
        builds = []
        monkeypatch.setattr(_build, "_start",
                            lambda name: builds.append(name))
        calls = []
        real = tplace.solve_express_plain

        def counted(*a, **kw):
            calls.append(1)
            return real(*a, **kw)

        monkeypatch.setattr(tplace, "solve_express_plain", counted)
        devmod.reset_launches()
        for i in range(4):
            submit_job(cache, f"hot-{i}")
            rep = lane.run_once()
            assert rep["placed"] == 1
            assert rep["profile"]["tpu_d2h_fetches"] == 1
            assert len(calls) == i + 1
        assert builds == []
        assert devmod.launches()["express_place"] == 0

    def test_dirty_rows_only_after_warm(self):
        cache = build_cluster()
        lane = lane_of(cache)
        submit_job(cache, "first")
        lane.run_once()
        assert lane.state.stats["rebuilds"] == 1
        submit_job(cache, "second")
        lane.run_once()
        assert lane.state.stats["rebuilds"] == 1
        assert lane.state.stats["row_patches"] >= 1
        assert lane.state.stats["patched_rows"] <= 2

    def test_patched_columns_equal_the_mirror(self):
        """K8's plain version patched the lane's standing columns in
        place: they equal the host mirror after every batch."""
        cache = build_cluster(n_nodes=8)
        lane = lane_of(cache)
        for i in range(5):
            submit_job(cache, f"j-{i}", tasks=1 + i % 2, min_member=1)
            lane.run_once()
            st = lane.state
            for k, dev in st.dev.items():
                want = torch.from_numpy(np.ascontiguousarray(st._mirror[k]))
                assert torch.equal(dev, want.to(dev.dtype)), k
        assert lane.state.stats["h2d_puts"] > 5


class TestEligibilityHonesty:
    def test_ineligible_arrivals_fall_through_to_session(self):
        cache = build_cluster(n_nodes=8)
        lane = lane_of(cache)
        submit_job(cache, "big-gang", tasks=6, min_member=6)
        submit_job(cache, "gpu", request_extra={"nvidia.com/gpu": "1"})
        submit_job(cache, "selector", node_selector={"zone": "zone-0"})
        submit_job(cache, "unadmitted",
                   phase=objects.PodGroupPhase.PENDING)
        rep = lane.run_once()
        assert rep["placed"] == 0
        assert lane.outstanding == {}
        reasons = rep["reasons"]
        assert reasons.get("gang_too_big") == 1
        assert reasons.get("scalar_resources") == 1
        assert reasons.get("constraints") == 1
        assert reasons.get("not_admitted") == 1
        run_session(cache)
        for name in ("big-gang", "selector", "unadmitted"):
            job = cache.jobs[f"xp/{name}"]
            assert all(t.node_name for t in job.tasks.values()), name
        assert lane.counters["reverted"] == 0

    def test_unknown_plugin_disables_lane(self):
        cache = build_cluster()
        lane = lane_of(cache)
        lane.set_tiers(make_tiers(["priority", "gang"], ["binpack"]))
        assert not lane.enabled
        submit_job(cache, "svc-1")
        rep = lane.run_once()
        assert rep["placed"] == 0
        assert rep["reasons"] == {"lane_disabled": 1}
        lane.set_tiers(make_tiers(*DEFAULT_TIERS))
        assert lane.enabled


def test_batch_failure_defers_and_feeds_the_breaker(monkeypatch):
    """A failing solve (as a kernel build or launch error would) defers
    the batch, counts one error and records a breaker failure — the
    lane's documented contract."""
    cache = build_cluster()
    lane = lane_of(cache)

    def boom(*a, **kw):
        raise RuntimeError("express_place kernel launch failed")

    monkeypatch.setattr(tplace, "solve_express", boom)
    submit_job(cache, "svc-1")
    rep = lane.run_once()
    assert rep["placed"] == 0 and rep["reasons"].get("error") == 1
    assert lane.counters["errors"] == 1
    assert lane.outstanding == {}
