"""The standing device replica (volcano_tpu_torch/ops/replica.py) against
the replica-off oracle and against the JAX package's replica.

The replica must be a pure transport: with it on (the default) every
session's binds equal the replica-off twin's (``VOLCANO_TPU_REPLICA=0``)
and the standing tensors equal the host mirror (the padded+cast staging
input) bit for bit after every session, across randomized churn, every
rebuild reason and the fused chain. Beside the twins of
tests/test_device_replica.py (all but the mesh suites: the port runs on
one device), the same churn runs through the JAX package's replica and
the port's on twin clusters, and both must count the same serves,
rebuild reasons, scatters and reuses. The port does not adopt a fused
chain's carry (the reference's adoption is at fault, ROADMAP Queue 3):
after a preempt-terminal chain it equals replica-off, where the JAX
package's adopting replica does not.

The port runs on the CPU in float64 (K8's wrapper takes its plain
version, ``index_copy_``), the JAX package in float64 under the test
conftest. Tolerance: none; every comparison is exact.
"""

from __future__ import annotations

import importlib
import os
import random
from contextlib import contextmanager

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volcano_tpu.scheduler.actions  # noqa: F401 (register actions)
import volcano_tpu.scheduler.plugins  # noqa: F401 (register plugins)
from volcano_tpu.bench import clusters as jclusters
from volcano_tpu.ops import replica as jreplica
from volcano_tpu.scheduler import framework as jframework

import volcano_tpu_torch.scheduler.actions  # noqa: F401 (register actions)
import volcano_tpu_torch.scheduler.plugins  # noqa: F401 (register plugins)
from tests.test_torch_evict import overcommit_cluster
from volcano_tpu_torch import _build
from volcano_tpu_torch import device as devmod
from volcano_tpu_torch.bench import clusters as tclusters
from volcano_tpu_torch.ops import replica as treplica
from volcano_tpu_torch.scheduler import framework as tframework

PKGS = {"jax": (jclusters, jframework), "torch": (tclusters, tframework)}
DEFAULT_TIERS = (["priority", "gang"],
                 ["drf", "predicates", "proportion", "nodeorder"])
CPU64 = {"tpuscore.device": "cpu", "tpuscore.dtype": "float64"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@contextmanager
def _env(**kv):
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _tu(pkg):
    name = "volcano_tpu" if pkg == "jax" else "volcano_tpu_torch"
    return (importlib.import_module(name + ".api.objects"),
            importlib.import_module(name + ".scheduler.util.test_utils"))


def session(cache, pkg="torch", replica="1", actions=("allocate",),
            tiers=DEFAULT_TIERS):
    """One session in rounds mode (allocate alone through the action, as
    tests/test_device_replica.py drives it; a chain through
    run_actions); returns the tpuscore profile."""
    clusters, framework = PKGS[pkg]
    args = dict(CPU64 if pkg == "torch" else {}, **{"tpuscore.mode": "rounds"})
    with _env(VOLCANO_TPU_REPLICA=replica):
        ssn = framework.open_session(cache, clusters.make_tiers(
            ["tpuscore"], *tiers, arguments={"tpuscore": args}))
        try:
            if tuple(actions) == ("allocate",):
                framework.get_action("allocate").execute(ssn)
            else:
                framework.run_actions(ssn, list(actions))
            prof = dict(ssn.plugins["tpuscore"].profile)
        finally:
            framework.close_session(ssn)
    return prof


def populate_small(c, pkg, groups=6, nodes=5):
    objects, tu = _tu(pkg)
    c.add_queue(tu.build_queue("default"))
    for g in range(groups):
        pg = f"pg-{g:03d}"
        c.add_pod_group(tu.build_pod_group(pg, namespace="ns", min_member=2))
        for i in range(4):
            c.add_pod(tu.build_pod(
                "ns", f"{pg}-t{i}", "", objects.POD_PHASE_PENDING,
                tu.build_resource_list("500m", "512Mi"), pg))
    for n in range(nodes):
        c.add_node(tu.build_node(
            f"node-{n:03d}", tu.build_resource_list_with_pods("8", "16Gi",
                                                              pods=64)))


def populate_over(c, pkg, groups=20, nodes=24, node_cpu="1"):
    """Demand >> capacity: every session keeps a pending backlog, so the
    solver encodes (and the replica serves) every single session."""
    objects, tu = _tu(pkg)
    c.add_queue(tu.build_queue("default"))
    for g in range(groups):
        pg = f"pg-{g:03d}"
        c.add_pod_group(tu.build_pod_group(pg, namespace="ns", min_member=2))
        for i in range(4):
            c.add_pod(tu.build_pod(
                "ns", f"{pg}-t{i}", "", objects.POD_PHASE_PENDING,
                tu.build_resource_list("500m", "256Mi"), pg))
    for n in range(nodes):
        c.add_node(tu.build_node(
            f"node-{n:03d}",
            tu.build_resource_list_with_pods(node_cpu, "16Gi", pods=64)))


def populate_overcommitted(c, pkg):
    objects, tu = _tu(pkg)
    c.add_queue(tu.build_queue("default"))
    for g in range(20):
        pg = f"job-{g:04d}"
        c.add_pod_group(tu.build_pod_group(pg, namespace="bench",
                                           min_member=2))
        for i in range(4):
            c.add_pod(tu.build_pod(
                "bench", f"{pg}-t{i}", "", objects.POD_PHASE_PENDING,
                tu.build_resource_list("2", "2Gi"), pg))
    for n in range(4):
        c.add_node(tu.build_node(
            f"node-{n:03d}",
            tu.build_resource_list_with_pods("8", "32Gi", pods=64)))


def upd_node(caches, name, cpu):
    """Capacity update of ONE existing node on every twin (each cache
    with its own package's objects)."""
    for pkg, c in caches:
        _, tu = _tu(pkg)
        c.add_node(tu.build_node(
            name, tu.build_resource_list_with_pods(cpu, "16Gi", pods=64)))


def assert_device_matches_mirror(rep, ctx="", skip=()):
    """The standing tensors equal the host mirror bit for bit — the
    mirror is by construction the oracle's padded+cast staging input."""
    assert rep.dev, ctx
    for name, dev in rep.dev.items():
        if name in skip:
            continue
        want = torch.from_numpy(np.ascontiguousarray(rep.mirror[name]))
        assert torch.equal(dev.cpu(), want), f"{ctx}: {name}"


def random_delta(rng, caches, state):
    """One random watch delta applied to every twin (the churn of
    tests/test_snapshot_incremental.py TestChurnParity)."""
    op = rng.choice(["add_pod", "add_pod", "del_pod", "rebind_pod",
                     "add_group", "upd_node", "add_node", "del_node"])
    state["seq"] += 1
    if op == "add_pod" and state["groups"]:
        pg = rng.choice(state["groups"])
        name = f"{pg}-x{state['seq']}"
        cpu = f"{rng.choice([250, 500])}m"
        for pkg, c in caches:
            objects, tu = _tu(pkg)
            c.add_pod(tu.build_pod("ns", name, "", objects.POD_PHASE_PENDING,
                                   tu.build_resource_list(cpu, "256Mi"), pg))
        state["pods"].append(("ns", name, pg))
    elif op == "del_pod" and state["pods"]:
        ns, name, pg = state["pods"].pop(rng.randrange(len(state["pods"])))
        for pkg, c in caches:
            job = c.jobs.get(f"{ns}/{pg}")
            task = None if job is None else next(
                (t for t in job.tasks.values() if t.name == name), None)
            if task is not None and task.pod is not None:
                c.delete_pod(task.pod)
    elif op == "rebind_pod" and state["pods"] and state["nodes"]:
        ns, name, pg = rng.choice(state["pods"])
        node = rng.choice(state["nodes"])
        for pkg, c in caches:
            objects, tu = _tu(pkg)
            job = c.jobs.get(f"{ns}/{pg}")
            task = None if job is None else next(
                (t for t in job.tasks.values() if t.name == name), None)
            if task is not None and task.pod is not None:
                old = task.pod
                new = tu.build_pod(ns, name, node, objects.POD_PHASE_RUNNING,
                                   tu.build_resource_list("250m", "256Mi"), pg)
                new.metadata.uid = old.metadata.uid
                new.metadata.creation_timestamp = \
                    old.metadata.creation_timestamp
                c.update_pod_from_watch(old, new)
    elif op == "add_group":
        pg = f"pg-n{state['seq']}"
        for pkg, c in caches:
            _, tu = _tu(pkg)
            c.add_pod_group(tu.build_pod_group(pg, namespace="ns",
                                               min_member=1))
        state["groups"].append(pg)
    elif op == "upd_node" and state["nodes"]:
        upd_node(caches, rng.choice(state["nodes"]), rng.choice(["8", "12"]))
    elif op == "add_node":
        name = f"node-n{state['seq']}"
        upd_node(caches, name, "8")
        state["nodes"].append(name)
    elif op == "del_node" and len(state["nodes"]) > 2:
        name = state["nodes"].pop(rng.randrange(len(state["nodes"])))
        for pkg, c in caches:
            nd = c.nodes.get(name)
            if nd is not None and nd.node is not None:
                c.delete_node(nd.node)


def _churn_state(groups, nodes):
    return {"groups": [f"pg-{g:03d}" for g in range(groups)],
            "nodes": [f"node-{n:03d}" for n in range(nodes)],
            "pods": [("ns", f"pg-{g:03d}-t{i}", f"pg-{g:03d}")
                     for g in range(groups) for i in range(4)],
            "seq": 0}


def _counted(stats):
    return {k: stats[k] for k in ("serves", "scatters", "scatter_rows",
                                  "rebuilds", "encode_reuses",
                                  "witness_violations")}


# ---------------------------------------------------------------------------
# K8: the row scatter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dirty", [[3], [0, 5, 9], list(range(0, 40, 2))])
def test_scatter_rows_matches_reference_with_padded_duplicates(dirty):
    """scatter_rows (the plain version, index_copy_) writes the node
    family in place exactly as the JAX at[idx].set does, with the index
    padded by repeating its first row."""
    rng = np.random.default_rng(len(dirty))
    n = 40
    host = {"node_idle": rng.random((n, 2)), "node_used": rng.random((n, 2)),
            "node_alloc": rng.random((n, 2)),
            "node_cnt": rng.integers(0, 9, n).astype(np.int32),
            "node_max_tasks": rng.integers(0, 9, n).astype(np.int32),
            "ok": rng.random(n) > 0.5}
    idx = treplica.bucket_pad_rows(dirty)
    assert np.array_equal(idx, jreplica.bucket_pad_rows(dirty))
    assert len(idx) in (16, 32) and len(idx) >= len(dirty)
    assert (idx[:len(idx) - len(dirty)] == dirty[0]).all()
    rows = {k: np.ascontiguousarray(
        (rng.random((len(dirty),) + v.shape[1:]) * 7).astype(v.dtype))
        for k, v in host.items()}
    rows = {k: v[np.r_[[0] * (len(idx) - len(dirty)), np.arange(len(dirty))]]
            for k, v in rows.items()}
    want = jreplica.scatter_rows({k: jnp.asarray(v) for k, v in host.items()},
                                 jnp.asarray(idx), rows)
    dev = {k: torch.from_numpy(v.copy()) for k, v in host.items()}
    got = treplica.scatter_rows(dev, idx, rows)
    assert got is dev
    for k in host:
        assert torch.equal(dev[k], torch.from_numpy(np.array(want[k]))), k
    assert devmod.launches()["scatter_rows"] == 0
    assert "scatter_rows" in _build.KERNELS


# ---------------------------------------------------------------------------
# churn fuzz: replica == replica-off oracle, port == JAX
# ---------------------------------------------------------------------------

class TestChurnFuzzParity:
    N_STEPS = 18

    def test_replica_matches_oracle_under_churn(self):
        rng = random.Random(23)
        a, b = tclusters.make_cache(), tclusters.make_cache()
        for c in (a, b):
            populate_small(c, "torch", groups=8, nodes=12)
        state = _churn_state(8, 12)
        for step in range(self.N_STEPS):
            for _ in range(rng.randrange(4)):
                random_delta(rng, (("torch", a), ("torch", b)), state)
            if step % 3 == 2:
                session(a, replica="1")
                session(b, replica="0")
                assert a.binder.binds == b.binder.binds, f"step {step}"
                assert_device_matches_mirror(a._device_replica,
                                             ctx=f"step {step}")
        assert not hasattr(b, "_device_replica")
        rep = a._device_replica
        assert rep.stats["serves"] > 0
        assert rep.stats["rebuilds"].get("cold") == 1

    @pytest.mark.parametrize("seed", [23, 5])
    def test_port_replica_matches_jax_replica_under_churn(self, seed):
        rng = random.Random(seed)
        caches = {pkg: PKGS[pkg][0].make_cache() for pkg in PKGS}
        for pkg, c in caches.items():
            populate_small(c, pkg, groups=8, nodes=12)
        state = _churn_state(8, 12)
        pairs = tuple(caches.items())
        for step in range(12):
            for _ in range(rng.randrange(4)):
                random_delta(rng, pairs, state)
            if step % 2 == 1:
                profs = {pkg: session(c, pkg) for pkg, c in caches.items()}
                assert caches["torch"].binder.binds == \
                    caches["jax"].binder.binds, step
                for key in ("encode_reused", "replica_scatter_rows",
                            "replica_rebuilds", "mode"):
                    assert profs["torch"].get(key) == profs["jax"].get(key), \
                        (step, key)
                assert_device_matches_mirror(caches["torch"]._device_replica,
                                             ctx=f"step {step}")
        assert _counted(caches["torch"]._device_replica.stats) == \
            _counted(caches["jax"]._device_replica.stats)


class TestScatterPath:
    def test_single_row_churn_scatters(self):
        cache = tclusters.make_cache()
        populate_over(cache, "torch", groups=20, nodes=24, node_cpu="1")
        p1 = session(cache)
        assert p1.get("mode") == "rounds", p1
        rep = cache._device_replica
        assert rep.stats["rebuilds"].get("cold") == 1
        session(cache)
        before = dict(rep.stats["rebuilds"])
        scattered = rep.stats["scatter_rows"]
        upd_node([("torch", cache)], "node-023", "2")
        p2 = session(cache)
        after = rep.stats["rebuilds"]
        for k in ("cold", "generation", "dense:node"):
            assert after.get(k, 0) == before.get(k, 0), after
        assert rep.stats["scatters"] >= 1
        assert p2.get("replica_scatter_rows", 0) >= 1
        assert rep.stats["scatter_rows"] > scattered
        assert "tpu_replica_scatter_ms" in p2
        assert p2["tpu_overlappable_dispatches"] >= 1
        assert_device_matches_mirror(rep, ctx="post-scatter")

    def test_bulk_churn_goes_dense_honestly(self):
        cache = tclusters.make_cache()
        populate_over(cache, "torch", groups=10, nodes=5, node_cpu="2")
        session(cache)
        session(cache)
        rep = cache._device_replica
        upd_node([("torch", cache)] * 1, "node-000", "3")
        for n in range(1, 4):
            upd_node([("torch", cache)], f"node-{n:03d}", "3")
        session(cache)
        assert rep.stats["rebuilds"].get("dense:node", 0) >= 1
        assert_device_matches_mirror(rep, ctx="post-dense")


class TestSteadyStateReuse:
    def test_unchanged_sessions_reuse_whole_encode(self, monkeypatch):
        """Unchanged overcommitted backlog: the whole prepare is reused
        with zero h2d puts and no kernel build, as in the JAX package."""
        caches = {pkg: PKGS[pkg][0].make_cache() for pkg in PKGS}
        for pkg, c in caches.items():
            populate_overcommitted(c, pkg)
        for pkg, c in caches.items():
            p1 = session(c, pkg)
            assert p1.get("mode") == "rounds", p1
            assert p1["h2d_puts"] > 0
            binds1 = dict(c.binder.binds)
            assert binds1
            session(c, pkg)
            assert dict(c.binder.binds) == binds1
        builds = []
        monkeypatch.setattr(_build, "_start", lambda name: builds.append(name))
        for _ in range(2):
            profs = {pkg: session(c, pkg) for pkg, c in caches.items()}
            for pkg, p in profs.items():
                assert p.get("encode_reused") is True, (pkg, p)
                assert p.get("h2d_puts") == 0, (pkg, p)
            assert profs["torch"]["replica_epoch"] == \
                profs["jax"]["replica_epoch"]
        assert builds == []
        assert caches["torch"].binder.binds == caches["jax"].binder.binds
        assert _counted(caches["torch"]._device_replica.stats) == \
            _counted(caches["jax"]._device_replica.stats)
        assert caches["torch"]._device_replica.stats["encode_reuses"] >= 2

    def test_flag_off_disables_and_restores(self):
        cache = tclusters.make_cache()
        populate_overcommitted(cache, "torch")
        session(cache)
        session(cache)
        p_off = session(cache, replica="0")
        assert "encode_reused" not in p_off
        assert "replica_epoch" not in p_off
        p_on = session(cache)
        assert p_on.get("encode_reused") is True \
            or "replica_epoch" in p_on, p_on
        assert not treplica.enabled() or os.environ.get(
            "VOLCANO_TPU_REPLICA", "1") != "0"


class TestFallbackReasons:
    def _twins(self, pkg):
        clusters = PKGS[pkg][0]
        a, b = clusters.make_cache(), clusters.make_cache()
        for c in (a, b):
            populate_over(c, pkg, groups=12, nodes=5, node_cpu="2")
        return a, b

    def _ladder(self, pkg):
        """tests/test_device_replica.py's reason ladder on one package;
        returns the replica's rebuild reasons after each rung."""
        a, b = self._twins(pkg)
        seen = []

        def step(ctx):
            session(a, pkg, replica="1")
            session(b, pkg, replica="0")
            assert a.binder.binds == b.binder.binds, (pkg, ctx)
            seen.append(dict(a._device_replica.stats["rebuilds"]))

        step("cold")
        rep = a._device_replica
        _, tu = _tu(pkg)
        for c in (a, b):
            c.add_queue(tu.build_queue("burst"))
        step("generation")
        for c in (a, b):
            c.set_fence_epoch(7)
        step("fence")
        rep._node_names = list(reversed(rep._node_names))
        rep.forget_prepare()
        step("axis")
        rep.mirror["node_used"] = rep.mirror["node_used"][:-1]
        rep.forget_prepare()
        step("shape")
        return a, b, seen

    def test_reason_ladder_keeps_parity(self):
        a, b, seen = self._ladder("torch")
        rep = a._device_replica
        assert seen[0] == {"cold": 1}
        assert seen[1].get("generation") == 1
        assert seen[2].get("fence") == 1
        assert seen[3].get("axis") == 1
        assert any(k.startswith("error:") or k == "shape" for k in seen[4])
        assert_device_matches_mirror(rep, ctx="post-ladder")

    def test_reason_ladder_matches_reference(self):
        """The port's rebuild reasons equal the JAX replica's rung by rung
        (the port's "device" rung replaces "mesh", which no rung trips)."""
        _, _, want = self._ladder("jax")
        _, _, got = self._ladder("torch")
        assert got == want

    def test_device_rung_replaces_mesh(self):
        """A serve on another (device, dtype) than the standing tensors
        restages wholesale under the "device" reason."""
        cache = tclusters.make_cache()
        populate_over(cache, "torch", groups=12, nodes=5, node_cpu="2")
        session(cache)
        rep = cache._device_replica
        rep._place = (torch.device("cpu"), torch.float32)
        rep.forget_prepare()
        session(cache)
        assert rep.stats["rebuilds"].get("device") == 1
        assert_device_matches_mirror(rep, ctx="post-device")

    def test_donated_rung_catches_an_in_place_write(self):
        """The in-place invariant: a consumer that wrote a standing tensor
        in place is caught by the version counter and healed by a
        rebuild."""
        cache = tclusters.make_cache()
        populate_over(cache, "torch", groups=12, nodes=8, node_cpu="1")
        session(cache)
        rep = cache._device_replica
        rep.dev["node_alloc"][0, 0] += 1.0
        rep.forget_prepare()
        session(cache)
        assert rep.stats["rebuilds"].get("donated") == 1
        assert_device_matches_mirror(rep, ctx="healed")

    def test_donated_rung_compares_content_under_the_witness(self):
        """A write that leaves no version trace (as a kernel writing
        through a raw pointer would) is caught by the witness's content
        check on the rows the host left alone."""
        with _env(VOLCANO_TPU_WITNESS="1"):
            cache = tclusters.make_cache()
            populate_over(cache, "torch", groups=12, nodes=8, node_cpu="1")
            session(cache)
            rep = cache._device_replica
            rep.dev["node_alloc"][0, 0] += 1.0
            rep._seal(["node_alloc"])
            rep.forget_prepare()
            session(cache)
            assert rep.stats["rebuilds"].get("donated") == 1
            assert rep.stats["witness_violations"] == 0
            assert_device_matches_mirror(rep, ctx="healed")


class TestWitnessMode:
    def test_marked_churn_is_fully_explained(self):
        with _env(VOLCANO_TPU_WITNESS="1"):
            cache = tclusters.make_cache()
            populate_over(cache, "torch", groups=16, nodes=12, node_cpu="1")
            session(cache)
            rep = cache._device_replica
            for step in range(3):
                upd_node([("torch", cache)], f"node-{step:03d}", "2")
                session(cache)
            assert rep.stats["witness_violations"] == 0
            assert not any(k.startswith("error:")
                           for k in rep.stats["rebuilds"])
            assert_device_matches_mirror(rep, ctx="witnessed")

    def test_unexplained_divergence_is_detected_and_healed(self):
        with _env(VOLCANO_TPU_WITNESS="1"):
            cache = tclusters.make_cache()
            populate_over(cache, "torch", groups=12, nodes=8, node_cpu="1")
            session(cache)
            session(cache)
            rep = cache._device_replica
            rep.mirror["node_used"] = rep.mirror["node_used"].copy()
            rep.mirror["node_used"][0] += 1
            rep.forget_prepare()
            session(cache)
            assert rep.stats["witness_violations"] >= 1
            assert rep.stats["rebuilds"].get("error:WitnessViolation") == 1
            assert_device_matches_mirror(rep, ctx="healed")
            session(cache)
            assert rep.stats["witness_violations"] == 1


# ---------------------------------------------------------------------------
# fused sessions: standing tensors == mirror, and no carry adoption
# ---------------------------------------------------------------------------

EVICT_TIERS = (["priority", "gang"], ["drf", "predicates", "proportion",
                                      "nodeorder"])
PREEMPT_TERMINAL = ("allocate", "backfill", "preempt")


def _fused_twins(seed):
    return {pkg: overcommit_cluster(PKGS[pkg][0], seed) for pkg in PKGS}


@contextmanager
def _own_cursor(cache, pkg):
    """Run with ``cache``'s own round-robin cursor: scheduler_helper keeps
    one per process, and twin caches must not share it."""
    name = "volcano_tpu" if pkg == "jax" else "volcano_tpu_torch"
    helper = importlib.import_module(name + ".scheduler.util.scheduler_helper")
    saved = helper._last_processed_node_index
    helper._last_processed_node_index = getattr(cache, "_rr", 0)
    try:
        yield
    finally:
        cache._rr = helper._last_processed_node_index
        helper._last_processed_node_index = saved


@pytest.mark.parametrize("seed", [11, 42])
def test_fused_chain_keeps_mirror_and_matches_replica_off(seed, monkeypatch):
    """cfg4-shaped four-stage chain: the replica-fed session equals the
    replica-off one in binds and evictions, and the standing tensors equal
    the mirror after each session."""
    monkeypatch.setenv("VOLCANO_TPU_FUSE", "1")
    chain = ("allocate", "backfill", "preempt", "reclaim")
    on = overcommit_cluster(tclusters, seed)
    off = overcommit_cluster(tclusters, seed)
    for k in range(2):
        p_on = session(on, actions=chain, tiers=EVICT_TIERS)
        session(off, replica="0", actions=chain, tiers=EVICT_TIERS)
        # the second session holds releasing capacity: the reference's
        # envelope runs it per-action
        assert k or p_on.get("fuse") == 1, p_on.get("fuse_fallback")
        assert on.binder.binds == off.binder.binds
        assert on.evictor.evicts == off.evictor.evicts
        assert_device_matches_mirror(on._device_replica, ctx="fused")


@pytest.mark.parametrize("seed", [11, 42, 7])
def test_preempt_terminal_chain_matches_replica_off(seed, monkeypatch):
    """A chain that ends at preempt, then an allocate session: the fused
    chain equals the JAX package's (binds, evictions, replica counts), and
    both sessions equal replica-off; the standing tensors equal the mirror
    after each (the chain hands the replica no carry)."""
    monkeypatch.setenv("VOLCANO_TPU_FUSE", "1")
    caches = _fused_twins(seed)
    off = overcommit_cluster(tclusters, seed)
    for pkg, c in caches.items():
        with _own_cursor(c, pkg):
            prof = session(c, pkg, actions=PREEMPT_TERMINAL,
                           tiers=EVICT_TIERS)
        assert prof.get("fuse") == 1, (pkg, prof.get("fuse_fallback"))
        assert prof.get("fuse_stages") == list(PREEMPT_TERMINAL)
    with _own_cursor(off, "torch"):
        session(off, replica="0", actions=PREEMPT_TERMINAL, tiers=EVICT_TIERS)
    on = caches["torch"]
    assert on.binder.binds == caches["jax"].binder.binds == off.binder.binds
    assert on.evictor.evicts == caches["jax"].evictor.evicts \
        == off.evictor.evicts
    rep = on._device_replica
    assert _counted(rep.stats) == \
        _counted(caches["jax"]._device_replica.stats)
    assert_device_matches_mirror(rep, ctx="after the chain")
    with _own_cursor(on, "torch"):
        session(on, tiers=EVICT_TIERS)
    with _own_cursor(off, "torch"):
        session(off, replica="0", tiers=EVICT_TIERS)
    assert on.binder.binds == off.binder.binds
    assert on.evictor.evicts == off.evictor.evicts
    assert_device_matches_mirror(rep, ctx="after the next serve")


def test_adoption_keeps_the_host_truth(monkeypatch):
    """cfg4 at 0.02, a preempt-terminal chain then an allocate session,
    in four twins: each package with the replica on and off. The JAX
    package adopts the chain's carry, skips the rows it placed on, and
    its next session then differs from its own replica-off run (its
    adopted carry holds preempt's pipelined requests and leaves node_idle
    of those rows stale, so it places on capacity that is gone; ROADMAP
    Queue 3). The port takes no carry: its replica-on run equals both
    replica-off runs, and every standing tensor equals the mirror."""
    monkeypatch.setenv("VOLCANO_TPU_FUSE", "1")
    twins = {(pkg, on): PKGS[pkg][0].build_config(4, 0.02)[0]
             for pkg in PKGS for on in ("1", "0")}
    tiers = tclusters.CONFIGS[4].tiers
    for actions in (PREEMPT_TERMINAL, ("allocate",)):
        for (pkg, on), c in twins.items():
            with _own_cursor(c, pkg):
                session(c, pkg, replica=on, actions=actions, tiers=tiers)
    binds = {k: c.binder.binds for k, c in twins.items()}
    evicts = {k: c.evictor.evicts for k, c in twins.items()}
    jrep = twins["jax", "1"]._device_replica
    assert jrep.stats["adoptions"] == 1
    assert jrep.stats["adopt_rows_skipped"] > 0
    # the reference's adopting replica leaves its own replica-off run
    assert binds["jax", "1"] != binds["jax", "0"]
    # the port sides with replica-off, in both packages
    assert binds["torch", "1"] == binds["torch", "0"] == binds["jax", "0"]
    assert evicts["torch", "1"] == evicts["torch", "0"] == evicts["jax", "0"]
    assert_device_matches_mirror(twins["torch", "1"]._device_replica,
                                 ctx="after the next serve")


def test_some_seed_adopts():
    """At least one preempt-terminal cluster above is one the JAX package
    adopts the carry from, so the replica-off equality there covers the
    case the port trims."""
    adopted = 0
    for seed in (11, 42, 7):
        with _env(VOLCANO_TPU_FUSE="1"):
            c = overcommit_cluster(jclusters, seed)
            with _own_cursor(c, "jax"):
                session(c, "jax", actions=PREEMPT_TERMINAL, tiers=EVICT_TIERS)
            adopted += c._device_replica.stats["adoptions"]
    assert adopted > 0
