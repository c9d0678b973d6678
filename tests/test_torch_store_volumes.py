"""StoreVolumeBinder, the cache's PV assume/bind effector, in the port
(volcano_tpu_torch/scheduler/cache/cache.py) against the JAX package's:
twins of every test in tests/test_volume_binder.py.

Each scenario builds its cluster through each package's own ``Store``
into a ``SchedulerCache(store=...)`` with ``run()`` (the volume binder
defaults to the store's), runs the same actions, and the two packages'
binds and PV/PVC end states must be equal, and equal to what the
reference test asserts. The rounds-mode residue test runs the port's
solve on the CPU in float64 and the JAX package's jitted (float64 under
the test conftest).

Tolerance: none; every comparison is exact.
"""

from __future__ import annotations

import importlib
import itertools
from types import SimpleNamespace

import pytest
import torch

TIERS = (["priority", "gang"], ["drf", "predicates", "proportion", "nodeorder"])


def _pkg(name):
    importlib.import_module(f"{name}.scheduler.actions")
    importlib.import_module(f"{name}.scheduler.plugins")
    mods = {
        "objects": "api.objects", "store": "store", "clock": "utils.clock",
        "cachemod": "scheduler.cache.cache", "tu": "scheduler.util.test_utils",
        "framework": "scheduler.framework", "clusters": "bench.clusters",
    }
    return SimpleNamespace(name=name, **{
        k: importlib.import_module(f"{name}.{v}") for k, v in mods.items()})


REF = _pkg("volcano_tpu")
PORT = _pkg("volcano_tpu_torch")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _both(scenario):
    seen = []
    for P in (REF, PORT):
        ticks = itertools.count(1)
        P.clock.set_source(lambda: float(next(ticks)))
        try:
            seen.append(scenario(P))
        finally:
            P.clock.set_source(None)
    assert seen[1] == seen[0]
    return seen[1]


def _pv(P, name, storage="10Gi", node_names=()):
    return P.objects.PersistentVolume(
        metadata=P.objects.ObjectMeta(name=name),
        capacity={"storage": storage}, node_names=list(node_names))


def _pvc(P, ns, name, storage="5Gi"):
    return P.objects.PersistentVolumeClaim(
        metadata=P.objects.ObjectMeta(name=name, namespace=ns),
        requests={"storage": storage})


def _cluster(P, nodes=2):
    tu = P.tu
    store = P.store.Store()
    cache = P.cachemod.SchedulerCache(
        store=store, binder=tu.FakeBinder(), evictor=tu.FakeEvictor(),
        status_updater=tu.FakeStatusUpdater())  # volume binder defaults: store
    cache.run()
    store.create(tu.build_queue("default"))
    for i in range(nodes):
        store.create(tu.build_node(
            f"n{i}", tu.build_resource_list_with_pods("8", "16Gi")))
    assert isinstance(cache.volume_binder, P.cachemod.StoreVolumeBinder)
    return store, cache


def _pod_with_pvc(P, ns, name, pvc_name, group):
    pod = P.tu.build_pod(ns, name, "", "Pending", {"cpu": "1"}, group)
    pod.spec.volumes.append(P.objects.Volume(
        name="data", persistent_volume_claim=pvc_name))
    return pod


def _schedule(P, cache, tiers=None):
    fw = P.framework
    ssn = fw.open_session(cache, tiers or P.clusters.make_tiers(*TIERS))
    for action in ("enqueue", "allocate", "backfill"):
        fw.get_action(action).execute(ssn)
    fw.close_session(ssn)


def _volumes(store):
    return ([(v.metadata.name, v.phase, v.claim_ref)
             for v in store.list("PersistentVolume")],
            [(c.metadata.name, c.phase, c.volume_name)
             for c in store.list("PersistentVolumeClaim")])


def test_assume_and_bind_commits_pv_pvc():
    def scenario(P):
        store, cache = _cluster(P)
        store.create(_pv(P, "pv-a", "10Gi"))
        store.create(_pvc(P, "default", "claim-a"))
        store.create(P.tu.build_pod_group("pg", min_member=1))
        store.create(_pod_with_pvc(P, "default", "p0", "claim-a", "pg"))
        _schedule(P, cache)
        return dict(cache.binder.binds), _volumes(store)

    binds, (pvs, pvcs) = _both(scenario)
    assert len(binds) == 1
    assert pvs == [("pv-a", "Bound", "default/claim-a")]
    assert pvcs == [("claim-a", "Bound", "pv-a")]


def test_local_volume_constrains_host():
    def scenario(P):
        store, cache = _cluster(P, nodes=3)
        store.create(_pv(P, "pv-local", "10Gi", node_names=["n1"]))
        store.create(_pvc(P, "default", "claim-l"))
        store.create(P.tu.build_pod_group("pg", min_member=1))
        store.create(_pod_with_pvc(P, "default", "p0", "claim-l", "pg"))
        _schedule(P, cache)
        return dict(cache.binder.binds), _volumes(store)

    binds, (pvs, pvcs) = _both(scenario)
    if binds:  # bound => it MUST be the volume's node
        assert binds == {"default/p0": "n1"}
        assert pvs[0][1] == "Bound"
    else:  # chosen host mismatched: allocation failed, nothing half-bound
        assert pvs[0][1] == "Available" and pvcs[0][1] == "Pending"


def test_smallest_sufficient_volume_wins():
    def scenario(P):
        store, cache = _cluster(P)
        store.create(_pv(P, "pv-big", "100Gi"))
        store.create(_pv(P, "pv-small", "6Gi"))
        store.create(_pvc(P, "default", "claim-s", "5Gi"))
        store.create(P.tu.build_pod_group("pg", min_member=1))
        store.create(_pod_with_pvc(P, "default", "p0", "claim-s", "pg"))
        _schedule(P, cache)
        return dict(cache.binder.binds), _volumes(store)

    binds, (pvs, pvcs) = _both(scenario)
    assert len(binds) == 1
    assert pvcs == [("claim-s", "Bound", "pv-small")]
    assert ("pv-big", "Available", "") in pvs


def test_no_fitting_volume_blocks_placement():
    def scenario(P):
        store, cache = _cluster(P)
        store.create(_pv(P, "pv-tiny", "1Gi"))
        store.create(_pvc(P, "default", "claim-x", "50Gi"))
        store.create(P.tu.build_pod_group("pg", min_member=1))
        store.create(_pod_with_pvc(P, "default", "p0", "claim-x", "pg"))
        _schedule(P, cache)
        return dict(cache.binder.binds), _volumes(store)

    binds, (pvs, _) = _both(scenario)
    assert "default/p0" not in binds
    assert pvs == [("pv-tiny", "Available", "")]


def test_two_claims_cannot_share_one_volume():
    def scenario(P):
        store, cache = _cluster(P)
        store.create(_pv(P, "pv-only", "10Gi"))
        store.create(_pvc(P, "default", "claim-1"))
        store.create(_pvc(P, "default", "claim-2"))
        store.create(P.tu.build_pod_group("pg", min_member=1))
        store.create(_pod_with_pvc(P, "default", "p1", "claim-1", "pg"))
        store.create(_pod_with_pvc(P, "default", "p2", "claim-2", "pg"))
        _schedule(P, cache)
        return dict(cache.binder.binds), _volumes(store)

    binds, (pvs, _) = _both(scenario)
    assert len(binds) == 1, binds  # exactly one pod got the volume
    assert pvs[0][1] == "Bound"


def test_pvc_pods_take_residue_under_rounds_mode():
    """PVC-referencing pods are left to the serial residue pass; plain
    pods are placed by the rounds solve (the port's on the CPU in
    float64), volumes bound, in the same session."""
    def scenario(P):
        store, cache = _cluster(P, nodes=3)
        store.create(_pv(P, "pv-r", "10Gi"))
        store.create(_pvc(P, "default", "claim-r"))
        store.create(P.tu.build_pod_group("pg", min_member=1))
        store.create(_pod_with_pvc(P, "default", "pv-pod", "claim-r", "pg"))
        for i in range(6):
            store.create(P.tu.build_pod("default", f"plain-{i}", "", "Pending",
                                        {"cpu": "1"}, "pg"))
        args = {}
        if P is PORT:
            args = {"tpuscore.device": "cpu", "tpuscore.dtype": "float64"}
        tiers = P.clusters.make_tiers(["tpuscore"], *TIERS,
                                      arguments={"tpuscore": args})
        fw = P.framework
        ssn = fw.open_session(cache, tiers)
        assert ssn.batch_allocator is not None
        ssn.batch_allocator.mode = "rounds"
        for action in ("enqueue", "allocate", "backfill"):
            fw.get_action(action).execute(ssn)
        prof = dict(ssn.plugins["tpuscore"].profile)
        fw.close_session(ssn)
        return (prof.get("mode"), prof.get("residue"), prof.get("placed"),
                dict(cache.binder.binds), _volumes(store))

    mode, residue, _, binds, (pvs, pvcs) = _both(scenario)
    assert mode == "rounds"
    assert residue >= 1  # the PVC pod went serial
    assert len(binds) == 7, binds
    assert pvs == [("pv-r", "Bound", "default/claim-r")]
    assert pvcs == [("claim-r", "Bound", "pv-r")]


def test_pvc_free_sessions_keep_native_bulk_path():
    def scenario(P):
        store, cache = _cluster(P)
        store.create(P.tu.build_pod_group("pg", min_member=2))
        for i in range(2):
            store.create(P.tu.build_pod("default", f"p{i}", "", "Pending",
                                        {"cpu": "1"}, "pg"))
        counts = [cache._pvc_pod_count]
        store.create(_pvc(P, "default", "c"))
        store.create(_pod_with_pvc(P, "default", "pv-pod", "c", "pg"))
        counts.append(cache._pvc_pod_count)
        store.delete("Pod", "default", "pv-pod")
        counts.append(cache._pvc_pod_count)
        return counts

    assert _both(scenario) == [0, 1, 0]
