"""Store-backed scheduling sessions: the port against the JAX package.

A small cfg2 (x 0.05: 250 tasks, 50 nodes) is written into each
package's own ``Store`` by that package's ``bench/clusters.py`` generator
(a thin writer whose ``add_*`` calls ``store.create``), so the objects
reach a ``SchedulerCache(store=...)`` only through its watches. One
rounds-mode allocate session runs in each (the port on the CPU in
float64, the JAX package jitted, float64 under the test conftest); the
default effectors bind by writing ``spec.node_name`` back into the store
and the solver records the Scheduled events.

- The two stores' ``spec.node_name`` maps are equal, and equal to the
  binds of a fed twin (the same generator into a ``FakeBinder`` cache);
  the Scheduled event keys are the binds in bind order, in both.
- A second session binds nothing new.
- Fenced: with the store's fence advanced past the cache's epoch, both
  packages reject every bind with ``FencedError`` and count the same
  ``fence_stats["rejected"]`` and ``fenced_rejections``. In-process the
  rejected binds still leave ``spec.node_name`` on the store's pods (the
  binder writes the canonical object before the store refuses it), so
  after resync the tasks read as bound in both packages: a reference
  fault, pinned here on both sides (ROADMAP Queue 3). Through the gateway
  the client's pods are copies, and the tasks are pending after resync
  in both.
- Through an ``ApiGateway`` and a ``RemoteStore``, the server store's
  binds and events equal the in-process session's, with no watch reset.
- The express lane over a fenced store: the first bind of a batch
  raises ``FencedError``, the commit stops the batch and parks the lane
  (``lease_lost``), the same in both packages.

Both sides pin ``utils/clock`` to one counter while the cluster is
written, so creation times (and so job order) are the same in every
run. Tolerance: none; every comparison is exact.
"""

from __future__ import annotations

import importlib
import itertools
import time
from types import SimpleNamespace

import pytest
import torch

CFG, SCALE = 2, 0.05


def _pkg(name):
    importlib.import_module(f"{name}.scheduler.actions")
    importlib.import_module(f"{name}.scheduler.plugins")
    mods = {"store": "store", "gateway": "store.gateway",
            "remote": "store.remote", "clock": "utils.clock",
            "cache": "scheduler.cache", "framework": "scheduler.framework",
            "clusters": "bench.clusters",
            "helper": "scheduler.util.scheduler_helper"}
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


def _wait(predicate, timeout=30.0, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        out = predicate()
        if out:
            return out
        time.sleep(interval)
    return None


class _Writer:
    """The generators' cache surface, writing into a store instead."""

    def __init__(self, store):
        self.add_node = self.add_queue = store.create
        self.add_pod_group = self.add_pod = store.create


def _populate(P, target):
    ticks = itertools.count(1)
    P.clock.set_source(lambda: float(next(ticks)))
    try:
        return P.clusters.CONFIGS[CFG].populate(target, SCALE)
    finally:
        P.clock.set_source(None)


def _tiers(P):
    args = {"tpuscore.mode": "rounds"}
    if P is PORT:
        args.update({"tpuscore.device": "cpu", "tpuscore.dtype": "float64"})
    return P.clusters.make_tiers(["tpuscore"], *P.clusters.CONFIGS[CFG].tiers,
                                 arguments={"tpuscore": args})


def _session(P, cache):
    fw = P.framework
    ssn = fw.open_session(cache, _tiers(P))
    fw.run_actions(ssn, ["allocate"])
    prof = dict(ssn.plugins["tpuscore"].profile)
    fw.close_session(ssn)
    return prof


def _store_binds(store):
    return {f"{p.metadata.namespace}/{p.metadata.name}": p.spec.node_name
            for p in store.list("Pod") if p.spec.node_name}


def _scheduled(store):
    return [e.object_key for e in store.events if e.reason == "Scheduled"]


def _fed(P):
    cache = P.clusters.make_cache()
    _populate(P, cache)
    prof = _session(P, cache)
    return dict(cache.binder.binds), list(cache.binder.channel), prof


def _in_process(P, fence=False):
    P.helper.reset_round_robin()
    store = P.store.Store()
    cache = P.cache.SchedulerCache(store=store)
    cache.run()
    _populate(P, _Writer(store))
    if fence:
        cache.set_fence_epoch(1)
        store.advance_fence(2)
    return store, cache


def _statuses(cache):
    return sorted((t.namespace + "/" + t.name, t.status.name)
                  for j in cache.jobs.values() for t in j.tasks.values())


def test_store_backed_session_matches_reference_and_fed_twin():
    out = {}
    for P in (REF, PORT):
        store, cache = _in_process(P)
        prof = _session(P, cache)
        binds, events = _store_binds(store), _scheduled(store)
        second = _session(P, cache)
        out[P.name] = (binds, events, _store_binds(store), _scheduled(store),
                       prof["mode"], prof["placed"], second.get("placed", 0))
        fed_binds, fed_order, fed_prof = _fed(P)
        assert binds == fed_binds
        assert events == fed_order  # Scheduled events: the binds, in order
        assert fed_prof["placed"] == prof["placed"]
    ours, ref = out["volcano_tpu_torch"], out["volcano_tpu"]
    assert ours == ref
    binds, events, binds2, events2, mode, placed, placed2 = ours
    assert mode == "rounds" and placed == len(binds) > 200
    assert binds2 == binds and events2 == events and placed2 == 0


def test_fenced_store_rejects_every_bind_in_both():
    out = {}
    for P in (REF, PORT):
        store, cache = _in_process(P, fence=True)
        prof = _session(P, cache)
        errs = len(cache._err_tasks)
        cache.process_resync_tasks()
        out[P.name] = (prof["placed"], errs, dict(store.fence_stats),
                       cache.binder.fenced_rejections,
                       cache.status_updater.fenced_rejections,
                       cache.fenced_rejections(), _scheduled(store),
                       _statuses(cache), _store_binds(store))
    ours, ref = out["volcano_tpu_torch"], out["volcano_tpu"]
    assert ours == ref
    placed, errs, stats, bind_rej, status_rej, total, events, statuses, \
        store_binds = ours
    assert placed > 200 and errs == placed
    # the bulk bind_many's first write and every per-task retry, then the
    # close's pod-group status writes
    assert bind_rej == placed + 1
    assert stats["rejected"] == bind_rej + status_rej
    assert stats["rejected_by_kind"]["Pod"] == bind_rej
    assert total >= bind_rej and events == []
    # the reference fault, on both sides: the rejected binds' node_name
    # stays on the store's canonical pods, so resync reads them as bound
    assert len(store_binds) == placed
    assert {s for _, s in statuses} == {"BOUND"}


WATCHED = ("Pod", "Node", "PodGroup", "Queue", "PriorityClass",
           "ResourceQuota", "PodDisruptionBudget")


def _stop_watches(P, remote, store):
    """Stop the cache's remote watches without waiting out their long
    polls: with the stop flag set, one write of each watched kind wakes
    every poll, so each thread sees the flag and the joins return."""
    remote._watch_stop.set()
    codec = importlib.import_module(f"{P.name}.api.codec")
    objects = importlib.import_module(f"{P.name}.api.objects")
    for kind in WATCHED:
        store.create(codec.kind_class(kind)(
            metadata=objects.ObjectMeta(name="zz-wake", namespace="wake")))
    remote.stop_watches()


def _remote_cache(P, store, gw, fence=False):
    remote = P.remote.RemoteStore(f"127.0.0.1:{gw.port}")
    P.helper.reset_round_robin()
    cache = P.cache.SchedulerCache(store=remote)
    cache.run()
    assert cache.wait_for_cache_sync()
    n_pods = len(store.list("Pod"))
    n_nodes = len(store.list("Node"))
    synced = _wait(lambda: (
        sum(len(j.tasks) for j in cache.jobs.values()) == n_pods
        and len(cache.nodes) == n_nodes and "default" in cache.queues
        and all(j.pod_group is not None for j in cache.jobs.values())))
    assert synced, "the remote watches never delivered the cluster"
    if fence:
        cache.set_fence_epoch(1)
        store.advance_fence(2)
    return remote, cache


@pytest.mark.parametrize("fence", [False, True], ids=["unfenced", "fenced"])
def test_remote_session_matches_reference(fence):
    out = {}
    for P in (REF, PORT):
        store = P.store.Store()
        _populate(P, _Writer(store))
        gw = P.gateway.ApiGateway(store, ":0").start()
        remote = None
        try:
            remote, cache = _remote_cache(P, store, gw, fence)
            prof = _session(P, cache)
            remote.flush_events()
            binds = _store_binds(store)
            if not fence:
                # the bind echoes come back through the watch
                assert _wait(lambda: all(
                    t.node_name for j in cache.jobs.values()
                    for t in j.tasks.values()
                    if f"{t.namespace}/{t.name}" in binds))
            cache.process_resync_tasks()
            out[P.name] = (prof["placed"], binds, _scheduled(store),
                           dict(store.fence_stats), cache.fenced_rejections(),
                           _statuses(cache), remote.watch_stats()["resets"])
        finally:
            if remote is not None:
                _stop_watches(P, remote, store)
            gw.stop()
    ours, ref = out["volcano_tpu_torch"], out["volcano_tpu"]
    assert ours == ref
    placed, binds, events, stats, rejections, statuses, resets = ours
    assert resets == 0 and placed > 200
    if fence:
        # the client's pods are copies: the server's stay unbound and
        # resync reads every task back as pending
        assert binds == {} and events == []
        assert stats["rejected"] >= placed + 1 and rejections >= placed + 1
        assert {s for _, s in statuses} == {"PENDING"}
    else:
        fed_binds, fed_order, _ = _fed(PORT)
        assert binds == fed_binds
        assert sorted(events) == sorted(fed_order)
        assert len(events) == len(binds) == placed


def test_fenced_express_commit_parks_the_lane():
    out = {}
    for P in (REF, PORT):
        tu = importlib.import_module(f"{P.name}.scheduler.util.test_utils")
        express = importlib.import_module(f"{P.name}.express")
        P.helper.reset_round_robin()
        store = P.store.Store()
        cache = P.cache.SchedulerCache(store=store)
        cache.run()
        ticks = itertools.count(1)
        P.clock.set_source(lambda: float(next(ticks)))
        try:
            for n in range(4):
                store.create(tu.build_node(
                    f"node-{n}", tu.build_resource_list_with_pods("8", "16Gi")))
            store.create(tu.build_queue("default"))
            kw = {} if P is REF else {"device": "cpu", "dtype": torch.float64}
            lane = express.ExpressLane(cache, **kw)
            for j in range(3):
                store.create(tu.build_pod_group(f"svc-{j}", namespace="xp"))
                store.create(tu.build_pod("xp", f"svc-{j}-t0", "", "Pending",
                                          {"cpu": "500m", "memory": "512Mi"},
                                          f"svc-{j}"))
            cache.set_fence_epoch(1)
            store.advance_fence(2)
            rep = lane.run_once()
        finally:
            P.clock.set_source(None)
        out[P.name] = (rep["placed"], rep["deferred"], lane.parked,
                       lane._park_reason, store.fence_stats["rejected"],
                       cache.binder.fenced_rejections, _scheduled(store))
    ours, ref = out["volcano_tpu_torch"], out["volcano_tpu"]
    assert ours == ref
    placed, deferred, parked, reason, rejected, bind_rej, events = ours
    assert parked and reason == "lease_lost" and events == []
    assert placed == 0 and deferred == 3
    assert rejected == bind_rej == 1  # the batch stopped at its first bind
