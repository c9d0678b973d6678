"""The port's state store (volcano_tpu_torch/store/store.py), wire codec
(volcano_tpu_torch/api/codec.py) and the cache's store seam against the
JAX package's (volcano_tpu/store, volcano_tpu/api/codec.py).

- Twins of every test in tests/test_store.py: each scenario runs on both
  packages' ``Store`` and what it observes (versions, watch callbacks,
  lists, admission results, events) must be equal, and equal to what the
  reference test asserts.
- Twins of tests/test_codec.py: object round trips over every ``KIND`` of
  the port's api/objects.py (objects filled field by field from one
  ``random.Random`` seed), and the port's ``to_wire`` of each object equals
  the JAX package's ``to_wire`` of the same object built from the same
  seed, as JSON, so both packages read and write one wire format (each
  decodes the other's envelopes).
- Twins of tests/test_cache.py's ``test_bind_failure_resyncs`` and
  ``TestStoreIntegration``: a ``SchedulerCache(store=...)`` fed through
  its watches.

Tolerance: none; every comparison is exact.
"""

from __future__ import annotations

import dataclasses
import importlib
import itertools
import json
import random
import typing
from types import SimpleNamespace

import pytest


def _pkg(name):
    mods = {
        "objects": "api.objects", "codec": "api.codec",
        "types": "api.types", "store": "store", "clock": "utils.clock",
        "cache": "scheduler.cache", "tu": "scheduler.util.test_utils",
    }
    return SimpleNamespace(name=name, **{
        k: importlib.import_module(f"{name}.{v}") for k, v in mods.items()})


REF = _pkg("volcano_tpu")
PORT = _pkg("volcano_tpu_torch")


def _both(scenario):
    """Run ``scenario(P)`` on each package with the clock pinned to one
    counter; the two observations must be equal. Returns the port's."""
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


def make_pod(P, name="p1", ns="default"):
    return P.tu.build_pod(ns, name, "", P.objects.POD_PHASE_PENDING,
                          P.tu.build_resource_list("1", "1Gi"), "pg1")


# -- tests/test_store.py twins ----------------------------------------------

def test_create_get():
    def scenario(P):
        s = P.store.Store()
        pod = s.create(make_pod(P))
        return pod.metadata.resource_version, s.get("Pod", "default", "p1") is pod

    assert _both(scenario) == (1, True)


def test_create_conflict():
    def scenario(P):
        s = P.store.Store()
        s.create(make_pod(P))
        with pytest.raises(P.store.ConflictError) as e:
            s.create(make_pod(P))
        return str(e.value)

    assert "already exists" in _both(scenario)


def test_update_bumps_version():
    def scenario(P):
        s = P.store.Store()
        pod = s.create(make_pod(P))
        pod.status.phase = P.objects.POD_PHASE_RUNNING
        s.update(pod)
        return pod.metadata.resource_version, s.resource_version

    assert _both(scenario) == (2, 2)


def test_update_missing():
    def scenario(P):
        s = P.store.Store()
        with pytest.raises(P.store.NotFoundError) as e:
            s.update(make_pod(P))
        return str(e.value)

    assert "not found" in _both(scenario)


def test_delete():
    def scenario(P):
        s = P.store.Store()
        s.create(make_pod(P))
        gone = s.delete("Pod", "default", "p1")
        return gone.metadata.name, s.try_get("Pod", "default", "p1"), \
            s.resource_version

    assert _both(scenario) == ("p1", None, 2)


def test_cluster_scoped():
    def scenario(P):
        s = P.store.Store()
        s.create(P.tu.build_node("n1", P.tu.build_resource_list("4", "8Gi")))
        s.create(P.tu.build_queue("q1"))
        return (s.get("Node", "", "n1").metadata.name,
                s.get("Queue", "", "q1").metadata.name,
                sorted(P.store.store.CLUSTER_SCOPED))

    assert _both(scenario)[:2] == ("n1", "q1")


def test_list_with_namespace_and_selector():
    def scenario(P):
        s = P.store.Store()
        p = make_pod(P, "a")
        p.metadata.labels["app"] = "x"
        s.create(p)
        s.create(make_pod(P, "b"))
        s.create(make_pod(P, "c", ns="other"))
        names = lambda objs: [o.metadata.name for o in objs]  # noqa: E731
        return (names(s.list("Pod")), names(s.list("Pod", namespace="default")),
                names(s.list("Pod", selector={"app": "x"})))

    assert _both(scenario) == (["a", "b", "c"], ["a", "b"], ["a"])


def test_watch_events():
    def scenario(P):
        s = P.store.Store()
        seen = []
        s.watch("Pod", P.store.WatchHandler(
            added=lambda o: seen.append(("add", o.metadata.name)),
            updated=lambda old, new: seen.append(("upd", new.metadata.name)),
            deleted=lambda o: seen.append(("del", o.metadata.name)),
        ))
        pod = s.create(make_pod(P))
        s.update(pod)
        s.delete("Pod", "default", "p1")
        return seen

    assert _both(scenario) == [("add", "p1"), ("upd", "p1"), ("del", "p1")]


def test_watch_replay():
    def scenario(P):
        s = P.store.Store()
        s.create(make_pod(P, "a"))
        s.create(make_pod(P, "b"))
        seen = []
        s.watch("Pod", P.store.WatchHandler(
            added=lambda o: seen.append(o.metadata.name)))
        return seen

    assert sorted(_both(scenario)) == ["a", "b"]


def test_mutator_then_validator():
    def scenario(P):
        s = P.store.Store()
        s.register_admission(
            "Pod",
            mutator=lambda p: p.metadata.labels.__setitem__("mutated", "yes"),
            validator=lambda p: None,
        )
        pod = s.create(make_pod(P))
        return dict(pod.metadata.labels)

    assert _both(scenario)["mutated"] == "yes"


def test_validator_rejects():
    def scenario(P):
        def reject(pod):
            raise P.store.AdmissionError("no")

        s = P.store.Store()
        s.register_admission("Pod", validator=reject)
        with pytest.raises(P.store.AdmissionError):
            s.create(make_pod(P))
        return s.try_get("Pod", "default", "p1"), s.resource_version

    assert _both(scenario) == (None, 0)


def test_record():
    def scenario(P):
        s = P.store.Store()
        pod = s.create(make_pod(P))
        s.record_event(pod, "Warning", "FailedScheduling", "no nodes")
        s.record_scheduled(["default/p1"], ["n1"])
        return [(e.object_kind, e.object_key, e.event_type, e.reason,
                 e.message, e.timestamp) for e in s.events_for(pod)]

    evs = _both(scenario)
    assert [e[3] for e in evs] == ["FailedScheduling", "Scheduled"]
    assert evs[1][4] == "Successfully assigned default/p1 to n1"


def test_fence_rejects_stale_epochs_and_counts_them():
    """The lease-epoch fence: stale stamps are rejected and accounted per
    kind and epoch; unstamped and current writes pass."""
    def scenario(P):
        s = P.store.Store()
        pod = s.create(make_pod(P))
        s.advance_fence(3)
        out = []
        for epoch in (None, 2, 3, 1):
            try:
                s.update(pod, epoch=epoch)
                out.append("ok")
            except P.store.FencedError:
                out.append("fenced")
        view = P.store.FencedStoreView(s, lambda: 2)
        with pytest.raises(P.store.FencedError):
            view.delete("Pod", "default", "p1")
        stats = dict(s.fence_stats)
        return out, stats

    out, stats = _both(scenario)
    assert out == ["ok", "fenced", "ok", "fenced"]
    assert stats["rejected"] == 3 and stats["rejected_by_kind"] == {"Pod": 3}
    assert stats["rejected_by_epoch"] == {2: 2, 1: 1}


# -- tests/test_codec.py twins ----------------------------------------------

def _fill(cls, rng, depth=0):
    """An instance of dataclass ``cls`` with every field set from ``rng``
    (the hints drive it, so twin classes draw the same values)."""
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        kwargs[f.name] = _value(hints[f.name], rng, depth)
    return cls(**kwargs)


def _value(hint, rng, depth):
    origin = typing.get_origin(hint)
    if origin is typing.Union:
        args = [a for a in typing.get_args(hint) if a is not type(None)]
        if rng.random() < 0.25 or depth > 4:
            return None
        return _value(args[0], rng, depth)
    if origin in (list, tuple):
        (arg,) = typing.get_args(hint) or (str,)
        return [_value(arg, rng, depth + 1) for _ in range(rng.randrange(0, 3))]
    if origin is dict:
        _, varg = typing.get_args(hint)
        return {f"k{rng.randrange(100)}": _value(varg, rng, depth + 1)
                for _ in range(rng.randrange(0, 3))}
    if isinstance(hint, type) and dataclasses.is_dataclass(hint):
        return _fill(hint, rng, depth + 1)
    if hint is bool:
        return rng.random() < 0.5
    if hint is int:
        return rng.randrange(-5, 1000)
    if hint is float:
        return rng.randrange(0, 10 ** 6) / 8.0
    if hint is str:
        return f"s{rng.randrange(10 ** 6)}"
    if hint is typing.Any or hint is object:
        return rng.choice([1, "x", 2.5, None])
    raise AssertionError(f"no filler for {hint!r}")


def _kinds(P):
    return sorted(cls.KIND for cls in vars(P.objects).values()
                  if isinstance(cls, type) and dataclasses.is_dataclass(cls)
                  and isinstance(getattr(cls, "KIND", None), str) and cls.KIND)


def test_every_store_kind_registered():
    kinds = _kinds(PORT)
    assert kinds == _kinds(REF)
    for kind in ("Pod", "Node", "PodGroup", "Queue", "Job", "Command",
                 "PriorityClass", "ResourceQuota", "PodDisruptionBudget",
                 "PersistentVolumeClaim", "ConfigMap", "Service"):
        assert kind in kinds
    for kind in kinds:
        assert PORT.codec.kind_class(kind).KIND == kind
    with pytest.raises(KeyError):
        PORT.codec.kind_class("NoSuchKind")


@pytest.mark.parametrize("kind", _kinds(PORT))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wire_form_matches_the_reference(kind, seed):
    ours = _fill(PORT.codec.kind_class(kind), random.Random(seed))
    ref = _fill(REF.codec.kind_class(kind), random.Random(seed))
    ours_json = json.dumps(PORT.codec.envelope(ours), sort_keys=True)
    assert ours_json == json.dumps(REF.codec.envelope(ref), sort_keys=True)
    # round trips, and each package decodes the other's envelope
    for codec in (PORT.codec, REF.codec):
        back = codec.from_envelope(json.loads(ours_json))
        assert json.dumps(codec.envelope(back), sort_keys=True) == ours_json


def test_roundtrip_object_zoo():
    def scenario(P):
        o = P.objects
        pod = P.tu.build_pod("ns", "p1", "n1", "Running", {"cpu": "1"}, "pg",
                             labels={"a": "b"})
        pod.spec.affinity = o.Affinity(
            pod_anti_affinity=o.PodAntiAffinity(required_terms=[
                o.PodAffinityTerm(
                    label_selector=o.LabelSelector(match_labels={"x": "y"}),
                    topology_key="kubernetes.io/hostname")]))
        wires = []
        for obj in (
            P.tu.build_node("n1", P.tu.build_resource_list_with_pods("4", "8Gi")),
            pod,
            P.tu.build_pod_group("pg", min_member=3),
            P.tu.build_queue("q", weight=2),
            o.Command(
                metadata=o.ObjectMeta(name="c"), action="AbortJob",
                target_object=o.OwnerReference(kind="Job", name="j")),
        ):
            env = P.codec.envelope(obj)
            back = P.codec.from_envelope(json.loads(json.dumps(env)))
            assert P.codec.to_wire(back) == P.codec.to_wire(obj)
            assert type(back) is type(obj)
            wires.append(json.dumps(env, sort_keys=True))
        return wires

    assert len(_both(scenario)) == 5


def test_nested_optionals_and_unknown_fields():
    def scenario(P):
        pod = P.tu.build_pod("ns", "p", "", "Pending", {}, "")
        wire = P.codec.envelope(pod)
        wire["object"]["not_a_field"] = 42  # forward compatibility: ignored
        back = P.codec.from_envelope(wire)
        return back.metadata.name, back.spec.affinity

    assert _both(scenario) == ("p", None)


# -- tests/test_cache.py twins (the store seam) -------------------------------

def _make_cache(P, store=None):
    return P.cache.SchedulerCache(
        store=store, binder=P.tu.FakeBinder(), evictor=P.tu.FakeEvictor(),
        status_updater=P.tu.FakeStatusUpdater(),
        volume_binder=P.tu.FakeVolumeBinder())


def test_bind_failure_resyncs():
    def scenario(P):
        class FailingBinder:
            def bind(self, pod, hostname):
                raise RuntimeError("apiserver down")

        tu, objects = P.tu, P.objects
        store = P.store.Store()
        c = P.cache.SchedulerCache(
            store=store, binder=FailingBinder(), evictor=tu.FakeEvictor(),
            status_updater=tu.FakeStatusUpdater(),
            volume_binder=tu.FakeVolumeBinder())
        c.run()
        store.create(tu.build_node("n1", tu.build_resource_list("8", "16Gi")))
        store.create(tu.build_queue("q1"))
        store.create(tu.build_pod_group("pg1", namespace="ns1", min_member=1,
                                        queue="q1"))
        store.create(tu.build_pod("ns1", "p1", "", objects.POD_PHASE_PENDING,
                                  tu.build_resource_list("2", "4Gi"), "pg1"))
        task = next(iter(c.jobs["ns1/pg1"].tasks.values()))
        c.bind(task, "n1")
        errs = len(c._err_tasks)
        # resync re-fetches truth: pod in store is still unbound/pending
        c.process_resync_tasks()
        job_task = next(iter(c.jobs["ns1/pg1"].tasks.values()))
        return (errs, len(c._err_tasks), job_task.status.name,
                c.nodes["n1"].idle.milli_cpu)

    assert _both(scenario) == (1, 0, "PENDING", 8000)


def test_watch_driven_mirror():
    def scenario(P):
        tu, objects = P.tu, P.objects
        store = P.store.Store()
        c = _make_cache(P, store)
        c.run()
        c.run()  # idempotent
        store.create(tu.build_node("n1", tu.build_resource_list("4", "8Gi")))
        store.create(tu.build_queue("default"))
        store.create(tu.build_pod_group("pg1"))
        pod = store.create(tu.build_pod(
            "default", "p1", "", objects.POD_PHASE_PENDING,
            tu.build_resource_list("1", "1Gi"), "pg1"))
        out = [sorted(c.nodes), sorted(c.jobs),
               len(c.jobs["default/pg1"].tasks)]
        # pod phase transition via store update flows through
        pod.status.phase = objects.POD_PHASE_RUNNING
        pod.spec.node_name = "n1"
        store.update(pod)
        task = next(iter(c.jobs["default/pg1"].tasks.values()))
        out += [task.status.name, c.nodes["n1"].used.milli_cpu]
        store.delete("Pod", "default", "p1")
        out.append(len(c.jobs["default/pg1"].tasks))
        # detached, the cache no longer mirrors the store
        c.detach_watches()
        store.create(tu.build_node("n2", tu.build_resource_list("4", "8Gi")))
        out.append(sorted(c.nodes))
        return out

    assert _both(scenario) == [["n1"], ["default/pg1"], 1, "RUNNING", 1000, 0,
                               ["n1"]]


def test_store_cache_builds_the_default_effectors():
    def scenario(P):
        store = P.store.Store()
        c = P.cache.SchedulerCache(store=store)
        bare = P.cache.SchedulerCache()
        return ([type(x).__name__ for x in (c.binder, c.evictor,
                                            c.status_updater, c.volume_binder)],
                [type(x).__name__ if x is not None else None
                 for x in (bare.binder, bare.evictor, bare.status_updater,
                           bare.volume_binder)])

    assert _both(scenario) == (
        ["DefaultBinder", "DefaultEvictor", "DefaultStatusUpdater",
         "StoreVolumeBinder"],
        [None, None, None, "DefaultVolumeBinder"])


def test_default_effectors_write_back_and_count_fenced_rejections():
    """DefaultBinder/DefaultEvictor/DefaultStatusUpdater write into the
    store; stamped with a stale epoch, bind and evict raise FencedError
    (counted), the status updater counts and moves on."""
    def scenario(P):
        tu, objects = P.tu, P.objects
        store = P.store.Store()
        c = P.cache.SchedulerCache(store=store)
        c.run()
        store.create(tu.build_node("n1", tu.build_resource_list("8", "16Gi")))
        store.create(tu.build_queue("default"))
        pg = store.create(tu.build_pod_group("pg1", min_member=1))
        store.create(tu.build_pod("default", "p1", "", objects.POD_PHASE_PENDING,
                                  tu.build_resource_list("1", "1Gi"), "pg1"))
        store.create(tu.build_pod("default", "p2", "", objects.POD_PHASE_PENDING,
                                  tu.build_resource_list("1", "1Gi"), "pg1"))
        tasks = sorted(c.jobs["default/pg1"].tasks.values(), key=lambda t: t.name)
        c.bind(tasks[0], "n1")
        out = [store.get("Pod", "default", "p1").spec.node_name]
        c.evict(tasks[0], "test")
        out.append(store.get("Pod", "default", "p1").metadata.deletion_timestamp
                   is not None)
        c.set_fence_epoch(1)
        store.advance_fence(2)
        with pytest.raises(P.store.FencedError):
            c.bind(tasks[1], "n1")
        c.status_updater.update_pod_group(pg)
        out += [c.binder.fenced_rejections, c.status_updater.fenced_rejections,
                store.fence_stats["rejected"],
                [(e.reason, e.object_key) for e in store.events]]
        return out

    out = _both(scenario)
    assert out[:5] == ["n1", True, 1, 1, 2]
