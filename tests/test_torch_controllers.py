"""The port's controllers (volcano_tpu_torch/controllers) against the JAX
package's (volcano_tpu/controllers).

Twins of every test in tests/test_controllers.py. Each twin builds its
Jobs once, as manifest dicts (the reference test's ``make_job`` encoded by
the JAX package's codec), decodes them through each package's own
``api/codec.py``, and runs the same steps on each package's Store and
controllers. It asserts the reference test's own checks on both packages,
and that both stores hold the same objects afterwards: every object of
every kind encoded by its package's codec (``envelope``), keyed by kind,
namespace and name, with uids and resource versions left out, and the
same recorded events.

What each package draws at random or from a clock is pinned the same way
on both sides while a twin runs: ``utils/clock`` to one counter, the uid
counter of ``api/objects.py``, ``uuid.uuid4`` (a session's uid, which
PodGroup conditions carry), the module ``random`` (volume-claim names),
the round-robin node cursor, and the ssh plugin's key pair (one RSA key made once for the module, or
``secrets.token_hex`` where ``cryptography`` is missing).

Tolerance: none; every comparison is exact.
"""

from __future__ import annotations

import copy
import importlib
import itertools
import random
import secrets
import uuid
from types import SimpleNamespace

import pytest
import torch

from tests.test_controllers import make_job


def _pkg(name):
    mods = {
        "objects": "api.objects", "codec": "api.codec", "store": "store.store",
        "clock": "utils.clock", "jobctl": "controllers.job",
        "policies": "controllers.job.policies", "apis": "controllers.apis",
        "podgroup": "controllers.podgroup", "queue": "controllers.queue",
        "gc": "controllers.garbagecollector", "helper": "scheduler.util.scheduler_helper",
        "degrade": "scheduler.degrade",
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


@pytest.fixture(autouse=True)
def _fresh_port_ladder():
    PORT.degrade.reset()
    yield
    PORT.degrade.reset()


_RSA_KEY = []


def _fixed_rsa_key(generate):
    """A ``generate_private_key`` that makes one RSA key (by ``generate``)
    and returns it for every keypair a twin makes, in both packages."""
    def fixed(*args, **kwargs):
        if not _RSA_KEY:
            _RSA_KEY.append(generate(*args, **kwargs))
        return _RSA_KEY[0]
    return fixed


@pytest.fixture
def pinned(monkeypatch):
    """``pinned(P)``: pin what P draws at random or from a clock (see the
    module docstring); ``pinned(None)`` releases the clock."""
    try:
        from cryptography.hazmat.primitives.asymmetric import rsa

        monkeypatch.setattr(rsa, "generate_private_key",
                            _fixed_rsa_key(rsa.generate_private_key))
    except ImportError:
        pass
    monkeypatch.setattr(secrets, "token_hex", lambda n=32: "ab" * n)
    pinned_to = []

    def pin(P):
        for Q in pinned_to:
            Q.clock.set_source(None)
        pinned_to.clear()
        if P is None:
            return
        ticks = itertools.count(1)
        P.clock.set_source(lambda: float(next(ticks)))
        pinned_to.append(P)
        monkeypatch.setattr(P.objects, "_uid_counter", itertools.count(1))
        sessions = itertools.count(1)
        monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=next(sessions)))
        random.seed(18)
        P.helper.reset_round_robin()

    yield pin
    pin(None)


def manifest(**kwargs) -> dict:
    """The reference test's ``make_job(**kwargs)`` as a manifest dict."""
    return REF.codec.envelope(make_job(**kwargs))


def decode(P, data: dict):
    return P.codec.from_envelope(copy.deepcopy(data))


def _strip(wire):
    if isinstance(wire, dict):
        return {k: _strip(v) for k, v in wire.items()
                if k not in ("uid", "resource_version")}
    if isinstance(wire, list):
        return [_strip(v) for v in wire]
    return wire


def dump(P, store) -> dict:
    """Every object of ``store`` by (kind, namespace, name), encoded by P's
    codec without uids and resource versions, and the recorded events."""
    objs = {}
    for kind in sorted(store._buckets):
        for obj in store.list(kind):
            key = (kind, obj.metadata.namespace, obj.metadata.name)
            objs[key] = _strip(P.codec.envelope(obj))
    events = [(e.object_kind, e.object_key, e.event_type, e.reason, e.message)
              for e in store.events]
    return {"objects": objs, "events": events}


def twin(pinned, scenario, pkgs=(REF, PORT)):
    """Run ``scenario(P)`` on each package of ``pkgs`` (the JAX package's
    modules, then the port's) with its draws pinned; it returns (store,
    observation). Both stores and both observations must be equal.
    Returns the port's observation."""
    seen = {}
    for P in pkgs:
        pinned(P)
        try:
            store, obs = scenario(P)
            seen[P.name] = (dump(P, store), obs)
        finally:
            pinned(None)
    ref, port = seen["volcano_tpu"], seen["volcano_tpu_torch"]
    assert port[0]["objects"].keys() == ref[0]["objects"].keys()
    for key, want in ref[0]["objects"].items():
        assert port[0]["objects"][key] == want, key
    assert port[0]["events"] == ref[0]["events"]
    assert port[1] == ref[1]
    return port[1]


def set_pod_phase(P, store, namespace, name, phase, exit_code=0):
    """Simulated kubelet: flip a pod's phase through the store."""
    pod = store.get("Pod", namespace, name)
    updated = copy.deepcopy(pod)
    updated.status.phase = phase
    if phase == P.objects.POD_PHASE_FAILED:
        updated.status.container_statuses = [
            P.objects.ContainerStatus(name="c", exit_code=exit_code)]
    store.update_status(updated)


def job_phase(store, name="job1", namespace="ns1"):
    return store.get("Job", namespace, name).status.state.phase


def _submit(P, data):
    store = P.store.Store()
    cc = P.jobctl.JobController(store)
    store.create(decode(P, data))
    cc.process_all()
    return store, cc


# -- TestJobSync ------------------------------------------------------------

def test_sync_creates_pods_and_podgroup(pinned):
    def scenario(P):
        store, _ = _submit(P, manifest())
        pods = store.list("Pod", namespace="ns1")
        assert len(pods) == 3
        names = {p.metadata.name for p in pods}
        assert names == {"job1-worker-0", "job1-worker-1", "job1-worker-2"}
        for p in pods:
            assert p.metadata.annotations[P.objects.JOB_NAME_KEY] == "job1"
            assert p.metadata.annotations[P.objects.TASK_SPEC_KEY] == "worker"
        pg = store.get("PodGroup", "ns1", "job1")
        assert pg.spec.min_member == 2
        assert pg.spec.min_resources["cpu"] == 2.0
        assert job_phase(store) == P.objects.JobPhase.PENDING
        return store, sorted(names)

    twin(pinned, scenario)


def test_pending_to_running_to_completed(pinned):
    def scenario(P):
        store, cc = _submit(P, manifest(min_available=2, tasks=(("worker", 2),)))
        seen = []
        for phase in (P.objects.POD_PHASE_RUNNING, P.objects.POD_PHASE_SUCCEEDED):
            for i in range(2):
                set_pod_phase(P, store, "ns1", f"job1-worker-{i}", phase)
            cc.process_all()
            seen.append(job_phase(store))
        assert seen == [P.objects.JobPhase.RUNNING, P.objects.JobPhase.COMPLETED]
        return store, seen

    twin(pinned, scenario)


def test_scale_replicas_diff(pinned):
    def scenario(P):
        store, cc = _submit(P, manifest(min_available=1, tasks=(("worker", 3),)))
        assert len(store.list("Pod", namespace="ns1")) == 3
        # scale down to 1 replica -> extra pods deleted
        updated = copy.deepcopy(store.get("Job", "ns1", "job1"))
        updated.spec.tasks[0].replicas = 1
        store.update(updated)
        cc.process_all()
        names = {p.metadata.name for p in store.list("Pod", namespace="ns1")}
        assert names == {"job1-worker-0"}
        return store, sorted(names)

    twin(pinned, scenario)


# -- TestPolicies -----------------------------------------------------------

def test_pod_failed_restarts_job(pinned):
    def scenario(P):
        O = P.objects
        data = manifest(min_available=2, tasks=(("worker", 2),), policies=[
            REF.objects.LifecyclePolicy(event=REF.objects.JobEvent.POD_FAILED,
                                        action=REF.objects.JobAction.RESTART_JOB)])
        store, cc = _submit(P, data)
        for i in range(2):
            set_pod_phase(P, store, "ns1", f"job1-worker-{i}", O.POD_PHASE_RUNNING)
        cc.process_all()
        assert job_phase(store) == O.JobPhase.RUNNING
        set_pod_phase(P, store, "ns1", "job1-worker-0", O.POD_PHASE_FAILED)
        cc.process_all()
        # restarted: back to Pending (pods recreated) and retry counted
        stored = store.get("Job", "ns1", "job1")
        assert stored.status.retry_count == 1
        assert stored.status.state.phase in (O.JobPhase.PENDING, O.JobPhase.RUNNING)
        assert len(store.list("Pod", namespace="ns1")) == 2
        return store, (stored.status.retry_count, stored.status.state.phase)

    twin(pinned, scenario)


def _exit_code_case(P):
    O = P.objects
    job = decode(P, manifest(policies=[REF.objects.LifecyclePolicy(
        exit_code=137, action=REF.objects.JobAction.TERMINATE_JOB)]))
    got = [P.policies.apply_policies(job, P.apis.Request(
        event=O.JobEvent.POD_FAILED, exit_code=code)) for code in (137, 1)]
    assert got == [O.JobAction.TERMINATE_JOB, O.JobAction.SYNC_JOB]
    return got


def _task_override_case(P):
    O = P.objects
    job = decode(P, manifest(
        tasks=(("worker", 1),),
        policies=[REF.objects.LifecyclePolicy(
            event=REF.objects.JobEvent.POD_FAILED,
            action=REF.objects.JobAction.ABORT_JOB)],
        task_policies=[REF.objects.LifecyclePolicy(
            event=REF.objects.JobEvent.POD_FAILED,
            action=REF.objects.JobAction.RESTART_JOB)]))
    got = P.policies.apply_policies(job, P.apis.Request(
        task_name="worker", event=O.JobEvent.POD_FAILED))
    assert got == O.JobAction.RESTART_JOB
    return got


def _stale_version_case(P):
    O = P.objects
    job = decode(P, manifest(policies=[REF.objects.LifecyclePolicy(
        event=REF.objects.JobEvent.POD_FAILED,
        action=REF.objects.JobAction.RESTART_JOB)]))
    job.status.version = 5
    got = P.policies.apply_policies(job, P.apis.Request(
        event=O.JobEvent.POD_FAILED, job_version=3))
    assert got == O.JobAction.SYNC_JOB
    return got


@pytest.mark.parametrize("case", [
    "exit_code_policy", "task_policies_override_job_policies",
    "stale_version_degrades_to_sync"])
def test_apply_policies(case, pinned):
    """test_exit_code_policy, test_task_policies_override_job_policies and
    test_stale_version_degrades_to_sync: the policy engine alone, no store;
    both packages pick the same action."""
    fn = {"exit_code_policy": _exit_code_case,
          "task_policies_override_job_policies": _task_override_case,
          "stale_version_degrades_to_sync": _stale_version_case}[case]
    twin(pinned, lambda P: (P.store.Store(), fn(P)))


def test_max_retry_fails_job(pinned):
    def scenario(P):
        O = P.objects
        data = manifest(min_available=1, tasks=(("worker", 1),), max_retry=2,
                        policies=[REF.objects.LifecyclePolicy(
                            event=REF.objects.JobEvent.POD_FAILED,
                            action=REF.objects.JobAction.RESTART_JOB)])
        store, cc = _submit(P, data)
        phases = []
        for _ in range(4):
            pods = store.list("Pod", namespace="ns1")
            if not pods:
                break
            set_pod_phase(P, store, "ns1", pods[0].metadata.name, O.POD_PHASE_FAILED)
            cc.process_all()
            phases.append(job_phase(store))
            if phases[-1] == O.JobPhase.FAILED:
                break
        assert job_phase(store) == O.JobPhase.FAILED
        return store, phases

    twin(pinned, scenario)


# -- TestCommands -----------------------------------------------------------

def _command(P, name, action):
    return P.objects.Command(
        metadata=P.objects.ObjectMeta(name=name, namespace="ns1"),
        action=action,
        target_object=P.objects.OwnerReference(kind=P.objects.Job.KIND,
                                               name="job1"))


def test_abort_and_resume(pinned):
    def scenario(P):
        O = P.objects
        store, cc = _submit(P, manifest(min_available=1, tasks=(("worker", 2),)))
        assert len(store.list("Pod", namespace="ns1")) == 2
        # vcctl job suspend == AbortJob Command (cli suspend.go)
        store.create(_command(P, "abort-job1", O.JobAction.ABORT_JOB))
        cc.process_all()
        assert job_phase(store) == O.JobPhase.ABORTED
        assert store.list("Pod", namespace="ns1") == []
        # command consumed exactly-once
        assert store.list("Command", namespace="ns1") == []
        store.create(_command(P, "resume-job1", O.JobAction.RESUME_JOB))
        cc.process_all()
        stored = store.get("Job", "ns1", "job1")
        assert stored.status.state.phase in (O.JobPhase.PENDING, O.JobPhase.RUNNING)
        assert len(store.list("Pod", namespace="ns1")) == 2
        return store, stored.status.state.phase

    twin(pinned, scenario)


# -- TestJobPlugins ---------------------------------------------------------

def test_svc_ssh_env(pinned):
    def scenario(P):
        store, _ = _submit(P, manifest(
            min_available=2, tasks=(("mpimaster", 1), ("mpiworker", 2)),
            plugins={"svc": [], "ssh": [], "env": []}))
        # hostfile ConfigMap with task host lists (svc.go generateHost)
        cm = store.get("ConfigMap", "ns1", "job1-svc")
        assert cm.data["mpiworker.host"] == (
            "job1-mpiworker-0.job1\njob1-mpiworker-1.job1")
        assert cm.data["mpimaster.host"] == "job1-mpimaster-0.job1"
        # headless service
        svc = store.get("Service", "ns1", "job1")
        assert svc.cluster_ip == "None"
        # ssh keypair configmap
        ssh_cm = store.get("ConfigMap", "ns1", "job1-ssh")
        assert "id_rsa" in ssh_cm.data and "authorized_keys" in ssh_cm.data
        pod = store.get("Pod", "ns1", "job1-mpiworker-1")
        assert pod.spec.hostname == "job1-mpiworker-1"
        assert pod.spec.subdomain == "job1"
        env = {e.name: e.value for e in pod.spec.containers[0].env}
        assert env["VK_TASK_INDEX"] == "1"
        mounts = [m.mount_path for m in pod.spec.containers[0].volume_mounts]
        assert "/etc/volcano" in mounts and "/root/.ssh" in mounts
        return store, (env, mounts)

    twin(pinned, scenario)


def test_plugin_resources_deleted_on_kill(pinned):
    def scenario(P):
        O = P.objects
        store, cc = _submit(P, manifest(min_available=1, tasks=(("w", 1),),
                                        plugins={"svc": []}))
        assert store.try_get("Service", "ns1", "job1") is not None
        store.create(O.Command(
            metadata=O.ObjectMeta(name="t", namespace="ns1"),
            action=O.JobAction.TERMINATE_JOB,
            target_object=O.OwnerReference(kind="Job", name="job1")))
        cc.process_all()
        assert store.try_get("Service", "ns1", "job1") is None
        assert store.try_get("ConfigMap", "ns1", "job1-svc") is None
        return store, job_phase(store)

    twin(pinned, scenario)


# -- TestPodGroupController -------------------------------------------------

@pytest.mark.parametrize("scheduler_name,groups", [
    ("volcano", 1),            # test_bare_pod_gets_podgroup
    ("default-scheduler", 0),  # test_other_scheduler_ignored
])
def test_podgroup_controller(scheduler_name, groups, pinned):
    def scenario(P):
        O = P.objects
        store = P.store.Store()
        pgc = P.podgroup.PodGroupController(store, scheduler_name="volcano")
        pod = O.Pod(metadata=O.ObjectMeta(name="bare", namespace="ns1"),
                    spec=O.PodSpec(scheduler_name=scheduler_name))
        pod.metadata.ensure_identity()
        store.create(pod)
        processed = pgc.process_all()
        assert len(store.list("PodGroup", namespace="ns1")) == groups
        if groups:
            pod = store.get("Pod", "ns1", "bare")
            group = pod.metadata.annotations[O.GROUP_NAME_ANNOTATION_KEY]
            pg = store.get("PodGroup", "ns1", group)
            assert pg.spec.min_member == 1
            assert pg.metadata.owner_references[0].name == "bare"
        else:
            assert processed == 0
        return store, processed

    twin(pinned, scenario)


# -- TestQueueController ----------------------------------------------------

def test_status_aggregation(pinned):
    def scenario(P):
        O = P.objects
        store = P.store.Store()
        qc = P.queue.QueueController(store)
        q = O.Queue(metadata=O.ObjectMeta(name="default"))
        q.metadata.ensure_identity()
        store.create(q)
        phases = [O.PodGroupPhase.PENDING, O.PodGroupPhase.RUNNING,
                  O.PodGroupPhase.RUNNING, O.PodGroupPhase.INQUEUE]
        for i, phase in enumerate(phases):
            pg = O.PodGroup(
                metadata=O.ObjectMeta(name=f"pg{i}", namespace="ns1"),
                spec=O.PodGroupSpec(queue="default"),
                status=O.PodGroupStatus(phase=phase))
            pg.metadata.ensure_identity()
            store.create(pg)
        qc.process_all()
        status = store.get("Queue", "", "default").status
        assert (status.pending, status.running, status.inqueue) == (1, 2, 1)
        return store, (status.pending, status.running, status.inqueue)

    twin(pinned, scenario)


# -- TestGarbageCollector ---------------------------------------------------

@pytest.mark.parametrize("ttl,later,collected", [
    (60, 1061.0, [0, 1]),    # test_ttl_cleanup
    (None, 1e9, [0, 0]),     # test_no_ttl_never_collected
])
def test_garbage_collector(ttl, later, collected, pinned):
    def scenario(P):
        store = P.store.Store()
        now = [1000.0]
        gc = P.gc.GarbageCollector(store, clock=lambda: now[0])
        job = decode(P, manifest(ttl=ttl))
        job.status.state.phase = P.objects.JobPhase.COMPLETED
        job.status.state.last_transition_time = 1000.0
        store.create(job)
        got = [gc.process_expired()]
        now[0] = later
        got.append(gc.process_expired())
        assert got == collected
        assert (store.try_get("Job", "ns1", "job1") is None) == bool(collected[1])
        return store, got

    twin(pinned, scenario)
