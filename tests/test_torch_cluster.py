"""The port's in-process cluster (volcano_tpu_torch/cluster.py: store,
admission, the controllers, the scheduler and a simulated kubelet)
against the JAX package's (volcano_tpu/cluster.py).

- Twins of every test in tests/test_e2e.py. Each builds its Jobs once as
  manifest dicts and decodes them through each package's codec, drives a
  ``Cluster`` of each package through the same steps, asserts the
  reference test's checks on both, and compares both stores whole
  (tests/test_torch_controllers.py ``twin``: every object by kind,
  namespace and name without uids and resource versions, and the recorded
  events, Scheduled ones among them). The threaded twin compares what
  its timing cannot change: each pod's node and phase, and the Job's
  and PodGroup's phases.
- The twin of tests/test_remote_watch.py::
  test_remote_controller_observes_phase_flip: a port QueueController on a
  port RemoteStore, against a port Cluster run() behind a port ApiGateway
  on 127.0.0.1 (the reference's fixture runs the JAX package's daemon,
  ``python -m volcano_tpu.scheduler``; the port's daemon is ROADMAP Queue 1
  item 5), sees a PodGroup's phase flip and aggregates it into the
  QueueStatus through a remote ``update_status``.
- The version twin: ``version_string()``'s Version and Git SHA lines and
  ``__version__`` are the same in both packages.
- One whole cluster above ``AUTO_ROUNDS_THRESHOLD`` (2,048 tasks): cfg2's
  job shape (chip_smoke.py ``cfg2_cluster``) at scale 0.45, 562 Jobs of
  four tasks (2,248 pods) on 450 nodes, through a ``Cluster`` of each
  package with the tpuscore conf in rounds mode and float64 (the port's
  solve on the CPU), from submission to Running: every pod's node, every
  Job, PodGroup and Queue status and the Scheduled events are equal.

The scheduler's conf is the reference test's: the serial default, or the
tpuscore conf with the port's solve placed on the CPU in float64.

Tolerance: none; every comparison is exact.
"""

from __future__ import annotations

import copy
import importlib
import time
from types import SimpleNamespace

import pytest
import torch

import chip_smoke
from tests.test_controllers import make_job
from tests.test_torch_controllers import decode, pinned, twin  # noqa: F401 (pinned: a fixture)


def _pkg(name):
    mods = {
        "objects": "api.objects", "codec": "api.codec", "store": "store.store",
        "clock": "utils.clock", "cluster": "cluster", "tu": "scheduler.util.test_utils",
        "scheduler": "scheduler.scheduler", "degrade": "scheduler.degrade",
        "helper": "scheduler.util.scheduler_helper",
    }
    return SimpleNamespace(name=name, **{
        k: importlib.import_module(f"{name}.{v}") for k, v in mods.items()})


REF = _pkg("volcano_tpu")
PORT = _pkg("volcano_tpu_torch")
BOTH = (REF, PORT)

def tpu_conf(P, mode=None):
    """P's TPU_SCHEDULER_CONF; the port's solve on the CPU in float64 (the
    JAX package runs float64 under the test conftest)."""
    args = [] if P is REF else ["tpuscore.device: cpu", "tpuscore.dtype: float64"]
    if mode:
        args.append(f"tpuscore.mode: {mode}")
    if not args:
        return P.scheduler.TPU_SCHEDULER_CONF
    return P.scheduler.TPU_SCHEDULER_CONF.replace(
        "  - name: tpuscore\n", "  - name: tpuscore\n    arguments:\n"
        + "".join(f"      {a}\n" for a in args))


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


def manifest(scheduler_name="volcano", **kwargs) -> dict:
    """tests/test_controllers.py's ``make_job`` with the e2e tests'
    scheduler name, as a manifest dict."""
    job = make_job(**kwargs)
    if scheduler_name:
        job.spec.scheduler_name = scheduler_name
    return REF.codec.envelope(job)


def make_cluster(P, nodes=3, cpu="8", mem="16Gi", **kwargs):
    cluster = P.cluster.Cluster(**kwargs)
    for n in range(nodes):
        cluster.store.create(P.tu.build_node(
            f"node-{n}", P.tu.build_resource_list_with_pods(cpu, mem)))
    return cluster


def submit(P, cluster, data):
    return cluster.store.create(decode(P, data))


def finish_pods(P, cluster, phase=None):
    for pod in cluster.store.list("Pod"):
        if pod.status.phase == P.objects.POD_PHASE_RUNNING:
            updated = copy.deepcopy(pod)
            updated.status.phase = phase or P.objects.POD_PHASE_SUCCEEDED
            cluster.store.update_status(updated)


def job_state(cluster, name="job1", namespace="ns1"):
    return cluster.store.get("Job", namespace, name).status.state.phase


def _running(P, pods):
    return all(p.status.phase == P.objects.POD_PHASE_RUNNING for p in pods)


# -- TestPipeline -----------------------------------------------------------

def test_submit_to_completed(pinned):
    def scenario(P):
        O = P.objects
        cluster = make_cluster(P)
        submit(P, cluster, manifest(min_available=2, tasks=(("worker", 2),)))
        cluster.settle(4)
        # pods created, gated until Inqueue, then bound and started
        pods = cluster.store.list("Pod", namespace="ns1")
        assert len(pods) == 2
        assert all(p.spec.node_name for p in pods)
        assert _running(P, pods)
        assert job_state(cluster) == O.JobPhase.RUNNING
        pg = cluster.store.get("PodGroup", "ns1", "job1")
        assert pg.status.phase == O.PodGroupPhase.RUNNING
        finish_pods(P, cluster)
        cluster.settle(3)
        assert job_state(cluster) == O.JobPhase.COMPLETED
        return cluster.store, sorted((p.metadata.name, p.spec.node_name) for p in pods)

    twin(pinned, scenario, BOTH)


def test_delay_pod_creation_gate(pinned):
    # without capacity the PodGroup stays Pending and pods are never
    # admitted (docs/design/delay-pod-creation.md)
    def scenario(P):
        cluster = make_cluster(P, nodes=0)
        submit(P, cluster, manifest(min_available=2, tasks=(("worker", 2),)))
        cluster.settle(3)
        assert cluster.store.list("Pod", namespace="ns1") == []
        pg = cluster.store.get("PodGroup", "ns1", "job1")
        assert pg.status.phase == P.objects.PodGroupPhase.PENDING
        return cluster.store, pg.status.phase

    twin(pinned, scenario, BOTH)


def test_gang_all_or_nothing_across_jobs(pinned):
    # one node fits only one 4-gang; second job waits entirely
    def scenario(P):
        cluster = make_cluster(P, nodes=1, cpu="4", mem="8Gi")
        for name in ("gang-a", "gang-b"):
            submit(P, cluster, manifest(name=name, min_available=4, tasks=(("w", 4),)))
        cluster.settle(4)
        bound = {p.metadata.annotations[P.objects.JOB_NAME_KEY]
                 for p in cluster.store.list("Pod") if p.spec.node_name}
        assert len(bound) == 1  # exactly one whole gang
        return cluster.store, sorted(bound)

    twin(pinned, scenario, BOTH)


def test_tpu_conf_pipeline(pinned):
    def scenario(P):
        cluster = make_cluster(P, scheduler_conf=tpu_conf(P))
        submit(P, cluster, manifest(min_available=2, tasks=(("worker", 2),)))
        cluster.settle(4)
        pods = cluster.store.list("Pod", namespace="ns1")
        assert len(pods) == 2 and all(p.spec.node_name for p in pods)
        return cluster.store, sorted(p.spec.node_name for p in pods)

    twin(pinned, scenario, BOTH)


# -- TestMPIRendezvous, TestPSWorkerRendezvous ------------------------------

def test_mpi_job_hostfile_and_keys(pinned):
    """The reference's e2e MPI flow (test/e2e/mpi.go:26-78): master +
    workers with svc/ssh plugins; hostfile lists worker DNS names."""
    def scenario(P):
        cluster = make_cluster(P)
        submit(P, cluster, manifest(
            name="lm-mpi-job", min_available=3,
            tasks=(("mpimaster", 1), ("mpiworker", 2)),
            plugins={"ssh": [], "svc": []}))
        cluster.settle(4)
        cm = cluster.store.get("ConfigMap", "ns1", "lm-mpi-job-svc")
        assert cm.data["mpiworker.host"].splitlines() == [
            "lm-mpi-job-mpiworker-0.lm-mpi-job",
            "lm-mpi-job-mpiworker-1.lm-mpi-job",
        ]
        assert "id_rsa" in cluster.store.get("ConfigMap", "ns1", "lm-mpi-job-ssh").data
        pods = cluster.store.list("Pod", namespace="ns1")
        assert len(pods) == 3
        assert _running(P, pods)
        for p in pods:
            assert p.spec.hostname == p.metadata.name
        assert {p.spec.subdomain for p in pods} == {"lm-mpi-job"}
        return cluster.store, cm.data

    twin(pinned, scenario, BOTH)


def test_tf_style_ps_worker_job(pinned):
    """The reference's distributed-TF e2e (test/e2e/tensorflow.go:123):
    ps x2 + worker x4 with the env and svc plugins; the gang blocks the
    whole job until both groups fit, then each pod has its per-group
    VK_TASK_INDEX and DNS identity and the svc ConfigMap a hostfile a
    group."""
    def scenario(P):
        O = P.objects
        cluster = make_cluster(P, nodes=1, cpu="4", mem="8Gi")
        submit(P, cluster, manifest(
            name="dist-mnist", min_available=6,
            tasks=(("ps", 2), ("worker", 4)), plugins={"env": [], "svc": []}))
        cluster.settle(4)
        # gang-blocked: 6 x 1cpu > 4 cpu — no pod of EITHER group binds
        bound = [p for p in cluster.store.list("Pod", namespace="ns1")
                 if p.spec.node_name]
        assert bound == [], "gang must stay whole while capacity is short"
        pg = cluster.store.get("PodGroup", "ns1", "dist-mnist")
        assert pg.status.phase != O.PodGroupPhase.RUNNING
        # capacity arrives -> the whole heterogeneous gang binds at once
        cluster.store.create(P.tu.build_node(
            "node-late", P.tu.build_resource_list_with_pods("8", "16Gi")))
        cluster.settle(5)
        pods = cluster.store.list("Pod", namespace="ns1")
        assert len(pods) == 6
        assert all(p.spec.node_name for p in pods)
        assert _running(P, pods)
        cm = cluster.store.get("ConfigMap", "ns1", "dist-mnist-svc")
        assert cm.data["ps.host"].splitlines() == [
            "dist-mnist-ps-0.dist-mnist", "dist-mnist-ps-1.dist-mnist"]
        assert cm.data["worker.host"].splitlines() == [
            f"dist-mnist-worker-{i}.dist-mnist" for i in range(4)]
        by_group = {}
        for p in pods:
            group = p.metadata.annotations[O.TASK_SPEC_KEY]
            env = {e.name: e.value for c in p.spec.containers for e in c.env}
            by_group.setdefault(group, []).append(int(env["VK_TASK_INDEX"]))
        assert sorted(by_group["ps"]) == [0, 1]
        assert sorted(by_group["worker"]) == [0, 1, 2, 3]
        assert {p.spec.subdomain for p in pods} == {"dist-mnist"}
        for p in pods:
            assert p.spec.hostname == p.metadata.name
        finish_pods(P, cluster)
        cluster.settle(3)
        assert job_state(cluster, "dist-mnist") == O.JobPhase.COMPLETED
        return cluster.store, {k: sorted(v) for k, v in by_group.items()}

    twin(pinned, scenario, BOTH)


# -- TestLifecyclePolicies --------------------------------------------------

def test_pod_failure_restarts_and_reschedules(pinned):
    def scenario(P):
        O = P.objects
        cluster = make_cluster(P)
        submit(P, cluster, manifest(
            min_available=2, tasks=(("worker", 2),),
            policies=[REF.objects.LifecyclePolicy(
                event=REF.objects.JobEvent.POD_FAILED,
                action=REF.objects.JobAction.RESTART_JOB)]))
        cluster.settle(4)
        assert job_state(cluster) == O.JobPhase.RUNNING
        # kill one pod -> RestartJob -> pods recreated and rescheduled
        victim = cluster.store.list("Pod", namespace="ns1")[0]
        updated = copy.deepcopy(victim)
        updated.status.phase = O.POD_PHASE_FAILED
        updated.status.container_statuses = [O.ContainerStatus(name="c", exit_code=1)]
        cluster.store.update_status(updated)
        cluster.settle(6)
        stored = cluster.store.get("Job", "ns1", "job1")
        assert stored.status.retry_count >= 1
        assert stored.status.state.phase == O.JobPhase.RUNNING
        pods = cluster.store.list("Pod", namespace="ns1")
        assert len(pods) == 2
        assert _running(P, pods)
        return cluster.store, stored.status.retry_count

    twin(pinned, scenario, BOTH)


def test_ttl_garbage_collection(pinned):
    def scenario(P):
        cluster = make_cluster(P)
        submit(P, cluster, manifest(min_available=1, tasks=(("w", 1),), ttl=0))
        cluster.settle(4)
        finish_pods(P, cluster)
        cluster.settle(4)
        # ttl=0: collected as soon as it finishes
        assert cluster.store.try_get("Job", "ns1", "job1") is None
        return cluster.store, None

    twin(pinned, scenario, BOTH)


# -- TestAdmission ----------------------------------------------------------

def _bad_jobs():
    """The reference test's rejected Jobs as manifests, each with the
    message its rejection must match."""
    R = REF.objects
    out = [(manifest(None, min_available=0), "minAvailable"),
           (manifest(None, min_available=5, tasks=(("w", 2),)), "total replicas"),
           (manifest(None, tasks=(("w", 2), ("w", 1)), min_available=1),
            "duplicated task name"),
           (manifest(None, min_available=1, tasks=(("UPPER", 1),)), "RFC 1123"),
           (manifest(None, min_available=1, tasks=(("w", 1),),
                     policies=[R.LifecyclePolicy(event=R.JobEvent.POD_FAILED,
                                                 exit_code=3,
                                                 action=R.JobAction.ABORT_JOB)]),
            "simultaneously")]
    queue = manifest(None, min_available=1, tasks=(("w", 1),))
    queue["object"]["spec"]["queue"] = "no-such-queue"
    out.append((queue, "queue"))
    out.append((manifest(None, min_available=1, tasks=(("w", 1),),
                         plugins={"teleport": []}), "job plugin"))
    return out


def test_invalid_jobs_rejected(pinned):
    def scenario(P):
        cluster = make_cluster(P)
        errors = []
        for data, match in _bad_jobs():
            with pytest.raises(P.store.AdmissionError, match=match) as e:
                submit(P, cluster, data)
            errors.append(str(e.value))
        assert cluster.store.list("Job") == []
        return cluster.store, errors

    twin(pinned, scenario, BOTH)


def test_mutation_defaults(pinned):
    def scenario(P):
        cluster = make_cluster(P)
        data = manifest(None, min_available=1, tasks=(("", 1),))
        data["object"]["spec"]["queue"] = ""
        submit(P, cluster, data)
        stored = cluster.store.get("Job", "ns1", "job1")
        assert stored.spec.queue == "default"
        assert stored.spec.tasks[0].name == "task0"
        return cluster.store, (stored.spec.queue, stored.spec.tasks[0].name)

    twin(pinned, scenario, BOTH)


# -- TestThreadedCluster ----------------------------------------------------

def test_threaded_pipeline():
    """``run()``'s threads carry the Job to two Running pods in both
    packages, on the same nodes."""
    seen = {}
    for P in (REF, PORT):
        P.helper.reset_round_robin()
        cluster = make_cluster(P, schedule_period=0.05)
        cluster.run()
        try:
            submit(P, cluster, manifest(min_available=2, tasks=(("worker", 2),)))
            deadline = time.time() + 20
            while time.time() < deadline:
                pods = cluster.store.list("Pod", namespace="ns1")
                if len(pods) == 2 and _running(P, pods):
                    break
                time.sleep(0.05)
            else:
                raise AssertionError(f"{P.name}: pods never started running")
        finally:
            cluster.stop()
        seen[P.name] = (
            sorted((p.metadata.name, p.spec.node_name, p.status.phase) for p in pods),
            job_state(cluster),
            cluster.store.get("PodGroup", "ns1", "job1").status.phase)
    assert seen["volcano_tpu_torch"] == seen["volcano_tpu"]


# -- TestJobCascadeDeletion -------------------------------------------------

def test_deleting_job_reaps_children(pinned):
    """Deleting a Job cascades to its pods, PodGroup and plugin resources,
    and the freed capacity binds a new gang."""
    def scenario(P):
        cluster = make_cluster(P)
        submit(P, cluster, manifest(min_available=2, tasks=(("worker", 2),),
                                    plugins={"svc": [], "ssh": []}))
        cluster.settle(4)
        store = cluster.store
        assert len(store.list("Pod", namespace="ns1")) == 2
        assert store.try_get("PodGroup", "ns1", "job1") is not None
        assert store.try_get("ConfigMap", "ns1", "job1-svc") is not None
        store.delete("Job", "ns1", "job1")
        cluster.settle(4)
        assert store.list("Pod", namespace="ns1") == []
        assert store.try_get("PodGroup", "ns1", "job1") is None
        assert store.try_get("ConfigMap", "ns1", "job1-svc") is None
        assert store.try_get("ConfigMap", "ns1", "job1-ssh") is None
        submit(P, cluster, manifest(name="job2", min_available=2, tasks=(("w", 2),)))
        cluster.settle(4)
        pods = store.list("Pod", namespace="ns1")
        assert len(pods) == 2 and all(p.spec.node_name for p in pods)
        return store, sorted((p.metadata.name, p.spec.node_name) for p in pods)

    twin(pinned, scenario, BOTH)


# -- tests/test_remote_watch.py::test_remote_controller_observes_phase_flip -

# example/job.yaml's gang job as a manifest: one 6-replica task group,
# minAvailable 3, a restart-on-evict policy, the env/ssh/svc plugins
EXAMPLE_JOB = {"kind": "Job", "object": {
    "metadata": {"name": "watch-job", "namespace": "default"},
    "spec": {
        "min_available": 3, "scheduler_name": "volcano", "queue": "default",
        "max_retry": 5, "plugins": {"ssh": [], "env": [], "svc": []},
        "policies": [{"event": "PodEvicted", "action": "RestartJob"}],
        "tasks": [{"name": "default-nginx", "replicas": 6, "template": {"spec": {
            "containers": [{"name": "nginx", "image": "nginx", "requests": {
                "cpu": "1"}}]}}}]}}}


def _wait(predicate, timeout=30.0, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        out = predicate()
        if out:
            return out
        time.sleep(interval)
    return None


def test_remote_controller_observes_phase_flip():
    """A controller outside the cluster: the port's QueueController wired
    to a port RemoteStore watches Queue/PodGroup over HTTP, sees the live
    scheduler flip a PodGroup's phase, and aggregates it into QueueStatus
    via remote update_status (the reference's informer-client topology)."""
    from volcano_tpu_torch.controllers.queue import QueueController
    from volcano_tpu_torch.store.gateway import ApiGateway
    from volcano_tpu_torch.store.remote import RemoteStore
    from volcano_tpu_torch.store.store import WatchHandler

    PORT.helper.reset_round_robin()
    cluster = make_cluster(PORT, nodes=4, schedule_period=0.2)
    gw = ApiGateway(cluster.store, "127.0.0.1:0", token="watch-tok").start()
    cluster.run()
    remote = RemoteStore(f"127.0.0.1:{gw.port}", token="watch-tok")
    try:
        # the cluster mutates stored objects in place before publishing
        # (in-process aliasing), so MODIFIED's old/new can show the same
        # phase: observe the phase timeline instead and assert the flip
        # from the sequence of watch events
        phases = {}

        def saw(pg):
            phases.setdefault(
                f"{pg.metadata.namespace}/{pg.metadata.name}", []
            ).append(pg.status.phase)

        remote.watch("PodGroup", WatchHandler(
            added=saw, updated=lambda old, new: saw(new)))
        ctl = QueueController(remote)
        # submit through the same remote surface; the live cluster
        # schedules it and flips its PodGroup's phase
        remote.create(decode(PORT, EXAMPLE_JOB))
        got = _wait(lambda: [k for k, seq in phases.items()
                             if len(set(seq)) >= 2])
        assert got, \
            f"no PodGroup phase flip observed over the remote watch: {phases}"

        def queue_running():
            ctl.process_all()
            q = remote.try_get("Queue", "", "default")
            return q is not None and (q.status.running or q.status.inqueue)

        assert _wait(queue_running), \
            "remote QueueController never aggregated the phase flip"
    finally:
        # wake the long polls (one write of each watched kind after the
        # stop flag) so the watch threads see the flag and join at once
        remote._watch_stop.set()
        for kind in ("PodGroup", "Queue"):
            cluster.store.create(PORT.codec.kind_class(kind)(
                metadata=PORT.objects.ObjectMeta(name="zz-wake", namespace="wake")))
        remote.stop_watches()
        cluster.stop()
        gw.stop()


# -- the job controller's drain cap (a reference property) ------------------

@pytest.mark.parametrize("pkg", ["volcano_tpu", "volcano_tpu_torch"])
def test_drain_cap_counts_each_job_and_each_new_pod(pkg):
    """``JobController.process_all(max_iterations=10000)`` drains one pass:
    once the enqueue action admits J four-task Jobs' PodGroups, the pass
    takes each Job's deferred request and then one request a pod it made,
    5 J in all, so J > 2,000 (8,000 pods submitted at once) raises "did not
    converge" in both packages. Here J = 10 against a cap of 49."""
    P = {p.name: p for p in BOTH}[pkg]
    P.helper.reset_round_robin()
    cluster = make_cluster(P, nodes=10)
    for j in range(10):
        submit(P, cluster, manifest(name=f"job{j}", min_available=4,
                                    tasks=(("worker", 4),)))
    cluster._ensure_cache()
    jc = cluster.job_controller
    assert jc.process_all() == 10  # each Job's first sync; its pods refused
    cluster.podgroup_controller.process_all()
    cluster.scheduler.run_once()   # enqueue: every PodGroup Inqueue
    with pytest.raises(RuntimeError, match="did not converge"):
        jc.process_all(max_iterations=49)
    assert jc.process_all() == 1
    assert len(cluster.store.list("Pod")) == 40


# -- version.py ---------------------------------------------------------------

def test_version_string_matches_the_reference():
    import volcano_tpu
    import volcano_tpu_torch
    from volcano_tpu import version as ref_version
    from volcano_tpu_torch import version as port_version

    assert volcano_tpu_torch.__version__ == volcano_tpu.__version__
    lines = [v.version_string().splitlines() for v in (ref_version, port_version)]
    assert [line.split(":")[0] for line in lines[1]] == ["Version", "Git SHA", "Built At"]
    assert lines[1][:2] == lines[0][:2]


# -- a whole cluster above AUTO_ROUNDS_THRESHOLD -----------------------------

CFG2_SCALE = 0.45


def test_cfg2_jobs_through_the_cluster_match_the_reference(pinned):
    """cfg2's job shape at 0.45 (2,248 tasks, above the 2,048 rounds
    threshold) submitted as Jobs to a Cluster of each package with the
    tpuscore conf in rounds mode: after settle(), equal stores (every
    pod's node, every status and timestamp, the Scheduled events), every
    pod Running."""
    nodes, jobs = chip_smoke.cfg2_cluster(CFG2_SCALE)
    node_data = [PORT.codec.envelope(n) for n in nodes]
    job_data = [PORT.codec.envelope(j) for j in jobs]
    n_tasks = sum(len(j.spec.tasks) for j in jobs)
    assert n_tasks == 2248 and len(nodes) == 450

    def scenario(P):
        O = P.objects
        cluster = P.cluster.Cluster(scheduler_conf=tpu_conf(P, "rounds"))
        # the clock stays pinned's counter of reads: both packages read it
        # at the same points, the degrade ladder's note of a rounds solve's
        # success among them
        for data in node_data:
            cluster.store.create(decode(P, data))
        for data in job_data:
            submit(P, cluster, data)
        cluster.settle(3)
        store = cluster.store
        pods = store.list("Pod")
        assert len(pods) == n_tasks
        assert all(p.spec.node_name for p in pods) and _running(P, pods)
        assert {j.status.state.phase for j in store.list("Job")} == {O.JobPhase.RUNNING}
        queue = store.get("Queue", "", "default").status
        assert queue.running == len(jobs)
        scheduled = [e.object_key for e in store.events if e.reason == "Scheduled"]
        assert sorted(scheduled) == sorted(
            f"{p.metadata.namespace}/{p.metadata.name}" for p in pods)
        return store, len(scheduled)

    assert twin(pinned, scenario, BOTH) == n_tasks


def test_a_dropped_job_request_is_not_retried_when_its_podgroup_is_admitted(pinned):
    """Reference fault (ROADMAP Queue 3, found by chip_smoke's phase 17(b),
    the process split): the job controller syncs a Job whose PodGroup is still Pending
    and the admission gate refuses its pods; after its retry budget
    (``MAX_REQUEUE_NUM`` failed attempts) it drops the request. When the
    scheduler's enqueue then admits the PodGroup, the controller's
    PodGroup handler enqueues the Job only for the Unknown phase, so the
    Job never gets its pods (upstream's ``updatePodGroup`` enqueues on any
    phase change). Both packages hold the same: the request dropped, the
    PodGroup Inqueue, no pod."""
    def scenario(P):
        O = P.objects
        cluster = make_cluster(P)
        submit(P, cluster, manifest())
        jc = cluster.job_controller
        budget = importlib.import_module(
            f"{P.name}.controllers.job.controller").MAX_REQUEUE_NUM
        for _ in range(budget + 2):
            jc.process_all()
        store = cluster.store
        assert any(e.reason == "FailedRequest" for e in store.events)
        pg = copy.deepcopy(store.get("PodGroup", "ns1", "job1"))
        assert pg.status.phase == O.PodGroupPhase.PENDING
        pg.status.phase = O.PodGroupPhase.INQUEUE
        store.update_status(pg)
        for _ in range(3):
            jc.process_all()
        assert store.list("Pod", namespace="ns1") == []
        return store, len(store.list("Pod"))

    assert twin(pinned, scenario, BOTH) == 0
