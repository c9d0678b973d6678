"""SchedulerCache — the cluster mirror the session snapshots from
(volcano pkg/scheduler/cache/{cache.go,event_handlers.go}).

Mirrors the store into JobInfo/NodeInfo/QueueInfo maps via watch streams,
produces the per-session deep-clone ``snapshot()``, and owns the effector
write-path (bind/evict/status) with resync-on-failure.

Differences from the reference, by design:
- watches are synchronous store callbacks, not informer goroutines, so
  ``wait_for_cache_sync`` is trivially true and the whole cache is
  deterministic (a property the replay benchmarks rely on);
- bind/evict call the effector inline rather than in a goroutine; failures
  feed the same ``resync`` path (cache.go:597-613 does this asynchronously).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

import numpy as np

from volcano_tpu_torch.api import objects
from volcano_tpu_torch.api.cluster_info import ClusterInfo
from volcano_tpu_torch.api.job_info import JobInfo, TaskInfo, new_task_info
from volcano_tpu_torch.api.namespace_info import NamespaceCollection
from volcano_tpu_torch.api.node_info import NodeInfo
from volcano_tpu_torch.api.queue_info import QueueInfo
from volcano_tpu_torch.api.types import TaskStatus, allocated_status
from volcano_tpu_torch.api.unschedule_info import ALL_NODE_UNAVAILABLE
from volcano_tpu_torch.scheduler.cache.interface import BindManyError
from volcano_tpu_torch.store import FencedError, NotFoundError, Store, WatchHandler


def _add_res_vec(res, vec, sign: float, scalar_names) -> None:
    """res += sign * vec over the encoder's resource layout
    (cpu, memory, *scalar_names) — the flush-side twin of the solver's
    apply_delta (ops/solver.py _apply_bulk)."""
    res.milli_cpu += sign * vec[0]
    res.memory += sign * vec[1]
    for si, name in enumerate(scalar_names):
        q = vec[2 + si]
        if q:
            res.add_scalar(name, sign * q)


def _is_terminated(status: TaskStatus) -> bool:
    return status in (TaskStatus.SUCCEEDED, TaskStatus.FAILED)


def pod_group_job_id(pg: objects.PodGroup) -> str:
    return f"{pg.metadata.namespace}/{pg.metadata.name}"


# ---------------------------------------------------------------------------
# Default effectors (write back to the store; cache.go:123-260)
# ---------------------------------------------------------------------------


class DefaultBinder:
    """Commit placement by setting spec.node_name (the Bind subresource).

    ``fence_epoch`` stamps every bind with the leadership epoch that
    authorized it (None = fencing off): a deposed leader finishing an
    in-flight fused chain cannot double-bind — the store rejects the
    stale stamp (FencedError) and the failure feeds the ordinary
    resync/rewind machinery. Rejections are counted per instance so the
    failover auditor can balance them against the store's accounting."""

    fence_epoch = None

    def __init__(self, store: Store):
        self.store = store
        self.fenced_rejections = 0

    def bind(self, pod: objects.Pod, hostname: str) -> None:
        pod.spec.node_name = hostname
        try:
            self.store.update(pod, epoch=self.fence_epoch)
        except FencedError:
            self.fenced_rejections += 1
            raise

    def bind_many(self, pairs) -> None:
        """Batch bind; reports partial progress so a mid-batch failure only
        retries the unbound remainder (interface.BindManyError contract)."""
        done = 0
        try:
            for pod, hostname in pairs:
                self.bind(pod, hostname)
                done += 1
        except Exception as e:
            raise BindManyError(done, e) from e


class DefaultEvictor:
    """Graceful deletion: stamp deletion_timestamp; the kubelet analog
    completes the termination. Evictions are fenced exactly like binds —
    a deposed leader must not terminate pods the new leader just placed
    or re-affirmed."""

    fence_epoch = None

    def __init__(self, store: Store):
        self.store = store
        self.fenced_rejections = 0

    def evict(self, pod: objects.Pod, reason: str = "") -> None:
        from volcano_tpu_torch.utils import clock

        pod.metadata.deletion_timestamp = clock.now()
        try:
            self.store.update(pod, epoch=self.fence_epoch)
        except FencedError:
            self.fenced_rejections += 1
            raise


class DefaultStatusUpdater:
    """Status writebacks tolerate deletion races: the snapshot a session
    closes against can be a full cycle stale, and an object deleted in the
    meantime makes its status update moot, not an error — the reference's
    updater logs update failures and moves on (job_updater.go:44-52).
    Fenced rejections are likewise moot-but-counted: a deposed leader's
    close-time condition/status writes must degrade to accounting, not
    crash the close path or overwrite the new leader's truth."""

    fence_epoch = None

    def __init__(self, store: Store):
        self.store = store
        self.fenced_rejections = 0

    def update_pod_condition(self, pod: objects.Pod, condition) -> None:
        for i, c in enumerate(pod.status.conditions):
            if c.type == condition.type:
                pod.status.conditions[i] = condition
                break
        else:
            pod.status.conditions.append(condition)
        try:
            self.store.update(pod, epoch=self.fence_epoch)
        except FencedError:
            self.fenced_rejections += 1
        except NotFoundError:
            pass  # pod deleted since the session snapshot

    def update_pod_group(self, pod_group: objects.PodGroup, status=None) -> None:
        if status is not None:
            # close-time status writeback on the SHARED PodGroup object:
            # the cache and every snapshot clone see it the instant it
            # lands, and the synchronous store echo is recognized by
            # add_pod_group's identity window.
            # vclint: neutral(shared-object status writeback; the echo window owns the mark decision)
            pod_group.status = status
        try:
            self.store.update_status(pod_group, epoch=self.fence_epoch)
        except FencedError:
            self.fenced_rejections += 1
        except NotFoundError:
            pass  # pod group deleted since the session snapshot


class DefaultVolumeBinder:
    """Storeless stand-in: volumes are considered host-agnostic. IS_NOOP
    lets the bulk writeback skip per-task volume calls entirely."""

    IS_NOOP = True

    def allocate_volumes(self, task: TaskInfo, hostname: str) -> None:
        task.volume_ready = True

    def bind_volumes(self, task: TaskInfo) -> None:
        pass


class StoreVolumeBinder:
    """PV assume/bind against real PersistentVolume objects — the analog
    of the reference's defaultVolumeBinder wrapping the k8s volumebinder
    (cache.go:240-258): AllocateVolumes ASSUMES a compatible volume for
    each unbound PVC the pod references on the chosen host (raising fails
    the allocation, exactly as an assume failure does), BindVolumes
    commits the assumption (PV/PVC flip to Bound in the store)."""

    def __init__(self, store: Store):
        self.store = store
        # task uid -> [(pvc, pv)] assumed but not yet bound
        self._assumed: Dict[str, list] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _pvc_names(task: TaskInfo) -> list:
        pod = task.pod
        if pod is None:
            return []
        return [v.persistent_volume_claim for v in pod.spec.volumes
                if v.persistent_volume_claim]

    def allocate_volumes(self, task: TaskInfo, hostname: str) -> None:
        names = self._pvc_names(task)
        if not names:
            task.volume_ready = True
            return
        from volcano_tpu_torch.api.quantity import parse_quantity

        assumed = []
        with self._lock:
            taken = {pv.metadata.name for lst in self._assumed.values()
                     for _, pv in lst}
            for name in names:
                pvc = self.store.try_get(
                    "PersistentVolumeClaim", task.namespace, name)
                if pvc is None:
                    raise RuntimeError(
                        f"pvc {task.namespace}/{name} not found")
                if pvc.phase == "Bound":
                    # a bound volume constrains placement: the host must
                    # satisfy the volume's node affinity
                    pv = self.store.try_get(
                        "PersistentVolume", "", pvc.volume_name)
                    if pv is not None and pv.node_names \
                            and hostname not in pv.node_names:
                        raise RuntimeError(
                            f"pvc {task.namespace}/{name} is bound to "
                            f"volume {pv.metadata.name} not reachable from "
                            f"{hostname}")
                    continue
                want = parse_quantity(pvc.requests.get("storage", 0))
                best = None
                for pv in self.store.list("PersistentVolume"):
                    if pv.phase != "Available" or pv.claim_ref:
                        continue
                    if pv.metadata.name in taken:
                        continue
                    if pv.node_names and hostname not in pv.node_names:
                        continue
                    have = parse_quantity(pv.capacity.get("storage", 0))
                    if have < want:
                        continue
                    # smallest sufficient volume, name tie-break — the
                    # k8s binder's smallest-fit policy, deterministic
                    key = (have, pv.metadata.name)
                    if best is None or key < (best[0], best[1].metadata.name):
                        best = (have, pv)
                if best is None:
                    raise RuntimeError(
                        f"no PersistentVolume fits pvc "
                        f"{task.namespace}/{name} on {hostname}")
                taken.add(best[1].metadata.name)
                assumed.append((pvc, best[1]))
            if assumed:
                self._assumed.setdefault(task.uid, []).extend(assumed)
        task.volume_ready = True

    def bind_volumes(self, task: TaskInfo) -> None:
        with self._lock:
            assumed = self._assumed.pop(task.uid, [])
        for pvc, pv in assumed:
            pv.claim_ref = f"{pvc.metadata.namespace}/{pvc.metadata.name}"
            pv.phase = "Bound"
            pvc.phase = "Bound"
            pvc.volume_name = pv.metadata.name
            self.store.update_status(pv)
            self.store.update_status(pvc)

    def unassume(self, task: TaskInfo) -> None:
        """Release assumptions for a task whose placement was discarded
        (statement rollback); bound volumes are untouched."""
        with self._lock:
            self._assumed.pop(task.uid, None)

    def reset_assumptions(self) -> None:
        """Session close: drop every unbound assumption — assume/bind
        always completes within one session (dispatch or statement
        commit), so leftovers belong to placements that never dispatched
        and would otherwise pin their PVs forever."""
        with self._lock:
            self._assumed.clear()


# ---------------------------------------------------------------------------
# The cache
# ---------------------------------------------------------------------------


class SchedulerCache:
    def __init__(
        self,
        store: Optional[Store] = None,
        scheduler_name: str = "volcano",
        default_queue: str = "default",
        binder=None,
        evictor=None,
        status_updater=None,
        volume_binder=None,
    ):
        self.store = store
        self.scheduler_name = scheduler_name
        self.default_queue = default_queue

        self.binder = binder if binder is not None else (DefaultBinder(store) if store else None)
        self.evictor = evictor if evictor is not None else (DefaultEvictor(store) if store else None)
        self.status_updater = (
            status_updater if status_updater is not None else (DefaultStatusUpdater(store) if store else None)
        )
        self.volume_binder = (
            volume_binder if volume_binder is not None
            else (StoreVolumeBinder(store) if store else DefaultVolumeBinder()))

        from volcano_tpu_torch.scheduler.cache.podtable import PodTable
        from volcano_tpu_torch.scheduler.cache.snapkeeper import SnapshotKeeper

        self.pod_table = PodTable()
        # delta-maintained session snapshot (snapkeeper.py): watch/effector
        # mutation paths below mark the touched job/node so snapshot()
        # re-clones only what moved since the last session
        self.snap_keeper = SnapshotKeeper()
        self.jobs: Dict[str, JobInfo] = {}
        self.nodes: Dict[str, NodeInfo] = {}
        self.queues: Dict[str, QueueInfo] = {}
        self.priority_classes: Dict[str, objects.PriorityClass] = {}
        self.default_priority = 0
        self.namespace_collection: Dict[str, NamespaceCollection] = {}

        self._lock = threading.RLock()
        # pods referencing PVCs (bulk-apply volume-call gate: a session
        # with none skips per-task volume work entirely)
        self._pvc_pod_count = 0
        self._err_tasks: List[TaskInfo] = []
        self._deleted_jobs: List[JobInfo] = []
        # native mirror-transition ctx for the effector path (built lazily;
        # False = not attempted, None = unavailable). jobs/nodes dict
        # objects are created once above and never reassigned, so the ctx
        # stays valid for the cache's lifetime.
        self._fast_mirror = False
        # deferred bulk-writeback payloads (ops/solver.py _apply_bulk): the
        # cache-side half of a session's placements, applied at session
        # close / before the next snapshot — the reference's Bind is async
        # and its cache learns statuses from later watch events, so the
        # mirror being one flush behind inside a cycle is the faithful
        # semantic (cache.go:123-135,597-613)
        self._pending_mirrors: List[dict] = []
        # express lane (volcano_tpu_torch/express): the lane registers itself
        # plus an arrival listener; the listener runs under the cache lock
        # from the watch handlers and must only enqueue
        self.express_lane = None
        self._arrival_listener = None
        # lease-epoch fencing (store/store.py): the epoch stamped onto
        # every effector write of the current leadership term, and the
        # count of writes the store rejected as stale (split-brain
        # attempts that the fence turned into ordinary effector failures)
        self.fence_epoch = None
        self.fenced_writes = 0
        # a new leadership term owes the cluster one recovery sweep: the
        # first session after set_fence_epoch reverts any half-bound gang
        # a deposed leader's fenced mid-chain abort left in the store
        # (framework.run_actions consumes this flag)
        self.fence_sweep_due = False
        # continuous pipeline (volcano_tpu_torch/pipeline): when armed, every
        # snapshot() alternates the keeper's double buffer so consecutive
        # sessions never share clone objects (cycle N's close can still
        # read its snapshot while cycle N+1's is already solving)
        self._pipeline_swap = False
        # self-echo window (update_job_status): the in-process store
        # dispatches watch callbacks synchronously with the SAME object the
        # writer handed it, so the close-time PodGroup status writeback
        # comes straight back through update_pod_group_from_watch. The
        # mutation already happened on the shared object before the write —
        # marking the job again only churns the dirty-set (and, in pipeline
        # mode, spuriously invalidates every speculative solve-ahead).
        # RemoteStore echoes deserialize to a different object and keep the
        # full mark path.
        self._expect_pg_echo = None

    def set_fence_epoch(self, epoch) -> None:
        """Stamp this cache's effector write-path with a leadership epoch
        (None disarms). Called on lease acquisition BEFORE the session
        loop starts, and deliberately NOT on loss — a deposed term's
        in-flight writes must keep their stale stamp so the store fences
        them, instead of regressing to unfenced authority."""
        self.fence_epoch = epoch
        self.fence_sweep_due = epoch is not None
        for effector in (self.binder, self.evictor, self.status_updater):
            if effector is not None and hasattr(effector, "fence_epoch"):
                effector.fence_epoch = epoch

    def fenced_rejections(self) -> int:
        """Fenced-write rejections observed through this cache's effectors
        plus the bulk-writeback path (the auditor's balance probe)."""
        total = self.fenced_writes
        for effector in (self.binder, self.evictor, self.status_updater):
            total += getattr(effector, "fenced_rejections", 0)
        return total

    def set_arrival_listener(self, fn) -> None:
        """Register the express lane's arrival callback: fn(job_uid) is
        invoked (under the cache lock) whenever a schedulable pending task
        or a PodGroup lands — mirror + enqueue only, by contract."""
        self._arrival_listener = fn

    # -- lifecycle ---------------------------------------------------------

    def run(self) -> None:
        """Wire the 11-informer equivalent: watch every kind the scheduler
        consumes (cache.go:322-425). Idempotent — the scheduler driver and
        an embedding cluster may both call it."""
        if self.store is None or getattr(self, "_watching", False):
            return
        self._watching = True
        s = self.store
        self._watch_regs = [
            ("Pod", WatchHandler(self.add_pod, self.update_pod_from_watch, self.delete_pod)),
            ("Node", WatchHandler(self.add_node, self.update_node_from_watch, self.delete_node)),
            ("PodGroup", WatchHandler(self.add_pod_group, self.update_pod_group_from_watch, self.delete_pod_group)),
            ("Queue", WatchHandler(self.add_queue, self.update_queue_from_watch, self.delete_queue)),
            ("PriorityClass", WatchHandler(self.add_priority_class, self.update_priority_class_from_watch, self.delete_priority_class)),
            ("ResourceQuota", WatchHandler(self.add_resource_quota, self.update_resource_quota_from_watch, self.delete_resource_quota)),
            ("PodDisruptionBudget", WatchHandler(self.add_pdb, self.update_pdb_from_watch, self.delete_pdb)),
        ]
        for kind, handler in self._watch_regs:
            s.watch(kind, handler)

    def detach_watches(self) -> None:
        """Unregister this cache's store watches (sim restart-injection /
        teardown): a replacement cache can then run() against the same
        store without the old cache double-mirroring every write."""
        if self.store is None or not getattr(self, "_watching", False):
            return
        for kind, handler in getattr(self, "_watch_regs", []):
            self.store.unwatch(kind, handler)
        self._watch_regs = []
        self._watching = False

    def wait_for_cache_sync(self) -> bool:
        return True  # synchronous watches are always synced

    # -- pod/task handlers (event_handlers.go:39-200) ----------------------

    def _get_or_create_job(self, ti: TaskInfo) -> Optional[JobInfo]:
        if not ti.job:
            return None
        if ti.job not in self.jobs:
            self.jobs[ti.job] = JobInfo(ti.job)
        return self.jobs[ti.job]

    def _add_task(self, ti: TaskInfo) -> None:
        self.snap_keeper.mark_job(ti.job)
        self.snap_keeper.mark_node(ti.node_name)
        job = self._get_or_create_job(ti)
        if job is not None:
            job.add_task_info(ti)
        if ti.pod is not None and any(
                v.persistent_volume_claim for v in ti.pod.spec.volumes):
            self._pvc_pod_count += 1
        if ti.pod is not None:
            # columnar mirror row (podtable.py): the encoder gathers dense
            # arrays instead of walking 50k task objects per session
            self.pod_table.add(ti.pod, ti)
        if ti.node_name:
            if ti.node_name not in self.nodes:
                self.nodes[ti.node_name] = NodeInfo(None)
            if not _is_terminated(ti.status):
                self.nodes[ti.node_name].add_task(ti)
        elif ti.status == TaskStatus.PENDING and ti.job \
                and self._arrival_listener is not None:
            self._arrival_listener(ti.job)

    def _delete_task(self, ti: TaskInfo) -> None:
        self.snap_keeper.mark_job(ti.job)
        self.snap_keeper.mark_node(ti.node_name)
        if ti.pod is not None and any(
                v.persistent_volume_claim for v in ti.pod.spec.volumes):
            self._pvc_pod_count = max(0, self._pvc_pod_count - 1)
        self.pod_table.remove(ti.uid)
        errs = []
        if ti.job:
            job = self.jobs.get(ti.job)
            if job is not None:
                try:
                    job.delete_task_info(ti)
                except KeyError as e:
                    errs.append(e)
            else:
                errs.append(KeyError(f"failed to find Job {ti.job} for task {ti.namespace}/{ti.name}"))
        if ti.node_name:
            node = self.nodes.get(ti.node_name)
            if node is not None:
                try:
                    node.remove_task(ti)
                except RuntimeError as e:
                    errs.append(e)
        if errs:
            raise RuntimeError("; ".join(str(e) for e in errs))

    def _responsible_for(self, pod: objects.Pod) -> bool:
        """Informer filter (cache.go:352-361): our pods, plus ANY bound pod —
        foreign bound pods must still count against node resources."""
        return (
            pod.spec.scheduler_name == self.scheduler_name
            or bool(pod.metadata.annotations.get(objects.GROUP_NAME_ANNOTATION_KEY))
            or bool(pod.spec.node_name)
        )

    def add_pod(self, pod: objects.Pod) -> None:
        self.flush_mirror()  # watch updates must land on a flushed mirror
        with self._lock:
            if not self._responsible_for(pod):
                return
            self._add_task(new_task_info(pod))

    def update_pod_from_watch(self, old_pod: objects.Pod, new_pod: objects.Pod) -> None:
        self.flush_mirror()  # see add_pod
        with self._lock:
            if old_pod is new_pod and self._neutral_pod_echo(new_pod):
                # a same-object write (in-process store dispatches the
                # writer's object) whose scheduling-relevant derived state
                # matches the cached task: a condition/metadata-only echo
                # — typically our own close-time FailedScheduling
                # writeback. Resyncing would rebuild an equal TaskInfo and
                # re-mark its job/node for nothing (in pipeline mode that
                # mark spuriously discards the speculative solve-ahead).
                # Bind confirmations and kubelet phase flips change the
                # derived status and keep the full resync path.
                return
            self._delete_pod_locked(old_pod)
            if not self._responsible_for(new_pod):
                return
            self._add_task(new_task_info(new_pod))

    def _neutral_pod_echo(self, pod: objects.Pod) -> bool:
        """True when the cached task for ``pod`` already matches the
        pod-derived scheduling state (status + node), so a same-object
        update carries nothing the scheduler can observe. Requests are not
        compared: the pod IS the cached task's pod object, and spec
        resources deriving resreq are immutable post-admission."""
        if not self._responsible_for(pod):
            return False
        pi = new_task_info(pod)
        job = self.jobs.get(pi.job)
        task = job.tasks.get(pi.uid) if job is not None else None
        if task is None or task.pod is not pod:
            return False
        return (task.status == pi.status
                and (task.node_name or "") == (pi.node_name or ""))

    def _delete_pod_locked(self, pod: objects.Pod) -> None:
        pi = new_task_info(pod)
        # Prefer the cached task (it may be in Binding status; event_handlers.go:154-161)
        task = pi
        job = self.jobs.get(pi.job)
        if job is not None and pi.uid in job.tasks:
            task = job.tasks[pi.uid]
        try:
            self._delete_task(task)
        except RuntimeError:
            pass
        if job is not None and job.is_terminated():
            self._delete_job(job)

    def delete_pod(self, pod: objects.Pod) -> None:
        self.flush_mirror()  # see add_pod
        with self._lock:
            self._delete_pod_locked(pod)

    # -- node handlers -----------------------------------------------------

    def add_node(self, node: objects.Node) -> None:
        self.flush_mirror()  # deferred node deltas must precede a set_node/rebuild
        with self._lock:
            self.snap_keeper.mark_node(node.metadata.name)
            if node.metadata.name in self.nodes:
                self.nodes[node.metadata.name].set_node(node)
            else:
                self.nodes[node.metadata.name] = NodeInfo(node)

    def update_node_from_watch(self, old: objects.Node, new: objects.Node) -> None:
        self.add_node(new)

    def delete_node(self, node: objects.Node) -> None:
        self.flush_mirror()  # see add_node
        with self._lock:
            self.snap_keeper.mark_node(node.metadata.name)
            self.nodes.pop(node.metadata.name, None)

    # -- podgroup handlers (event_handlers.go:159-196) ---------------------

    def add_pod_group(self, pg: objects.PodGroup) -> None:
        with self._lock:
            job_id = pod_group_job_id(pg)
            job = self.jobs.get(job_id)
            if pg is self._expect_pg_echo and job is not None \
                    and job.pod_group is pg:
                # our own status writeback echoing back as the identical
                # object: the cache (and every snapshot clone, which
                # shares pod_group) already sees the mutation — re-marking
                # would only dirty the keeper for a value-neutral event.
                # set_pod_group still runs: it re-reads derived fields
                # from the same object (idempotent, cheap).
                # vclint: neutral(same-object echo of our own writeback; value already visible to cache and clones - RemoteStore echoes keep the full mark path)
                job.set_pod_group(pg)
                return
            self.snap_keeper.mark_job(job_id)
            if job_id not in self.jobs:
                self.jobs[job_id] = JobInfo(job_id)
            job = self.jobs[job_id]
            job.set_pod_group(pg)
            if not job.queue:
                job.queue = self.default_queue
            if self._arrival_listener is not None:
                # a group admitted after its pods arrived completes the
                # express eligibility picture — re-nudge the lane
                self._arrival_listener(job_id)

    def update_pod_group_from_watch(self, old: objects.PodGroup, new: objects.PodGroup) -> None:
        self.add_pod_group(new)

    def delete_pod_group(self, pg: objects.PodGroup) -> None:
        self.flush_mirror()  # job deletion must see flushed task state
        with self._lock:
            job_id = pod_group_job_id(pg)
            self.snap_keeper.mark_job(job_id)
            job = self.jobs.get(job_id)
            if job is None:
                return
            job.unset_pod_group()
            self._delete_job(job)

    # -- queue handlers ----------------------------------------------------

    def add_queue(self, queue: objects.Queue) -> None:
        with self._lock:
            if queue.metadata.name not in self.queues:
                # queue SET changes flip job eligibility cluster-wide;
                # updates of an existing queue don't (QueueInfos are
                # re-cloned fresh every snapshot regardless)
                self.snap_keeper.invalidate()
            else:
                # spec updates (weight, capability) re-derive fresh next
                # snapshot, but a speculative solve sealed under the old
                # policy must be invalidated (snapkeeper.mark_meta) —
                # scoped to the queue so the read-set intersect can let
                # noise on a queue the sealed solve never consumed commit
                self.snap_keeper.mark_meta("queue", queue.metadata.name)
            self.queues[queue.metadata.name] = QueueInfo(queue)

    def update_queue_from_watch(self, old: objects.Queue, new: objects.Queue) -> None:
        self.add_queue(new)

    def delete_queue(self, queue: objects.Queue) -> None:
        with self._lock:
            # pop only a queue we actually hold, on the same path as its
            # invalidation — a delete for an unknown queue must neither
            # mutate nor rebuild (VT007: every mutation reaches a mark)
            if queue.metadata.name in self.queues:
                self.snap_keeper.invalidate()
                self.queues.pop(queue.metadata.name, None)

    # -- priority class handlers (event_handlers.go) -----------------------

    def add_priority_class(self, pc: objects.PriorityClass) -> None:
        with self._lock:
            # job.priority derives from the PC set at snapshot time; the
            # dirty-sets don't model that dependency, so rebuild wholesale
            self.snap_keeper.invalidate()
            self.priority_classes[pc.metadata.name] = pc
            if pc.global_default:
                self.default_priority = pc.value

    def update_priority_class_from_watch(self, old, new) -> None:
        self.add_priority_class(new)

    def delete_priority_class(self, pc: objects.PriorityClass) -> None:
        with self._lock:
            self.snap_keeper.invalidate()
            self.priority_classes.pop(pc.metadata.name, None)
            if pc.global_default:
                self.default_priority = 0

    # -- resource quota handlers (namespace weights) -----------------------

    def add_resource_quota(self, quota: objects.ResourceQuota) -> None:
        with self._lock:
            ns = quota.metadata.namespace
            coll = self.namespace_collection.setdefault(ns, NamespaceCollection(ns))
            coll.update(quota)
            # namespace weights re-derive fresh each snapshot; the epoch
            # bump invalidates any speculative solve sealed under the
            # old weights (snapkeeper.mark_meta), scoped to the namespace
            self.snap_keeper.mark_meta("quota", ns)

    def update_resource_quota_from_watch(self, old, new) -> None:
        self.add_resource_quota(new)

    def delete_resource_quota(self, quota: objects.ResourceQuota) -> None:
        with self._lock:
            coll = self.namespace_collection.get(quota.metadata.namespace)
            if coll is not None:
                coll.delete(quota)
                if coll.empty():
                    del self.namespace_collection[quota.metadata.namespace]
                self.snap_keeper.mark_meta("quota", quota.metadata.namespace)

    # -- pdb handlers ------------------------------------------------------

    def add_pdb(self, pdb: objects.PodDisruptionBudget) -> None:
        with self._lock:
            job_id = f"{pdb.metadata.namespace}/{pdb.metadata.name}"
            self.snap_keeper.mark_job(job_id)
            if job_id not in self.jobs:
                self.jobs[job_id] = JobInfo(job_id)
            self.jobs[job_id].set_pdb(pdb)

    def update_pdb_from_watch(self, old, new) -> None:
        self.add_pdb(new)

    def delete_pdb(self, pdb: objects.PodDisruptionBudget) -> None:
        with self._lock:
            job_id = f"{pdb.metadata.namespace}/{pdb.metadata.name}"
            self.snap_keeper.mark_job(job_id)
            job = self.jobs.get(job_id)
            if job is None:
                return
            job.unset_pdb()
            self._delete_job(job)

    # -- job cleanup (cache.go:656-688) ------------------------------------

    def _delete_job(self, job: JobInfo) -> None:
        self.snap_keeper.mark_job(job.uid)
        self._deleted_jobs.append(job)
        self._process_cleanup_jobs()

    def _process_cleanup_jobs(self) -> None:
        remaining = []
        for job in self._deleted_jobs:
            if job.is_terminated():
                self.jobs.pop(job.uid, None)
            else:
                remaining.append(job)
        self._deleted_jobs = remaining

    # -- effector path (cache.go:499-613) ----------------------------------

    def _find_job_and_task(self, task_info: TaskInfo):
        job = self.jobs.get(task_info.job)
        if job is None:
            raise KeyError(f"failed to find Job {task_info.job} for Task {task_info.uid}")
        task = job.tasks.get(task_info.uid)
        if task is None:
            raise KeyError(f"failed to find task in status {task_info.status} by id {task_info.uid}")
        return job, task

    def _mirror(self):
        """Native effector-side transition ctx, or None (Python path). A
        None while the background native compile is still in flight is NOT
        latched — the cache outlives sessions, so giving up on the first
        cold-start call would disable the native path for its lifetime."""
        if self._fast_mirror is False:
            from volcano_tpu_torch.ops import fasttrans

            m = fasttrans.build_mirror(self.jobs, self.nodes)
            if m is None and not fasttrans.native_settled():
                return None  # retry on a later effector call
            self._fast_mirror = m
        return self._fast_mirror

    def bind(self, task_info: TaskInfo, hostname: str) -> None:
        """Update cache state to Binding and invoke the binder; on binder
        failure, queue the task for resync (cache.go:558-613)."""
        mirror = self._mirror()
        with self._lock:
            self.snap_keeper.mark_job(task_info.job)
            self.snap_keeper.mark_node(hostname)
            if mirror is not None:
                task, pod = mirror.mirror_bind(task_info, hostname)
            else:
                job, task = self._find_job_and_task(task_info)
                node = self.nodes.get(hostname)
                if node is None:
                    raise KeyError(f"failed to bind Task {task.uid} to host {hostname}: host does not exist")
                job.update_task_status(task, TaskStatus.BINDING)
                task.node_name = hostname
                node.add_task(task)
                pod = task.pod
        try:
            self.binder.bind(pod, hostname)
        except FencedError:
            # deposed leadership: undo the cache-side flip via resync and
            # RE-RAISE so batch callers (express commit) stop dispatching
            # the rest of a doomed gang instead of burning one rejection
            # per task — per-task callers (Statement commit) already treat
            # a bind failure as non-fatal
            self.resync_task(task)
            raise
        except Exception:
            self.resync_task(task)
        else:
            if self.store is not None:
                self.store.record_event(
                    pod, "Normal", "Scheduled",
                    f"Successfully assigned {pod.metadata.namespace}/{pod.metadata.name} to {hostname}",
                )

    def evict(self, task_info: TaskInfo, reason: str) -> None:
        mirror = self._mirror()
        with self._lock:
            self.snap_keeper.mark_evict(task_info.job, task_info.node_name)
            if mirror is not None:
                task, pod = mirror.mirror_evict(task_info)
            else:
                job, task = self._find_job_and_task(task_info)
                node = self.nodes.get(task.node_name)
                if node is None:
                    raise KeyError(f"failed to evict Task {task.uid}: host {task.node_name} does not exist")
                job.update_task_status(task, TaskStatus.RELEASING)
                node.update_task(task)
                pod = task.pod
        try:
            self.evictor.evict(pod, reason)
        except FencedError:
            self.resync_task(task)
            raise  # see bind(): deposed leadership stops the batch
        except Exception:
            self.resync_task(task)
        else:
            if self.store is not None:
                self.store.record_event(pod, "Normal", "Evict", reason)

    def allocate_volumes(self, task: TaskInfo, hostname: str) -> None:
        self.volume_binder.allocate_volumes(task, hostname)

    def bind_volumes(self, task: TaskInfo) -> None:
        self.volume_binder.bind_volumes(task)

    # -- resync (cache.go:688-710, event_handlers.go:88-105) ---------------

    def resync_task(self, task: TaskInfo) -> None:
        self._err_tasks.append(task)

    def process_resync_tasks(self) -> None:
        """Re-fetch truth from the store for tasks whose effector failed."""
        self.flush_mirror()  # sync_task deletes/re-adds against the mirror
        tasks, self._err_tasks = self._err_tasks, []
        for task in tasks:
            try:
                self.sync_task(task)
            except Exception:
                self._err_tasks.append(task)

    def sync_task(self, old_task: TaskInfo) -> None:
        if self.store is None:
            return
        try:
            new_pod = self.store.get("Pod", old_task.namespace, old_task.name)
        except NotFoundError:
            with self._lock:
                try:
                    self._delete_task(old_task)
                except RuntimeError:
                    pass
            return
        with self._lock:
            self._delete_task(old_task)
            self._add_task(new_task_info(new_pod))

    # -- status writeback (cache.go:832-895) -------------------------------

    def task_unschedulable(self, task: TaskInfo, message: str) -> None:
        """Record FailedScheduling + update the PodScheduled condition
        (cache.go:629-655), deduping unchanged conditions."""
        pod = task.pod
        condition = objects.PodCondition(
            type="PodScheduled", status="False", reason="Unschedulable", message=message
        )
        for c in pod.status.conditions:
            if (
                c.type == condition.type
                and c.status == condition.status
                and c.message == condition.message
            ):
                return  # no update needed
        if self.store is not None:
            self.store.record_event(pod, "Warning", "FailedScheduling", message)
        if self.status_updater is not None:
            self.status_updater.update_pod_condition(pod, condition)

    def record_job_status_event(self, job: JobInfo) -> None:
        """(cache.go:834-869)"""
        base_msg = job.job_fit_errors or ALL_NODE_UNAVAILABLE
        pg_unschedulable = job.pod_group is not None and job.pod_group.status.phase in (
            objects.PodGroupPhase.UNKNOWN,
            objects.PodGroupPhase.PENDING,
            objects.PodGroupPhase.INQUEUE,
        )
        pdb_unschedulable = job.pdb is not None and bool(
            job.task_status_index.get(TaskStatus.PENDING)
        )
        if (pg_unschedulable or pdb_unschedulable) and self.store is not None and job.pod_group is not None:
            pending = len(job.task_status_index.get(TaskStatus.PENDING, {}))
            msg = f"{pending}/{len(job.tasks)} tasks in gang unschedulable: {job.fit_error()}"
            self.store.record_event(job.pod_group, "Warning", "Unschedulable", msg)

        for status in (TaskStatus.ALLOCATED, TaskStatus.PENDING, TaskStatus.PIPELINED):
            for task in job.task_status_index.get(status, {}).values():
                fit_error = job.nodes_fit_errors.get(task.uid)
                msg = fit_error.error() if fit_error is not None else base_msg
                self.task_unschedulable(task, msg)

    def update_job_status(self, job: JobInfo, update_pg: bool) -> JobInfo:
        if update_pg and self.status_updater is not None and job.pod_group is not None:
            # the synchronous in-process echo of this write is value-
            # neutral (the status swap already landed on the shared
            # object); the identity window lets add_pod_group recognize it
            # and skip the spurious keeper mark
            self._expect_pg_echo = job.pod_group
            try:
                self.status_updater.update_pod_group(job.pod_group)
            finally:
                self._expect_pg_echo = None
        self.record_job_status_event(job)
        return job

    # -- snapshot (cache.go:713-798) ---------------------------------------

    def defer_mirror(self, payload: dict) -> None:
        """Queue the cache-side half of a bulk writeback (see _apply_bulk);
        applied by flush_mirror before anything reads the mirror."""
        with self._lock:
            self._pending_mirrors.append(payload)

    def flush_mirror(self) -> None:
        """Apply deferred bulk-writeback payloads to the cache trees:
        status flips + bucket moves + node task-map inserts + allocated /
        idle / used sums for every placement the session's bulk apply
        performed. Runs entirely under the cache lock (the same discipline
        as the effectors and watch handlers). Ordering with interleaved
        effector calls is safe: bulk-bound tasks are disjoint from the
        tasks bind/evict touch, and the node deltas here move idle/used
        while evictions move releasing.

        Accounting is PER FLIPPED TASK on both the job AND node side: a
        placed task whose cache twin vanished in the defer window (pod
        deleted) contributes nothing here — its sums were settled by
        delete_task_info — so node idle/used never drifts from the
        sum-over-held-tasks invariant the incremental snapshot relies on.
        After an exact flush the cache twins equal the session objects, so
        the snapshot keeper records them as in-sync (the payload carries
        the session-side versions captured at defer time); any skipped
        task re-dirties its job and node instead."""
        with self._lock:
            pending, self._pending_mirrors = self._pending_mirrors, []
            if not pending:
                return
            BINDING = TaskStatus.BINDING
            keeper = self.snap_keeper
            # native batched flush (fastapply.c mirror_all_jobs /
            # apply_node_deltas): identical semantics to the Python body
            # below, which remains the fallback and oracle. Non-blocking —
            # a cold process flushes through the Python loop rather than
            # waiting on the background cc.
            from volcano_tpu_torch._native import get_fastapply_nowait

            mod = get_fastapply_nowait()
            mirror_all = getattr(mod, "mirror_all_jobs", None) \
                if mod is not None else None
            alloc_mask = (int(TaskStatus.BOUND) | int(TaskStatus.BINDING)
                          | int(TaskStatus.RUNNING)
                          | int(TaskStatus.ALLOCATED))
            for p in pending:
                task_infos = p["task_infos"]
                node_names = p["node_names"]
                scalar_names = p["scalar_names"]
                skipped: List[int] = []
                if mirror_all is not None:
                    skipped = mirror_all(
                        p["job_nz"], p["seg_ends"], p["placed"],
                        p["assign"].astype(np.int64, copy=False),
                        task_infos, node_names, self.nodes,
                        p["job_infos"], self.jobs,
                        TaskStatus.PENDING, BINDING,
                        np.ascontiguousarray(p["job_sums"]),
                        tuple(scalar_names), alloc_mask) or []
                else:
                    assign = p["assign"]
                    placed = p["placed"].tolist()
                    lo = 0
                    for ji, hi in zip(p["job_nz"].tolist(),
                                      p["seg_ends"].tolist()):
                        tis = placed[lo:hi]
                        seg_lo = lo
                        lo = hi
                        job = p["job_infos"][ji]
                        cache_job = self.jobs.get(job.uid)
                        if cache_job is None:
                            skipped.extend(range(seg_lo, hi))
                            continue
                        cache_job._status_version += 1
                        cidx = cache_job.task_status_index
                        c_tasks = cache_job.tasks
                        for k, ti in enumerate(tis, start=seg_lo):
                            task = task_infos[ti]
                            ctask = c_tasks.get(task.uid)
                            if ctask is None:
                                # the pod was deleted in the defer window;
                                # delete_task_info settled its sums
                                skipped.append(k)
                                continue
                            host = node_names[int(assign[ti])]
                            old_status = ctask.status
                            old_bucket = cidx.get(old_status)
                            if old_bucket is not None:
                                old_bucket.pop(ctask.uid, None)
                                if not old_bucket:
                                    del cidx[old_status]
                            ctask.node_name = host
                            ctask.status = BINDING
                            cidx.setdefault(BINDING, {})[ctask.uid] = ctask
                            # per-flipped-task boundary rules, exactly as
                            # update_task_status moves the sums
                            if not allocated_status(old_status):
                                cache_job.allocated.add(ctask.resreq)
                            if old_status == TaskStatus.PENDING:
                                cache_job.pending_sum.sub(ctask.resreq)
                            cnode = self.nodes.get(host)
                            if cnode is not None:
                                cnode._acct_gen += 1
                                # the session task is shared into the cache
                                # node map, as the inline writeback did
                                cnode.tasks[task.key] = task
                self._flush_node_deltas(p, skipped, mod)
                self._flush_sync_keeper(p, skipped, keeper)

    def _flush_node_deltas(self, p: dict, skipped: List[int], mod) -> None:
        """Node idle/used deltas for one payload, restricted to the tasks
        the mirror pass actually flipped: skipped placements (cache twin
        deleted in the defer window) are subtracted from the session's
        wholesale per-node sums before they land on the cache nodes."""
        node_names = p["node_names"]
        scalar_names = p["scalar_names"]
        node_sums = p["node_sums"]
        if skipped:
            placed_req = p.get("placed_req")
            if placed_req is not None:
                node_sums = node_sums.copy()
                placed = p["placed"]
                assign = p["assign"]
                for k in skipped:
                    node_sums[int(assign[int(placed[k])])] -= placed_req[k]
            # else: a legacy payload without per-task reqs; the wholesale
            # sums are applied and the touched nodes are re-cloned next
            # open anyway (skipped marks them dirty below)
        fast_nodes = getattr(mod, "apply_node_deltas", None) \
            if mod is not None else None
        if fast_nodes is not None:
            fast_nodes(p["node_nz"], np.ascontiguousarray(node_sums),
                       node_names, self.nodes, None, tuple(scalar_names))
            return
        sums = node_sums.tolist()
        for ni in p["node_nz"].tolist():
            cnode = self.nodes.get(node_names[ni])
            if cnode is None:
                continue
            cnode._acct_gen += 1
            vec = sums[ni]
            _add_res_vec(cnode.idle, vec, -1.0, scalar_names)
            _add_res_vec(cnode.used, vec, +1.0, scalar_names)

    def _flush_sync_keeper(self, p: dict, skipped: List[int],
                           keeper) -> None:
        """Record the flushed objects as snapshot-in-sync (versions were
        captured at defer time, AFTER the session-side bulk mutations), so
        the next open reuses them; skipped placements re-dirty instead."""
        job_vers = p.get("job_vers")
        if job_vers is not None:
            job_infos = p["job_infos"]
            for ji, ver in zip(p["job_nz"].tolist(), job_vers):
                keeper.sync_job(job_infos[ji].uid, ver)
        node_gens = p.get("node_gens")
        if node_gens is not None:
            node_names = p["node_names"]
            for ni, gen in zip(p["node_nz"].tolist(), node_gens):
                keeper.sync_node(node_names[ni], gen)
        if skipped:
            task_infos = p["task_infos"]
            node_names = p["node_names"]
            placed = p["placed"]
            assign = p["assign"]
            for k in skipped:
                ti = int(placed[k])
                keeper.mark_job(task_infos[ti].job)
                keeper.mark_node(node_names[int(assign[ti])])

    def snapshot(self) -> ClusterInfo:
        """The per-session snapshot, delta-maintained by the keeper
        (snapkeeper.py): only jobs/nodes whose cache twins or handed-out
        clones moved since the last session are re-cloned; the first call
        (and any keeper invalidation) is the wholesale rebuild of
        cache.go:713-798. In pipeline mode the keeper's buffer pair is
        swapped first — the flush lands on the PREVIOUS session's buffer
        (whose objects the flush mirrored), then the other buffer is
        delta-opened for the new session."""
        self.flush_mirror()
        with self._lock:
            if self._pipeline_swap:
                self.snap_keeper.swap()
            return self.snap_keeper.snapshot(self)

    # -- continuous pipeline support (volcano_tpu_torch/pipeline) ----------------

    def enable_pipeline(self) -> None:
        """Arm the double-buffered snapshot path (idempotent). Serial
        callers are untouched until this is called; VOLCANO_TPU_PIPELINE=0
        keeps the single-buffer oracle by never calling it."""
        self.snap_keeper.enable_pair()
        self._pipeline_swap = True

    def pipeline_fingerprint(self) -> tuple:
        """The delta fingerprint a speculative solve-ahead seals at
        dispatch and re-checks before apply: the keeper's dirty epoch
        (every watch/effector mark bumps it), the keeper generation
        (wholesale invalidations), the lease fence epoch (a takeover must
        kill in-flight speculation), and the summed cache-node accounting
        generation plus the summed job status version (belt-and-braces
        for any mirror mutation a mark path missed — the job sum is the
        node sum's twin: without it an unmarked job-side mutation would
        move neither dirty epoch nor acct and a sealed stage could commit
        against state it never saw; surfaced by vclint VT009). Any
        component moving between seal and check means state the
        speculative snapshot did not see — the stage is discarded. The
        device replica's epoch (ops/replica.py) rides along: a sealed
        stage captured its staged buffers from a specific replica state,
        and a scatter/rebuild between seal and check means the
        device content it dispatched against has been superseded."""
        keeper = self.snap_keeper
        rep = getattr(self, "_device_replica", None)
        with self._lock:
            acct = 0
            for node in self.nodes.values():
                acct += node._acct_gen
            jver = 0
            for job in self.jobs.values():
                jver += job._status_version
            return (keeper.dirty_epoch, keeper.generation,
                    self.fence_epoch, acct, len(self.nodes),
                    jver, len(self.jobs),
                    rep.replica_epoch if rep is not None else -1)

    def readset_seal(self) -> dict:
        """Capture the read-set seal baseline for a speculative dispatch
        (read-set-scoped invalidation, pipeline/driver.py): the mark
        journal cursor (dirty_epoch; the journal is armed here on first
        use), per-row version baselines for every node and job, and the
        queue/namespace id sets the sealed snapshot could have consumed.
        One locked O(N+J) pass — the same complexity class as the
        fingerprint itself, taken at the same moment so the cursor and
        the baselines describe one consistent state."""
        with self._lock:
            keeper = self.snap_keeper
            keeper.enable_journal()
            return {
                "cursor": keeper.dirty_epoch,
                "node_gens": {name: node._acct_gen
                              for name, node in self.nodes.items()},
                "job_vers": {uid: job._status_version
                             for uid, job in self.jobs.items()},
                "jobs": set(self.jobs.keys()),
                "queues": set(self.queues.keys()),
                "namespaces": set(self.namespace_collection.keys()),
            }

    def readset_delta(self, seal: dict):
        """The rows that moved since ``readset_seal``: the journal's
        typed marks past the seal cursor PLUS the belt-and-braces version
        sweep (rows whose _acct_gen/_status_version moved without a mark
        — exactly the unmarked-mutation class vclint VT009 exists for;
        the sweep makes the intersect safe against them instead of
        trusting the lint alone). Returns ``None`` when the journal
        window is unprovable — the caller must degrade to the
        whole-fingerprint discard."""
        with self._lock:
            marks = self.snap_keeper.marks_since(seal["cursor"])
            if marks is None:
                return None
            node_gens = seal["node_gens"]
            changed_nodes = {
                name for name, node in self.nodes.items()
                if node._acct_gen != node_gens.get(name)}
            changed_nodes.update(n for n in node_gens
                                 if n not in self.nodes)
            job_vers = seal["job_vers"]
            changed_jobs = {
                uid for uid, job in self.jobs.items()
                if job._status_version != job_vers.get(uid)}
            changed_jobs.update(u for u in job_vers
                                if u not in self.jobs)
            return {
                "marks": list(marks),
                "changed_nodes": changed_nodes,
                "changed_jobs": changed_jobs,
            }
