"""TaskInfo and JobInfo — the session's working view of pods and pod groups
(volcano pkg/scheduler/api/job_info.go)."""

from __future__ import annotations

from typing import Dict, Optional

from volcano_tpu_torch.api import objects
from volcano_tpu_torch.api.objects import GROUP_NAME_ANNOTATION_KEY
from volcano_tpu_torch.api.pod_helpers import (
    get_pod_resource_request,
    get_pod_resource_without_init_containers,
    get_task_status,
)
from volcano_tpu_torch.api.resource import Resource
from volcano_tpu_torch.api.types import TaskStatus, allocated_status
from volcano_tpu_torch.api.unschedule_info import FitErrors


def get_job_id(pod: objects.Pod) -> str:
    """Job key of a pod via its group-name annotation (job_info.go:57-65)."""
    gn = pod.metadata.annotations.get(GROUP_NAME_ANNOTATION_KEY, "")
    if gn:
        return f"{pod.metadata.namespace}/{gn}"
    return ""


class TaskInfo:
    """All scheduler-relevant info about one task/pod (job_info.go:37-55)."""

    __slots__ = (
        "uid",
        "job",
        "name",
        "namespace",
        "resreq",
        "init_resreq",
        "node_name",
        "status",
        "priority",
        "volume_ready",
        "pod",
        # columnar-mirror coordinates (scheduler/cache/podtable.py): the
        # cache assigns them; clones inherit; (row, row_gen) validate reads
        "row",
        "row_gen",
        # "namespace/name", precomputed once — the node task-map / binder /
        # event key that hot paths would otherwise re-format per use
        "key",
    )

    def __init__(
        self,
        uid: str,
        job: str,
        name: str,
        namespace: str,
        resreq: Resource,
        init_resreq: Resource,
        node_name: str = "",
        status: TaskStatus = TaskStatus.PENDING,
        priority: int = 1,
        volume_ready: bool = False,
        pod: Optional[objects.Pod] = None,
    ):
        self.uid = uid
        self.job = job
        self.name = name
        self.namespace = namespace
        self.resreq = resreq
        self.init_resreq = init_resreq
        self.node_name = node_name
        self.status = status
        self.priority = priority
        self.volume_ready = volume_ready
        self.pod = pod
        self.row = -1
        self.row_gen = -1
        self.key = namespace + "/" + name

    def clone(self) -> "TaskInfo":
        t = TaskInfo(
            uid=self.uid,
            job=self.job,
            name=self.name,
            namespace=self.namespace,
            resreq=self.resreq.clone(),
            init_resreq=self.init_resreq.clone(),
            node_name=self.node_name,
            status=self.status,
            priority=self.priority,
            volume_ready=self.volume_ready,
            pod=self.pod,
        )
        t.row = self.row
        t.row_gen = self.row_gen
        return t

    def shared_clone(self) -> "TaskInfo":
        """Status-frozen copy for node task-maps that SHARES the resreq /
        init_resreq Resource objects. Node maps clone tasks only so later
        status flips don't corrupt node accounting (node_info.go:196-197);
        the request Resources are never mutated through a node map, so the
        bulk-apply path avoids 2 Resource deep-copies per placement."""
        t = TaskInfo.__new__(TaskInfo)
        t.uid = self.uid
        t.job = self.job
        t.name = self.name
        t.namespace = self.namespace
        t.resreq = self.resreq
        t.init_resreq = self.init_resreq
        t.node_name = self.node_name
        t.status = self.status
        t.priority = self.priority
        t.volume_ready = self.volume_ready
        t.pod = self.pod
        t.row = self.row
        t.row_gen = self.row_gen
        t.key = self.key
        return t

    def __repr__(self) -> str:
        return (
            f"Task ({self.uid}:{self.namespace}/{self.name}): "
            f"job {self.job}, status {self.status}, pri {self.priority}, "
            f"resreq {self.resreq}"
        )


def new_task_info(pod: objects.Pod) -> TaskInfo:
    """Build a TaskInfo from a Pod (job_info.go:68-92)."""
    ti = TaskInfo(
        uid=pod.metadata.uid,
        job=get_job_id(pod),
        name=pod.metadata.name,
        namespace=pod.metadata.namespace,
        resreq=get_pod_resource_without_init_containers(pod),
        init_resreq=get_pod_resource_request(pod),
        node_name=pod.spec.node_name,
        status=get_task_status(pod),
        priority=pod.spec.priority if pod.spec.priority is not None else 1,
        pod=pod,
    )
    return ti


class JobInfo:
    """All info about one job (= PodGroup + its tasks), with resource
    accounting kept incrementally (job_info.go:126-178)."""

    def __init__(self, uid: str, *tasks: TaskInfo):
        self.uid = uid
        self.name = ""
        self.namespace = ""
        self.queue = ""
        self.priority = 0
        self.min_available = 0

        self.nodes_fit_delta: Dict[str, Resource] = {}
        self.job_fit_errors = ""
        self.nodes_fit_errors: Dict[str, FitErrors] = {}

        self.task_status_index: Dict[TaskStatus, Dict[str, TaskInfo]] = {}
        self.tasks: Dict[str, TaskInfo] = {}
        # status-index mutation counter + ready_task_num memo; code that
        # mutates task_status_index directly (the bulk apply path) must
        # bump _status_version
        self._status_version = 0
        self._ready_cache = None
        self._valid_cache = None
        # columnar view of the PENDING bucket captured by clone() while it
        # is already touching every task: (tasks, rows, row_gens, version).
        # Valid only while _status_version still matches — any index
        # mutation invalidates it (see pending_axis)
        self._pending_axis = None

        self.allocated = Resource.empty()
        self.total_request = Resource.empty()
        # sum of PENDING tasks' requests, kept incrementally like
        # `allocated`: proportion's queue `request` (allocated + pending)
        # becomes two O(1) adds per job at session open instead of a
        # per-task walk (proportion.go:72-102 recomputes per task; with
        # 50k pending tasks that walk alone costs ~100 ms per session)
        self.pending_sum = Resource.empty()

        self.creation_timestamp = 0.0
        self.pod_group: Optional[objects.PodGroup] = None
        self.pdb: Optional[objects.PodDisruptionBudget] = None

        for task in tasks:
            self.add_task_info(task)

    # -- pod group / pdb binding ------------------------------------------

    def set_pod_group(self, pg: objects.PodGroup) -> None:
        self.name = pg.metadata.name
        self.namespace = pg.metadata.namespace
        self.min_available = pg.spec.min_member
        self.queue = pg.spec.queue
        self.creation_timestamp = pg.metadata.creation_timestamp
        self.pod_group = pg

    def unset_pod_group(self) -> None:
        self.pod_group = None

    def set_pdb(self, pdb: objects.PodDisruptionBudget) -> None:
        self.name = pdb.metadata.name
        self.namespace = pdb.metadata.namespace
        self.min_available = pdb.min_available
        self.creation_timestamp = pdb.metadata.creation_timestamp
        self.pdb = pdb

    def unset_pdb(self) -> None:
        self.pdb = None

    # -- task bookkeeping --------------------------------------------------

    def _add_task_index(self, ti: TaskInfo) -> None:
        self.task_status_index.setdefault(ti.status, {})[ti.uid] = ti
        self._status_version += 1

    def _delete_task_index(self, ti: TaskInfo) -> None:
        tasks = self.task_status_index.get(ti.status)
        if tasks is not None:
            tasks.pop(ti.uid, None)
            if not tasks:
                del self.task_status_index[ti.status]
        self._status_version += 1

    def add_task_info(self, ti: TaskInfo) -> None:
        self.tasks[ti.uid] = ti
        self._add_task_index(ti)
        self.total_request.add(ti.resreq)
        if allocated_status(ti.status):
            self.allocated.add(ti.resreq)
        elif ti.status == TaskStatus.PENDING:
            self.pending_sum.add(ti.resreq)

    def delete_task_info(self, ti: TaskInfo) -> None:
        task = self.tasks.get(ti.uid)
        if task is None:
            raise KeyError(
                f"failed to find task <{ti.namespace}/{ti.name}> "
                f"in job <{self.namespace}/{self.name}>"
            )
        self.total_request.sub(task.resreq)
        if allocated_status(task.status):
            self.allocated.sub(task.resreq)
        elif task.status == TaskStatus.PENDING:
            self.pending_sum.sub(task.resreq)
        del self.tasks[task.uid]
        self._delete_task_index(task)

    def update_task_status(self, task: TaskInfo, status: TaskStatus) -> None:
        """Move a task to a new status bucket, keeping the resource
        accounting consistent. A task not currently in the job is simply
        (re-)added under the new status — the reference discards the delete
        error (job_info.go:232-245) and session code relies on that.

        The present-task case fuses delete_task_info + add_task_info: a
        status flip with a value-equal request leaves total_request
        unchanged and moves `allocated` only across the allocated-status
        boundary, so the fused path performs exactly the net Resource ops
        (and the index bucket move) — identical end state, minus the
        sub-then-add round trips and their trivially-net-zero sufficiency
        asserts. Mismatched requests take the legacy path."""
        stored = self.tasks.get(task.uid)
        if stored is None:
            task.status = status
            self.add_task_info(task)
            return
        if stored.resreq != task.resreq:
            self.delete_task_info(task)
            task.status = status
            self.add_task_info(task)
            return
        old_status = stored.status
        old_alloc = allocated_status(old_status)
        self._delete_task_index(stored)
        task.status = status
        new_alloc = allocated_status(status)
        if old_alloc and not new_alloc:
            self.allocated.sub(stored.resreq)
        elif new_alloc and not old_alloc:
            self.allocated.add(task.resreq)
        if old_status == TaskStatus.PENDING and status != TaskStatus.PENDING:
            self.pending_sum.sub(stored.resreq)
        elif status == TaskStatus.PENDING and old_status != TaskStatus.PENDING:
            self.pending_sum.add(task.resreq)
        # the incoming object replaces the stored one, as legacy
        # delete+add does (session code passes clones with independent
        # status words)
        self.tasks[task.uid] = task
        self._add_task_index(task)

    # -- readiness math ----------------------------------------------------

    def ready_task_num(self) -> int:
        # memoized on the status-index mutation counter: gang gates call
        # this per candidate visit in the preempt/allocate hot loops
        cached = self._ready_cache
        if cached is not None and cached[0] == self._status_version:
            return cached[1]
        n = 0
        for status, tasks in self.task_status_index.items():
            if allocated_status(status) or status == TaskStatus.SUCCEEDED:
                n += len(tasks)
        self._ready_cache = (self._status_version, n)
        return n

    def waiting_task_num(self) -> int:
        return len(self.task_status_index.get(TaskStatus.PIPELINED, {}))

    def valid_task_num(self) -> int:
        # memoized on the status-index version like ready_task_num: the
        # gang job-valid gate runs per job in every session open/encode
        cached = self._valid_cache
        if cached is not None and cached[0] == self._status_version:
            return cached[1]
        n = 0
        for status, tasks in self.task_status_index.items():
            if (
                allocated_status(status)
                or status == TaskStatus.SUCCEEDED
                or status == TaskStatus.PIPELINED
                or status == TaskStatus.PENDING
            ):
                n += len(tasks)
        self._valid_cache = (self._status_version, n)
        return n

    def ready(self) -> bool:
        return self.ready_task_num() >= self.min_available

    def pipelined(self) -> bool:
        return self.waiting_task_num() + self.ready_task_num() >= self.min_available

    # -- misc --------------------------------------------------------------

    def fit_error(self) -> str:
        """Status histogram message for unschedulable conditions
        (job_info.go:324-341)."""
        reasons = {str(s): len(t) for s, t in self.task_status_index.items()}
        reasons["minAvailable"] = self.min_available
        parts = sorted(f"{v} {k}" for k, v in reasons.items())
        return f"{objects.POD_GROUP_NOT_READY}, {', '.join(parts)}."

    def _clone_header(self) -> "JobInfo":
        info = JobInfo(self.uid)
        info.name = self.name
        info.namespace = self.namespace
        info.queue = self.queue
        info.priority = self.priority
        info.min_available = self.min_available
        info.pdb = self.pdb
        info.pod_group = self.pod_group
        info.creation_timestamp = self.creation_timestamp
        return info

    def clone(self) -> "JobInfo":
        """Field-copying clone: tasks become status-frozen shared_clones
        (resreq/init_resreq are never mutated in place anywhere in the
        tree — the same contract node task-maps already rely on), the
        status index is rebuilt with dict ops only, and the accounting
        sums (allocated / total_request / pending_sum) are deep-copied
        from the incrementally-maintained values instead of being
        re-derived one Resource.add per task. End state is identical to
        the replay clone (clone_replay, kept as the test oracle).

        Also captures the PENDING columnar axis while this walk already
        holds each task: the encoder's task axis becomes list-concats +
        one fromiter instead of a second 50k-object walk per session."""
        info = self._clone_header()
        info.allocated = self.allocated.clone()
        info.total_request = self.total_request.clone()
        info.pending_sum = self.pending_sum.clone()
        tasks = info.tasks
        index = info.task_status_index
        pend_t: list = []
        pend_r: list = []
        pend_g: list = []
        # bucket-wise walk: every task in a bucket shares its status, so
        # the per-task bucket lookup and PENDING branch hoist out of the
        # inner loop (at 50k tasks this loop is the bulk of session open)
        for status, bucket in self.task_status_index.items():
            nb = index[status] = {}
            for uid, task in bucket.items():
                t = task.shared_clone()
                nb[uid] = t
                tasks[uid] = t
            if status == TaskStatus.PENDING:
                pend_t = list(nb.values())
                pend_r = [t.row for t in pend_t]
                pend_g = [t.row_gen for t in pend_t]
        info._pending_axis = (pend_t, pend_r, pend_g, info._status_version)
        return info

    def clone_replay(self) -> "JobInfo":
        """Replay clone — rebuild the index and accounting through
        add_task_info from deep task clones (the original clone path).
        The oracle for clone(): drift between the incremental sums and
        the task set shows up as a mismatch between the two."""
        info = self._clone_header()
        pend_t: list = []
        pend_r: list = []
        pend_g: list = []
        for task in self.tasks.values():
            t = task.clone()
            info.add_task_info(t)
            if t.status == TaskStatus.PENDING:
                pend_t.append(t)
                pend_r.append(t.row)
                pend_g.append(t.row_gen)
        info._pending_axis = (pend_t, pend_r, pend_g, info._status_version)
        return info

    def pending_axis(self):
        """The clone-captured (tasks, rows, row_gens) of the PENDING
        bucket, or None when the status index changed since capture (the
        caller walks the bucket instead)."""
        ax = self._pending_axis
        if ax is not None and ax[3] == self._status_version:
            return ax[0], ax[1], ax[2]
        return None

    def is_terminated(self) -> bool:
        """helpers.go JobTerminated."""
        return self.pod_group is None and self.pdb is None and not self.tasks

    def __repr__(self) -> str:
        return (
            f"Job ({self.uid}): namespace {self.namespace} ({self.queue}), "
            f"name {self.name}, minAvailable {self.min_available}, "
            f"{len(self.tasks)} tasks"
        )
