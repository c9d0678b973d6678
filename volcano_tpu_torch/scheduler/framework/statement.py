"""Statement — the per-job operation log with commit/rollback; THE gang
atomicity mechanism (volcano pkg/scheduler/framework/statement.go).

Operations (allocate/pipeline/evict) mutate *session* state eagerly and are
logged; ``commit`` flushes them to the cache (bind/evict effectors), while
``discard`` undoes them in reverse order, restoring session state so a
partially-placed gang leaves no trace.
"""

from __future__ import annotations

import logging
from typing import List, Tuple

from volcano_tpu_torch.api.job_info import TaskInfo
from volcano_tpu_torch.api.types import TaskStatus
from volcano_tpu_torch.scheduler.framework.event_handlers import Event

logger = logging.getLogger(__name__)


class Statement:
    def __init__(self, ssn):
        self.ssn = ssn
        self.operations: List[Tuple[str, tuple]] = []
        # native transition engine (None => every op runs the Python body
        # below, which remains the behavioral oracle)
        self._ft = ssn.fast_trans()

    # -- evict -------------------------------------------------------------

    def evict(self, reclaimee: TaskInfo, reason: str) -> None:
        """Session-state eviction, logged (statement.go:40-72)."""
        if self._ft is not None:
            self._ft.evict(reclaimee, strict=False)
            self.operations.append(("evict", (reclaimee, reason)))
            return
        ssn = self.ssn
        job = ssn.jobs.get(reclaimee.job)
        if job is not None:
            job.update_task_status(reclaimee, TaskStatus.RELEASING)
        node = ssn.nodes.get(reclaimee.node_name)
        if node is not None:
            node.update_task(reclaimee)
        ssn._fire_deallocate(reclaimee)
        self.operations.append(("evict", (reclaimee, reason)))

    def _commit_evict(self, reclaimee: TaskInfo, reason: str) -> None:
        try:
            self.ssn.cache.evict(reclaimee, reason)
        except Exception as e:
            logger.error("failed to evict task %s/%s: %s", reclaimee.namespace, reclaimee.name, e)
            self._unevict(reclaimee)

    def _unevict(self, reclaimee: TaskInfo) -> None:
        if self._ft is not None:
            self._ft.unevict(reclaimee)
            return
        ssn = self.ssn
        job = ssn.jobs.get(reclaimee.job)
        if job is not None:
            job.update_task_status(reclaimee, TaskStatus.RUNNING)
        node = ssn.nodes.get(reclaimee.node_name)
        if node is not None:
            # The reference calls AddTask here and silently drops its
            # "already on node" error (statement.go:100-102), leaving the
            # node's Releasing accounting inflated for the rest of the
            # session. We restore it properly instead.
            node.update_task(reclaimee)
        ssn._fire_allocate(reclaimee)

    # -- pipeline ----------------------------------------------------------

    def pipeline(self, task: TaskInfo, hostname: str) -> None:
        """(statement.go:116-156)"""
        self.ssn._placement_gen += 1
        if self._ft is not None:
            self._ft.pipeline(task, hostname, strict=False)
            self.operations.append(("pipeline", (task, hostname)))
            return
        ssn = self.ssn
        job = ssn.jobs.get(task.job)
        if job is not None:
            job.update_task_status(task, TaskStatus.PIPELINED)
        task.node_name = hostname
        node = ssn.nodes.get(hostname)
        if node is not None:
            try:
                node.add_task(task)
            except RuntimeError as e:
                logger.error("failed to pipeline task %s to %s: %s", task.name, hostname, e)
        ssn._fire_allocate(task)
        self.operations.append(("pipeline", (task, hostname)))

    def _unpipeline(self, task: TaskInfo) -> None:
        self.ssn._placement_gen += 1
        if self._ft is not None:
            self._ft.unpipeline(task)
            return
        ssn = self.ssn
        job = ssn.jobs.get(task.job)
        if job is not None:
            job.update_task_status(task, TaskStatus.PENDING)
        node = ssn.nodes.get(task.node_name)
        if node is not None:
            try:
                node.remove_task(task)
            except RuntimeError as e:
                logger.error("failed to unpipeline task %s: %s", task.name, e)
        task.node_name = ""
        ssn._fire_deallocate(task)

    # -- allocate ----------------------------------------------------------

    def allocate(self, task: TaskInfo, hostname: str) -> None:
        """Session-state allocation, logged (statement.go:199-251)."""
        ssn = self.ssn
        ssn._placement_gen += 1
        ssn.cache.allocate_volumes(task, hostname)
        job = ssn.jobs.get(task.job)
        if job is None:
            raise KeyError(f"failed to find job {task.job}")
        job.update_task_status(task, TaskStatus.ALLOCATED)
        task.node_name = hostname
        node = ssn.nodes.get(hostname)
        if node is None:
            raise KeyError(f"failed to find node {hostname}")
        node.add_task(task)
        ssn._fire_allocate(task)
        self.operations.append(("allocate", (task, hostname)))

    def _commit_allocate(self, task: TaskInfo, hostname: str) -> None:
        # Per-operation failures must not abort the rest of the commit
        # (statement.go:325-340 ignores them) — other gang members still bind.
        try:
            self.ssn.cache.bind_volumes(task)
            self.ssn.cache.bind(task, task.node_name)
        except Exception as e:
            logger.error("failed to bind task %s/%s: %s", task.namespace, task.name, e)
            return
        job = self.ssn.jobs.get(task.job)
        if job is not None:
            job.update_task_status(task, TaskStatus.BINDING)

    def _unallocate(self, task: TaskInfo, reason: str) -> None:
        ssn = self.ssn
        ssn._placement_gen += 1
        # release any volume assumption made by allocate's
        # cache.allocate_volumes (bound volumes are untouched)
        unassume = getattr(ssn.cache.volume_binder, "unassume", None)
        if unassume is not None:
            unassume(task)
        job = ssn.jobs.get(task.job)
        if job is not None:
            job.update_task_status(task, TaskStatus.PENDING)
        node = ssn.nodes.get(task.node_name)
        if node is not None:
            try:
                node.remove_task(task)
            except RuntimeError as e:
                logger.error("failed to unallocate task %s: %s", task.name, e)
        task.node_name = ""
        ssn._fire_deallocate(task)

    # -- commit/rollback (statement.go:309-337) ----------------------------

    def discard(self) -> None:
        """Reverse-order undo of every logged operation."""
        for name, args in reversed(self.operations):
            if name == "evict":
                self._unevict(args[0])
            elif name == "pipeline":
                self._unpipeline(args[0])
            elif name == "allocate":
                self._unallocate(args[0], "discarded")
        self.operations = []

    def commit(self) -> None:
        """Flush logged operations to the cache effectors."""
        for name, args in self.operations:
            if name == "evict":
                self._commit_evict(*args)
            elif name == "pipeline":
                pass  # pipelined placement stays session-local (statement.go:158)
            elif name == "allocate":
                self._commit_allocate(*args)
        self.operations = []
