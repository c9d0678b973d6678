"""allocate — the primary placement action
(volcano pkg/scheduler/actions/allocate/allocate.go:42-247).

Stages: namespace PQ -> queue (linear scan with Overused filter) -> job PQ ->
task PQ -> predicate -> prioritize -> best node -> Allocate (fits idle) or
Pipeline (fits releasing); per-job Statement committed only when the gang is
JobReady, else discarded.

This serial loop is the parity oracle; the ``tpuscore`` plugin swaps the
per-task sweep for a batched TPU solve (volcano_tpu_torch.ops) behind the same
Statement/commit gate.
"""

from __future__ import annotations

import logging
from typing import Dict

from volcano_tpu_torch.api import objects
from volcano_tpu_torch.api.job_info import JobInfo, TaskInfo
from volcano_tpu_torch.api.types import TaskStatus
from volcano_tpu_torch.api.unschedule_info import NODE_RESOURCE_FIT_FAILED, FitFailure
from volcano_tpu_torch.scheduler.framework.interface import Action
from volcano_tpu_torch.scheduler.util import scheduler_helper as helper
from volcano_tpu_torch.scheduler.util.priority_queue import (
    PriorityQueue,
    make_task_queue,
)

logger = logging.getLogger(__name__)


def finish_batched(ssn, solver) -> None:
    """Post-bulk bookkeeping after a successful batched solve: residue
    profile keys + the serial residue pass. Shared by the per-action
    execute below and the session-fused driver (ops/session_fuse.py), so
    both land identical residue semantics and profile keys."""
    prof = solver.profile
    # residue-family keys are always present (0 when the serial
    # residue pass never ran) so bench consumers need no
    # existence checks
    prof.setdefault("residue_pass_ms", 0.0)
    prof.setdefault("residue_pass_tasks", 0)
    residue = prof.get("residue", 0)
    unplaced = prof.get("tasks", 0) - prof.get("placed", 0)
    if residue or (prof.get("has_releasing") and unplaced):
        # serial residue pass: tasks the device solve does not model
        # (pod affinity, host ports) are still PENDING, and nodes
        # with releasing capacity can still pipeline leftovers; the
        # serial loop picks up exactly the remaining pending tasks
        # on post-bulk state with full predicate fidelity. The dense
        # alloc assist (vectorized window + cached score rows, live
        # residual affinity/ports checks) replaces the per-node
        # closure sweeps with bit-identical selections.
        import time

        from volcano_tpu_torch.ops import preemptview

        logger.info(
            "allocate: serial residue pass (%d residue tasks, "
            "%d unplaced)", residue, unplaced)
        t0 = time.perf_counter()
        AllocateAction()._serial_execute(
            ssn, assist=preemptview.build_alloc_assist(ssn))
        # the tail the device solve left to the host, as first-class
        # profile terms (bench: tpu_residue_ms / tpu_residue_tasks)
        # — the candidate-window straggler rounds exist to shrink
        # exactly these numbers
        prof["residue_pass_ms"] = round(
            (time.perf_counter() - t0) * 1e3, 3)
        prof["residue_pass_tasks"] = residue + (
            unplaced if prof.get("has_releasing") else 0)


class AllocateAction(Action):
    def name(self) -> str:
        return "allocate"

    def execute(self, ssn) -> None:
        # TPU backend hook: if the tpuscore plugin attached a batch solver to
        # this session, let it drive placement for the whole snapshot; the
        # serial loop below remains the fallback and oracle.
        solver = getattr(ssn, "batch_allocator", None)
        if solver is not None and solver(ssn):
            finish_batched(ssn, solver)
            return
        self._serial_execute(ssn)

    def _serial_execute(self, ssn, assist=None) -> None:
        namespaces = PriorityQueue(cmp_fn=ssn.namespace_order_cmp)
        # namespace -> queue -> job PQ
        jobs_map: Dict[str, Dict[str, PriorityQueue]] = {}

        for job in ssn.jobs.values():
            if job.pod_group.status.phase == objects.PodGroupPhase.PENDING:
                continue
            if not job.task_status_index.get(TaskStatus.PENDING):
                continue  # nothing to place or pipeline for this job
            vr = ssn.job_valid(job)
            if vr is not None and not vr.pass_:
                continue
            if job.queue not in ssn.queues:
                logger.warning(
                    "Skip adding Job <%s/%s>: queue %s not found",
                    job.namespace, job.name, job.queue)
                continue
            queue_map = jobs_map.get(job.namespace)
            if queue_map is None:
                namespaces.push(job.namespace)
                queue_map = jobs_map[job.namespace] = {}
            if job.queue not in queue_map:
                queue_map[job.queue] = PriorityQueue(cmp_fn=ssn.job_order_cmp)
            queue_map[job.queue].push(job)

        pending_tasks: Dict[str, PriorityQueue] = {}
        all_nodes = helper.get_node_list(ssn.nodes)

        def predicate_fn(task: TaskInfo, node) -> None:
            # resource fit against idle OR releasing, then plugin chain
            # (allocate.go:103-117)
            if not task.init_resreq.less_equal(node.idle) and not task.init_resreq.less_equal(node.releasing):
                raise FitFailure(NODE_RESOURCE_FIT_FAILED)
            ssn.predicate_fn(task, node)

        predicates = ssn.plugins.get("predicates") if assist is not None else None

        def _residual_for(task):
            """Live ports/affinity check closure for the assist's window,
            or None when the base mask already decides everything."""
            if predicates is None or not hasattr(predicates, "needs_residual"):
                return None
            if not predicates.needs_residual(task.pod):
                return None
            check = predicates.residual_check

            def residual(node) -> bool:
                try:
                    check(task, node)
                except FitFailure:
                    return False
                return True

            return residual

        while not namespaces.empty():
            namespace = namespaces.pop()
            queue_in_namespace = jobs_map[namespace]

            # linear queue scan with overused filter (allocate.go:134-146)
            queue = None
            for queue_id in list(queue_in_namespace):
                current = ssn.queues[queue_id]
                if ssn.overused(current):
                    del queue_in_namespace[queue_id]
                    continue
                if queue is None or ssn.queue_order_fn(current, queue):
                    queue = current
            if queue is None:
                continue

            jobs = queue_in_namespace.get(queue.uid)
            if jobs is None or jobs.empty():
                continue

            job: JobInfo = jobs.pop()
            if job.uid not in pending_tasks:
                pending_tasks[job.uid] = make_task_queue(ssn, [
                    task for task in job.task_status_index.get(
                        TaskStatus.PENDING, {}).values()
                    if not task.resreq.is_empty()  # BestEffort -> backfill
                ])
            tasks = pending_tasks[job.uid]

            stmt = ssn.statement()
            stmt_ops = []  # (hook_undo_kind, host, task) for assist unwind

            while not tasks.empty():
                task: TaskInfo = tasks.pop()

                if job.nodes_fit_delta:
                    job.nodes_fit_delta = {}

                node = None
                if assist is not None:
                    node = assist.alloc_best_node(task, _residual_for(task))
                if node is None:
                    found_nodes, fit_errors = helper.predicate_nodes(
                        task, all_nodes, predicate_fn)
                    if not found_nodes:
                        job.nodes_fit_errors[task.uid] = fit_errors
                        break

                    node_scores = helper.prioritize_nodes(
                        task, found_nodes,
                        ssn.batch_node_order_fn, ssn.node_order_map_fn,
                        ssn.node_order_reduce_fn)
                    node = helper.select_best_node(node_scores)

                if task.init_resreq.less_equal(node.idle):
                    try:
                        stmt.allocate(task, node.name)
                    except (KeyError, RuntimeError) as e:
                        logger.error("Failed to bind Task %s on %s: %s", task.uid, node.name, e)
                    else:
                        if assist is not None:
                            assist.on_allocate(node.name, task)
                            stmt_ops.append(("alloc", node.name, task))
                else:
                    # record the shortfall, then try releasing resources
                    delta = node.idle.clone()
                    delta.fit_delta(task.init_resreq)
                    job.nodes_fit_delta[node.name] = delta
                    if task.init_resreq.less_equal(node.releasing):
                        stmt.pipeline(task, node.name)
                        if assist is not None:
                            assist.on_pipeline_alloc(node.name, task)
                            stmt_ops.append(("pipe", node.name, task))

                if ssn.job_ready(job):
                    jobs.push(job)
                    break

            if ssn.job_ready(job):
                stmt.commit()
            else:
                stmt.discard()
                if assist is not None:
                    # mirror the statement rollback in the assist's matrices
                    for kind, host, t in reversed(stmt_ops):
                        if kind == "alloc":
                            assist.on_unallocate(host, t)
                        else:
                            assist.on_unpipeline_alloc(host, t)

            namespaces.push(namespace)
