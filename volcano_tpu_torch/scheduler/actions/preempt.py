"""preempt — within-queue job-vs-job, then intra-job task-vs-task preemption
(volcano pkg/scheduler/actions/preempt/preempt.go:45-277).

Victims come from the tiered ``ssn.preemptable`` intersection; lowest-priority
victims are evicted until the preemptor fits; the preemptor is Pipelined onto
the node. The per-job Statement commits when JobPipelined holds.
"""

from __future__ import annotations

import logging
from typing import Dict, List

from volcano_tpu_torch.api import objects
from volcano_tpu_torch.api.resource import (
    MIN_MEMORY, MIN_MILLI_CPU, MIN_MILLI_SCALAR, Resource)
from volcano_tpu_torch.api.types import TaskStatus
from volcano_tpu_torch.scheduler import metrics
from volcano_tpu_torch.scheduler.framework.interface import Action
from volcano_tpu_torch.scheduler.util import scheduler_helper as helper
from volcano_tpu_torch.scheduler.util.priority_queue import (
    PriorityQueue,
    make_task_queue,
)

logger = logging.getLogger(__name__)


class PreemptAction(Action):
    def name(self) -> str:
        return "preempt"

    def execute(self, ssn) -> None:
        from volcano_tpu_torch.ops import evict as evict_mod
        from volcano_tpu_torch.ops import preemptview, victimview

        # batched device eviction (ops/evict.py): the whole action — job
        # heaps, candidate windows, victim tiers, eviction cuts, gang
        # commit/discard — runs as ONE packed device dispatch and the host
        # replays the committed ops through the real Statements. Bindings
        # and evictions are identical to the walk below within the modeled
        # envelope (VOLCANO_TPU_EVICT=0 forces this oracle path; see
        # tests/test_evict_kernel.py).
        plan = evict_mod.build(ssn, "preempt")
        if plan is not None and plan.run():
            return

        # dense (preemptor x node) feasibility/score rows replace the
        # serial per-task O(nodes) closure sweeps when tpuscore is on;
        # victim selection and Statement authority stay here (SURVEY §7)
        view = preemptview.build(ssn)
        # batched tiered-intersection victim proposal (ops/victimview.py);
        # None => every node uses the serial ssn.preemptable dispatch
        selector = victimview.build(ssn, "preemptable") \
            if view is not None else None

        # per-session metric accumulator: the per-candidate Counter.inc
        # (lock + dict op, ~6us) x thousands of candidates is measurable on
        # the preempt hot path; scrape-time values are identical when the
        # totals land once at the end of the action
        stats = {"victims": 0, "attempts": 0}
        preemptors_map: Dict[str, PriorityQueue] = {}
        preemptor_tasks: Dict[str, object] = {}
        under_request: List = []
        queues: Dict[str, object] = {}

        for job in ssn.jobs.values():
            if job.pod_group.status.phase == objects.PodGroupPhase.PENDING:
                continue
            vr = ssn.job_valid(job)
            if vr is not None and not vr.pass_:
                continue
            queue = ssn.queues.get(job.queue)
            if queue is None:
                continue
            queues.setdefault(queue.uid, queue)

            if job.task_status_index.get(TaskStatus.PENDING):
                if job.queue not in preemptors_map:
                    preemptors_map[job.queue] = PriorityQueue(cmp_fn=ssn.job_order_cmp)
                preemptors_map[job.queue].push(job)
                under_request.append(job)
                preemptor_tasks[job.uid] = make_task_queue(
                    ssn, job.task_status_index[TaskStatus.PENDING].values())

        for queue in queues.values():
            # Preemption between jobs within the queue.
            while True:
                preemptors = preemptors_map.get(queue.uid)
                if preemptors is None or preemptors.empty():
                    break
                preemptor_job = preemptors.pop()

                stmt = ssn.statement()
                assigned = False
                stmt_pipelines: List = []  # (node_name, task) to unwind
                poison0 = view.poison_state() if view is not None else False
                while True:
                    if preemptor_tasks[preemptor_job.uid].empty():
                        break
                    preemptor = preemptor_tasks[preemptor_job.uid].pop()

                    def job_filter(task, _preemptor=preemptor, _job=preemptor_job):
                        if task.status != TaskStatus.RUNNING:
                            return False
                        job = ssn.jobs.get(task.job)
                        if job is None:
                            return False
                        return job.queue == _job.queue and _preemptor.job != task.job

                    host = _preempt(ssn, stmt, preemptor, ssn.nodes,
                                    job_filter, view, selector, stats)
                    if host is not None:
                        assigned = True
                        if view is not None:
                            view.on_pipeline(host, preemptor)
                            stmt_pipelines.append((host, preemptor))

                    if ssn.job_pipelined(preemptor_job):
                        stmt.commit()
                        break

                if not ssn.job_pipelined(preemptor_job):
                    # discard restores the cluster exactly — including any
                    # poison raised by THIS statement's fallback pipelines
                    # (the un-modeled pod is resident no longer)
                    stmt.discard()
                    if view is not None:
                        for host, task in stmt_pipelines:
                            view.on_unpipeline(host, task)
                        view.restore_poison(poison0)
                    continue

                if assigned:
                    preemptors.push(preemptor_job)

            # Preemption between tasks within one job.
            for job in under_request:
                while True:
                    tasks = preemptor_tasks.get(job.uid)
                    if tasks is None or tasks.empty():
                        break
                    preemptor = tasks.pop()

                    def task_filter(task, _preemptor=preemptor):
                        if task.status != TaskStatus.RUNNING:
                            return False
                        return _preemptor.job == task.job

                    stmt = ssn.statement()
                    host = _preempt(ssn, stmt, preemptor, ssn.nodes,
                                    task_filter, view, selector, stats)
                    if host is not None and view is not None:
                        view.on_pipeline(host, preemptor)
                    stmt.commit()
                    if host is None:
                        break

        if stats["victims"]:
            metrics.update_preemption_victims(stats["victims"])
        if stats["attempts"]:
            metrics.register_preemption_attempts(stats["attempts"])


def _preempt(ssn, stmt, preemptor, nodes, task_filter, view=None,
             selector=None, stats=None):
    """(preempt.go:180-260). Returns the pipelined node name, or None.

    With a dense view the candidate stream (feasibility window + score
    order) comes from vectorized rows, and a victim selector batches the
    tiered plugin intersection; the eviction cut below is identical
    either way."""
    candidates = view.candidates(preemptor) if view is not None else None
    fell_back = candidates is None
    if fell_back:  # no view, or un-modeled preemptor (ports/affinity)
        all_nodes = helper.get_node_list(nodes)
        found_nodes, _ = helper.predicate_nodes(preemptor, all_nodes, ssn.predicate_fn)
        node_scores = helper.prioritize_nodes(
            preemptor, found_nodes,
            ssn.batch_node_order_fn, ssn.node_order_map_fn, ssn.node_order_reduce_fn)
        candidates = helper.sort_nodes(node_scores)

    # scalar-free requests (the overwhelmingly common case) take a pure
    # float cut below: the accumulate/epsilon-compare sequence is
    # arithmetic-identical to Resource.add + less_equal, minus the object
    # churn per victim — any scalar on either side restores the oracle
    init_req = preemptor.init_resreq
    init_scalars = init_req.scalar_resources
    fast_req = init_scalars is None or not any(
        v > MIN_MILLI_SCALAR for v in init_scalars.values())

    for node in candidates:
        # shared_clone: victims need independent status words for the
        # evict bookkeeping but never mutate their request Resources
        preemptees = [
            task.shared_clone()
            for task in node.tasks.values()
            if task_filter is None or task_filter(task)
        ]
        victims = (selector.victims(preemptor, preemptees)
                   if selector is not None
                   else ssn.preemptable(preemptor, preemptees))
        if stats is not None:
            stats["victims"] += len(victims)
        else:
            metrics.update_preemption_victims(len(victims))

        if not _validate_victims(victims, preemptor.init_resreq):
            continue

        fast = fast_req and not any(v.resreq.scalar_resources
                                    for v in victims)
        preempted = Resource.empty()
        resreq = None if fast else preemptor.init_resreq.clone()
        need_cpu, need_mem = init_req.milli_cpu, init_req.memory
        got_cpu = got_mem = 0.0

        # lowest-priority victims first (inverse task order)
        victims_queue = make_task_queue(ssn, victims, reverse=True)
        while not victims_queue.empty():
            preemptee = victims_queue.pop()
            try:
                stmt.evict(preemptee, "preempt")
            except Exception as e:
                logger.error("Failed to preempt Task <%s/%s> for <%s/%s>: %s",
                             preemptee.namespace, preemptee.name,
                             preemptor.namespace, preemptor.name, e)
                continue
            if fast:
                vr = preemptee.resreq
                got_cpu += vr.milli_cpu
                got_mem += vr.memory
                if (need_cpu < got_cpu or abs(need_cpu - got_cpu)
                        < MIN_MILLI_CPU) and \
                   (need_mem < got_mem or abs(need_mem - got_mem)
                        < MIN_MEMORY):
                    break
            else:
                preempted.add(preemptee.resreq)
                if resreq.less_equal(preempted):
                    break

        if stats is not None:
            stats["attempts"] += 1
        else:
            metrics.register_preemption_attempts()

        if fast:
            covered = (need_cpu < got_cpu or abs(need_cpu - got_cpu)
                       < MIN_MILLI_CPU) and \
                      (need_mem < got_mem or abs(need_mem - got_mem)
                       < MIN_MEMORY)
        else:
            covered = preemptor.init_resreq.less_equal(preempted)
        if covered:
            stmt.pipeline(preemptor, node.name)
            if fell_back and view is not None and view.needs_poison(preemptor):
                # pipeline fires allocate events IMMEDIATELY (statement.py),
                # so this pod's (anti-)affinity is resident right now and
                # cached masks are stale for the very next candidate; the
                # action restores the pre-statement poison state on discard
                view.poison()
            return node.name

    return None


def _validate_victims(victims, resreq) -> bool:
    """(preempt.go:262-277)"""
    if not victims:
        return False
    all_res = Resource.empty()
    for v in victims:
        all_res.add(v.resreq)
    return not all_res.less(resreq)
