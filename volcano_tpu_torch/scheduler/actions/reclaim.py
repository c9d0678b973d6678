"""reclaim — cross-queue reclamation for starved queues
(volcano pkg/scheduler/actions/reclaim/reclaim.go:42-205).

A non-overused queue's pending job evicts Running tasks from *other* queues
(via the tiered ``ssn.reclaimable`` intersection — the proportion plugin
enforces the deserved-share floor) and pipelines the reclaimer. Direct
``ssn.evict``/``ssn.pipeline``, no statement.
"""

from __future__ import annotations

import logging
from typing import Dict, List

from volcano_tpu_torch.api import objects
from volcano_tpu_torch.api.resource import Resource
from volcano_tpu_torch.api.types import TaskStatus
from volcano_tpu_torch.api.unschedule_info import FitFailure
from volcano_tpu_torch.scheduler.framework.interface import Action
from volcano_tpu_torch.scheduler.util import scheduler_helper as helper
from volcano_tpu_torch.scheduler.util.priority_queue import (
    PriorityQueue,
    make_task_queue,
)

logger = logging.getLogger(__name__)


class ReclaimAction(Action):
    def name(self) -> str:
        return "reclaim"

    def execute(self, ssn) -> None:
        from volcano_tpu_torch.ops import evict as evict_mod
        from volcano_tpu_torch.ops import preemptview, victimview

        # batched device eviction (ops/evict.py): queue rotation, tiered
        # victim masks, deserved-floor walks and the eviction cuts run as
        # one packed device dispatch; the host replays the op log through
        # ssn.evict/ssn.pipeline in serial order. VOLCANO_TPU_EVICT=0
        # forces the oracle walk below (tests/test_evict_kernel.py).
        plan = evict_mod.build(ssn, "reclaim")
        if plan is not None and plan.run():
            return

        # dense per-signature feasibility rows replace the per-task O(nodes)
        # predicate closure sweep when tpuscore is on (same candidates, name
        # order, as reclaim.go's full node walk); the victim selector
        # batches the tiered Reclaimable intersection on dense nodes
        view = preemptview.build(ssn)
        selector = victimview.build(ssn, "reclaimable") \
            if view is not None else None

        queues = PriorityQueue(cmp_fn=ssn.queue_order_cmp)
        queue_set = set()
        preemptors_map: Dict[str, PriorityQueue] = {}
        preemptor_tasks: Dict[str, object] = {}

        for job in ssn.jobs.values():
            if job.pod_group.status.phase == objects.PodGroupPhase.PENDING:
                continue
            vr = ssn.job_valid(job)
            if vr is not None and not vr.pass_:
                continue
            queue = ssn.queues.get(job.queue)
            if queue is None:
                continue
            if queue.uid not in queue_set:
                queue_set.add(queue.uid)
                queues.push(queue)
            if job.task_status_index.get(TaskStatus.PENDING):
                if job.queue not in preemptors_map:
                    preemptors_map[job.queue] = PriorityQueue(cmp_fn=ssn.job_order_cmp)
                preemptors_map[job.queue].push(job)
                preemptor_tasks[job.uid] = make_task_queue(
                    ssn, job.task_status_index[TaskStatus.PENDING].values())

        while not queues.empty():
            queue = queues.pop()
            if ssn.overused(queue):
                continue

            jobs = preemptors_map.get(queue.uid)
            if jobs is None or jobs.empty():
                continue
            job = jobs.pop()

            tasks = preemptor_tasks.get(job.uid)
            if tasks is None or tasks.empty():
                continue
            task = tasks.pop()

            assigned = False
            candidates = view.masked_nodes_in_name_order(task) \
                if view is not None else None
            fell_back = candidates is None
            if fell_back:
                def _serial_feasible(_task=task):
                    # lazy, like the original walk: predicates run only up
                    # to the node that succeeds
                    for nd in helper.get_node_list(ssn.nodes):
                        try:
                            ssn.predicate_fn(_task, nd)
                        except FitFailure:
                            continue
                        yield nd
                candidates = _serial_feasible()
            for node in candidates:
                resreq = task.init_resreq.clone()
                reclaimed = Resource.empty()

                reclaimees: List = []
                for t in node.tasks.values():
                    if t.status != TaskStatus.RUNNING:
                        continue
                    j = ssn.jobs.get(t.job)
                    if j is None:
                        continue
                    if j.queue != job.queue:
                        reclaimees.append(t.shared_clone())
                victims = (selector.victims(task, reclaimees)
                           if selector is not None
                           else ssn.reclaimable(task, reclaimees))
                if not victims:
                    continue

                all_res = Resource.empty()
                for v in victims:
                    all_res.add(v.resreq)
                if all_res.less(resreq):
                    continue

                for reclaimee in victims:
                    try:
                        ssn.evict(reclaimee, "reclaim")
                    except (KeyError, RuntimeError) as e:
                        logger.error("Failed to reclaim %s/%s: %s",
                                     reclaimee.namespace, reclaimee.name, e)
                        continue
                    reclaimed.add(reclaimee.resreq)
                    if resreq.less_equal(reclaimed):
                        break

                if task.init_resreq.less_equal(reclaimed):
                    ssn.pipeline(task, node.name)
                    if view is not None:
                        view.on_pipeline(node.name, task)
                        if fell_back and view.needs_poison(task):
                            # affinity pod became resident (see preempt)
                            view.poison()
                    assigned = True
                    break

            if assigned:
                queues.push(queue)
