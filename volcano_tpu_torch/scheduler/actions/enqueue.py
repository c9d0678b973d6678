"""enqueue — admit Pending PodGroups into the cluster
(volcano pkg/scheduler/actions/enqueue/enqueue.go:42-124).

A PodGroup flips Pending->Inqueue when its MinResources fit within
1.2x cluster allocatable minus used (the overcommit factor, enqueue.go:80)
and every JobEnqueueable plugin agrees. Downstream, the admission pod-gate
only lets pods be created for Inqueue groups (delay-pod-creation design).
"""

from __future__ import annotations

from typing import Dict

from volcano_tpu_torch.api import objects
from volcano_tpu_torch.api.resource import Resource
from volcano_tpu_torch.scheduler.framework.interface import Action
from volcano_tpu_torch.scheduler.util.priority_queue import PriorityQueue

OVERCOMMIT_FACTOR = 1.2


class EnqueueAction(Action):
    def name(self) -> str:
        return "enqueue"

    def execute(self, ssn) -> None:
        queues = PriorityQueue(cmp_fn=ssn.queue_order_cmp)
        queue_set = set()
        jobs_map: Dict[str, PriorityQueue] = {}

        for job in ssn.jobs.values():
            queue = ssn.queues.get(job.queue)
            if queue is None:
                continue
            if queue.uid not in queue_set:
                queue_set.add(queue.uid)
                queues.push(queue)
            if job.pod_group.status.phase == objects.PodGroupPhase.PENDING:
                if job.queue not in jobs_map:
                    jobs_map[job.queue] = PriorityQueue(cmp_fn=ssn.job_order_cmp)
                jobs_map[job.queue].push(job)

        empty = Resource.empty()
        nodes_idle = Resource.empty()
        for node in ssn.nodes.values():
            nodes_idle.add(node.allocatable.clone().multi(OVERCOMMIT_FACTOR).sub(node.used))

        while not queues.empty():
            if nodes_idle.less(empty):
                break
            queue = queues.pop()
            jobs = jobs_map.get(queue.uid)
            if jobs is None or jobs.empty():
                continue
            job = jobs.pop()

            inqueue = False
            if job.pod_group.spec.min_resources is None:
                inqueue = True
            else:
                pg_resource = Resource.from_resource_list(job.pod_group.spec.min_resources)
                if ssn.job_enqueueable(job) and pg_resource.less_equal(nodes_idle):
                    nodes_idle.sub(pg_resource)
                    inqueue = True

            if inqueue:
                job.pod_group.status.phase = objects.PodGroupPhase.INQUEUE
                ssn.jobs[job.uid] = job

            queues.push(queue)
