"""proportion — weighted fair-share ("water-filling") of cluster capacity
across queues (volcano pkg/scheduler/plugins/proportion/proportion.go).

Deserved shares are computed by iterating `deserved += remaining*w/Σw`,
clamping at each queue's request, until remaining is empty
(proportion.go:104-157). Provides QueueOrder (by share), Reclaimable
(victims only while their queue stays above deserved), Overused, and
JobEnqueueable (queue capability cap).
"""

from __future__ import annotations

from typing import Dict, List

from volcano_tpu_torch.api.resource import Resource
from volcano_tpu_torch.api.share_helpers import min_resource, share as share_fn

from volcano_tpu_torch.scheduler.framework.event_handlers import EventHandler
from volcano_tpu_torch.scheduler.framework.interface import Plugin

PLUGIN_NAME = "proportion"


class _QueueAttr:
    __slots__ = ("queue_id", "name", "weight", "share", "deserved", "allocated", "request")

    def __init__(self, queue_id: str, name: str, weight: int):
        self.queue_id = queue_id
        self.name = name
        self.weight = weight
        self.share = 0.0
        self.deserved = Resource.empty()
        self.allocated = Resource.empty()
        self.request = Resource.empty()


class ProportionPlugin(Plugin):
    def __init__(self, arguments=None):
        self.arguments = arguments or {}
        self.total_resource = Resource.empty()
        self.queue_opts: Dict[str, _QueueAttr] = {}

    def name(self) -> str:
        return PLUGIN_NAME

    def _update_share(self, attr: _QueueAttr) -> None:
        res = 0.0
        for rn in attr.deserved.resource_names():
            s = share_fn(attr.allocated.get(rn), attr.deserved.get(rn))
            if s > res:
                res = s
        attr.share = res

    def on_session_open(self, ssn) -> None:
        from volcano_tpu_torch.scheduler.cache.nodeaxis import add_total_allocatable

        add_total_allocatable(ssn, self.total_resource)

        # queue attributes from jobs (proportion.go:72-102): the per-task
        # walk collapses to the incrementally-maintained job sums —
        # allocated-status requests (job.allocated) and PENDING requests
        # (job.pending_sum), two O(1) adds per job
        for job in ssn.jobs.values():
            if job.queue not in self.queue_opts:
                queue = ssn.queues[job.queue]
                self.queue_opts[job.queue] = _QueueAttr(queue.uid, queue.name, queue.weight)
            attr = self.queue_opts[job.queue]
            attr.allocated.add(job.allocated)
            attr.request.add(job.allocated)
            attr.request.add(job.pending_sum)

        # iterative water-filling of deserved (proportion.go:104-157)
        remaining = self.total_resource.clone()
        meet: set[str] = set()
        while True:
            total_weight = sum(
                attr.weight for attr in self.queue_opts.values()
                if attr.queue_id not in meet
            )
            if total_weight == 0:
                break

            increased_total = Resource.empty()
            decreased_total = Resource.empty()
            for attr in self.queue_opts.values():
                if attr.queue_id in meet:
                    continue
                old_deserved = attr.deserved.clone()
                attr.deserved.add(
                    remaining.clone().multi(attr.weight / total_weight)
                )
                if attr.request.less(attr.deserved):
                    attr.deserved = min_resource(attr.deserved, attr.request)
                    meet.add(attr.queue_id)
                self._update_share(attr)
                increased, decreased = attr.deserved.diff(old_deserved)
                increased_total.add(increased)
                decreased_total.add(decreased)

            remaining.sub(increased_total).add(decreased_total)
            if remaining.is_empty():
                break

        def queue_order_fn(l, r) -> int:
            ls = self.queue_opts[l.uid].share
            rs = self.queue_opts[r.uid].share
            if ls == rs:
                return 0
            return -1 if ls < rs else 1

        ssn.add_queue_order_fn(PLUGIN_NAME, queue_order_fn)

        def reclaimable_fn(reclaimer, reclaimees: List) -> List:
            victims = []
            allocations: Dict[str, Resource] = {}
            for reclaimee in reclaimees:
                job = ssn.jobs.get(reclaimee.job)
                if job is None:
                    continue
                attr = self.queue_opts[job.queue]
                if job.queue not in allocations:
                    allocations[job.queue] = attr.allocated.clone()
                allocated = allocations[job.queue]
                if allocated.less(reclaimee.resreq):
                    continue
                allocated.sub(reclaimee.resreq)
                # victim only while the queue stays >= deserved
                if attr.deserved.less_equal(allocated):
                    victims.append(reclaimee)
            return victims

        ssn.add_reclaimable_fn(PLUGIN_NAME, reclaimable_fn)

        def overused_fn(queue) -> bool:
            attr = self.queue_opts.get(queue.uid)
            if attr is None:
                return False
            return not attr.allocated.less_equal(attr.deserved)

        ssn.add_overused_fn(PLUGIN_NAME, overused_fn)

        def job_enqueueable_fn(job) -> bool:
            queue = ssn.queues[job.queue]
            capability = queue.queue.spec.capability
            if not capability:
                return True
            attr = self.queue_opts[job.queue]
            pg_resource = Resource.from_resource_list(job.pod_group.spec.min_resources)
            return pg_resource.clone().add(attr.allocated).less_equal(
                Resource.from_resource_list(capability)
            )

        ssn.add_job_enqueueable_fn(PLUGIN_NAME, job_enqueueable_fn)

        def on_allocate(event) -> None:
            job = ssn.jobs[event.task.job]
            attr = self.queue_opts[job.queue]
            attr.allocated.add(event.task.resreq)
            self._update_share(attr)

        def on_deallocate(event) -> None:
            job = ssn.jobs[event.task.job]
            attr = self.queue_opts[job.queue]
            attr.allocated.sub(event.task.resreq)
            self._update_share(attr)

        ssn.add_event_handler(
            EventHandler(allocate_func=on_allocate, deallocate_func=on_deallocate,
                         origin=(PLUGIN_NAME, self))
        )

    def on_session_close(self, ssn) -> None:
        self.total_resource = Resource.empty()
        self.queue_opts = {}


def new(arguments):
    return ProportionPlugin(arguments)
