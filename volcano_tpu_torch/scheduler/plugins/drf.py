"""drf — Dominant Resource Fairness ordering and preemption policy
(volcano pkg/scheduler/plugins/drf/drf.go).

share(job) = max_r allocated_r / total_r (drf.go:299-311). Job order prefers
the smaller share; preemption only when the preemptor's post-allocation share
stays below the victim's post-eviction share; optional weighted namespace
order. Event handlers keep shares incremental as the session allocates/evicts.
"""

from __future__ import annotations

import math
from typing import Dict, List

from volcano_tpu_torch.api.resource import Resource

from volcano_tpu_torch.scheduler import conf
from volcano_tpu_torch.scheduler.framework.event_handlers import EventHandler
from volcano_tpu_torch.scheduler.framework.interface import Plugin

PLUGIN_NAME = "drf"
SHARE_DELTA = 0.000001


class _Attr:
    __slots__ = ("share", "dominant_resource", "allocated")

    def __init__(self):
        self.share = 0.0
        self.dominant_resource = ""
        self.allocated = Resource.empty()


class DrfPlugin(Plugin):
    def __init__(self, arguments=None):
        self.arguments = arguments or {}
        self.total_resource = Resource.empty()
        self.job_attrs: Dict[str, _Attr] = {}
        self.namespace_opts: Dict[str, _Attr] = {}
        self._total_pairs = None  # (total, [(name, value)]) memo

    def name(self) -> str:
        return PLUGIN_NAME

    def _namespace_order_enabled(self, ssn) -> bool:
        for tier in ssn.tiers:
            for plugin in tier.plugins:
                if plugin.name == PLUGIN_NAME:
                    return conf.enabled(plugin.enabled_namespace_order)
        return False

    def _calculate_share(self, allocated: Resource, total: Resource):
        # total is static after on_session_open; its (name, value) pairs
        # are materialized once — this runs per task transition event in
        # the preempt/reclaim hot loops
        pairs = self._total_pairs
        if pairs is None or pairs[0] is not total:
            pairs = self._total_pairs = (
                total, [(rn, total.get(rn)) for rn in total.resource_names()])
        res, dominant = 0.0, ""
        get = allocated.get
        for rn, tv in pairs[1]:
            l = get(rn)
            s = ((0.0 if l == 0 else 1.0) if tv == 0 else l / tv)
            if s > res:
                res = s
                dominant = rn
        return dominant, res

    def _update_share(self, attr: _Attr) -> None:
        attr.dominant_resource, attr.share = self._calculate_share(
            attr.allocated, self.total_resource
        )

    def on_session_open(self, ssn) -> None:
        from volcano_tpu_torch.scheduler.cache.nodeaxis import add_total_allocatable

        add_total_allocatable(ssn, self.total_resource)

        namespace_order_enabled = self._namespace_order_enabled(ssn)

        job_attrs = self.job_attrs
        for job in ssn.jobs.values():
            attr = _Attr()
            # job.allocated is the incrementally-maintained sum over the
            # allocated-status buckets — identical to the per-task walk
            # (drf.go:84-90) at O(1) per job
            alloc = job.allocated
            if alloc.milli_cpu == 0.0 and alloc.memory == 0.0 and \
                    not any((alloc.scalar_resources or {}).values()):
                # exactly-zero allocation: share is 0 with no dominant
                # resource, which is _Attr()'s initial state — skip the
                # copy and the share scan (the common all-pending regime)
                job_attrs[job.uid] = attr
            else:
                attr.allocated.add(alloc)
                self._update_share(attr)
                job_attrs[job.uid] = attr

            if namespace_order_enabled:
                ns_opt = self.namespace_opts.setdefault(job.namespace, _Attr())
                ns_opt.allocated.add(attr.allocated)
                self._update_share(ns_opt)

        def preemptable_fn(preemptor, preemptees: List) -> List:
            victims = []

            if namespace_order_enabled:
                # namespace-level weighted-share policy first (drf.go:120-178)
                l_ns_info = ssn.namespace_info.get(preemptor.namespace)
                l_weight = l_ns_info.get_weight() if l_ns_info else 1
                l_ns_att = self.namespace_opts[preemptor.namespace]
                l_alloc = l_ns_att.allocated.clone().add(preemptor.resreq)
                _, l_share = self._calculate_share(l_alloc, self.total_resource)
                l_weighted = l_share / l_weight

                namespace_allocation: Dict[str, Resource] = {}
                undecided = []
                for preemptee in preemptees:
                    if preemptor.namespace == preemptee.namespace:
                        undecided.append(preemptee)
                        continue
                    ns_alloc = namespace_allocation.get(preemptee.namespace)
                    if ns_alloc is None:
                        r_att = self.namespace_opts[preemptee.namespace]
                        ns_alloc = r_att.allocated.clone()
                        namespace_allocation[preemptee.namespace] = ns_alloc
                    r_ns_info = ssn.namespace_info.get(preemptee.namespace)
                    r_weight = r_ns_info.get_weight() if r_ns_info else 1
                    r_alloc = ns_alloc.sub(preemptee.resreq)
                    _, r_share = self._calculate_share(r_alloc, self.total_resource)
                    r_weighted = r_share / r_weight
                    if l_weighted < r_weighted:
                        victims.append(preemptee)
                    if l_weighted - r_weighted > SHARE_DELTA:
                        continue
                    undecided.append(preemptee)
                preemptees = undecided

            l_att = self.job_attrs[preemptor.job]
            l_alloc = l_att.allocated.clone().add(preemptor.resreq)
            _, ls = self._calculate_share(l_alloc, self.total_resource)

            allocations: Dict[str, Resource] = {}
            for preemptee in preemptees:
                if preemptee.job not in allocations:
                    allocations[preemptee.job] = self.job_attrs[preemptee.job].allocated.clone()
                r_alloc = allocations[preemptee.job].sub(preemptee.resreq)
                _, rs = self._calculate_share(r_alloc, self.total_resource)
                if ls < rs or abs(ls - rs) <= SHARE_DELTA:
                    victims.append(preemptee)
            return victims

        ssn.add_preemptable_fn(PLUGIN_NAME, preemptable_fn)

        def job_order_fn(l, r) -> int:
            l_share = self.job_attrs[l.uid].share
            r_share = self.job_attrs[r.uid].share
            if l_share == r_share:
                return 0
            return -1 if l_share < r_share else 1

        ssn.add_job_order_fn(PLUGIN_NAME, job_order_fn)

        if namespace_order_enabled:
            def namespace_order_fn(l: str, r: str) -> int:
                l_opt = self.namespace_opts.get(l) or _Attr()
                r_opt = self.namespace_opts.get(r) or _Attr()
                li = ssn.namespace_info.get(l)
                ri = ssn.namespace_info.get(r)
                lw = li.get_weight() if li else 1
                rw = ri.get_weight() if ri else 1
                lws, rws = l_opt.share / lw, r_opt.share / rw
                if lws == rws:
                    return 0
                return -1 if lws < rws else 1

            ssn.add_namespace_order_fn(PLUGIN_NAME, namespace_order_fn)

        def on_allocate(event) -> None:
            attr = self.job_attrs[event.task.job]
            attr.allocated.add(event.task.resreq)
            self._update_share(attr)
            if namespace_order_enabled:
                ns_opt = self.namespace_opts[event.task.namespace]
                ns_opt.allocated.add(event.task.resreq)
                self._update_share(ns_opt)

        def on_deallocate(event) -> None:
            attr = self.job_attrs[event.task.job]
            attr.allocated.sub(event.task.resreq)
            self._update_share(attr)
            if namespace_order_enabled:
                ns_opt = self.namespace_opts[event.task.namespace]
                ns_opt.allocated.sub(event.task.resreq)
                self._update_share(ns_opt)

        ssn.add_event_handler(
            EventHandler(allocate_func=on_allocate, deallocate_func=on_deallocate,
                         origin=(PLUGIN_NAME, self, namespace_order_enabled))
        )

    def on_session_close(self, ssn) -> None:
        self.total_resource = Resource.empty()
        self.job_attrs = {}


def new(arguments):
    return DrfPlugin(arguments)
