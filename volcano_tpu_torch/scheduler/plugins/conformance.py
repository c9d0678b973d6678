"""conformance — never evict cluster-critical workloads
(volcano pkg/scheduler/plugins/conformance/conformance.go:44-66)."""

from __future__ import annotations

from typing import List

from volcano_tpu_torch.api import objects
from volcano_tpu_torch.scheduler.framework.interface import Plugin

PLUGIN_NAME = "conformance"

KUBE_SYSTEM_NAMESPACE = "kube-system"


class ConformancePlugin(Plugin):
    def __init__(self, arguments=None):
        self.arguments = arguments or {}

    def name(self) -> str:
        return PLUGIN_NAME

    def on_session_open(self, ssn) -> None:
        def evictable_fn(evictor, evictees: List) -> List:
            victims = []
            for evictee in evictees:
                class_name = (
                    evictee.pod.spec.priority_class_name if evictee.pod else ""
                )
                if class_name in (
                    objects.SYSTEM_CLUSTER_CRITICAL,
                    objects.SYSTEM_NODE_CRITICAL,
                ) or evictee.namespace == KUBE_SYSTEM_NAMESPACE:
                    continue
                victims.append(evictee)
            return victims

        ssn.add_preemptable_fn(PLUGIN_NAME, evictable_fn)
        ssn.add_reclaimable_fn(PLUGIN_NAME, evictable_fn)


def new(arguments):
    return ConformancePlugin(arguments)
