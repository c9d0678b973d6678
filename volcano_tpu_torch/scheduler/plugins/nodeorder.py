"""nodeorder — node scoring priorities
(volcano pkg/scheduler/plugins/nodeorder/nodeorder.go).

NodeOrderFn = LeastRequested + BalancedResourceAllocation + NodeAffinity,
each x its configurable weight (raw map scores, no normalize — matching the
reference, which calls only the k8s Map fns, nodeorder.go:161-200).
BatchNodeOrderFn = InterPodAffinity, normalized 0..10 across the node set
then x podaffinity.weight (nodeorder.go:202-220).

Implemented natively over the session's NodeInfo; the k8s formulas
(1.13-era priorities) are reproduced including the non-zero request
defaults (100 mCPU / 200 MB).
"""

from __future__ import annotations

import math
from typing import Dict, List

from volcano_tpu_torch.api import objects
from volcano_tpu_torch.api.job_info import TaskInfo
from volcano_tpu_torch.api.node_info import NodeInfo
from volcano_tpu_torch.api.resource import Resource
from volcano_tpu_torch.scheduler.framework.interface import Plugin
from volcano_tpu_torch.scheduler.plugins.predicates import (
    _node_topology_value,
    _pods_on_node,
    _selector_matches_pod,
)

PLUGIN_NAME = "nodeorder"

NODE_AFFINITY_WEIGHT = "nodeaffinity.weight"
POD_AFFINITY_WEIGHT = "podaffinity.weight"
LEAST_REQUESTED_WEIGHT = "leastrequested.weight"
BALANCED_RESOURCE_WEIGHT = "balancedresource.weight"

MAX_PRIORITY = 10

# k8s non-zero request defaults (priorities/util)
DEFAULT_MILLI_CPU_REQUEST = 100.0
DEFAULT_MEMORY_REQUEST = 200.0 * 1024 * 1024


def _non_zero_request(res: Resource) -> tuple[float, float]:
    cpu = res.milli_cpu if res.milli_cpu != 0 else DEFAULT_MILLI_CPU_REQUEST
    mem = res.memory if res.memory != 0 else DEFAULT_MEMORY_REQUEST
    return cpu, mem


def least_requested_score(task: TaskInfo, node: NodeInfo) -> float:
    """((capacity-requested)*10/capacity averaged over cpu+mem)."""
    req_cpu, req_mem = _non_zero_request(task.resreq)
    used_cpu, used_mem = node.used.milli_cpu, node.used.memory
    total_cpu = node.allocatable.milli_cpu
    total_mem = node.allocatable.memory

    def dim_score(capacity: float, requested: float) -> float:
        if capacity == 0 or requested > capacity:
            return 0.0
        return (capacity - requested) * float(MAX_PRIORITY) / capacity

    cpu_score = dim_score(total_cpu, used_cpu + req_cpu)
    mem_score = dim_score(total_mem, used_mem + req_mem)
    return math.floor((cpu_score + mem_score) / 2)


def balanced_resource_score(task: TaskInfo, node: NodeInfo) -> float:
    """10 - |cpuFraction - memFraction|*10; 0 when over capacity."""
    req_cpu, req_mem = _non_zero_request(task.resreq)
    total_cpu = node.allocatable.milli_cpu
    total_mem = node.allocatable.memory
    if total_cpu == 0 or total_mem == 0:
        return 0.0
    cpu_fraction = (node.used.milli_cpu + req_cpu) / total_cpu
    mem_fraction = (node.used.memory + req_mem) / total_mem
    if cpu_fraction >= 1 or mem_fraction >= 1:
        return 0.0
    return math.floor(MAX_PRIORITY - abs(cpu_fraction - mem_fraction) * MAX_PRIORITY)


def node_affinity_score(task: TaskInfo, node: NodeInfo) -> float:
    """Sum of weights of matching preferred node-affinity terms (raw, like
    CalculateNodeAffinityPriorityMap without the normalize reduce)."""
    pod = task.pod
    if pod is None or pod.spec.affinity is None or pod.spec.affinity.node_affinity is None:
        return 0.0
    labels = node.node.metadata.labels if node.node is not None else {}
    score = 0
    for pref in pod.spec.affinity.node_affinity.preferred_terms:
        if pref.weight != 0 and pref.preference.matches(labels):
            score += pref.weight
    return float(score)


def inter_pod_affinity_scores(
    task: TaskInfo, nodes: List[NodeInfo], hard_pod_affinity_weight: int = 1
) -> Dict[str, float]:
    """k8s InterPodAffinityPriority: accumulate signed term weights per
    topology domain (incoming pod's preferred terms against existing pods,
    existing pods' preferred terms against the incoming pod, and the
    hard-affinity symmetric weight), then normalize to 0..MAX_PRIORITY."""
    pod = task.pod
    if pod is None:
        return {}
    counts: Dict[str, float] = {n.name: 0.0 for n in nodes}

    def add_topo(term: objects.PodAffinityTerm, anchor: NodeInfo, weight: float) -> None:
        topo = _node_topology_value(anchor, term.topology_key)
        for n in nodes:
            if _node_topology_value(n, term.topology_key) == topo:
                counts[n.name] += weight

    my_affinity = pod.spec.affinity
    for node in nodes:
        for existing in _pods_on_node(node):
            # incoming pod's preferred (anti-)affinity vs existing pod
            if my_affinity is not None:
                if my_affinity.pod_affinity is not None:
                    for wt in my_affinity.pod_affinity.preferred_terms:
                        if _selector_matches_pod(wt.pod_affinity_term, existing, pod.metadata.namespace):
                            add_topo(wt.pod_affinity_term, node, float(wt.weight))
                if my_affinity.pod_anti_affinity is not None:
                    for wt in my_affinity.pod_anti_affinity.preferred_terms:
                        if _selector_matches_pod(wt.pod_affinity_term, existing, pod.metadata.namespace):
                            add_topo(wt.pod_affinity_term, node, -float(wt.weight))
            # existing pod's (anti-)affinity vs incoming pod
            ea = existing.spec.affinity
            if ea is not None:
                if ea.pod_affinity is not None:
                    for wt in ea.pod_affinity.preferred_terms:
                        if _selector_matches_pod(wt.pod_affinity_term, pod, existing.metadata.namespace):
                            add_topo(wt.pod_affinity_term, node, float(wt.weight))
                    # hard-affinity symmetry
                    for term in ea.pod_affinity.required_terms:
                        if _selector_matches_pod(term, pod, existing.metadata.namespace):
                            add_topo(term, node, float(hard_pod_affinity_weight))
                if ea.pod_anti_affinity is not None:
                    for wt in ea.pod_anti_affinity.preferred_terms:
                        if _selector_matches_pod(wt.pod_affinity_term, pod, existing.metadata.namespace):
                            add_topo(wt.pod_affinity_term, node, -float(wt.weight))

    values = list(counts.values())
    max_c, min_c = max(values, default=0.0), min(values, default=0.0)
    if max_c == min_c:
        return {name: 0.0 for name in counts}
    return {
        name: float(MAX_PRIORITY) * (c - min_c) / (max_c - min_c)
        for name, c in counts.items()
    }


class NodeOrderPlugin(Plugin):
    def __init__(self, arguments=None):
        self.arguments = arguments or {}

    def name(self) -> str:
        return PLUGIN_NAME

    def on_session_open(self, ssn) -> None:
        from volcano_tpu_torch.scheduler.framework.arguments import Arguments

        args = self.arguments if isinstance(self.arguments, Arguments) else Arguments(self.arguments)
        least_req_weight = args.get_int(LEAST_REQUESTED_WEIGHT, 1)
        node_affinity_weight = args.get_int(NODE_AFFINITY_WEIGHT, 1)
        pod_affinity_weight = args.get_int(POD_AFFINITY_WEIGHT, 1)
        balanced_weight = args.get_int(BALANCED_RESOURCE_WEIGHT, 1)

        def node_order_fn(task: TaskInfo, node: NodeInfo) -> float:
            score = 0.0
            score += least_requested_score(task, node) * least_req_weight
            score += balanced_resource_score(task, node) * balanced_weight
            score += node_affinity_score(task, node) * node_affinity_weight
            return score

        ssn.add_node_order_fn(PLUGIN_NAME, node_order_fn)

        def batch_node_order_fn(task: TaskInfo, nodes: List[NodeInfo]) -> Dict[str, float]:
            scores = inter_pod_affinity_scores(task, nodes)
            return {name: s * pod_affinity_weight for name, s in scores.items()}

        ssn.add_batch_node_order_fn(PLUGIN_NAME, batch_node_order_fn)


def new(arguments):
    return NodeOrderPlugin(arguments)
