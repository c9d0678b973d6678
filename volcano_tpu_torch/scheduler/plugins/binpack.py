"""binpack — best-fit node scoring
(volcano pkg/scheduler/plugins/binpack/binpack.go).

score = (sum_r w_r * (request_r + used_r)/capacity_r) / sum(w) * 10 * weight,
with per-resource weights (incl. arbitrary scalar resources) from plugin
arguments (binpack.go:95-152, 201-261).
"""

from __future__ import annotations

from typing import Dict

from volcano_tpu_torch.api.job_info import TaskInfo
from volcano_tpu_torch.api.node_info import NodeInfo
from volcano_tpu_torch.scheduler.framework.interface import Plugin

PLUGIN_NAME = "binpack"

BINPACK_WEIGHT = "binpack.weight"
BINPACK_CPU = "binpack.cpu"
BINPACK_MEMORY = "binpack.memory"
BINPACK_RESOURCES = "binpack.resources"
BINPACK_RESOURCES_PREFIX = BINPACK_RESOURCES + "."

MAX_PRIORITY = 10


class PriorityWeight:
    def __init__(self, weight=1, cpu=1, memory=1, resources=None):
        self.binpacking_weight = weight
        self.binpacking_cpu = cpu
        self.binpacking_memory = memory
        self.binpacking_resources: Dict[str, int] = resources or {}


def calculate_weight(args) -> PriorityWeight:
    from volcano_tpu_torch.scheduler.framework.arguments import Arguments

    args = args if isinstance(args, Arguments) else Arguments(args or {})
    w = PriorityWeight()
    w.binpacking_weight = args.get_int(BINPACK_WEIGHT, 1)
    w.binpacking_cpu = args.get_int(BINPACK_CPU, 1)
    if w.binpacking_cpu < 0:
        w.binpacking_cpu = 1
    w.binpacking_memory = args.get_int(BINPACK_MEMORY, 1)
    if w.binpacking_memory < 0:
        w.binpacking_memory = 1
    for resource in str(args.get(BINPACK_RESOURCES, "")).split(","):
        resource = resource.strip()
        if not resource:
            continue
        rw = args.get_int(BINPACK_RESOURCES_PREFIX + resource, 1)
        if rw < 0:
            rw = 1
        w.binpacking_resources[resource] = rw
    return w


def resource_bin_packing_score(requested: float, capacity: float, used: float, weight: int) -> float:
    """(binpack.go:249-261)"""
    if capacity == 0 or weight == 0:
        return 0.0
    used_finally = requested + used
    if used_finally > capacity:
        return 0.0
    return used_finally * weight / capacity


def bin_packing_score(task: TaskInfo, node: NodeInfo, weight: PriorityWeight) -> float:
    """(binpack.go:201-246)"""
    score = 0.0
    weight_sum = 0
    requested = task.resreq
    for resource in requested.resource_names():
        request = requested.get(resource)
        if request == 0:
            continue
        if resource == "cpu":
            resource_weight = weight.binpacking_cpu
        elif resource == "memory":
            resource_weight = weight.binpacking_memory
        elif resource in weight.binpacking_resources:
            resource_weight = weight.binpacking_resources[resource]
        else:
            continue
        score += resource_bin_packing_score(
            request, node.allocatable.get(resource), node.used.get(resource), resource_weight
        )
        weight_sum += resource_weight

    if weight_sum > 0:
        score /= weight_sum
    return score * MAX_PRIORITY * weight.binpacking_weight


class BinpackPlugin(Plugin):
    def __init__(self, arguments=None):
        self.weight = calculate_weight(arguments)

    def name(self) -> str:
        return PLUGIN_NAME

    def on_session_open(self, ssn) -> None:
        if self.weight.binpacking_weight == 0:
            return
        ssn.add_node_order_fn(
            PLUGIN_NAME, lambda task, node: bin_packing_score(task, node, self.weight)
        )


def new(arguments):
    return BinpackPlugin(arguments)
