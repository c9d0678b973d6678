"""Predicate/prioritize/select helpers for the serial (oracle) backend
(volcano pkg/scheduler/util/scheduler_helper.go).

The reference fans these loops out over 16 workers; here they are serial and
deterministic — this path is the *parity oracle* for the TPU backend
(volcano_tpu_torch.ops), which replaces the whole (tasks x nodes) sweep with one
batched solve. Deliberate divergence from the reference: best-node ties are
broken by node name, not randomly (scheduler_helper.go:209), so Go-loop vs
TPU bindings can be compared byte-for-byte.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

from volcano_tpu_torch.api.job_info import TaskInfo
from volcano_tpu_torch.api.node_info import NodeInfo
from volcano_tpu_torch.api.unschedule_info import FitError, FitErrors, FitFailure
from volcano_tpu_torch.scheduler.options import server_opts

BASELINE_PERCENTAGE_OF_NODES_TO_FIND = 50

# Round-robin start index so all nodes get examined across cycles
# (scheduler_helper.go:38 lastProcessedNodeIndex).
_last_processed_node_index = 0


def calculate_num_of_feasible_nodes_to_find(num_all_nodes: int) -> int:
    """Adaptive sampling: (50 - n/125)%%, floored at min-percentage and
    min-nodes (scheduler_helper.go:42-60)."""
    opts = server_opts
    if num_all_nodes <= opts.min_nodes_to_find or opts.percentage_of_nodes_to_find >= 100:
        return num_all_nodes

    adaptive = opts.percentage_of_nodes_to_find
    if adaptive <= 0:
        adaptive = BASELINE_PERCENTAGE_OF_NODES_TO_FIND - num_all_nodes // 125
        if adaptive < opts.min_percentage_of_nodes_to_find:
            adaptive = opts.min_percentage_of_nodes_to_find

    num_nodes = num_all_nodes * adaptive // 100
    return max(num_nodes, opts.min_nodes_to_find)


def predicate_nodes(
    task: TaskInfo, nodes: List[NodeInfo], fn: Callable
) -> Tuple[List[NodeInfo], FitErrors]:
    """Find up to the sampled number of feasible nodes, starting from where
    the previous cycle left off (scheduler_helper.go:64-118)."""
    global _last_processed_node_index

    fe = FitErrors()
    all_nodes = len(nodes)
    if all_nodes == 0:
        return [], fe
    num_to_find = calculate_num_of_feasible_nodes_to_find(all_nodes)

    found: List[NodeInfo] = []
    processed = 0
    for index in range(all_nodes):
        node = nodes[(_last_processed_node_index + index) % all_nodes]
        processed += 1
        try:
            fn(task, node)
        except FitFailure as err:
            fe.set_node_error(node.name, err.fit_error(task, node))
            continue
        found.append(node)
        if len(found) >= num_to_find:
            break

    _last_processed_node_index = (_last_processed_node_index + processed) % all_nodes
    return found, fe


def reset_round_robin() -> None:
    """Reset cross-cycle sampling state (for deterministic tests/benchmarks)."""
    global _last_processed_node_index
    _last_processed_node_index = 0


def prioritize_nodes(
    task: TaskInfo,
    nodes: List[NodeInfo],
    batch_fn: Callable,
    map_fn: Callable,
    reduce_fn: Callable,
) -> Dict[float, List[NodeInfo]]:
    """score -> nodes map (scheduler_helper.go:120-183)."""
    import math

    plugin_node_scores: Dict[str, Dict[str, float]] = {}
    node_order_scores: Dict[str, float] = {}
    for node in nodes:
        map_scores, order_score = map_fn(task, node)
        for plugin, score in map_scores.items():
            plugin_node_scores.setdefault(plugin, {})[node.name] = float(
                math.floor(score)
            )
        node_order_scores[node.name] = order_score

    reduce_scores = reduce_fn(task, plugin_node_scores)
    batch_scores = batch_fn(task, nodes)

    node_scores: Dict[float, List[NodeInfo]] = {}
    for node in nodes:
        score = reduce_scores.get(node.name, 0.0)
        score += node_order_scores.get(node.name, 0.0)
        score += batch_scores.get(node.name, 0.0)
        node_scores.setdefault(score, []).append(node)
    return node_scores


def sort_nodes(node_scores: Dict[float, List[NodeInfo]]) -> List[NodeInfo]:
    """Nodes in descending score order (scheduler_helper.go:185-197)."""
    out: List[NodeInfo] = []
    for score in sorted(node_scores, reverse=True):
        out.extend(node_scores[score])
    return out


def select_best_node(node_scores: Dict[float, List[NodeInfo]]) -> NodeInfo:
    """Highest-scoring node; deterministic name tie-break (the reference picks
    randomly, scheduler_helper.go:200-211 — divergence documented above)."""
    best_nodes: List[NodeInfo] = []
    max_score = -1.0
    for score, node_list in node_scores.items():
        if score > max_score:
            max_score = score
            best_nodes = node_list
    return min(best_nodes, key=lambda n: n.name)


def get_node_list(nodes: Dict[str, NodeInfo]) -> List[NodeInfo]:
    """Deterministic (name-sorted) node list; the reference's map iteration
    is randomized, ours is canonical for replay parity."""
    return [nodes[name] for name in sorted(nodes)]
