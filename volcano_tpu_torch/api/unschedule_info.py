"""Per-node failure-reason bookkeeping for events and conditions
(volcano pkg/scheduler/api/unschedule_info.go)."""

from __future__ import annotations

from typing import Dict, List

ALL_NODE_UNAVAILABLE = "all nodes are unavailable"

# (unschedule_info.go:14-15)
NODE_RESOURCE_FIT_FAILED = "node(s) resource fit failed"


class FitFailure(Exception):
    """Raised by predicate fns when a task cannot fit a node; carries the
    failure reasons (the error-return analog of api.PredicateFn)."""

    def __init__(self, *reasons: str):
        super().__init__(", ".join(reasons))
        self.reasons = list(reasons)

    def fit_error(self, task, node) -> "FitError":
        return FitError(task, node, *self.reasons)


class FitError:
    """Why one task failed to fit on one node (unschedule_info.go:82)."""

    __slots__ = ("task_namespace", "task_name", "node_name", "reasons")

    def __init__(self, task, node, *reasons: str):
        self.task_namespace = task.namespace
        self.task_name = task.name
        self.node_name = node.name
        self.reasons: List[str] = list(reasons)

    def error(self) -> str:
        return (
            f"task {self.task_namespace}/{self.task_name} on node "
            f"{self.node_name} fit failed: {', '.join(self.reasons)}"
        )

    def __repr__(self) -> str:
        return self.error()


class FitErrors:
    """Histogram of failure reasons across nodes for one task
    (unschedule_info.go:22)."""

    def __init__(self):
        self.nodes: Dict[str, FitError] = {}
        self.err: str = ""

    def set_error(self, err: str) -> None:
        self.err = err

    def set_node_error(self, node_name: str, fit_error: FitError) -> None:
        self.nodes[node_name] = fit_error

    def error(self) -> str:
        """"<err>: <lexically-sorted '<count> <reason>' histogram>." —
        matching the reference format exactly (unschedule_info.go Error) so
        parity oracles can compare events/conditions byte-for-byte."""
        reasons: Dict[str, int] = {}
        for fe in self.nodes.values():
            for reason in fe.reasons:
                reasons[reason] = reasons.get(reason, 0) + 1
        prefix = self.err if self.err else ALL_NODE_UNAVAILABLE
        parts = sorted(f"{count} {reason}" for reason, count in reasons.items())
        return f"{prefix}: {', '.join(parts)}."
