"""ClusterInfo — the per-session snapshot handed to every action
(volcano pkg/scheduler/api/cluster_info.go)."""

from __future__ import annotations

from typing import Dict

from volcano_tpu_torch.api.job_info import JobInfo
from volcano_tpu_torch.api.namespace_info import NamespaceInfo
from volcano_tpu_torch.api.node_info import NodeInfo
from volcano_tpu_torch.api.queue_info import QueueInfo


class ClusterInfo:
    __slots__ = ("jobs", "nodes", "queues", "namespace_info", "node_axis")

    def __init__(self):
        self.jobs: Dict[str, JobInfo] = {}
        self.nodes: Dict[str, NodeInfo] = {}
        self.queues: Dict[str, QueueInfo] = {}
        self.namespace_info: Dict[str, NamespaceInfo] = {}
        # columnar capture of the ready nodes (cache/nodeaxis.py), built by
        # snapshot() in the same pass that clones them; None when the
        # embedding cache does not capture
        self.node_axis = None

    def __repr__(self) -> str:
        return (
            f"ClusterInfo: {len(self.jobs)} jobs, {len(self.nodes)} nodes, "
            f"{len(self.queues)} queues"
        )
