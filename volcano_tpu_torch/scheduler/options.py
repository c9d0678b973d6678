"""Scheduler server options
(volcano cmd/scheduler/app/options/options.go:44-108)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ServerOpts:
    scheduler_name: str = "volcano"
    scheduler_conf: str = ""
    schedule_period_seconds: float = 1.0
    default_queue: str = "default"
    enable_leader_election: bool = True
    enable_priority_class: bool = True
    # node-sampling knobs (options.go:37-40); 0 percentage = adaptive
    min_nodes_to_find: int = 100
    min_percentage_of_nodes_to_find: int = 5
    percentage_of_nodes_to_find: int = 0
    listen_address: str = ":8080"
    healthz_address: str = "127.0.0.1:11251"


# Global singleton read by scheduler_helper (the reference does the same,
# scheduler_helper.go:43).
server_opts = ServerOpts()
