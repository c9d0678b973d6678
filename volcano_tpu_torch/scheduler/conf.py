"""Scheduler configuration schema
(volcano pkg/scheduler/conf/scheduler_conf.go:19-58).

YAML shape:

.. code-block:: yaml

    actions: "enqueue, allocate, backfill"
    tiers:
    - plugins:
      - name: priority
      - name: gang
    - plugins:
      - name: drf
      - name: predicates
        arguments:
          predicate.MemoryPressureEnable: "true"
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class PluginOption:
    """One plugin entry in a tier with its 10 enable flags (None = unset,
    defaulted to True by apply_plugin_conf_defaults, plugins/defaults.go:24)."""

    name: str
    enabled_job_order: Optional[bool] = None
    enabled_namespace_order: Optional[bool] = None
    enabled_job_ready: Optional[bool] = None
    enabled_job_pipelined: Optional[bool] = None
    enabled_task_order: Optional[bool] = None
    enabled_preemptable: Optional[bool] = None
    enabled_reclaimable: Optional[bool] = None
    enabled_queue_order: Optional[bool] = None
    enabled_predicate: Optional[bool] = None
    enabled_node_order: Optional[bool] = None
    arguments: Dict[str, str] = field(default_factory=dict)


@dataclass
class Tier:
    plugins: List[PluginOption] = field(default_factory=list)


@dataclass
class SchedulerConfiguration:
    actions: str = ""
    tiers: List[Tier] = field(default_factory=list)


def enabled(flag: Optional[bool]) -> bool:
    """Tri-state flag check (session_plugins.go isEnabled): only an explicit
    True (post-defaulting) enables the extension point."""
    return flag is True


_ENABLE_FLAGS = (
    "enabled_job_order",
    "enabled_namespace_order",
    "enabled_job_ready",
    "enabled_job_pipelined",
    "enabled_task_order",
    "enabled_preemptable",
    "enabled_reclaimable",
    "enabled_queue_order",
    "enabled_predicate",
    "enabled_node_order",
)


def apply_plugin_conf_defaults(option: PluginOption) -> None:
    """All 10 enable flags default True when unset
    (plugins/defaults.go:24)."""
    for flag in _ENABLE_FLAGS:
        if getattr(option, flag) is None:
            setattr(option, flag, True)
