"""Task/node status enums and plugin function conventions.

Mirrors volcano pkg/scheduler/api/types.go. Plugin extension-point callables
are plain Python callables; their signatures are documented on the Session
registration methods (see volcano_tpu_torch.scheduler.framework.session).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class TaskStatus(enum.IntFlag):
    """Status of a task/pod in the scheduler (types.go:24-58)."""

    PENDING = 1 << 0      # pending in the store
    ALLOCATED = 1 << 1    # scheduler assigned a host (session-local)
    PIPELINED = 1 << 2    # assigned a host, waiting on releasing resources
    BINDING = 1 << 3      # bind request sent
    BOUND = 1 << 4        # bound to a host
    RUNNING = 1 << 5      # running on the host
    RELEASING = 1 << 6    # being deleted
    SUCCEEDED = 1 << 7
    FAILED = 1 << 8
    UNKNOWN = 1 << 9

    def __str__(self) -> str:  # "Pending", "Allocated", ...
        return self.name.capitalize() if self.name else "Unknown"


def allocated_status(status: TaskStatus) -> bool:
    """Whether the status counts as occupying resources
    (pkg/scheduler/api/helpers.go AllocatedStatus)."""
    return status in (
        TaskStatus.BOUND,
        TaskStatus.BINDING,
        TaskStatus.RUNNING,
        TaskStatus.ALLOCATED,
    )


class NodePhase(enum.IntEnum):
    READY = 1
    NOT_READY = 2

    def __str__(self) -> str:
        return "Ready" if self is NodePhase.READY else "NotReady"


@dataclass
class ValidateResult:
    """Result of a JobValid extension point (types.go:121-125)."""

    pass_: bool
    reason: str = ""
    message: str = ""
