"""The effector seam of the scheduler cache
(volcano pkg/scheduler/cache/interface.go:27-76).

``Binder``/``Evictor``/``StatusUpdater``/``VolumeBinder`` are the pluggable
write-paths from scheduler decisions back to the state store. Unit tests,
the deterministic replay benchmark, and the TPU parity harness all plug
fakes into exactly this seam.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable


class BindManyError(Exception):
    """Raised by a Binder's optional ``bind_many`` on partial failure.

    ``done`` is the count of leading pairs successfully bound before the
    failure, so the caller retries only the remainder instead of re-binding
    pods that already succeeded (which would fail against a real binder and
    spuriously resync genuinely-bound tasks). A bind_many implementation
    that raises anything else promises it made no partial progress."""

    def __init__(self, done: int, cause: Exception):
        super().__init__(f"bind_many failed after {done} binds: {cause}")
        self.done = done
        self.cause = cause


@runtime_checkable
class Binder(Protocol):
    def bind(self, pod, hostname: str) -> None:
        """Commit a placement (the pods/{name}/binding POST analog).

        Implementations may also provide ``bind_many(pairs)`` taking an
        iterable of (pod, hostname); it must raise BindManyError to report
        partial progress."""


@runtime_checkable
class Evictor(Protocol):
    def evict(self, pod, reason: str = "") -> None:
        """Start graceful deletion of a pod."""


@runtime_checkable
class StatusUpdater(Protocol):
    def update_pod_condition(self, pod, condition) -> None: ...

    def update_pod_group(self, pod_group, status=None) -> None: ...


@runtime_checkable
class VolumeBinder(Protocol):
    def allocate_volumes(self, task, hostname: str) -> None: ...

    def bind_volumes(self, task) -> None: ...
