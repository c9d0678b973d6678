"""Plugin and Action interfaces (volcano pkg/scheduler/framework/interface.go)."""

from __future__ import annotations

import abc


class Plugin(abc.ABC):
    """Policy plugin: contributes closures to the session's extension points
    during on_session_open."""

    @abc.abstractmethod
    def name(self) -> str: ...

    @abc.abstractmethod
    def on_session_open(self, ssn) -> None: ...

    def on_session_close(self, ssn) -> None:
        pass


class Action(abc.ABC):
    """Scheduling algorithm, run in configured order each session."""

    @abc.abstractmethod
    def name(self) -> str: ...

    def initialize(self) -> None:
        pass

    @abc.abstractmethod
    def execute(self, ssn) -> None: ...

    def un_initialize(self) -> None:
        pass
