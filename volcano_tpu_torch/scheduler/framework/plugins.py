"""Global plugin-builder and action registries
(volcano pkg/scheduler/framework/plugins.go:30-72)."""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

_lock = threading.Lock()
_plugin_builders: Dict[str, Callable] = {}
_actions: Dict[str, object] = {}


def register_plugin_builder(name: str, builder: Callable) -> None:
    """builder(arguments: Arguments) -> Plugin"""
    with _lock:
        _plugin_builders[name] = builder


def get_plugin_builder(name: str) -> Optional[Callable]:
    with _lock:
        return _plugin_builders.get(name)


def register_action(action) -> None:
    with _lock:
        _actions[action.name()] = action


def get_action(name: str):
    with _lock:
        action = _actions.get(name)
    if action is None:
        raise KeyError(f"action {name} is not found")
    return action
