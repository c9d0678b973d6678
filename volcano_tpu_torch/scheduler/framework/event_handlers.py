"""Session event handlers (volcano pkg/scheduler/framework/event_handlers.go).

Plugins register allocate/deallocate callbacks to keep incremental state
(DRF shares, proportion allocations) in sync with session mutations.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional


@dataclass
class Event:
    task: object  # TaskInfo


@dataclass
class EventHandler:
    allocate_func: Optional[Callable[[Event], None]] = None
    deallocate_func: Optional[Callable[[Event], None]] = None
    # stock plugins tag their handlers so the native transition engine
    # (ops/fasttrans.py) can recognize — and fuse — exactly the handler
    # set it models; any untagged handler disables the fast path
    origin: Optional[tuple] = None
