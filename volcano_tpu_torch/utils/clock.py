"""Injectable wall-clock seam for everything that STAMPS state.

Every place the stack writes a timestamp into durable state — object
identity (``creation_timestamp``), job state transitions, pod
``start_time``/``deletion_timestamp``, recorded events — reads the clock
through :func:`now` instead of calling ``time.time()`` directly. In
production the source IS ``time.time``; the simulator
(a later slice of the port) swaps in its virtual clock so a simulated cluster's
whole causal history is expressed in deterministic virtual time and two
runs of the same scenario+seed produce byte-identical state (the
determinism contract in docs/DESIGN.md §12).

Measurement-only reads (``perf_counter`` latency spans, thread backoffs)
deliberately do NOT go through here: they never influence a decision or a
stored value, and redirecting them would make virtual runs report fake
latencies.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

_source: Optional[Callable[[], float]] = None


def now() -> float:
    """Current time from the installed source (default: ``time.time``)."""
    src = _source
    return time.time() if src is None else src()


def set_source(source: Optional[Callable[[], float]]) -> None:
    """Install a time source (``None`` restores ``time.time``). The
    simulator installs its virtual clock for the duration of a run and
    restores the default in a ``finally`` — leaking a virtual source into
    production code paths would freeze their timestamps."""
    global _source
    _source = source
