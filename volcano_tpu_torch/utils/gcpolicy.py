"""Low-latency GC policy for the scheduler process (a copy of
volcano_tpu/utils/gcpolicy.py).

CPython's automatic cyclic GC triggers full-heap scans from allocation
pressure; at cfg5's scale the session/cache heap holds millions of
objects, and a collection landing inside a session or an express batch
stalls it for tens of milliseconds or more (PERF.md: the express lane's
worst batch is one generation-1 collection). The reference has no analog
problem (Go's concurrent collector); the CPython-native equivalent of its
predictable latency is the standard service recipe:

- disable *automatic* collection (refcounting still reclaims everything
  acyclic immediately — the vast majority of session garbage);
- collect explicitly at safe points, BETWEEN scheduling cycles: young
  generations every cycle, the full heap on a long stride so cyclic garbage
  still cannot accumulate unboundedly.

Scheduler._loop installs this around its cycle loop; library
users who embed a Scheduler keep whatever policy their process already has
unless they opt in.
"""

from __future__ import annotations

import gc
import threading


class LowLatencyGC:
    """Handle around the disable/collect-at-safe-points policy.

    Usage:
        policy = LowLatencyGC.install()
        while ...:
            run_cycle()
            policy.maintain()   # between cycles: young gens now, full rarely
        policy.uninstall()
    """

    FULL_EVERY = 50  # gen2 stride (cycles)

    # install/uninstall are reference-counted at class level: two scheduler
    # loops in one process (the HA active/passive topology) must not have
    # the first uninstall re-enable automatic GC under the survivor
    _installs = 0
    _outermost_was_enabled = False
    _lock = threading.Lock()  # two HA loops may install concurrently

    def __init__(self):
        self._cycles = 0
        self._active = True

    @classmethod
    def install(cls) -> "LowLatencyGC":
        with cls._lock:
            if cls._installs == 0:
                cls._outermost_was_enabled = gc.isenabled()
                gc.disable()
            cls._installs += 1
        return cls()

    def maintain(self) -> None:
        """Call between cycles (outside the latency path)."""
        self._cycles += 1
        if self._cycles % self.FULL_EVERY == 0:
            gc.collect()  # full: bounded cyclic-garbage accumulation
        else:
            gc.collect(1)  # young gens: cheap, keeps the nursery drained

    def uninstall(self) -> None:
        cls = type(self)
        with cls._lock:
            if not self._active:
                return
            self._active = False
            cls._installs -= 1
            if cls._installs == 0 and cls._outermost_was_enabled:
                gc.enable()
