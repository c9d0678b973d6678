"""Metered fault-degradation ladder: typed backoff, per-dependency
circuit breakers, and explicit degradation rungs.

The stack already degrades honestly at each seam — per-action kernel
fallbacks (ops/solver.py, ops/evict.py, ops/session_fuse.py), the
express lane's defer-to-session contract, the remote watch re-list
retry. What was missing is the POLICY layer tying those seams together:
how hard to retry a failing dependency (capped jittered exponential
backoff, never fixed-interval hammering), when to stop asking entirely
(a circuit breaker per dependency), which explicit rung the scheduler is
on, and how it all recovers — automatically, and visible on /metrics.

Rungs, mildest first (each is the documented response to a persistently
failing dependency; see docs/DESIGN.md §15):

- ``per_action_fallback``  — a device solve failed; that action ran its
  serial oracle (the standing ops/ fallback, now counted here);
- ``serial_host_solve``    — the kernel breaker is OPEN: persistent
  device/compile failure, every action goes serial preemptively instead
  of paying a doomed dispatch + fallback per action;
- ``pipeline_disabled``    — the continuous pipeline's breaker is open
  (repeated pipelined-cycle ERRORS — speculation discards are normal
  churn and never trip it): the scheduler loop falls back to the serial
  run_once cycle until the half-open probe passes;
- ``express_disabled``     — the express lane's breaker is open (repeated
  batch errors) or the lane was parked by lease loss: arrivals fall
  through to full sessions;
- ``watch_coalesce_aggressive`` — watch fan-out lag is climbing (a
  watcher crossed half its demotion budget): the fan-out layer
  (store/flowcontrol.py) compacts EVERY delivery batch instead of only
  large catch-ups, trading event granularity for drain rate before any
  watcher has to be demoted;
- ``admission_shed``       — the intake gate (admission/intake.py) is
  actively shedding submissions: rejected-with-retry, batch before
  interactive; the gauge holds for ``shed_hold_s`` past the last shed so
  scrapers see bursts shorter than their interval;
- ``snapshot_resync_only`` — the front-door breaker is open (a demotion
  storm — watchers falling off faster than they resync): deep laggards
  stop receiving incremental catch-up streams entirely and are answered
  with the reset/re-list contract immediately, keeping the journal and
  the delivery path bounded while the herd recovers; a successful
  resync (promotion) is the half-open probe's success;
- ``session_skip``         — the remote-store breaker is open: skip
  sessions rather than schedule against an unreachable truth, with a
  BOUNDED staleness budget (after ``max_session_skips`` consecutive
  skips the next session runs regardless, so a flapping probe can never
  park the scheduler forever).

Every rung is published as ``volcano_degraded_mode{rung}`` (1 = active)
and recovery closes the breaker and clears the gauge — no operator
action required.

Determinism: backoff jitter derives from a per-instance seeded RNG (the
name, not the wall clock), and breaker cooldowns read utils/clock.now()
— the simulator's virtual clock during a sim run — so degraded-mode
decisions replay byte-identically under the same seed.
"""

from __future__ import annotations

import random
import threading
from typing import Dict, Optional

from volcano_tpu_torch.scheduler import metrics
from volcano_tpu_torch.utils import clock

RUNGS = ("per_action_fallback", "watch_coalesce_aggressive",
         "pipeline_disabled", "serial_host_solve", "express_disabled",
         "admission_shed", "snapshot_resync_only", "session_skip")


class Backoff:
    """Capped, jittered exponential backoff (full-jitter style: the delay
    is uniform in [delay*(1-jitter), delay] so synchronized retriers
    de-correlate). ``next_delay()`` advances the attempt; ``reset()`` on
    success. Deterministic per (name): the jitter RNG is seeded from the
    name, never the clock — two runs retry identically."""

    def __init__(self, name: str, base: float = 0.5, cap: float = 30.0,
                 factor: float = 2.0, jitter: float = 0.5,
                 rng: Optional[random.Random] = None):
        if base <= 0 or cap < base or factor < 1.0:
            raise ValueError("backoff needs base > 0, cap >= base, factor >= 1")
        self.name = name
        self.base = float(base)
        self.cap = float(cap)
        self.factor = float(factor)
        self.jitter = min(max(float(jitter), 0.0), 1.0)
        self.attempt = 0
        self.retries = 0
        self.total_backoff_s = 0.0
        self._rng = rng if rng is not None else random.Random(
            f"volcano-backoff:{name}")

    def peek(self) -> float:
        """The un-jittered delay the next next_delay() scales from."""
        return min(self.base * (self.factor ** self.attempt), self.cap)

    def next_delay(self) -> float:
        delay = self.peek()
        if self.jitter:
            delay *= 1.0 - self.jitter * self._rng.random()
        self.attempt += 1
        self.retries += 1
        self.total_backoff_s += delay
        return delay

    def reset(self) -> None:
        self.attempt = 0

    def stats(self) -> Dict[str, float]:
        return {"attempt": self.attempt, "retries": self.retries,
                "total_backoff_s": round(self.total_backoff_s, 3)}


class CircuitBreaker:
    """Per-dependency breaker: CLOSED (healthy) -> OPEN after
    ``threshold`` consecutive failures -> HALF_OPEN one probe after
    ``cooldown_s`` -> CLOSED on probe success, OPEN again on failure.

    ``allow()`` answers "may I try this dependency now" and is what the
    callers gate on; time comes from utils/clock.now() so the simulator's
    virtual clock drives recovery deterministically."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, name: str, threshold: int = 3,
                 cooldown_s: float = 30.0):
        self.name = name
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self._lock = threading.Lock()
        self._failures = 0
        self._state = self.CLOSED
        self._opened_at = 0.0
        self.stats = {"failures": 0, "opens": 0, "probes": 0, "closes": 0}

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN \
                    and clock.now() - self._opened_at >= self.cooldown_s:
                self._state = self.HALF_OPEN
                self.stats["probes"] += 1
                return True  # exactly this caller probes
            return self._state == self.HALF_OPEN

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            if self._state != self.CLOSED:
                self._state = self.CLOSED
                self.stats["closes"] += 1

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            self.stats["failures"] += 1
            if self._state == self.HALF_OPEN \
                    or (self._state == self.CLOSED
                        and self._failures >= self.threshold):
                self._state = self.OPEN
                self._opened_at = clock.now()
                self.stats["opens"] += 1


class DegradeLadder:
    """The per-scheduler degradation policy: one breaker per dependency
    (remote store, device kernel, express lane) plus the bounded
    session-skip budget, all metered through volcano_degraded_mode."""

    def __init__(self, store_threshold: int = 3, store_cooldown_s: float = 15.0,
                 kernel_threshold: int = 3, kernel_cooldown_s: float = 60.0,
                 express_threshold: int = 3, express_cooldown_s: float = 30.0,
                 pipeline_threshold: int = 3, pipeline_cooldown_s: float = 30.0,
                 frontdoor_threshold: int = 5,
                 frontdoor_cooldown_s: float = 10.0,
                 coalesce_hold_s: float = 10.0, shed_hold_s: float = 5.0,
                 max_session_skips: int = 5):
        self.store = CircuitBreaker("store", store_threshold,
                                    store_cooldown_s)
        self.kernel = CircuitBreaker("kernel", kernel_threshold,
                                     kernel_cooldown_s)
        self.express = CircuitBreaker("express", express_threshold,
                                      express_cooldown_s)
        self.pipeline = CircuitBreaker("pipeline", pipeline_threshold,
                                       pipeline_cooldown_s)
        # front-door breaker: failure = a watcher demotion, success = a
        # completed resync (promotion). Open = snapshot_resync_only.
        self.frontdoor = CircuitBreaker("frontdoor", frontdoor_threshold,
                                        frontdoor_cooldown_s)
        self.coalesce_hold_s = float(coalesce_hold_s)
        self.shed_hold_s = float(shed_hold_s)
        self._coalesce_until = 0.0
        self._shed_until = 0.0
        self.max_session_skips = int(max_session_skips)
        self._skips = 0
        self.counters = {"sessions_skipped": 0, "forced_sessions": 0,
                         "per_action_fallbacks": 0, "watch_demotions": 0,
                         "watch_promotions": 0, "admission_sheds": 0}

    # -- dependency reports (each publishes its rung transition) -----------

    def note_store_error(self) -> None:
        self.store.record_failure()
        self._publish()

    def note_store_ok(self) -> None:
        self.store.record_success()
        self._skips = 0
        self._publish()

    def note_kernel_failure(self) -> None:
        self.kernel.record_failure()
        self.counters["per_action_fallbacks"] += 1
        metrics.set_degraded_mode("per_action_fallback", True)
        self._publish()

    def note_kernel_ok(self) -> None:
        self.kernel.record_success()
        metrics.set_degraded_mode("per_action_fallback", False)
        self._publish()

    def note_express_error(self) -> None:
        self.express.record_failure()
        self._publish()

    def note_express_ok(self) -> None:
        self.express.record_success()
        self._publish()

    def note_pipeline_error(self) -> None:
        """A pipelined cycle CRASHED (not a speculation discard — those
        are the design working as intended and are merely counted)."""
        self.pipeline.record_failure()
        self._publish()

    def note_pipeline_ok(self) -> None:
        self.pipeline.record_success()
        self._publish()

    # -- front-door signals (watch fan-out + admission intake) --------------

    def note_watch_lag(self, lag: int, demote_lag: int) -> None:
        """A watcher's poll observed ``lag`` pending events against the
        fan-out's ``demote_lag`` budget. Crossing HALF the budget arms
        the watch_coalesce_aggressive rung for ``coalesce_hold_s`` —
        compaction ramps up BEFORE anyone has to be demoted."""
        if demote_lag > 0 and 2 * lag >= demote_lag:
            self._coalesce_until = clock.now() + self.coalesce_hold_s
            self._publish()

    def note_watch_demotion(self) -> None:
        self.counters["watch_demotions"] += 1
        self.frontdoor.record_failure()
        self._publish()

    def note_watch_promoted(self) -> None:
        """A demoted watcher completed its snapshot resync — the
        front-door breaker's success signal (and half-open probe)."""
        self.counters["watch_promotions"] += 1
        self.frontdoor.record_success()
        self._publish()

    def note_admission_shed(self) -> None:
        self.counters["admission_sheds"] += 1
        self._shed_until = clock.now() + self.shed_hold_s
        self._publish()

    def note_admission_ok(self) -> None:
        self._publish()

    # -- the gates callers consult ------------------------------------------

    def force_serial(self) -> bool:
        """True while the kernel breaker refuses device dispatches: the
        solver skips the device path (its callers run the serial oracle)
        instead of paying a doomed dispatch per action. allow() doubles as
        the half-open probe — one dispatch is let through after the
        cooldown, and its success closes the breaker."""
        return not self.kernel.allow()

    def express_allowed(self) -> bool:
        return self.express.allow()

    def pipeline_allowed(self) -> bool:
        """True while the pipelined loop may run; False = the
        pipeline_disabled rung — the scheduler runs the serial run_once
        cycle (byte-for-byte the VOLCANO_TPU_PIPELINE=0 oracle) until the
        half-open probe lets one pipelined cycle prove itself again."""
        return self.pipeline.allow()

    def watch_coalesce_aggressive(self) -> bool:
        """True while delivery batches should be compacted regardless of
        size: the lag signal armed the hold window, or the front-door
        breaker is already open (resync-only implies coalesce-hard)."""
        return clock.now() < self._coalesce_until \
            or self.frontdoor.state != CircuitBreaker.CLOSED

    def watch_resync_only(self) -> bool:
        """True while deep laggards must be answered with an immediate
        reset/re-list instead of an incremental catch-up stream. allow()
        doubles as the half-open probe: after the cooldown exactly one
        laggard gets an incremental attempt, and its completed resync
        (note_watch_promoted) closes the breaker."""
        return not self.frontdoor.allow()

    def should_skip_session(self) -> bool:
        """True while the store breaker is open AND the staleness budget
        holds; the budget guarantees a bounded-staleness session even
        under a permanently failing probe."""
        if self.store.allow():
            self._skips = 0
            return False
        if self._skips >= self.max_session_skips:
            self.counters["forced_sessions"] += 1
            self._skips = 0
            return False
        self._skips += 1
        self.counters["sessions_skipped"] += 1
        return True

    # -- metering ------------------------------------------------------------

    def rung(self) -> str:
        """The most severe active rung ('' when healthy). Pure state
        inspection — allow() would consume a half-open probe slot."""
        if self.store.state != CircuitBreaker.CLOSED or self._skips:
            return "session_skip"
        if self.frontdoor.state != CircuitBreaker.CLOSED:
            return "snapshot_resync_only"
        if clock.now() < self._shed_until:
            return "admission_shed"
        if self.express.state != CircuitBreaker.CLOSED:
            return "express_disabled"
        if self.kernel.state != CircuitBreaker.CLOSED:
            return "serial_host_solve"
        if self.pipeline.state != CircuitBreaker.CLOSED:
            return "pipeline_disabled"
        if clock.now() < self._coalesce_until:
            return "watch_coalesce_aggressive"
        return ""

    def _publish(self) -> None:
        metrics.set_degraded_mode(
            "serial_host_solve",
            self.kernel.state != CircuitBreaker.CLOSED)
        metrics.set_degraded_mode(
            "express_disabled",
            self.express.state != CircuitBreaker.CLOSED)
        metrics.set_degraded_mode(
            "session_skip", self.store.state != CircuitBreaker.CLOSED)
        metrics.set_degraded_mode(
            "pipeline_disabled",
            self.pipeline.state != CircuitBreaker.CLOSED)
        now = clock.now()
        metrics.set_degraded_mode(
            "watch_coalesce_aggressive",
            now < self._coalesce_until
            or self.frontdoor.state != CircuitBreaker.CLOSED)
        metrics.set_degraded_mode("admission_shed", now < self._shed_until)
        metrics.set_degraded_mode(
            "snapshot_resync_only",
            self.frontdoor.state != CircuitBreaker.CLOSED)

    def stats(self) -> Dict[str, object]:
        return {
            "rung": self.rung(),
            "counters": dict(self.counters),
            "breakers": {b.name: {"state": b.state, **b.stats}
                         for b in (self.store, self.kernel, self.express,
                                   self.pipeline, self.frontdoor)},
        }


# Process-default ladder: the seams that cannot see a Scheduler instance
# (ops/solver.py device-failure hooks) report here; a Scheduler adopts it
# so its loop and the kernel share one policy. reset() restores pristine
# state (sim runs and tests call it alongside metrics.reset()).

_default: Optional[DegradeLadder] = None
_default_lock = threading.Lock()


def default_ladder() -> DegradeLadder:
    global _default
    ladder = _default
    if ladder is None:
        with _default_lock:
            if _default is None:
                _default = DegradeLadder()
            ladder = _default
    return ladder


def reset() -> None:
    global _default
    with _default_lock:
        _default = None


def note_kernel_failure() -> None:
    default_ladder().note_kernel_failure()


def note_kernel_ok() -> None:
    default_ladder().note_kernel_ok()


def force_serial() -> bool:
    return default_ladder().force_serial()
