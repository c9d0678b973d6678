"""Admission backpressure — the front door's intake gate.

A submission storm today grows the store/controller backlog without
bound: every Job is validated, created, and queued no matter how far
behind the scheduler already is. This module adds the missing policy —
bounded-inflight admission with a token-bucket intake and
priority-aware shedding — as ordinary store admission middleware, so it
guards the in-process path and the HTTP gateway identically:

- ``IntakeGate.admit(priority)`` takes one token from a refilling bucket
  (rate ``rate_per_s``, depth ``burst``) and checks the backlog bound;
  when either is exhausted it raises ``OverloadedError`` carrying a
  computed ``retry_after`` — rejected-WITH-retry, never a silent drop.
- Priority-aware shedding: the last ``interactive_reserve`` fraction of
  both the bucket and the backlog budget is reserved for interactive /
  express-eligible arrivals (``classify_job``: the express envelope's
  shape — small task count, tiny gang), so under a burst the batch
  storm sheds FIRST and interactive latency degrades LAST.
- ``set_backlog`` feeds the demand signal (pending pods / gated
  PodGroups, published per scheduler cycle) — admission slows down when
  the scheduler is behind, which is what turns an unbounded-queue storm
  into bounded latency.

Every shed notifies the degradation ladder (``admission_shed`` rung) and
meters ``volcano_admission_shed_total{reason}`` plus the
``volcano_admission_retry_after_seconds`` histogram. Time comes from
utils/clock.now() — the simulator's virtual clock during a sim run — so
shedding decisions replay byte-identically under the same seed.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from volcano_tpu_torch.store.store import OverloadedError, Store
from volcano_tpu_torch.utils import clock

PRIORITY_CLASSES = ("interactive", "batch")


def classify_job(job) -> str:
    """"interactive" when the job fits the express lane's eligibility
    envelope (small task count, tiny/no gang — the latency-sensitive
    class), else "batch". Interactive arrivals shed LAST."""
    try:
        from volcano_tpu_torch.express.trigger import (
            EXPRESS_MAX_GANG, EXPRESS_MAX_TASKS)
    except Exception:  # express package absent/ungated embedders
        EXPRESS_MAX_TASKS, EXPRESS_MAX_GANG = 8, 4
    try:
        replicas = sum(int(t.replicas) for t in job.spec.tasks)
        min_avail = int(job.spec.min_available)
    except Exception:
        return "batch"
    if replicas <= EXPRESS_MAX_TASKS and min_avail <= EXPRESS_MAX_GANG:
        return "interactive"
    return "batch"


class IntakeGate:
    """Token-bucket + backlog-bound admission with an interactive
    reserve. Thread-safe; deterministic under utils/clock."""

    def __init__(self, rate_per_s: float = 200.0,
                 burst: Optional[float] = None,
                 max_backlog: int = 0,
                 interactive_reserve: float = 0.25,
                 backlog_retry_s: float = 2.0,
                 ladder=None):
        if rate_per_s <= 0:
            raise ValueError("intake needs rate_per_s > 0")
        self.rate = float(rate_per_s)
        self.burst = float(burst) if burst is not None \
            else max(2.0 * self.rate, 2.0)
        self.max_backlog = int(max_backlog)
        self.interactive_reserve = min(max(float(interactive_reserve),
                                           0.0), 0.9)
        self.backlog_retry_s = float(backlog_retry_s)
        self._explicit_ladder = ladder
        self._lock = threading.Lock()
        self._tokens = self.burst
        self._stamp: Optional[float] = None
        self._backlog = 0
        self.counters: Dict[str, float] = {
            "admitted": 0, "admitted_interactive": 0, "admitted_batch": 0,
            "shed_total": 0, "shed_rate": 0, "shed_backlog": 0,
            "shed_interactive": 0, "shed_batch": 0,
            "retry_after_s_sum": 0.0}

    def _ladder(self):
        if self._explicit_ladder is not None:
            return self._explicit_ladder
        from volcano_tpu_torch.scheduler import degrade

        return degrade.default_ladder()

    # -- signals ------------------------------------------------------------

    def set_backlog(self, n: int) -> None:
        """Feed the demand signal (pending work the scheduler has not
        yet placed) — published once per cycle by the scheduler loop or
        the sim harness."""
        with self._lock:
            self._backlog = max(int(n), 0)

    # -- the gate -----------------------------------------------------------

    def _refill(self, now: float) -> None:
        if self._stamp is None:
            self._stamp = now
            return
        elapsed = max(now - self._stamp, 0.0)
        if elapsed > 0:
            self._tokens = min(self.burst,
                               self._tokens + elapsed * self.rate)
            self._stamp = now

    def admit(self, priority: str = "batch", cost: float = 1.0) -> None:
        """Admit one submission or raise OverloadedError(retry_after).

        Shedding order is priority-aware on BOTH axes: batch arrivals
        cannot spend the last ``interactive_reserve`` fraction of the
        bucket, and they shed at ``(1 - reserve) * max_backlog`` while
        interactive arrivals ride to the full bound."""
        interactive = priority == "interactive"
        with self._lock:
            now = clock.now()
            self._refill(now)
            if self.max_backlog > 0:
                limit = self.max_backlog if interactive else int(
                    self.max_backlog * (1.0 - self.interactive_reserve))
                if self._backlog >= max(limit, 1):
                    retry = self.backlog_retry_s
                    self._note_shed("backlog", priority, retry)
                    raise OverloadedError(
                        f"intake backlog {self._backlog} >= {limit} for "
                        f"{priority}; retry in {retry:.3f}s",
                        retry_after=retry, reason="backlog")
            floor = 0.0 if interactive \
                else self.burst * self.interactive_reserve
            if self._tokens - cost < floor:
                need = floor + cost - self._tokens
                retry = max(need / self.rate, 1e-3)
                self._note_shed("rate", priority, retry)
                raise OverloadedError(
                    f"intake rate exhausted for {priority} "
                    f"(tokens={self._tokens:.2f}, floor={floor:.2f}); "
                    f"retry in {retry:.3f}s",
                    retry_after=retry, reason="rate")
            self._tokens -= cost
            self.counters["admitted"] += 1
            self.counters[f"admitted_{priority}"] = \
                self.counters.get(f"admitted_{priority}", 0) + 1
        try:
            self._ladder().note_admission_ok()
        except Exception:
            pass

    def _note_shed(self, reason: str, priority: str,
                   retry_after: float) -> None:
        self.counters["shed_total"] += 1
        self.counters[f"shed_{reason}"] += 1
        self.counters[f"shed_{priority}"] = \
            self.counters.get(f"shed_{priority}", 0) + 1
        self.counters["retry_after_s_sum"] += retry_after
        try:
            from volcano_tpu_torch.scheduler import metrics

            metrics.register_admission_shed(reason)
            metrics.observe_admission_retry_after(retry_after)
        except Exception:
            pass
        try:
            self._ladder().note_admission_shed()
        except Exception:
            pass

    # -- stats --------------------------------------------------------------

    def stats(self) -> Dict[str, float]:
        with self._lock:
            out = dict(self.counters)
            out["tokens"] = round(self._tokens, 3)
            out["backlog"] = self._backlog
            out["rate_per_s"] = self.rate
            out["burst"] = self.burst
            out["max_backlog"] = self.max_backlog
            attempts = out["admitted"] + out["shed_total"]
            out["attempts"] = attempts
            out["shed_fraction"] = round(
                out["shed_total"] / attempts, 4) if attempts else 0.0
            return out


def install_intake(store: Store, gate: IntakeGate,
                   kinds=("Job",)) -> IntakeGate:
    """Register the gate as admission middleware. It runs BEHIND the
    functional validators (admission/admission.py registers first), so a
    malformed submission is rejected 422 without consuming intake budget
    — only well-formed load competes for tokens."""
    for kind in kinds:
        if kind == "Job":
            store.register_admission(
                kind, validator=lambda job: gate.admit(classify_job(job)))
        else:
            store.register_admission(
                kind, validator=lambda obj: gate.admit("batch"))
    return gate
