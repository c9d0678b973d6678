"""Scheduler metrics under namespace ``volcano``
(volcano pkg/scheduler/metrics/metrics.go:37-121).

Self-contained histogram/counter/gauge registry rendering the Prometheus text
exposition format, with the reference's exact series names:

- volcano_e2e_scheduling_latency_milliseconds (histogram, 5ms*2^k buckets)
- volcano_plugin_scheduling_latency_microseconds{plugin,OnSession}
- volcano_action_scheduling_latency_microseconds{action}
- volcano_task_scheduling_latency_microseconds
- volcano_schedule_attempts_total{result}
- volcano_pod_preemption_victims / volcano_total_preemption_attempts
- volcano_unschedule_task_count{job_id} / volcano_unschedule_job_count
- volcano_job_retry_counts{job_id}
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

_NAMESPACE = "volcano"


class Histogram:
    def __init__(self, name: str, help_: str, buckets: List[float], label_names=()):
        self.name = name
        self.help = help_
        self.buckets = sorted(buckets)
        self.label_names = tuple(label_names)
        self._data: Dict[Tuple[str, ...], Tuple[List[int], float, int]] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, labels: Tuple[str, ...] = ()) -> None:
        with self._lock:
            counts, total, n = self._data.get(labels, ([0] * len(self.buckets), 0.0, 0))
            counts = list(counts)
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            self._data[labels] = (counts, total + value, n + 1)

    def snapshot(self):
        with self._lock:
            return dict(self._data)


class Counter:
    def __init__(self, name: str, help_: str, label_names=()):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self._data: Dict[Tuple[str, ...], float] = {}
        self._lock = threading.Lock()

    def inc(self, labels: Tuple[str, ...] = (), value: float = 1.0) -> None:
        with self._lock:
            self._data[labels] = self._data.get(labels, 0.0) + value

    def get(self, labels: Tuple[str, ...] = ()) -> float:
        with self._lock:
            return self._data.get(labels, 0.0)


class Gauge:
    """A set-to-current-value metric (pending pods, queue depth): unlike a
    Counter it can move both ways, so scrapers read the instantaneous
    level instead of a monotone total."""

    def __init__(self, name: str, help_: str, label_names=()):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self._data: Dict[Tuple[str, ...], float] = {}
        self._lock = threading.Lock()

    def set(self, value: float, labels: Tuple[str, ...] = ()) -> None:
        with self._lock:
            self._data[labels] = float(value)

    def inc(self, labels: Tuple[str, ...] = (), value: float = 1.0) -> None:
        with self._lock:
            self._data[labels] = self._data.get(labels, 0.0) + value

    def get(self, labels: Tuple[str, ...] = ()) -> float:
        with self._lock:
            return self._data.get(labels, 0.0)


class Registry:
    def __init__(self):
        ms = [0.005 * (2**k) for k in range(10)]  # 5ms..~5s, in seconds
        us = [5e-6 * (2**k) for k in range(12)]
        self.e2e_latency = Histogram(
            f"{_NAMESPACE}_e2e_scheduling_latency_milliseconds",
            "E2e scheduling latency in milliseconds", ms)
        self.plugin_latency = Histogram(
            f"{_NAMESPACE}_plugin_scheduling_latency_microseconds",
            "Plugin scheduling latency in microseconds", us, ("plugin", "OnSession"))
        self.action_latency = Histogram(
            f"{_NAMESPACE}_action_scheduling_latency_microseconds",
            "Action scheduling latency in microseconds", us, ("action",))
        self.task_latency = Histogram(
            f"{_NAMESPACE}_task_scheduling_latency_microseconds",
            "Task scheduling latency in microseconds", us)
        self.schedule_attempts = Counter(
            f"{_NAMESPACE}_schedule_attempts_total",
            "Num of attempts to schedule pods, by result", ("result",))
        self.preemption_victims = Counter(
            f"{_NAMESPACE}_pod_preemption_victims", "Number of preemption victims")
        self.preemption_attempts = Counter(
            f"{_NAMESPACE}_total_preemption_attempts", "Total preemption attempts")
        self.unschedule_task_count = Counter(
            f"{_NAMESPACE}_unschedule_task_count", "Unschedulable tasks per job", ("job_id",))
        self.unschedule_job_count = Counter(
            f"{_NAMESPACE}_unschedule_job_count", "Number of unschedulable jobs")
        self.job_retry_counts = Counter(
            f"{_NAMESPACE}_job_retry_counts", "Job retries", ("job_id",))
        # express lane (volcano_tpu_torch/express): optimistic placements
        # between sessions, the session-time reverts, and the fast-path
        # latency distribution (sub-10 ms is the design envelope, so the
        # buckets resolve single milliseconds)
        self.express_placements = Counter(
            f"{_NAMESPACE}_express_placements_total",
            "Tasks optimistically placed by the express lane")
        self.express_reverted = Counter(
            f"{_NAMESPACE}_express_reverted_total",
            "Express placements reverted by full-session reconciliation")
        self.express_deferred = Counter(
            f"{_NAMESPACE}_express_deferred_total",
            "Arrivals the express lane deferred to a full session")
        self.express_latency = Histogram(
            f"{_NAMESPACE}_express_latency_seconds",
            "Express run-once latency in seconds",
            [0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25])
        # HA failover (scheduler/ha.py + store fencing): leadership churn,
        # the fenced-write rejection total the failover auditor balances
        # against the store's own accounting, and the degradation-ladder
        # rung gauge (scheduler/degrade.py) — one labeled series per rung,
        # 1 while that rung is active
        self.leader_transitions = Counter(
            f"{_NAMESPACE}_leader_transitions_total",
            "Leadership acquisitions observed by this process")
        self.fenced_writes_rejected = Counter(
            f"{_NAMESPACE}_fenced_writes_rejected_total",
            "Writes rejected for carrying a stale lease epoch")
        self.degraded_mode = Gauge(
            f"{_NAMESPACE}_degraded_mode",
            "Degradation-ladder rung activity (1 = active)", ("rung",))
        # continuous pipeline (a later slice of the port): sustained throughput
        # (the headline the pipelined loop binds on), per-reason
        # speculation discards (an invalidated stage is NEVER applied —
        # the counter is the proof the discard path ran), and the host
        # wall overlapped with an in-flight speculative device solve
        self.pipeline_sessions_per_sec = Gauge(
            f"{_NAMESPACE}_pipeline_sessions_per_sec",
            "Sustained committed sessions per wall second through the "
            "pipelined loop")
        self.pipeline_spec_discards = Counter(
            f"{_NAMESPACE}_pipeline_spec_discards_total",
            "Speculative solve-ahead stages discarded before apply, "
            "by invalidation reason", ("reason",))
        self.pipeline_spec_commits = Counter(
            f"{_NAMESPACE}_pipeline_spec_commits_total",
            "Speculative solve-ahead stages committed, by kind: quiet "
            "(fingerprint unmoved) vs readset (state moved but every "
            "delta proven disjoint from the stage's read set)", ("kind",))
        self.pipeline_overlap = Histogram(
            f"{_NAMESPACE}_pipeline_overlap_seconds",
            "Host work overlapped with an in-flight speculative device "
            "solve, per committed cycle",
            [0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0])
        # device-path honesty fallbacks (ROADMAP item 4): every envelope
        # miss that dropped a session/action back to the serial oracle,
        # labeled by kind (fuse, evict_preempt, evict_reclaim,
        # evict_backfill). The sim auditor audits these as RATES against
        # per-scenario budgets, so an envelope regression fails the gate
        # exactly like a parity regression
        self.device_fallbacks = Counter(
            f"{_NAMESPACE}_device_fallbacks_total",
            "Device-path honesty fallbacks to the serial oracle, by kind",
            ("kind",))
        # front-door overload (store/flowcontrol.py + admission/intake.py):
        # per-class watch fan-out lag, delivery-side coalescing, and the
        # intake gate's shed/retry-after accounting — the meters the
        # front_door_storm auditor budgets ride on
        self.watch_queue_depth = Gauge(
            f"{_NAMESPACE}_watch_queue_depth",
            "Pending watch events behind the slowest observed cursor, "
            "per watcher class", ("watcher_class",))
        self.watch_events_coalesced = Counter(
            f"{_NAMESPACE}_watch_events_coalesced_total",
            "Watch events collapsed by delivery-side batch compaction")
        self.admission_shed = Counter(
            f"{_NAMESPACE}_admission_shed_total",
            "Submissions shed by the intake gate, by reason", ("reason",))
        self.admission_retry_after = Histogram(
            f"{_NAMESPACE}_admission_retry_after_seconds",
            "Retry-after hints handed to shed submissions, in seconds",
            [0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 5.0, 10.0])
        # instantaneous cluster levels (set each cycle; the sim harness and
        # the scheduler loop both publish through these)
        self.pending_pods = Gauge(
            f"{_NAMESPACE}_pending_pods", "Pods currently awaiting placement")
        self.queue_depth = Gauge(
            f"{_NAMESPACE}_queue_depth",
            "PodGroups currently pending or inqueue, per queue", ("queue",))
        self.sessions_run = Gauge(
            f"{_NAMESPACE}_sessions_run",
            "Scheduler sessions completed since process start")


_registry: Optional[Registry] = None
_registry_lock = threading.Lock()


def registry() -> Registry:
    # double-checked fast path: per-victim hot loops (preempt/reclaim)
    # call through here thousands of times per session, and the global
    # assignment below is atomic under the GIL
    global _registry
    r = _registry
    if r is not None:
        return r
    with _registry_lock:
        if _registry is None:
            _registry = Registry()
        return _registry


def reset() -> None:
    global _registry
    with _registry_lock:
        _registry = None


# -- recording helpers (metrics.go:123-191) ---------------------------------


def update_e2e_duration(seconds: float) -> None:
    registry().e2e_latency.observe(seconds)


def update_plugin_duration(plugin: str, on_session: str, seconds: float) -> None:
    registry().plugin_latency.observe(seconds, (plugin, on_session))


def update_action_duration(action: str, seconds: float) -> None:
    registry().action_latency.observe(seconds, (action,))


def update_task_schedule_duration(seconds: float) -> None:
    registry().task_latency.observe(seconds)


def register_schedule_attempts(result: str) -> None:
    registry().schedule_attempts.inc((result,))


def update_preemption_victims(n: int) -> None:
    registry().preemption_victims.inc(value=n)


def register_preemption_attempts(n: int = 1) -> None:
    registry().preemption_attempts.inc(value=n)


def update_unschedule_task_count(job_id: str, n: int) -> None:
    registry().unschedule_task_count.inc((job_id,), n)


def update_unschedule_job_count(n: int = 1) -> None:
    registry().unschedule_job_count.inc(value=n)


def register_job_retry(job_id: str) -> None:
    registry().job_retry_counts.inc((job_id,))


def set_pending_pods(n: int) -> None:
    registry().pending_pods.set(n)


def set_queue_depth(queue: str, n: int) -> None:
    registry().queue_depth.set(n, (queue,))


def set_sessions_run(n: int) -> None:
    registry().sessions_run.set(n)


def register_express_placements(n: int = 1) -> None:
    registry().express_placements.inc(value=n)


def register_express_reverted(n: int = 1) -> None:
    registry().express_reverted.inc(value=n)


def register_express_deferred(n: int = 1) -> None:
    registry().express_deferred.inc(value=n)


def observe_express_latency(seconds: float) -> None:
    registry().express_latency.observe(seconds)


def register_leader_transition(n: int = 1) -> None:
    registry().leader_transitions.inc(value=n)


def register_fenced_write(n: int = 1) -> None:
    registry().fenced_writes_rejected.inc(value=n)


def set_degraded_mode(rung: str, active: bool) -> None:
    registry().degraded_mode.set(1.0 if active else 0.0, (rung,))


def set_pipeline_sessions_per_sec(v: float) -> None:
    registry().pipeline_sessions_per_sec.set(v)


def register_fallback(kind: str, n: int = 1) -> None:
    registry().device_fallbacks.inc((kind,), n)


def register_pipeline_spec_discard(reason: str, n: int = 1) -> None:
    registry().pipeline_spec_discards.inc((reason,), n)


def register_pipeline_spec_commit(kind: str, n: int = 1) -> None:
    registry().pipeline_spec_commits.inc((kind,), n)


def observe_pipeline_overlap(seconds: float) -> None:
    registry().pipeline_overlap.observe(seconds)


def set_watch_queue_depth(watcher_class: str, n: int) -> None:
    registry().watch_queue_depth.set(n, (watcher_class,))


def register_watch_coalesced(n: int = 1) -> None:
    registry().watch_events_coalesced.inc(value=n)


def register_admission_shed(reason: str, n: int = 1) -> None:
    registry().admission_shed.inc((reason,), n)


def observe_admission_retry_after(seconds: float) -> None:
    registry().admission_retry_after.observe(seconds)


# -- exposition -------------------------------------------------------------


def render() -> str:
    """Prometheus text format for the /metrics endpoint analog."""
    r = registry()
    lines: List[str] = []
    for h in (r.e2e_latency, r.plugin_latency, r.action_latency,
              r.task_latency, r.express_latency, r.pipeline_overlap,
              r.admission_retry_after):
        lines.append(f"# HELP {h.name} {h.help}")
        lines.append(f"# TYPE {h.name} histogram")
        for labels, (counts, total, n) in h.snapshot().items():
            label_str = ",".join(f'{k}="{v}"' for k, v in zip(h.label_names, labels))
            for b, c in zip(h.buckets, counts):
                le = f'le="{b}"'
                full = ",".join(x for x in (label_str, le) if x)
                lines.append(f"{h.name}_bucket{{{full}}} {c}")
            # the +Inf bucket is mandatory in the exposition format (its
            # value == _count); scrapers compute quantiles from it
            inf = ",".join(x for x in (label_str, 'le="+Inf"') if x)
            lines.append(f"{h.name}_bucket{{{inf}}} {n}")
            suffix = f"{{{label_str}}}" if label_str else ""
            lines.append(f"{h.name}_sum{suffix} {total}")
            lines.append(f"{h.name}_count{suffix} {n}")
    for c in (
        r.schedule_attempts, r.preemption_victims, r.preemption_attempts,
        r.unschedule_task_count, r.unschedule_job_count, r.job_retry_counts,
        r.express_placements, r.express_reverted, r.express_deferred,
        r.leader_transitions, r.fenced_writes_rejected,
        r.pipeline_spec_discards, r.pipeline_spec_commits,
        r.watch_events_coalesced, r.admission_shed,
    ):
        lines.append(f"# HELP {c.name} {c.help}")
        lines.append(f"# TYPE {c.name} counter")
        with c._lock:
            for labels, v in c._data.items():
                label_str = ",".join(f'{k}="{v2}"' for k, v2 in zip(c.label_names, labels))
                suffix = f"{{{label_str}}}" if label_str else ""
                lines.append(f"{c.name}{suffix} {v}")
    for g in (r.pending_pods, r.queue_depth, r.sessions_run,
              r.degraded_mode, r.pipeline_sessions_per_sec,
              r.watch_queue_depth):
        lines.append(f"# HELP {g.name} {g.help}")
        lines.append(f"# TYPE {g.name} gauge")
        with g._lock:
            for labels, v in g._data.items():
                label_str = ",".join(f'{k}="{v2}"' for k, v2 in zip(g.label_names, labels))
                suffix = f"{{{label_str}}}" if label_str else ""
                lines.append(f"{g.name}{suffix} {v}")
    return "\n".join(lines) + "\n"
