"""Express lane — watch-triggered queue, eligibility envelope, and the
sub-10 ms run-once path.

Arrivals are event-driven: the SchedulerCache's pod/podgroup handlers
notify the lane (cache.set_arrival_listener) as they mirror the watch
stream, the lane enqueues the owning job and sets its wake event, and the
scheduler loop (or the simulator's express slice, or bench --express)
services the queue between full sessions. The fast path is:

    drain -> classify (cache lock) -> refresh live axis (dirty rows only)
    -> one device dispatch (place.solve_express) -> optimistic commit
    through the real cache effectors -> reconciliation token

Eligibility envelope (everything else falls through to the next full
session, counted per reason — the honesty contract tested by
tests/test_express.py):

- the session conf's plugins are all express-modeled (no binpack, no
  custom plugins) — checked once at attach;
- the PodGroup exists, is admitted (Inqueue/Running), its queue exists;
- small jobs only: <= EXPRESS_MAX_TASKS tasks, min_available <=
  EXPRESS_MAX_GANG (non-gang or tiny gang);
- cpu+mem requests only (no scalar resources), non-empty (BestEffort
  stays with backfill), pods are <plain> (no selectors/affinity/
  tolerations), no host ports, no pod affinity, no PVC volumes;
- jobs the reconciler ever reverted are denylisted — the full session
  owns them from then on (no optimistic-revert livelock).

Express has NO preemption rights and no deserved-share model: it places
onto genuinely idle capacity or not at all, and the next full session is
the fairness/preemption authority (express/reconcile.py).

The lane runs on the card (``device`` cuda, ``dtype`` float32) unless it
is built with ``device="cpu"``; the placement kernel is K14
(express/place.py), and a build or launch failure inside a batch defers
the batch, counted in ``counters["errors"]`` and fed to the breaker.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from volcano_tpu_torch.api import objects
from volcano_tpu_torch.api.pod_traits import pod_encode_traits
from volcano_tpu_torch.api.types import TaskStatus
from volcano_tpu_torch.express.encode import ExpressState
from volcano_tpu_torch.scheduler import metrics

logger = logging.getLogger(__name__)

EXPRESS_MAX_TASKS = 8
EXPRESS_MAX_GANG = 4

# plugins whose allocate-time semantics the express scorer + reconciler
# model; any other name in the conf disables the lane wholesale (same
# honesty gate as solver.ROUNDS_SAFE_PLUGINS)
EXPRESS_SAFE_PLUGINS = frozenset({
    "tpuscore", "priority", "gang", "drf", "predicates", "proportion",
    "nodeorder",
})

_ADMITTED = (objects.PodGroupPhase.INQUEUE, objects.PodGroupPhase.RUNNING)


@dataclass
class ExpressToken:
    """One optimistic commit awaiting full-session reconciliation."""

    job_uid: str
    binds: Dict[str, Tuple[str, str]]  # task uid -> (task key, node name)
    seq: int                           # lane.session_seq at commit time
    stamp: float = 0.0
    # lane.commit_epoch at commit time: the continuous pipeline's
    # speculative solve-ahead seals this epoch at dispatch — a token
    # minted after the seal proves an express commit landed on state the
    # in-flight solve already read, so the SPECULATIVE session is
    # discarded and the token reconciles against the session that
    # actually commits (pipeline/driver.py fingerprint)
    epoch: int = 0


@dataclass
class ExpressReport:
    queued: int = 0
    placed: int = 0
    deferred: int = 0
    batches: int = 0
    full_sweep_steps: int = 0
    ms: float = 0.0
    reasons: Dict[str, int] = field(default_factory=dict)
    profile: Dict[str, object] = field(default_factory=dict)

    def as_dict(self) -> Dict:
        return {"queued": self.queued, "placed": self.placed,
                "deferred": self.deferred, "batches": self.batches,
                "full_sweep_steps": self.full_sweep_steps,
                "ms": round(self.ms, 3),
                "reasons": dict(sorted(self.reasons.items())),
                "profile": self.profile}


class ExpressLane:
    """The event-driven express lane for one SchedulerCache."""

    def __init__(self, cache, max_tasks: int = EXPRESS_MAX_TASKS,
                 max_gang: int = EXPRESS_MAX_GANG, device=None, dtype=None):
        from volcano_tpu_torch import device as devmod

        self.device = devmod.resolve_device(device)
        self.dtype = devmod.resolve_dtype(dtype, self.device)
        self.cache = None
        self.max_tasks = max_tasks
        self.max_gang = max_gang
        self.enabled = True
        self._qlock = threading.Lock()
        self._queue: deque = deque()
        self._queued: set = set()
        self.wake = threading.Event()
        self.outstanding: Dict[str, ExpressToken] = {}
        self.denylist: set = set()
        # failover hygiene + degradation: a parked lane defers every
        # arrival to full sessions (lease loss parks it; re-acquire/
        # promote unparks), and the error breaker auto-parks after
        # repeated batch failures, recovering via its half-open probe
        # (the express_disabled rung, scheduler/degrade.py)
        self._park_reason: Optional[str] = None
        from volcano_tpu_torch.scheduler.degrade import CircuitBreaker

        self.breaker = CircuitBreaker("express-lane", threshold=3,
                                      cooldown_s=30.0)
        # (job_uid, task_key, node_name) triples from the most recent
        # reconcile's reverts — the auditor's zero-residue probe
        self.last_reverts: List[Tuple[str, str, str]] = []
        self.session_seq = 0
        # monotone commit counter (one bump per committed batch): the
        # pipeline fingerprint's express component — cheaper to compare
        # than the outstanding-token dict, and it moves even for tokens
        # that resolve terminally before the check
        self.commit_epoch = 0
        self.counters = {"arrivals": 0, "placed": 0, "deferred": 0,
                         "reconciled": 0, "reverted": 0, "terminal": 0,
                         "batches": 0, "errors": 0}
        self.latencies_ms: List[float] = []
        self.state: Optional[ExpressState] = None
        if cache is not None:
            self.attach(cache)

    # -- wiring ------------------------------------------------------------

    def attach(self, cache=None) -> None:
        """Bind to (or re-bind after a restart to) a SchedulerCache:
        install the arrival listener, register the keeper shadow, and
        expose the lane for the session-time reconciler. Outstanding
        tokens and counters survive a re-attach (crash recovery: the
        binds are durable in the store; the next session still owes them
        a verdict)."""
        old_stats = None
        if cache is not None:
            if self.state is not None:
                old_stats = dict(self.state.stats)
                try:
                    self.state.detach()
                except Exception:  # pragma: no cover - old cache torn down
                    pass
            self.cache = cache
            self.state = None
        cache = self.cache
        cache.express_lane = self
        cache.set_arrival_listener(self.note_arrival)
        if self.state is None:
            self.state = ExpressState(cache, self.device, self.dtype)
            if old_stats:
                # cumulative across crash-recovery re-attaches: the lane
                # is one continuous series even when the cache is not
                for k, v in old_stats.items():
                    self.state.stats[k] += v

    def park(self, reason: str = "parked") -> None:
        """Suspend the fast path (arrivals defer to full sessions) without
        losing state: outstanding tokens still owe the next session a
        verdict, the queue keeps accumulating, and the device buffers stay
        warm for unpark. Called on lease loss — a deposed leader must not
        keep optimistically binding — and by the error breaker."""
        self._park_reason = reason

    def unpark(self) -> None:
        self._park_reason = None
        if self.has_pending():
            self.wake.set()

    @property
    def parked(self) -> bool:
        return self._park_reason is not None

    def set_tiers(self, tiers) -> None:
        """Gate the lane on the session conf: any plugin outside the
        express-modeled set disables the fast path entirely (arrivals then
        fall through to full sessions, counted)."""
        names = {p.name for tier in tiers for p in tier.plugins}
        unknown = sorted(names - EXPRESS_SAFE_PLUGINS)
        self.enabled = not unknown
        if unknown:
            logger.info("express lane disabled: unmodeled plugins %s",
                        unknown)

    # -- arrivals (called under the cache lock — enqueue only) -------------

    def note_arrival(self, job_uid: str) -> None:
        if not job_uid:
            return
        with self._qlock:
            self.counters["arrivals"] += 1
            if job_uid not in self._queued:
                self._queued.add(job_uid)
                self._queue.append(job_uid)
        self.wake.set()

    def _count(self, key: str, n: int) -> None:
        """Counter bumps under _qlock: note_arrival increments
        ``counters`` from the watch-handler thread, the lane thread from
        run_once — an unlocked read-modify-write here would race it
        (VT008's inferred lock/field map; the witness shim asserts the
        same map at runtime)."""
        with self._qlock:
            self.counters[key] += n

    def has_pending(self) -> bool:
        return bool(self._queue)

    def _drain(self) -> List[str]:
        with self._qlock:
            uids = list(self._queue)
            self._queue.clear()
            self._queued.clear()
            self.wake.clear()
        return uids

    # -- eligibility -------------------------------------------------------

    def _classify(self, job) -> Tuple[Optional[list], str]:
        """(pending tasks to place, "") when express-eligible, else
        (None, reason). Caller holds the cache lock."""
        if job is None:
            return None, "gone"
        if job.uid in self.denylist:
            return None, "denylisted"
        if job.uid in self.outstanding:
            return None, "outstanding"
        pg = job.pod_group
        if pg is None:
            return None, "no_podgroup"
        if pg.status.phase not in _ADMITTED:
            return None, "not_admitted"
        if job.queue not in self.cache.queues:
            return None, "no_queue"
        pending = job.task_status_index.get(TaskStatus.PENDING)
        if not pending:
            return None, "no_pending"
        if len(job.tasks) > self.max_tasks:
            return None, "too_many_tasks"
        if job.min_available > self.max_gang:
            return None, "gang_too_big"
        if len(job.tasks) < job.min_available:
            return None, "incomplete"  # more pods still materializing
        tasks = []
        for uid in sorted(pending):
            t = pending[uid]
            if t.node_name:
                return None, "pending_bound"
            if t.resreq.is_empty():
                return None, "best_effort"
            if t.resreq.scalar_resources or t.init_resreq.scalar_resources:
                return None, "scalar_resources"
            pod = t.pod
            if pod is None:
                return None, "no_pod"
            sig, ports, aff = pod_encode_traits(pod)
            if sig != "<plain>" or ports or aff:
                return None, "constraints"
            if any(v.persistent_volume_claim for v in pod.spec.volumes):
                return None, "volumes"
            tasks.append(t)
        # serial task order within the job: priority desc, creation, uid
        tasks.sort(key=lambda t: (
            -t.priority,
            t.pod.metadata.creation_timestamp if t.pod else 0, t.uid))
        return tasks, ""

    # -- the fast path -----------------------------------------------------

    def run_once(self) -> Dict:
        """Service the arrival queue once: classify, place, commit.
        Returns the report dict (always; zero-queued calls are cheap)."""
        t0 = time.perf_counter()
        rep = ExpressReport()
        uids = self._drain()
        rep.queued = len(uids)
        if not uids:
            return rep.as_dict()
        reason = None
        if self._park_reason is not None:
            reason = f"parked:{self._park_reason}"
        elif not self.enabled:
            reason = "lane_disabled"
        elif not self.breaker.allow():
            reason = "circuit_open"
        if reason is not None:
            rep.deferred = len(uids)
            rep.reasons[reason] = len(uids)
            self._count("deferred", len(uids))
            metrics.register_express_deferred(len(uids))
            return rep.as_dict()
        try:
            self._run_batch(uids, rep)
        except Exception:
            # any device/encode failure defers the whole batch to the next
            # full session — express is an accelerator, never a gate; the
            # breaker turns PERSISTENT failure into an auto-park
            # (express_disabled rung) instead of a doomed dispatch per wake
            logger.exception("express batch failed; deferring to session")
            self._count("errors", 1)
            self.breaker.record_failure()
            rep.deferred += rep.queued - rep.placed - rep.deferred
            rep.reasons["error"] = rep.reasons.get("error", 0) + 1
        else:
            if rep.batches:
                self.breaker.record_success()
        rep.ms = (time.perf_counter() - t0) * 1e3
        self.latencies_ms.append(rep.ms)
        metrics.observe_express_latency(rep.ms / 1e3)
        return rep.as_dict()

    def _run_batch(self, uids: List[str], rep: ExpressReport) -> None:
        from volcano_tpu_torch.express import place as place_mod
        from volcano_tpu_torch.express.commit import commit_batch
        from volcano_tpu_torch.utils import devprof

        cache = self.cache
        with cache._lock:
            jobs: List[Tuple[object, list]] = []
            budget = place_mod.EXPRESS_MAX_BATCH
            total = 0
            for uid in uids:
                job = cache.jobs.get(uid)
                tasks, reason = self._classify(job)
                if tasks is None:
                    rep.deferred += 1
                    rep.reasons[reason] = rep.reasons.get(reason, 0) + 1
                    continue
                if total + len(tasks) > budget:
                    # re-enqueue past the batch budget; the next wake
                    # services them (bounded latency beats one huge batch)
                    self.note_arrival(uid)
                    continue
                jobs.append((job, tasks))
                total += len(tasks)
            rows = self.state.refresh() if jobs else []
        if not jobs:
            self._count("deferred", rep.deferred)
            if rep.deferred:
                metrics.register_express_deferred(rep.deferred)
            return

        # serial job order across the batch: priority desc, uid tie-break
        # (creation order — uids are ns/name and submissions are named
        # monotonically; the full session's tie rank agrees)
        jobs.sort(key=lambda jt: (-jt[0].priority, jt[0].uid))

        with devprof.session(rep.profile):
            dev = self.state.stage(rows)
            assign, fulls = self._dispatch(place_mod, dev, jobs)
        rep.full_sweep_steps = fulls
        node_names = self.state.axis.names
        placed, deferred = commit_batch(cache, self, jobs, assign,
                                        node_names)
        rep.placed = placed
        rep.deferred += deferred
        rep.batches = 1
        with self._qlock:
            self.counters["placed"] += placed
            self.counters["deferred"] += rep.deferred
            self.counters["batches"] += 1
        if placed:
            metrics.register_express_placements(placed)
        if rep.deferred:
            metrics.register_express_deferred(rep.deferred)

    def _dispatch(self, place_mod, dev, jobs) -> Tuple[np.ndarray, int]:
        """Encode the batch arrays, run the kernel, fetch the packed
        result. Buckets come off the solver ladder so repeat arrivals of
        any size up to the bucket reuse one compiled program."""
        import torch

        from volcano_tpu_torch.ops.solver import _bucket
        from volcano_tpu_torch.scheduler.plugins import nodeorder as nodeorder_mod
        from volcano_tpu_torch.utils import devprof

        n_tasks = sum(len(ts) for _, ts in jobs)
        tb = _bucket(max(n_tasks, 1))
        jb = _bucket(max(len(jobs), 1))
        task_req = np.zeros((tb, 2))
        task_initreq = np.zeros((tb, 2))
        task_valid = np.zeros(tb, bool)
        task_job = np.zeros(tb, np.int32)
        task_has_pod = np.ones(tb, bool)
        job_need = np.full(jb, np.iinfo(np.int32).max, np.int32)
        ti = 0
        for ji, (job, tasks) in enumerate(jobs):
            job_need[ji] = len(tasks)  # all-or-nothing per job
            for t in tasks:
                task_req[ti] = (t.resreq.milli_cpu, t.resreq.memory)
                task_initreq[ti] = (t.init_resreq.milli_cpu,
                                    t.init_resreq.memory)
                task_valid[ti] = True
                task_job[ti] = ji
                ti += 1
        nzc = np.where(task_req[:, 0] != 0, task_req[:, 0],
                       nodeorder_mod.DEFAULT_MILLI_CPU_REQUEST)
        nzm = np.where(task_req[:, 1] != 0, task_req[:, 1],
                       nodeorder_mod.DEFAULT_MEMORY_REQUEST)
        weights = np.array([1.0, 1.0])  # default-conf nodeorder weights
        spec = place_mod.ExpressSpec(
            tb=tb, jb=jb,
            window_k=place_mod.window_for(self.state.n, tb))
        # the batch arrays on the lane's device, floats in its dtype
        batch = [torch.from_numpy(a).to(self.dtype)
                 if a.dtype.kind == "f" else torch.from_numpy(a)
                 for a in (task_initreq, task_req, nzc, nzm, task_valid,
                           task_job, task_has_pod, job_need, weights)]
        batch = [t.to(self.device) for t in batch]
        wait = devprof.start_fetch(place_mod.solve_express(
            spec, dev["idle"], dev["alloc"], dev["cnt"], dev["ok"],
            dev["maxt"], *batch))
        out = wait()
        return np.asarray(out[:tb]), int(out[tb])

    # -- summaries ---------------------------------------------------------

    def latency_percentiles(self) -> Dict[str, float]:
        lat = sorted(self.latencies_ms)
        if not lat:
            return {"p50": 0.0, "p99": 0.0, "max": 0.0}

        def pick(q):
            return round(lat[min(int(q * len(lat)), len(lat) - 1)], 3)

        return {"p50": pick(0.5), "p99": pick(0.99),
                "max": round(lat[-1], 3)}

    def summary(self) -> Dict:
        return {"counters": dict(self.counters),
                "latency_ms": self.latency_percentiles(),
                "state": dict(self.state.stats) if self.state else {},
                "outstanding": len(self.outstanding),
                "parked": self._park_reason or "",
                "breaker": self.breaker.state}
