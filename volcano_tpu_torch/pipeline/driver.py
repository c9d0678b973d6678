"""Continuous scheduling pipeline — double-buffered sessions with
speculative solve-ahead, on PyTorch and CUDA (port of
volcano_tpu/pipeline/driver.py).

The serial loop runs snapshot -> actions -> effectors -> close strictly
in sequence, so the device idles while the host closes a session and the
host idles while the device solves. This driver overlaps the phases of
CONSECUTIVE cycles instead, on one host thread (determinism — the only
concurrency is the device's own async execution):

    apply N   -> open N+1 (buffer swap, delta-open) -> dispatch N+1
              -> close N  (status writebacks, JobUpdater — overlapped
                           with N+1's device solve)
              -> [inter-cycle work: controllers, express, waits]
    cycle N+1 -> fingerprint check -> apply N+1 (speculation held)
                                   or discard + re-run (state moved)

Double buffer: the SnapshotKeeper's buffer pair (snapkeeper.py
enable_pair/swap) gives session N+1 its own clone set while session N's
close still reads its snapshot; every cache mark lands in both buffers'
dirty sets, so each buffer delta-maintains independently.

Speculation contract: cycle N+1's session is opened and its packed
rounds solve dispatched BEFORE cycle N's close (whose status writebacks
could, in principle, change state) and before any inter-cycle delta. A
delta fingerprint — the keeper's dirty epoch + generation, the lease
fence epoch, the summed cache-node accounting generation, and the
express lane's commit epoch — is sealed at dispatch and re-checked
before apply, ALONGSIDE a read-set descriptor of what the sealed solve
actually consumed: the encoded job uids (plus staged-enqueue flip jobs),
the queue/namespace policy rows, and — on the device side — the kernel's
touched-node mask carried in the packed result tail (rounds.py). On
movement the keeper's typed mark journal (snapkeeper.marks_since) plus a
belt-and-braces version sweep (cache.readset_delta) classify every delta
since the seal: deltas provably DISJOINT from the read set commit the
stage anyway (``pipeline_spec_commits_total{kind="readset"}``; an
unmoved fingerprint is ``kind="quiet"``), while an intersecting delta —
or anything disjointness cannot be proven for: generation/fence/
conf/replica-epoch movement, a trimmed or disarmed journal, unscoped
meta marks, membership growth (phantom rows the serial order would have
admitted this cycle) — discards the stage, counted per family as
``pipeline_spec_discard{reason="readset:*"}`` (or the coarse reason).
``VOLCANO_TPU_READSET=0`` restores whole-fingerprint invalidation.
A discarded stage is never fetched into session state and the cycle
re-runs non-speculatively on fresh state — which is exactly the serial
order, so the serial loop (``VOLCANO_TPU_PIPELINE=0``) stays the
byte-for-byte oracle whether speculation is on, off
(``VOLCANO_TPU_PIPELINE_SPEC=0``), held, or discarded. A read-set
commit linearizes the stage AT ITS SEAL POINT: the disjoint deltas that
arrived mid-solve are consumed by the NEXT cycle's snapshot, exactly as
if they had arrived one cycle later — legal because, being disjoint,
they could not have changed what this solve read or what it wrote.

Enqueue runs STAGED in a speculative session: the real EnqueueAction
executes, the Pending->Inqueue flips (which land on the SHARED PodGroup
objects) are recorded and immediately reverted, and they re-apply only
at commit time — a discarded speculative session must leave zero
observable state. A staged flip whose job already has pending tasks
would change what the solve encodes (the serial order admits it before
allocate), so that cycle declines to speculate (``enqueue_active``)
instead of risking parity. Under delayed pod creation (the production
admission gate) this never triggers in steady state.

Envelope: the pipelined fast path covers action chains of the shape
``[enqueue,] allocate[, backfill]`` whose allocate runs the packed rounds
solve (solver._prepare/parse_packed/apply_packed are the stage
boundaries). Anything else — preempt/reclaim chains (the fused
session dispatch owns those), serial-fallback sessions, custom plugins —
runs through the ordinary ``framework.run_actions`` per cycle, unpipelined
but correct (``fallback_cycles``). Repeated pipelined-cycle ERRORS open
the degrade ladder's ``pipeline_disabled`` breaker and the scheduler loop
reverts to serial run_once until the half-open probe passes.

Trims from the reference, each deliberate:

- the mesh item of the fingerprint (and the ``mesh`` discard reason):
  the port runs on one device;
- the serial fallback on a dispatch or fetch error (the reference logs,
  notes a kernel failure and re-runs the allocate action's ladder): in
  the port a build, launch or solve failure raises, the crashed cycle
  abandons its stage and feeds the ladder's pipeline breaker.

In the port the rounds solve is a host-driven loop (K7 is still to move
onto the card), so a speculative dispatch returns only once its solve
has run; the decisions are the same, only the overlap is lost. A
committed stage reports it: ``dispatch_ms`` (host time the dispatch
held), ``stage_device_ms`` (device time from the dispatch's start to the
result's copy, by CUDA events) and ``device_overlap_ms``, the part of the
stage's device work still running when the dispatch returned (what the
solve-ahead hides behind the close and the inter-cycle window), beside
``fetch_wait_ms``, the time the commit blocked on the fetch. The
solver's profile carries the session's device counters as the serial
path's does (devprof ``tpu_sync_points``, ``tpu_fence_wait_ms``, and
``tpu_overlap_ms``, the host time between the fetch's start and its
wait), the speculative prepare and dispatch included.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

import torch

from volcano_tpu_torch.api import objects
from volcano_tpu_torch.api.types import TaskStatus
from volcano_tpu_torch.scheduler import metrics
from volcano_tpu_torch.utils import devprof
from volcano_tpu_torch.scheduler.framework import (
    close_session,
    get_action,
    open_session,
    run_actions,
    takeover_recovery_sweep,
)

logger = logging.getLogger(__name__)

# the pipelined chain grammar: allocate, optionally preceded by enqueue
# and followed by backfill — the packed rounds solve is the single device
# stage whose dispatch can run ahead of the previous cycle's close
_CHAIN = ("enqueue", "allocate", "backfill")


def pipeline_enabled() -> bool:
    """VOLCANO_TPU_PIPELINE=0 forces the serial loop (the oracle)."""
    return os.environ.get("VOLCANO_TPU_PIPELINE", "1") != "0"


def speculation_enabled() -> bool:
    """VOLCANO_TPU_PIPELINE_SPEC=0 keeps the pipelined loop but never
    dispatches ahead (double-buffer-only mode)."""
    return os.environ.get("VOLCANO_TPU_PIPELINE_SPEC", "1") != "0"


def readset_enabled() -> bool:
    """VOLCANO_TPU_READSET=0 restores whole-fingerprint invalidation:
    any movement discards the stage, read set unconsulted."""
    return os.environ.get("VOLCANO_TPU_READSET", "1") != "0"


class _InFlight:
    """One speculative solve-ahead: the early-opened session, its
    prepared packed dispatch, the sealed fingerprint + read set, and the
    staged enqueue flips that re-apply only at commit."""

    __slots__ = ("ssn", "names", "prep", "dev", "wait", "fingerprint",
                 "flips", "tiers", "t_dispatch", "readset", "out",
                 "read_nodes", "commit_kind", "audit", "dispatch_s",
                 "events", "fetch_wait_s", "counters")

    def __init__(self, ssn, names, prep, dev, wait, fingerprint, flips,
                 tiers, t_dispatch, readset=None, dispatch_s=0.0,
                 events=None, counters=None):
        self.ssn = ssn
        self.names = names
        self.prep = prep
        self.dev = dev
        self.wait = wait
        self.fingerprint = fingerprint
        self.flips = flips
        self.tiers = tiers
        self.t_dispatch = t_dispatch
        # sealed read-set descriptor (None => whole-fingerprint scope)
        self.readset = readset
        self.out = None          # memoized fetch: the check may need the
        #                          packed result (touched-node mask) before
        #                          the commit consumes it — fetch ONCE
        self.read_nodes = None   # resolved node-name read set, lazy
        self.commit_kind = "quiet"
        self.audit = None        # disjointness witness for the sim auditor
        self.dispatch_s = dispatch_s  # host time the dispatch held
        self.events = events     # CUDA events around the stage, or None
        self.fetch_wait_s = 0.0
        # devprof counters of the speculative prepare and dispatch, added
        # to the committing session's
        self.counters = counters or {}

    def fetch(self) -> np.ndarray:
        """The stage's single fetch point: both the read-set check (mask
        classification) and the commit's parse consume this; whichever
        runs first pays the sync, the other reuses the array."""
        if self.out is None:
            t0 = time.perf_counter()
            self.out = self.wait()
            self.fetch_wait_s = time.perf_counter() - t0
        return self.out

    def device_times(self) -> Tuple[Optional[float], Optional[float]]:
        """(device ms of the stage, the part of it still running after the
        dispatch returned), from the CUDA events; (None, None) on the CPU.
        Call after the fetch."""
        if self.events is None:
            return None, None
        start, end = self.events
        device_ms = start.elapsed_time(end)
        return device_ms, max(0.0, device_ms - self.dispatch_s * 1e3)


class PipelineDriver:
    """The pipelined cycle driver for one SchedulerCache.

    ``policy_fn`` returns the cycle's (actions, tiers); the TIERS OBJECT
    IDENTITY is part of the speculation fingerprint, so callers must hand
    back the same object while the conf is unchanged (Scheduler caches
    its parse on the conf text; the sim's conf is fixed).
    """

    # rolling window for the sustained sessions/sec gauge
    _RATE_WINDOW = 32

    def __init__(self, cache, policy_fn: Callable[[], Tuple[list, list]],
                 degrade=None, spec: Optional[bool] = None,
                 intake: Optional[Callable[[], None]] = None):
        self.cache = cache
        self.policy_fn = policy_fn
        # None => the process-default ladder, resolved LAZILY per use:
        # degrade.reset() (sim runs, tests) swaps the default instance,
        # and a driver built before the reset must not gate on the stale
        # one
        self._degrade = degrade
        self.spec = speculation_enabled() if spec is None else spec
        # intake: drained AFTER the cycle commits and BEFORE the next
        # cycle's snapshot seals — the watch-ingest quantization point.
        # A driver (bench --pipeline, an embedder pumping a delta queue)
        # that funnels arrivals through it makes them visible to the very
        # next speculative snapshot instead of invalidating it mid-flight;
        # deltas that bypass it (live watch events, express commits) are
        # still caught by the fingerprint and discard the stage.
        self.intake = intake
        cache.enable_pipeline()
        self._inflight: Optional[_InFlight] = None
        self._cycle_walls: List[float] = []
        # disjointness witnesses for read-set commits (sim auditor): each
        # entry pairs the delta rows that moved since the seal with the
        # rows the sealed solve read — the auditor re-proves every
        # intersection is empty. Bounded ring; the total lives in stats.
        self.readset_audit: List[Dict] = []
        self.readset_audit_total = 0  # monotonic: survives ring trims
        self._AUDIT_CAP = 256
        self.stats: Dict[str, object] = {
            "cycles": 0, "committed": 0, "fallback_cycles": 0,
            "spec_dispatched": 0, "spec_applied": 0, "spec_discarded": 0,
            "spec_reruns": 0, "stale_commits": 0,
            "spec_discards": {}, "spec_skips": {},
            "spec_commits": {}, "readset_audits": 0,
        }

    @property
    def degrade(self):
        if self._degrade is not None:
            return self._degrade
        from volcano_tpu_torch.scheduler import degrade as degrade_mod

        return degrade_mod.default_ladder()

    # -- fingerprint ---------------------------------------------------------

    def _fingerprint(self, tiers) -> tuple:
        lane = getattr(self.cache, "express_lane", None)
        return (self.cache.pipeline_fingerprint(),
                lane.commit_epoch if lane is not None else -1,
                id(tiers))

    def _check(self, st: _InFlight, tiers) -> Tuple[bool, str]:
        now = self._fingerprint(tiers)
        old = st.fingerprint
        if now == old:
            st.commit_kind = "quiet"
            return True, ""
        # attribute the discard to the first component that moved — the
        # metric label operators alert on
        (o_cache, o_epoch, o_tiers) = old
        (n_cache, n_epoch, n_tiers) = now
        if o_tiers != n_tiers:
            return False, "conf_changed"
        if st.readset is None:
            # whole-fingerprint scope (VOLCANO_TPU_READSET=0 or the seal
            # degraded at dispatch): ANY movement discards
            if o_epoch != n_epoch:
                return False, "express_commit"
            if o_cache[2] != n_cache[2]:
                return False, "fence_epoch"
            if o_cache[1] != n_cache[1]:
                return False, "generation"
            if o_cache[0] != n_cache[0]:
                return False, "watch_delta"
            if o_cache[5:7] != n_cache[5:7]:
                # job-side belt-and-braces (VT009): an unmarked job
                # mutation moved the status-version sum without touching
                # dirty epoch
                return False, "job_version"
            return False, "acct_gen"
        # read-set scope: coarse channels no journal entry can scope —
        # lease fences, full invalidations, replica-buffer supersession —
        # stay whole-snapshot conservative
        if o_cache[2] != n_cache[2]:
            return False, "fence_epoch"
        if o_cache[1] != n_cache[1]:
            return False, "generation"
        if o_cache[7] != n_cache[7]:
            return False, "readset:replica"
        return self._readset_check(st, o_epoch, n_epoch)

    def _readset_check(self, st: _InFlight, o_epoch: int,
                       n_epoch: int) -> Tuple[bool, str]:
        """Classify every delta since the seal against the stage's read
        set. Commit (kind="readset") only when EVERY delta is provably
        disjoint; the first unprovable or intersecting delta names the
        discard family. Consumes the keeper journal via the seal cursor
        (cache.readset_delta) — non-destructively, so the apply-time
        re-probe reaches the same verdict."""
        rs = st.readset
        delta = self.cache.readset_delta(rs["seal"])
        if delta is None:
            # journal disarmed / trimmed past the cursor / marks
            # unaccounted: disjointness unprovable
            return False, "readset:journal"
        # express epoch movement: each post-seal optimistic commit must
        # be an outstanding token (the lane was EMPTY at seal — the
        # speculation gate) whose bind rows we can test like any other
        # delta; its job uid is NEW by construction, exempt from the
        # phantom rule, and its reconcile defers past this commit
        # (_preamble passes the sealed epoch to reconcile_session)
        express_jobs = set()
        if n_epoch != o_epoch:
            lane = getattr(self.cache, "express_lane", None)
            toks = list(lane.outstanding.values()) if lane is not None \
                else []
            if n_epoch - o_epoch != len(toks) or not toks:
                return False, "express_commit"
            for tok in toks:
                if not getattr(tok, "binds", None):
                    # a token with no recorded bind rows cannot be
                    # scoped — degrade to the coarse express discard
                    return False, "express_commit"
                express_jobs.add(tok.job_uid)
        read_jobs = rs["read_jobs"]
        sealed_jobs = rs["seal"]["jobs"]
        moved_jobs = set(delta["changed_jobs"])
        moved_nodes = set(delta["changed_nodes"])
        moved_metas = []
        for entry in delta["marks"]:
            kind = entry[0]
            if kind == "job":
                moved_jobs.add(entry[1])
            elif kind == "node":
                moved_nodes.add(entry[1])
            elif kind == "meta":
                moved_metas.append(entry)
            else:
                # ("gen",) or an unknown mark kind: a full invalidation
                # should have been caught by the generation gate — treat
                # any surprise as unprovable
                return False, "readset:journal"
        for uid in sorted(moved_jobs):
            if uid in read_jobs:
                return False, "readset:job"
            if uid not in sealed_jobs and uid not in express_jobs:
                # membership growth: a job the serial order would have
                # admitted into THIS cycle's encode — committing over it
                # would reorder it behind work it may outrank
                return False, "readset:phantom"
        for entry in moved_metas:
            mkind = entry[1] if len(entry) > 1 else ""
            muid = entry[2] if len(entry) > 2 else ""
            if mkind == "queue":
                if not muid or muid in rs["read_queues"]:
                    return False, "readset:queue"
            elif mkind == "quota":
                if not muid or muid in rs["read_ns"]:
                    return False, "readset:ns"
            else:
                # unscoped policy movement: unprovable
                return False, "readset:meta"
        if moved_nodes:
            if rs["read_all_nodes"]:
                # residue/releasing apply or backfill-eligible work reads
                # the whole node axis serially — any node movement
                # intersects
                return False, "readset:node"
            read_nodes = self._read_node_set(st)
            if read_nodes is None:
                return False, "readset:fetch"
            sealed_axis = rs["sealed_axis"]
            for name in sorted(moved_nodes):
                if name in read_nodes:
                    return False, "readset:node"
                if name not in sealed_axis:
                    # capacity that was not in the sealed ready axis
                    # (new node, or one that just became ready): the
                    # serial order would have offered it to this cycle's
                    # solve — phantom, same as a new job
                    return False, "readset:phantom"
        st.commit_kind = "readset"
        st.audit = {
            "delta_jobs": sorted(moved_jobs),
            "delta_nodes": sorted(moved_nodes),
            "delta_metas": [tuple(e[1:]) for e in moved_metas],
            "read_jobs": sorted(read_jobs),
            "read_nodes": sorted(st.read_nodes)
            if st.read_nodes is not None else [],
            "read_queues": sorted(rs["read_queues"]),
            "read_ns": sorted(rs["read_ns"]),
        }
        return True, ""

    def _read_node_set(self, st: _InFlight):
        """The stage's node read set: the kernel's touched mask from the
        packed result tail, mapped back through the encode's node axis.
        Fetching here is the same sync the commit was about to pay — the
        array is memoized on the stage (st.fetch) and reused by the
        apply. None on fetch/parse failure (caller degrades)."""
        if st.read_nodes is not None:
            return st.read_nodes
        _assign, meta = st.ssn.batch_allocator.parse_packed(st.fetch())
        mask = meta["touched_nodes"]
        names = st.prep["enc"].node_names
        st.read_nodes = {names[i] for i in np.nonzero(mask)[0]
                         if i < len(names)}
        return st.read_nodes

    # -- cycle entry ---------------------------------------------------------

    def run_cycle(self) -> Dict:
        """One COMMITTED session per call (plus, usually, the next
        cycle's speculative dispatch left in flight). Returns the cycle
        info dict (mode, timings, speculation outcome)."""
        t_cycle = time.perf_counter()
        info: Dict[str, object] = {}
        st, self._inflight = self._inflight, None
        try:
            actions, tiers = self.policy_fn()
            names = [a if isinstance(a, str) else a.name() for a in actions]
            if st is not None:
                ok, reason = self._check(st, tiers)
                if ok:
                    pending, st = st, None
                    ssn = self._commit(pending, info)
                    if ssn is None:  # stale at apply: rerun
                        ssn = self._full_cycle(actions, names, tiers, info)
                else:
                    self._discard(st, reason)
                    st = None
                    self.stats["spec_reruns"] += 1
                    info["spec"] = f"discarded:{reason}"
                    ssn = self._full_cycle(actions, names, tiers, info)
            else:
                ssn = self._full_cycle(actions, names, tiers, info)
            self.stats["committed"] += 1
            if self.intake is not None:
                # quantized delta ingest: arrivals drained here are INSIDE
                # the next snapshot's seal instead of invalidating it
                self.intake()
            # solve-ahead for the NEXT cycle, dispatched before this
            # session's close so the device works through the close-side
            # host writebacks and the inter-cycle window
            self._speculate(actions, names, tiers, info)
            t0 = time.perf_counter()
            close_session(ssn)
            info["close_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
        except Exception:
            # a crashed pipelined cycle must not strand a half-dispatched
            # speculation — neither the stage detached at entry nor one
            # this cycle dispatched; the degrade ladder decides how many
            # crashes buy a fallback to the serial loop
            if st is not None:
                self._discard(st, "abandoned")
            self.abandon()
            self.degrade.note_pipeline_error()
            raise
        self.degrade.note_pipeline_ok()
        self.stats["cycles"] += 1
        wall = time.perf_counter() - t_cycle
        info["e2e_ms"] = round(wall * 1e3, 3)
        self._cycle_walls.append(wall)
        if len(self._cycle_walls) > self._RATE_WINDOW:
            del self._cycle_walls[0]
        total = sum(self._cycle_walls)
        if total > 0:
            metrics.set_pipeline_sessions_per_sec(
                round(len(self._cycle_walls) / total, 3))
        return info

    def abandon(self) -> None:
        """Drop any in-flight speculation without applying it (shutdown,
        leadership loss, crashed cycle). The discard counter stays honest
        — an abandoned stage was never applied either."""
        st, self._inflight = self._inflight, None
        if st is not None:
            self._discard(st, "abandoned")

    # -- the non-speculative (serial-order) cycle ---------------------------

    def _chain_ok(self, names: List[str]) -> bool:
        if "allocate" not in names:
            return False
        order = [n for n in _CHAIN if n in names]
        return list(names) == order

    def _preamble(self, ssn, reconcile_after: Optional[int] = None) -> None:
        """The run_actions head every COMMITTING session owes: express
        reconciliation (the session is the fairness authority for every
        outstanding optimistic bind) and the takeover recovery sweep.

        ``reconcile_after`` — a read-set commit's sealed express epoch:
        tokens minted AFTER the seal reference jobs this session's
        snapshot never saw, so they stay outstanding and reconcile next
        cycle (which runs serially — the pipeline refuses to speculate
        while tokens are outstanding)."""
        lane = getattr(self.cache, "express_lane", None)
        if lane is not None:
            from volcano_tpu_torch.express.reconcile import reconcile_session

            lane.set_tiers(ssn.tiers)
            reconcile_session(ssn, after_epoch=reconcile_after)
        if getattr(self.cache, "fence_sweep_due", False):
            self.cache.fence_sweep_due = False
            takeover_recovery_sweep(ssn)

    def _full_cycle(self, actions, names, tiers, info) -> object:
        """Open + run + (caller closes) one session in strict serial
        order — the re-run path after a discard, and every cycle whose
        chain is outside the pipelined envelope."""
        ssn = open_session(self.cache, tiers)
        if not self._chain_ok(names):
            self.stats["fallback_cycles"] += 1
            info["mode"] = "fallback"
            info["action_ms"] = run_actions(ssn, actions)
            return ssn
        self._preamble(ssn)
        action_ms: Dict[str, float] = {}
        t0 = time.perf_counter()
        if "enqueue" in names:
            get_action("enqueue").execute(ssn)
            action_ms["enqueue"] = round(
                (time.perf_counter() - t0) * 1e3, 3)
        solver = getattr(ssn, "batch_allocator", None)
        if solver is None:
            prep = None
        else:
            with devprof.session(solver.profile):
                prep = solver._prepare(ssn)
                t0 = time.perf_counter()
                if prep is not None and prep["mode"] == "rounds":
                    out = devprof.start_fetch(solver.dispatch(prep))()
                    solver.profile["h2d_s"] = prep["h2d_s"]
                    solver.profile["dispatch_s"] = time.perf_counter() - t0
                    self._apply(ssn, solver, prep, out)
        if prep is None or prep["mode"] != "rounds":
            # sub-threshold / fallback sessions: the allocate action owns
            # its own solver ladder (serial oracle included)
            info["mode"] = "per_action"
            for name in names:
                if name == "enqueue":
                    continue
                t1 = time.perf_counter()
                get_action(name).execute(ssn)
                action_ms[name] = round(
                    (time.perf_counter() - t1) * 1e3, 3)
            info["action_ms"] = action_ms
            return ssn
        action_ms["allocate"] = round((time.perf_counter() - t0) * 1e3, 3)
        if "backfill" in names:
            t1 = time.perf_counter()
            get_action("backfill").execute(ssn)
            action_ms["backfill"] = round(
                (time.perf_counter() - t1) * 1e3, 3)
        info.setdefault("mode", "pipelined")
        info["action_ms"] = action_ms
        return ssn

    @staticmethod
    def _apply(ssn, solver, prep, out) -> None:
        """Parse + bulk-apply one fetched packed rounds result, and the
        residue pass after it."""
        from volcano_tpu_torch.scheduler import degrade as degrade_mod
        from volcano_tpu_torch.scheduler.actions.allocate import finish_batched

        assign, meta = solver.parse_packed(out)
        degrade_mod.note_kernel_ok()
        solver.apply_packed(ssn, prep, np.asarray(assign), meta)
        finish_batched(ssn, solver)

    # -- speculation ---------------------------------------------------------

    def _skip(self, info, reason: str) -> None:
        skips = self.stats["spec_skips"]
        skips[reason] = skips.get(reason, 0) + 1
        info.setdefault("spec", f"skipped:{reason}")

    def _speculate(self, actions, names, tiers, info) -> None:
        """Open the NEXT cycle's session and dispatch its solve before
        the current one closes. Leaves self._inflight set on success;
        otherwise records why this cycle declined to solve ahead."""
        if not self.spec or self.degrade.force_serial():
            self._skip(info, "disabled")
            return
        if not self._chain_ok(names):
            self._skip(info, "chain_shape")
            return
        lane = getattr(self.cache, "express_lane", None)
        if lane is not None and lane.outstanding:
            # outstanding optimistic binds: their reconcile verdicts (and
            # any freed revert capacity) must land BEFORE the solve
            # encodes — the committing session owns them, never this one
            self._skip(info, "express_tokens")
            return
        if getattr(self.cache, "fence_sweep_due", False):
            self._skip(info, "fence_sweep_due")
            return
        ssn = open_session(self.cache, tiers)
        flips, flip_uids = [], []
        if "enqueue" in names:
            staged = self._staged_enqueue(ssn)
            if staged is None:
                self._release(ssn)
                self._skip(info, "enqueue_active")
                return
            flips, flip_uids = staged
        # encode with the staged flips APPLIED (the encoder excludes
        # Pending-phase jobs — encoder.py job gate), then park them until
        # commit: the shared PodGroup objects must carry zero observable
        # state while this session is merely speculative
        solver = getattr(ssn, "batch_allocator", None)
        # the stage's prepare and dispatch counters ride to its commit
        with devprof.session(None) as counters:
            try:
                prep = solver._prepare(ssn) if solver is not None else None
            finally:
                for pg in flips:
                    pg.status.phase = objects.PodGroupPhase.PENDING
            if prep is None or prep["mode"] != "rounds":
                self._release(ssn)
                self._skip(info, "not_packed_rounds")
                return
            fingerprint = self._fingerprint(tiers)
            readset = self._seal_readset(ssn, names, prep, flip_uids)
            events = None
            if solver.device.type == "cuda":
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                events[0].record()
            t_dispatch = time.perf_counter()
            dev = solver.dispatch(prep)
            wait = devprof.start_fetch(dev)
            dispatch_s = time.perf_counter() - t_dispatch
            if events is not None:
                events[1].record()
        self._inflight = _InFlight(ssn, names, prep, dev, wait,
                                   fingerprint, flips, tiers, t_dispatch,
                                   readset=readset, dispatch_s=dispatch_s,
                                   events=events, counters=dict(counters))
        self.stats["spec_dispatched"] += 1
        info.setdefault("spec", "dispatched")

    def _seal_readset(self, ssn, names, prep, flip_uids):
        """Seal the stage's read-set descriptor next to the coarse
        fingerprint: the host half from the prepare (encoded job uids,
        queue/namespace policy rows, the residue/releasing conservatism
        flag), the staged-enqueue flip jobs (their phase re-applies at
        commit, so post-seal movement on them must discard), the
        backfill-eligibility widening (backfill binds onto ANY node of
        its stale snapshot, so its node read set is the whole axis), and
        the keeper's journal cursor + version baselines
        (cache.readset_seal). None degrades the stage to whole-
        fingerprint scope — never to a wrong commit."""
        if not readset_enabled():
            return None
        rs = prep.get("readset")
        if rs is None:
            return None
        try:
            seal = self.cache.readset_seal()
        except Exception:
            logger.exception("readset seal failed; whole-fingerprint "
                             "scope for this stage")
            return None
        read_all = bool(rs.get("read_all_nodes"))
        if not read_all and "backfill" in names \
                and self._backfill_work(ssn):
            read_all = True
        return {
            "seal": seal,
            "read_jobs": set(rs["job_uids"]) | set(flip_uids),
            "read_queues": set(rs["queue_ids"]),
            "read_ns": set(rs["ns_ids"]),
            "read_all_nodes": read_all,
            # the encode's READY node axis: movement on any row outside
            # it is capacity this solve was never offered
            "sealed_axis": set(prep["enc"].node_names),
        }

    @staticmethod
    def _backfill_work(ssn) -> bool:
        """Does the sealed session hold backfill-eligible work (a
        PENDING task with an empty init resreq on a started job —
        actions/backfill.py eligibility)? If so the backfill pass reads
        every node, and the stage's node read set widens to the axis."""
        PENDING = objects.PodGroupPhase.PENDING
        for job in ssn.jobs.values():
            pg = job.pod_group
            if pg is not None and pg.status.phase == PENDING:
                continue
            for task in job.task_status_index.get(
                    TaskStatus.PENDING, {}).values():
                if task.init_resreq.is_empty():
                    return True
        return False

    def _staged_enqueue(self, ssn):
        """Run the REAL enqueue action and record its Pending->Inqueue
        flips. The flips land on PodGroup objects SHARED with the cache/
        store, so the caller parks them back to Pending after the encode
        and re-applies them only at commit — a discarded speculative
        session must leave zero observable state. Returns the flip list
        still APPLIED (the encode needs the admitted phase), or None when
        a flipped job already has pending tasks — the serial order would
        let allocate see it admitted this cycle, so the cycle must not
        speculate (the caller reverts before declining). The flip JOB
        uids ride along as ``(flips, flip_uids)`` — they join the
        stage's job read set (the commit re-applies their phase, so
        post-seal movement on them must discard)."""
        PENDING = objects.PodGroupPhase.PENDING
        before = []
        for job in ssn.jobs.values():
            pg = job.pod_group
            if pg is not None and pg.status.phase == PENDING:
                before.append((job, pg))
        get_action("enqueue").execute(ssn)
        flips = []
        flip_uids = []
        active = False
        for job, pg in before:
            if pg.status.phase == objects.PodGroupPhase.INQUEUE:
                flips.append(pg)
                flip_uids.append(job.uid)
                if job.task_status_index.get(TaskStatus.PENDING):
                    active = True
        if active:
            for pg in flips:
                pg.status.phase = PENDING
            return None
        return flips, flip_uids

    # -- commit / discard ----------------------------------------------------

    def _commit(self, st: _InFlight, info) -> Optional[object]:
        """The fingerprint held: this speculative session IS the cycle.
        Returns the session, or None when the apply-time re-check caught
        a stale fingerprint (the caller re-runs the cycle serially;
        nothing was applied)."""
        ssn = st.ssn
        solver = ssn.batch_allocator
        t0 = time.perf_counter()
        # quiet commit: no outstanding tokens by fingerprint, reconcile
        # still bumps the lane's session seq. Read-set commit: post-seal
        # tokens (already proven disjoint) defer past this session.
        self._preamble(ssn, reconcile_after=st.fingerprint[1])
        for pg in st.flips:
            pg.status.phase = objects.PodGroupPhase.INQUEUE
        # apply-time re-check, the sim auditor's pipeline_no_stale_commit
        # witness: stale_commits counts stages whose fingerprint mismatched
        # HERE, past the cycle-entry check — it must stay 0 (nothing on
        # this thread may move state between the two probes), and if it
        # ever fires the stage is still discarded, never applied
        ok, reason = self._check(st, st.tiers)
        if not ok:
            self.stats["stale_commits"] += 1
            self._note_discard(f"stale_at_apply:{reason}")
            self.stats["spec_reruns"] += 1
            info["spec"] = f"discarded:stale_at_apply:{reason}"
            self._revert_flips(st)
            devprof.discard(st.dev)
            self._release(ssn)
            return None
        t_wait = time.perf_counter()
        overlap_s = t_wait - st.t_dispatch
        with devprof.session(solver.profile) as live:
            for key, val in st.counters.items():
                live[key] += val
            out = st.fetch()
            solver.profile["h2d_s"] = st.prep["h2d_s"]
            solver.profile["dispatch_s"] = st.dispatch_s
            self._apply(ssn, solver, st.prep, out)
        device_ms, device_overlap_ms = st.device_times()
        info["dispatch_ms"] = round(st.dispatch_s * 1e3, 3)
        info["fetch_wait_ms"] = round(st.fetch_wait_s * 1e3, 3)
        info["stage_device_ms"] = device_ms
        info["device_overlap_ms"] = device_overlap_ms
        action_ms = {"allocate": round(
            (time.perf_counter() - t0) * 1e3, 3)}
        if "backfill" in st.names:
            t1 = time.perf_counter()
            get_action("backfill").execute(ssn)
            action_ms["backfill"] = round(
                (time.perf_counter() - t1) * 1e3, 3)
        self.stats["spec_applied"] += 1
        kind = st.commit_kind
        commits = self.stats["spec_commits"]
        commits[kind] = commits.get(kind, 0) + 1
        metrics.register_pipeline_spec_commit(kind)
        if st.audit is not None:
            self.readset_audit.append(st.audit)
            self.readset_audit_total += 1
            self.stats["readset_audits"] += 1
            if len(self.readset_audit) > self._AUDIT_CAP:
                del self.readset_audit[0]
        metrics.observe_pipeline_overlap(overlap_s)
        info["mode"] = "speculative"
        info["overlap_ms"] = round(overlap_s * 1e3, 3)
        info["spec_applied"] = True
        info["spec_commit"] = kind
        info["action_ms"] = action_ms
        return ssn

    def _revert_flips(self, st: _InFlight) -> None:
        for pg in st.flips:
            pg.status.phase = objects.PodGroupPhase.PENDING

    def _note_discard(self, reason: str) -> None:
        self.stats["spec_discarded"] += 1
        discards = self.stats["spec_discards"]
        discards[reason] = discards.get(reason, 0) + 1
        metrics.register_pipeline_spec_discard(reason)

    def _discard(self, st: _InFlight, reason: str) -> None:
        """An invalidated speculative stage: never fetched into session
        state, never applied. The device result is dropped untouched and
        the early-opened session is released without close-side effects
        (it made none — enqueue flips were staged-and-reverted and no
        statement ever committed)."""
        self._note_discard(reason)
        devprof.discard(st.dev)
        self._release(st.ssn)

    @staticmethod
    def _release(ssn) -> None:
        """Drop a session that never committed anything: clear the same
        references close_session clears, WITHOUT plugin close hooks,
        status writebacks, or the job updater — a speculative session
        that did not commit must be invisible."""
        ssn.jobs = {}
        ssn.nodes = {}
        ssn.node_axis = None
        ssn.plugins = {}
        ssn.event_handlers = []
        ssn.job_order_fns = {}
        ssn.namespace_order_fns = {}
        ssn.queue_order_fns = {}
