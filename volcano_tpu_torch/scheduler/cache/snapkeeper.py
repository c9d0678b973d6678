"""SnapshotKeeper — delta-maintained session snapshot.

The reference rebuilds its snapshot wholesale every session
(cache.go:713-798) and round-5 measured that faithfulness at ~152 ms of
host Python per cycle at 50k tasks x 10k nodes — more than the entire
device solve. But this cache already receives TYPED deltas (watch events,
effector calls, the deferred bulk-mirror flush), so the keeper maintains
the snapshot between sessions and rebuilds only what actually moved:

- **dirty-sets** — every cache mutation path (watch handlers, bind/evict
  effectors, resyncs) marks the touched job uid / node name; at the next
  ``snapshot()`` only those entries are re-cloned from the cache;
- **session-mutation detection** — the keeper records each handed-out
  clone's ``_status_version`` / ``_acct_gen``; a session that mutated an
  object through the Statement path (allocate/evict/pipeline and their
  unwinds) leaves the version ahead of the record and the object is
  re-cloned.  Pipelined placements in particular are session-only state
  and MUST revert to the cache's truth each cycle — the version gap is
  what reverts them;
- **bulk-flush sync** — the rounds writeback's deferred mirror flush
  (cache.flush_mirror) applies the session's own placements to the cache
  trees, after which snapshot object == cache object for everything it
  flipped.  The flush re-records those versions (``sync_job``/``sync_node``
  with the versions captured at defer time, solver._apply_bulk), so a
  steady-state bulk cycle reuses its whole snapshot instead of re-cloning
  50k tasks.  Any task the flush could NOT flip (deleted in the defer
  window) re-dirties its job and node;
- **generation counter** — structural changes the dirty-sets don't model
  (queue set, priority classes) bump ``generation``; the next snapshot
  falls back to a full rebuild, exactly the wholesale path.  A remote
  watch reset floods the handlers with re-ADDs, which mark everything
  dirty — equivalent to a rebuild without a special case.

Reuse safety: a reused JobInfo/NodeInfo is handed to the next session
as-is, so per-session scratch (fit errors) is cleared on reuse, and the
bulk writeback's task-sharing into node maps stays safe because the only
in-place task mutations sessions perform target PENDING (bulk/Statement
allocate) or RUNNING (preempt/reclaim victims) tasks — never the shared
BINDING set, whose status only moves via watch events, which dirty the
owning job and node and force a re-clone.

The columnar node axis (nodeaxis.py) is promoted to a long-lived
structure the same way: rows are refreshed in place for re-cloned /
session-mutated nodes and the whole axis is recaptured only when the
ready-node membership changes.

``VOLCANO_TPU_WHOLESALE_SNAPSHOT=1`` disables the keeper (every snapshot
is a full rebuild — the round-5 behavior and the parity oracle).
"""

from __future__ import annotations

import os
from typing import Dict, Set

import numpy as np

from volcano_tpu_torch.api.cluster_info import ClusterInfo
from volcano_tpu_torch.scheduler.cache.nodeaxis import (
    capture_node_axis,
    refresh_rows,
)


class DirtyShadow:
    """A second consumer of the keeper's dirty marks (the express lane's
    live-axis maintenance, express/encode.py): every mark_job/mark_node
    lands in each registered shadow too, so a between-sessions consumer
    can drain its own copy without racing ``snapshot()`` for the keeper's
    sets. ``generation`` mirrors the keeper's wholesale-rebuild signal."""

    __slots__ = ("dirty_jobs", "dirty_nodes", "generation")

    def __init__(self):
        self.dirty_jobs: Set[str] = set()
        self.dirty_nodes: Set[str] = set()
        self.generation = 0


class _SnapshotBuffer:
    """One snapshot buffer's private state (the pipeline's double-buffer
    half). The keeper's live buffer lives directly on the keeper (the
    pre-pipeline layout, untouched for single-buffer users); ``swap()``
    exchanges the keeper's live fields with a parked ``_SnapshotBuffer``
    so two consecutive sessions never share clone objects."""

    __slots__ = ("jobs", "nodes", "job_vers", "node_gens",
                 "dirty_jobs", "dirty_nodes", "axis", "built_generation")

    def __init__(self):
        self.jobs: Dict[str, object] = {}
        self.nodes: Dict[str, object] = {}
        self.job_vers: Dict[str, int] = {}
        self.node_gens: Dict[str, int] = {}
        self.dirty_jobs: Set[str] = set()
        self.dirty_nodes: Set[str] = set()
        self.axis = None
        self.built_generation = -1


class SnapshotKeeper:
    def __init__(self):
        self.enabled = not os.environ.get("VOLCANO_TPU_WHOLESALE_SNAPSHOT")
        self.jobs: Dict[str, object] = {}    # uid -> clone in the live snap
        self.nodes: Dict[str, object] = {}   # name -> clone (ready only)
        self.job_vers: Dict[str, int] = {}   # uid -> in-sync _status_version
        self.node_gens: Dict[str, int] = {}  # name -> in-sync _acct_gen
        self.dirty_jobs: Set[str] = set()
        self.dirty_nodes: Set[str] = set()
        self.shadows: list = []   # DirtyShadow fan-out (express lane)
        self.generation = 0       # bump => next snapshot fully rebuilds
        self._built_generation = -1
        self.axis = None
        # delta fingerprint for the pipeline's speculative solve-ahead:
        # every mark/invalidate bumps it, so (dirty_epoch, generation)
        # captured at dispatch and re-checked before apply detects ANY
        # state movement the speculative snapshot did not see
        self.dirty_epoch = 0
        # mark journal (read-set-scoped speculation): when armed, every
        # dirty_epoch bump appends exactly one typed entry — ("job", uid),
        # ("node", name), ("meta", kind, uid) or ("gen",) — so a consumer
        # that captured dirty_epoch at seal can later ask WHICH rows moved
        # (marks_since) instead of only THAT something moved. The journal
        # is bounded: a front trim advances journal_base, and any cursor
        # behind the base (or an epoch bump that bypassed the journal)
        # makes the window unprovable — marks_since then returns None and
        # the caller must degrade to the whole-fingerprint discard.
        self.journal_enabled = False
        self.journal: list = []
        self.journal_base = 0
        self.JOURNAL_CAP = 8192
        # pipeline double-buffer: when armed (enable_pair), marks land in
        # BOTH buffers' dirty sets and swap() alternates which buffer the
        # next snapshot builds — session N and session N+1 then never
        # share clone objects, so N's close can still read its snapshot
        # while N+1's is already open
        self._standby: "_SnapshotBuffer | None" = None
        self.stats = {"rebuilds": 0, "incremental": 0,
                      "reused_jobs": 0, "cloned_jobs": 0,
                      "reused_nodes": 0, "cloned_nodes": 0,
                      "axis_rebuilds": 0, "axis_rows_refreshed": 0,
                      "evict_marks": 0, "swaps": 0}

    # -- pipeline buffer pair ------------------------------------------------

    @property
    def pair_enabled(self) -> bool:
        return self._standby is not None

    def enable_pair(self) -> None:
        """Arm the double buffer (idempotent). The standby starts with
        built_generation=-1, so its first build is a wholesale rebuild —
        after that both buffers delta-maintain independently."""
        if self._standby is None:
            self._standby = _SnapshotBuffer()

    def swap(self) -> None:
        """Exchange the live buffer with the standby (caller holds the
        cache lock). No-op until enable_pair()."""
        sb = self._standby
        if sb is None:
            return
        (self.jobs, sb.jobs) = (sb.jobs, self.jobs)
        (self.nodes, sb.nodes) = (sb.nodes, self.nodes)
        (self.job_vers, sb.job_vers) = (sb.job_vers, self.job_vers)
        (self.node_gens, sb.node_gens) = (sb.node_gens, self.node_gens)
        (self.dirty_jobs, sb.dirty_jobs) = (sb.dirty_jobs, self.dirty_jobs)
        (self.dirty_nodes, sb.dirty_nodes) = (
            sb.dirty_nodes, self.dirty_nodes)
        (self.axis, sb.axis) = (sb.axis, self.axis)
        (self._built_generation, sb.built_generation) = (
            sb.built_generation, self._built_generation)
        self.stats["swaps"] += 1

    # -- marks (called under the cache lock) --------------------------------

    def add_shadow(self) -> DirtyShadow:
        """Register an express-lane dirty-set shadow; it receives every
        subsequent mark. Start dirty via generation so the first consumer
        refresh is a wholesale rebuild."""
        sh = DirtyShadow()
        sh.generation = -1
        self.shadows.append(sh)
        return sh

    def drop_shadow(self, sh: DirtyShadow) -> None:
        if sh in self.shadows:
            self.shadows.remove(sh)

    def mark_job(self, uid: str) -> None:
        if uid:
            self.dirty_jobs.add(uid)
            self.dirty_epoch += 1
            if self.journal_enabled:
                self._journal(("job", uid))
            if self._standby is not None:
                self._standby.dirty_jobs.add(uid)
            for sh in self.shadows:
                sh.dirty_jobs.add(uid)

    def mark_node(self, name: str) -> None:
        if name:
            self.dirty_nodes.add(name)
            self.dirty_epoch += 1
            if self.journal_enabled:
                self._journal(("node", name))
            if self._standby is not None:
                self._standby.dirty_nodes.add(name)
            for sh in self.shadows:
                sh.dirty_nodes.add(name)

    def mark_evict(self, job_uid: str, node_name: str) -> None:
        """Eviction effector path: dirty both sides of the eviction in one
        call and count it — the batched eviction replays land here exactly
        like the serial walk, which is what keeps the next incremental
        snapshot honest about RELEASING tasks."""
        self.mark_job(job_uid)
        self.mark_node(node_name)
        self.stats["evict_marks"] += 1

    def mark_meta(self, kind: str = "", uid: str = "") -> None:
        """A policy-level delta the per-object dirty-sets don't model —
        an existing queue's spec update, a namespace quota change.
        QueueInfos and namespace weights are re-derived fresh every
        snapshot, so no clone needs invalidating; but the pipeline's
        speculative solve-ahead read the OLD policy, so the fingerprint
        epoch must move or a sealed stage could commit against a weight
        the serial order would not have used. ``kind``/``uid`` scope the
        journal entry ("queue"/name, "quota"/namespace) so the read-set
        intersect can tell noise on an id the sealed solve never consumed
        from movement of a policy row it did; an unscoped call journals
        as unknown and the intersect must treat it as a hit."""
        self.dirty_epoch += 1
        if self.journal_enabled:
            self._journal(("meta", kind, uid))

    def invalidate(self) -> None:
        self.generation += 1
        self.dirty_epoch += 1
        if self.journal_enabled:
            self._journal(("gen",))
        for sh in self.shadows:
            sh.generation += 1

    # -- mark journal (read-set-scoped speculation) -------------------------

    def enable_journal(self) -> None:
        """Arm the mark journal (idempotent; caller holds the cache lock).
        Arming anchors the base at the CURRENT dirty_epoch — bumps before
        this moment are deliberately unprovable."""
        if not self.journal_enabled:
            self.journal_enabled = True
            self.journal = []
            self.journal_base = self.dirty_epoch

    def _journal(self, entry) -> None:
        j = self.journal
        j.append(entry)
        if len(j) > self.JOURNAL_CAP:
            drop = len(j) - self.JOURNAL_CAP // 2
            del j[:drop]
            self.journal_base += drop

    def marks_since(self, cursor: int):
        """The typed mark entries for every dirty_epoch bump past
        ``cursor`` (a dirty_epoch captured at seal), oldest first — or
        ``None`` when the window is unprovable: journal disarmed when the
        cursor was taken, cursor trimmed past, or an epoch bump that
        bypassed the journal (entry count must equal the epoch delta
        exactly; anything else means an unjournaled movement and the
        caller degrades to the whole-fingerprint discard)."""
        if not self.journal_enabled:
            return None
        if cursor < self.journal_base:
            return None
        if self.journal_base + len(self.journal) != self.dirty_epoch:
            return None
        return self.journal[cursor - self.journal_base:]

    # -- bulk-flush sync ----------------------------------------------------

    def sync_job(self, uid: str, version: int) -> None:
        """Declare the snapshot job in sync with the cache at `version`
        (the flush just mirrored the session's bulk placements). The sync
        is valid only for the LIVE buffer — its clones ARE the session
        objects the flush mirrored; the standby buffer's clone of the same
        job predates the placement and must re-clone from the flushed
        cache twin at its next turn, so it is dirtied instead."""
        if uid in self.job_vers:
            self.job_vers[uid] = version
        if self._standby is not None:
            self._standby.dirty_jobs.add(uid)

    def sync_node(self, name: str, gen: int) -> None:
        if name in self.node_gens:
            self.node_gens[name] = gen
        if self._standby is not None:
            self._standby.dirty_nodes.add(name)

    # -- snapshot -----------------------------------------------------------

    def snapshot(self, cache) -> ClusterInfo:
        """Build the session snapshot (caller holds the cache lock)."""
        if not self.enabled or self._built_generation != self.generation:
            return self._full_build(cache)
        return self._incremental_build(cache)

    def _job_priority(self, cache, job) -> int:
        if job.pod_group is None:
            return job.priority
        pc = cache.priority_classes.get(
            job.pod_group.spec.priority_class_name)
        return pc.value if pc is not None else cache.default_priority

    def _clone_job(self, cache, job):
        job.priority = self._job_priority(cache, job)
        clone = job.clone()
        self.jobs[clone.uid] = clone
        self.job_vers[clone.uid] = clone._status_version
        return clone

    def _clone_node(self, node):
        clone = node.clone()
        self.nodes[clone.name] = clone
        self.node_gens[clone.name] = clone._acct_gen
        return clone

    def _full_build(self, cache) -> ClusterInfo:
        self.stats["rebuilds"] += 1
        self.jobs = {}
        self.nodes = {}
        self.job_vers = {}
        self.node_gens = {}
        self.dirty_jobs = set()
        self.dirty_nodes = set()
        for node in cache.nodes.values():
            if node.ready():
                self._clone_node(node)
        self.axis = capture_node_axis(self.nodes)
        queues = {q.uid: q.clone() for q in cache.queues.values()}
        for job in cache.jobs.values():
            if job.pod_group is None and job.pdb is None:
                continue  # no scheduling spec
            if job.queue not in queues:
                continue  # queue doesn't exist
            self._clone_job(cache, job)
        self._built_generation = self.generation
        return self._emit(cache, queues)

    def _incremental_build(self, cache) -> ClusterInfo:
        self.stats["incremental"] += 1
        queues = {q.uid: q.clone() for q in cache.queues.values()}

        # ---- nodes: re-clone dirty + session-mutated, reuse the rest ----
        dirty_nodes, self.dirty_nodes = self.dirty_nodes, set()
        membership_changed = False
        recloned: Dict[str, object] = {}
        for name in dirty_nodes:
            cn = cache.nodes.get(name)
            if cn is None or not cn.ready():
                if self.nodes.pop(name, None) is not None:
                    membership_changed = True
                self.node_gens.pop(name, None)
                continue
            if name not in self.nodes:
                membership_changed = True
            recloned[name] = self._clone_node(cn)
        # session-mutated (Statement path / bulk apply the flush didn't
        # sync): the handed-out clone's generation moved past the record
        node_gens = self.node_gens
        for name, node in self.nodes.items():
            if name in recloned:
                continue
            if node._acct_gen != node_gens[name]:
                cn = cache.nodes.get(name)
                if cn is None or not cn.ready():
                    # the cache-side twin vanished/unreadied without a
                    # dirty mark — should not happen; rebuild honestly
                    self.invalidate()
                    return self._full_build(cache)
                recloned[name] = self._clone_node(cn)
        self.stats["cloned_nodes"] += len(recloned)
        self.stats["reused_nodes"] += len(self.nodes) - len(recloned)

        # ---- node axis: patch rows in place, recapture on membership ----
        axis = self.axis
        if membership_changed or axis is None \
                or len(axis.names) != len(self.nodes):
            self.axis = capture_node_axis(self.nodes)
            self.stats["axis_rebuilds"] += 1
        else:
            updates = {}
            if recloned:
                index = {n: i for i, n in enumerate(axis.names)}
                for n, nd in recloned.items():
                    updates[index[n]] = nd
            # rows whose accounting generation moved since capture: nodes
            # the previous session's bulk placements touched (content kept
            # in sync by the mirror flush, but the captured columns are
            # pre-placement) — patch them from the live objects
            n = len(axis.nodes)
            if n:
                cur = np.fromiter(
                    (nd._acct_gen for nd in axis.nodes), np.int64, n)
                for i in np.nonzero(cur != axis.gens)[0].tolist():
                    updates.setdefault(i, axis.nodes[i])
            if updates:
                if refresh_rows(axis, sorted(updates.items())):
                    self.stats["axis_rows_refreshed"] += len(updates)
                else:  # new scalar resource dimension: columns reshape
                    self.axis = capture_node_axis(self.nodes)
                    self.stats["axis_rebuilds"] += 1

        # ---- jobs: re-evaluate dirty, version-check the rest ----
        dirty_jobs, self.dirty_jobs = self.dirty_jobs, set()
        cache_jobs = cache.jobs
        job_vers = self.job_vers
        cloned = 0
        for uid in dirty_jobs:
            job = cache_jobs.get(uid)
            if job is None or (job.pod_group is None and job.pdb is None) \
                    or job.queue not in queues:
                self.jobs.pop(uid, None)
                job_vers.pop(uid, None)
                continue
            self._clone_job(cache, job)
            cloned += 1
        for uid, job in list(self.jobs.items()):
            if uid in dirty_jobs:
                continue
            if job._status_version != job_vers[uid] \
                    or uid not in cache_jobs:
                cj = cache_jobs.get(uid)
                if cj is None or (cj.pod_group is None and cj.pdb is None) \
                        or cj.queue not in queues:
                    del self.jobs[uid]
                    del job_vers[uid]
                    continue
                self._clone_job(cache, cj)
                cloned += 1
            elif job.job_fit_errors or job.nodes_fit_errors \
                    or job.nodes_fit_delta:
                # reused clone: per-session scratch must not leak into the
                # next session (fresh clones start empty)
                job.job_fit_errors = ""
                job.nodes_fit_errors = {}
                job.nodes_fit_delta = {}
        self.stats["cloned_jobs"] += cloned
        self.stats["reused_jobs"] += len(self.jobs) - cloned
        return self._emit(cache, queues)

    def _emit(self, cache, queues) -> ClusterInfo:
        """Fresh ClusterInfo over the keeper's live objects: the dicts are
        copies (open_session_state deletes invalid jobs from its dict; the
        keeper's own maps must not see that), the values are shared."""
        snap = ClusterInfo()
        snap.jobs = dict(self.jobs)
        snap.nodes = dict(self.nodes)
        snap.queues = queues
        for ns, coll in cache.namespace_collection.items():
            snap.namespace_info[ns] = coll.snapshot()
        snap.node_axis = self.axis
        return snap
