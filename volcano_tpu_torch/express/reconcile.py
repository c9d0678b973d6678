"""Full-session reconciliation — the fairness/preemption authority's
verdict on every optimistic express bind.

Runs at the head of every full session's action chain
(framework.run_actions), after plugins opened (so proportion's deserved
shares and the gang/job-ready machinery are live). For every outstanding
token recorded since the previous session:

- **confirm** when the session agrees: the job still exists, every
  express-bound task is still allocated on its recorded node, the gang is
  ready (min_available holds), and the job's queue is not overused (the
  proportion plugin's deserved-share gate — the check express itself
  deliberately does not model);
- **revert** otherwise: the surviving express binds become ordinary
  evictions through the existing Statement machinery (stmt.evict ->
  commit -> cache.evict -> evictor), so events, cache accounting,
  SnapshotKeeper dirty-sets, and metrics land exactly as a preemption
  would, the freed capacity is visible to THIS session's own actions
  (the reconciler runs before allocate), and the job controller's normal
  recovery resubmits the evicted pods for the full path to place.
  Reverted jobs are denylisted from the lane — the full session owns
  them from then on;
- tokens whose tasks all vanished (pod deleted / completed in the
  window) resolve as terminal lifecycle churn — nothing to keep, nothing
  to reclaim.

Every token is resolved within ONE session — the invariant the
simulator's auditor now checks continuously (sim/auditor.py
express_reconciliation rule).

Continuous-pipeline interaction (volcano_tpu/pipeline): a SPECULATIVE
session — opened and dispatched ahead of the previous cycle's close —
never reconciles; only the session that actually COMMITS does, and it
bumps ``lane.session_seq`` exactly once. Tokens carry the lane's
``commit_epoch`` at mint time, and the pipeline seals that epoch into its
dispatch fingerprint: an express commit landing while a speculative solve
is in flight moves the epoch, the speculative stage is discarded unapplied
(``pipeline_spec_discard{reason="express_commit"}``), and the token drains
through the re-run — the session that commits, never the one in flight.
The pipeline also refuses to START speculating while tokens are
outstanding (their reverts must free capacity BEFORE the solve encodes),
so a reconcile verdict is always computed by the same session whose
placements it shapes.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

from volcano_tpu_torch.api.types import allocated_status
from volcano_tpu_torch.scheduler import metrics

logger = logging.getLogger(__name__)


def reconcile_session(ssn, after_epoch: Optional[int] = None) \
        -> Optional[Dict]:
    """Resolve every outstanding express token against this session.
    No-op (None) when no lane is attached.

    ``after_epoch`` — the committing pipeline stage's SEALED commit
    epoch: tokens minted after it (token.epoch > after_epoch) reference
    jobs this session's snapshot never contained, so reconciling them
    here would wrongly revert fresh binds ("job left the snapshot").
    They stay outstanding — counted as ``deferred`` — and resolve in the
    NEXT session, which the pipeline guarantees runs on a fresh snapshot
    (speculation refuses to start while tokens are outstanding)."""
    lane = getattr(ssn.cache, "express_lane", None)
    if lane is None:
        return None
    stats = {"confirmed": 0, "reverted": 0, "terminal": 0,
             "reverted_tasks": 0, "deferred": 0}
    lane.last_reverts = []
    for job_uid in sorted(lane.outstanding):
        if after_epoch is not None \
                and lane.outstanding[job_uid].epoch > after_epoch:
            stats["deferred"] += 1
            continue
        token = lane.outstanding.pop(job_uid)
        job = ssn.jobs.get(job_uid)
        live = []      # (session task, recorded node) still express-bound
        missing = 0
        for uid in sorted(token.binds):
            key, node_name = token.binds[uid]
            task = job.tasks.get(uid) if job is not None else None
            if task is None:
                missing += 1  # lifecycle churn: pod completed/deleted
                continue
            if allocated_status(task.status) and task.node_name == node_name:
                live.append((task, node_name))
            else:
                missing += 1  # moved by something with authority already
        if not live:
            stats["terminal"] += 1
            lane._count("terminal", 1)
            continue
        verdict = _verdict(ssn, job, token, missing)
        if verdict is None:
            stats["confirmed"] += 1
            lane._count("reconciled", 1)
            continue
        stmt = ssn.statement()
        for task, node_name in live:
            stmt.evict(task, f"express-reconcile: {verdict}")
            lane.last_reverts.append((job_uid, task.key, node_name))
        stmt.commit()
        lane.denylist.add(job_uid)
        stats["reverted"] += 1
        stats["reverted_tasks"] += len(live)
        lane._count("reverted", len(live))
        logger.info("express revert %s (%d tasks): %s",
                    job_uid, len(live), verdict)
    if stats["reverted_tasks"]:
        metrics.register_express_reverted(stats["reverted_tasks"])
    lane.session_seq += 1
    return stats


def _verdict(ssn, job, token, missing: int) -> Optional[str]:
    """None to confirm, else the revert reason."""
    if job is None:
        return "job left the snapshot with live binds"
    if missing:
        # part of the gang vanished; keeping the remainder would risk a
        # standing half-gang — the session's gang gate decides
        if not ssn.job_ready(job):
            return "gang lost members below min_available"
    if not ssn.job_ready(job):
        return "gang not ready under the session's job-ready gate"
    queue = ssn.queues.get(job.queue)
    if queue is None:
        return "queue no longer exists"
    if ssn.overused(queue):
        return "queue overused under the session's deserved shares"
    return None
