"""Optimistic commit — express placements through the real cache
effectors, Omega-style validate-then-commit.

The kernel decided against a snapshot of the live axis; between that
snapshot and the commit, watch events may have moved the cluster. Each
job's placements are therefore re-validated under the cache lock against
the LIVE NodeInfo accounting (the same ``resreq.less_equal(idle)`` gate
``NodeInfo.add_task`` enforces) before any bind dispatches; a job that no
longer fits is deferred whole — express never half-commits a gang and
never lets an optimistic bind trip a node into OutOfSync.

Surviving placements go through ``cache.bind`` — the exact effector the
Statement commit path uses (statement._commit_allocate -> ssn.cache.bind):
cache job/node accounting flips to BINDING, the SnapshotKeeper marks the
touched job+nodes (which also feeds the express state's dirty shadow for
the next refresh), the binder dispatches, and the Scheduled event is
recorded. Each committed job records an ExpressToken; the next full
session confirms or reverts it (express/reconcile.py).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Tuple

import numpy as np

from volcano_tpu_torch.api.types import TaskStatus
from volcano_tpu_torch.express.trigger import ExpressToken
from volcano_tpu_torch.store import FencedError
from volcano_tpu_torch.utils import clock

logger = logging.getLogger(__name__)


def commit_batch(cache, lane, jobs: List[Tuple[object, list]],
                 assign: np.ndarray, node_names: List[str]) -> Tuple[int, int]:
    """Validate + bind the batch. Returns (placed tasks, deferred jobs)."""
    placed = 0
    deferred = 0
    ti = 0
    plans = []
    with cache._lock:
        for job, tasks in jobs:
            picks = assign[ti: ti + len(tasks)]
            ti += len(tasks)
            if (picks < 0).any():
                deferred += 1  # kernel deferred (infeasible / gang strip)
                continue
            plan = _validate(cache, job, tasks, picks, node_names)
            if plan is None:
                deferred += 1
                continue
            plans.append((job, plan))
    # binds run OUTSIDE the cache lock: cache.bind takes the lock itself,
    # and the binder's store write dispatches synchronous watch callbacks
    # whose handlers re-enter the cache — holding the lock across that is
    # the ABBA inversion VT003 exists to prevent
    fenced = False
    for ji, (job, plan) in enumerate(plans):
        binds: Dict[str, Tuple[str, str]] = {}
        ok = True
        for task, node_name in plan:
            try:
                cache.bind(task, node_name)
            except FencedError:
                # the lease moved mid-commit (a deposed leader's express
                # batch): the store fenced this bind, so STOP the whole
                # batch and park the lane — every remaining write would
                # burn one rejection to learn the same thing. Binds that
                # already landed belong to this job's token below; the
                # NEW leader's first session reconciles (and reverts)
                # them through the ordinary token drain.
                logger.warning(
                    "express commit fenced (lease lost) at %s; parking "
                    "lane", task.uid)
                lane.park("lease_lost")
                ok = False
                fenced = True
                break
            except Exception:
                # a raced mutation beat the bind; the remainder of this
                # gang is NOT dispatched — reconcile reverts the partial
                logger.exception("express bind failed for %s", task.uid)
                ok = False
                break
            binds[task.uid] = (task.key, node_name)
            placed += 1
        if binds:
            lane.commit_epoch += 1
            lane.outstanding[job.uid] = ExpressToken(
                job_uid=job.uid, binds=binds, seq=lane.session_seq,
                stamp=clock.now(), epoch=lane.commit_epoch)
        if not ok:
            deferred += 1
        if fenced:
            deferred += len(plans) - ji - 1  # undispatched remainder
            break
    return placed, deferred


def _validate(cache, job, tasks, picks, node_names):
    """Live-state re-validation for one job (caller holds the cache
    lock). Returns [(cache task, node name)] or None to defer. Validation
    charges a scratch tally per node so two batch tasks aimed at one node
    are checked against their COMBINED request."""
    cache_job = cache.jobs.get(job.uid)
    if cache_job is None:
        return None
    plan = []
    tallies: Dict[str, object] = {}
    for task, ni in zip(tasks, picks.tolist()):
        if ni < 0 or ni >= len(node_names):
            return None
        ct = cache_job.tasks.get(task.uid)
        if ct is None or ct.status != TaskStatus.PENDING or ct.node_name:
            return None  # raced: task moved since classification
        name = node_names[ni]
        node = cache.nodes.get(name)
        if node is None or not node.ready():
            return None
        tally = tallies.get(name)
        if tally is None:
            tally = tallies[name] = ct.resreq.clone()
        else:
            tally.add(ct.resreq)
        if not tally.less_equal(node.idle):
            return None
        plan.append((ct, name))
    return plan
