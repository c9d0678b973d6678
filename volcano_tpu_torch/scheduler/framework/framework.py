"""Session lifecycle (volcano pkg/scheduler/framework/framework.go:30-62)."""

from __future__ import annotations

import logging
import time
from typing import List

from volcano_tpu_torch.api.types import TaskStatus, allocated_status
from volcano_tpu_torch.scheduler import conf
from volcano_tpu_torch.scheduler import metrics
from volcano_tpu_torch.scheduler.framework.arguments import Arguments
from volcano_tpu_torch.scheduler.framework.job_updater import JobUpdater
from volcano_tpu_torch.scheduler.framework.plugins import get_plugin_builder
from volcano_tpu_torch.scheduler.framework.session import Session, open_session_state

logger = logging.getLogger(__name__)


def open_session(cache, tiers: List[conf.Tier]) -> Session:
    ssn = Session(cache)
    # snapshot happens before tiers are installed (so the open-time JobValid
    # pass is a no-op — actions re-validate; matches framework.go:31-32)
    open_session_state(ssn)
    # conf loading normally defaults the enable flags (util.go:59); defaulting
    # again here is idempotent and protects hand-built tiers.
    for tier in tiers:
        for option in tier.plugins:
            conf.apply_plugin_conf_defaults(option)
    ssn.tiers = tiers

    for tier in tiers:
        for plugin_option in tier.plugins:
            builder = get_plugin_builder(plugin_option.name)
            if builder is None:
                logger.error("Failed to get plugin %s.", plugin_option.name)
                continue
            plugin = builder(Arguments(plugin_option.arguments))
            ssn.plugins[plugin.name()] = plugin

    for plugin in ssn.plugins.values():
        start = time.perf_counter()
        plugin.on_session_open(ssn)
        metrics.update_plugin_duration(plugin.name(), "OnSessionOpen", time.perf_counter() - start)
    return ssn


def takeover_recovery_sweep(ssn) -> int:
    """First session of a new leadership term: revert the half-bound gangs
    a deposed leader's fenced mid-chain abort may have left in the store.

    A leader killed between two binds of one gang's fused chain (or serial
    Statement commit) leaves 0 < bound < minAvailable pods with node_name
    set — pods the deposed term can no longer touch (its writes are
    fenced) and that would otherwise violate gang atomicity until chance
    capacity completes them. The new term evicts them through the ordinary
    Statement machinery (same fidelity as an express revert: events, cache
    accounting, dirty-sets, metrics), freeing the capacity for THIS
    session's own placements; the job controller's normal recovery
    resubmits the gang for atomic re-placement. Jobs with any terminal
    task are lifecycle churn, not failover residue — skipped, exactly as
    the auditor's gang rule exempts them. Returns gangs reverted."""
    terminal = TaskStatus.SUCCEEDED | TaskStatus.FAILED
    reverted = 0
    for job_uid in sorted(ssn.jobs):
        job = ssn.jobs[job_uid]
        if job.min_available <= 1:
            continue
        tasks = [job.tasks[uid] for uid in sorted(job.tasks)]
        if any(t.status & terminal for t in tasks):
            continue
        bound = [t for t in tasks
                 if allocated_status(t.status) and t.node_name]
        if not bound or len(bound) >= job.min_available:
            continue
        stmt = ssn.statement()
        for task in bound:
            stmt.evict(task, "takeover-recovery: gang short after failover")
        stmt.commit()
        reverted += 1
    if reverted:
        logger.warning(
            "takeover recovery: reverted %d half-bound gang(s) left by a "
            "deposed leader", reverted)
    return reverted


def run_actions(ssn: Session, actions) -> dict:
    """Run the session's action chain, preferring the whole-session fused
    dispatch (ops/session_fuse.py) when the session is inside its envelope;
    otherwise the plain per-action loop. ``actions`` is a sequence of
    action names or Action instances. Returns {action name: wall ms}."""
    from volcano_tpu_torch.ops import session_fuse
    from volcano_tpu_torch.scheduler.framework.plugins import get_action

    names = [a if isinstance(a, str) else a.name() for a in actions]
    if getattr(ssn.cache, "fence_sweep_due", False):
        # one recovery sweep per leadership term, before any placement
        ssn.cache.fence_sweep_due = False
        takeover_recovery_sweep(ssn)
    out = session_fuse.try_run(ssn, names)
    if out is not None:
        return out
    action_ms = {}
    for name in names:
        t0 = time.perf_counter()
        get_action(name).execute(ssn)
        action_ms[name] = round((time.perf_counter() - t0) * 1e3, 3)
    return action_ms


def close_session(ssn: Session) -> None:
    # apply any cache-mirror work the bulk writeback deferred off the
    # in-session critical path (solver._apply_bulk; the reference's bind
    # is async and its cache syncs from later watch events) — plugins'
    # on_session_close and the job updater read the cache below
    flush = getattr(ssn.cache, "flush_mirror", None)
    if flush is not None:
        flush()
    # volume assumptions not bound by session end belong to placements
    # that never dispatched (e.g. a gang that stayed short) — release
    # them, or their PVs stay unselectable forever (assume/bind always
    # completes within one session; see StoreVolumeBinder)
    vb = getattr(ssn.cache, "volume_binder", None)
    reset_assumed = getattr(vb, "reset_assumptions", None)
    if reset_assumed is not None:
        reset_assumed()
    for plugin in ssn.plugins.values():
        start = time.perf_counter()
        plugin.on_session_close(ssn)
        metrics.update_plugin_duration(plugin.name(), "OnSessionClose", time.perf_counter() - start)

    JobUpdater(ssn).update_all()

    ssn.jobs = {}
    ssn.nodes = {}
    ssn.node_axis = None  # releases the snapshot's cloned NodeInfos too
    ssn.plugins = {}
    ssn.event_handlers = []
    ssn.job_order_fns = {}
    ssn.namespace_order_fns = {}
    ssn.queue_order_fns = {}
