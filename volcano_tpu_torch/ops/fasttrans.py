"""Fast per-operation transition engine for preempt/reclaim/backfill.

Port of volcano_tpu/ops/fasttrans.py (host code; unchanged semantics).

Builds a native TransCtx (_native/fasttrans.c) over a session's state when
— and only when — its event-handler set is exactly the recognized stock
set (drf with or without namespace order, proportion, the predicates
resident tracker). The C context executes one whole transition per call: the job
status-index bucket move, the node accounting transition, and the
DRF/proportion share updates that the session would otherwise perform as
~15 interpreted calls (statement.go:29-156; session.go:198-369 are the
reference semantics these transitions mirror).

The predicates tracker stays in Python: its allocate arm mutates the
resident-affinity label index, so the wrapper fires the original closure
after each C call, in the same relative order the session would (handler
state is disjoint: drf touches job_attrs, proportion queue_opts, the
tracker its label index — relative order between them is unobservable).
Its deallocate arm is skipped only for RELEASING tasks, where both of its
branches are statically no-ops (predicates.py _track_deallocate guards on
status != RELEASING).

An unrecognized handler or a missing native module disables the fast path
entirely — the Python Statement/Session/cache code is the oracle and
remains the fallback at every level. DRF's optional namespace-order mode
is supported natively (the C engine mirrors the namespace_opts arm).
"""

from __future__ import annotations

import logging
from typing import Optional

from volcano_tpu_torch import _native
from volcano_tpu_torch.api.types import TaskStatus

logger = logging.getLogger("volcano_tpu_torch.scheduler.framework.statement")


class FastTrans:
    """Session-side transitions + the Python-resident predicates tracker."""

    __slots__ = ("ctx", "pred_alloc", "pred_dealloc", "_event_cls")

    def __init__(self, ctx, pred_alloc, pred_dealloc):
        from volcano_tpu_torch.scheduler.framework.event_handlers import Event

        self.ctx = ctx
        self.pred_alloc = pred_alloc
        self.pred_dealloc = pred_dealloc
        self._event_cls = Event

    # each method mirrors one Python transition exactly; see fasttrans.c

    def evict(self, task, strict: bool) -> None:
        flipped = self.ctx.evict(task, strict)
        # predicates deallocate arm: statically a no-op once the status is
        # RELEASING — but a missing job (non-strict statement semantics)
        # leaves the status untouched, and then the tracker's label-index/
        # anti-affinity removal is real work the oracle performs
        if not flipped and self.pred_dealloc is not None:
            self.pred_dealloc(self._event_cls(task))

    def pipeline(self, task, hostname: str, strict: bool) -> None:
        self.ctx.pipeline(task, hostname, strict)
        if self.pred_alloc is not None:
            self.pred_alloc(self._event_cls(task))

    def unevict(self, task) -> None:
        self.ctx.unevict(task)
        if self.pred_alloc is not None:
            self.pred_alloc(self._event_cls(task))

    def unpipeline(self, task) -> None:
        self.ctx.unpipeline(task)
        if self.pred_dealloc is not None:
            self.pred_dealloc(self._event_cls(task))

    def allocate(self, task, hostname: str):
        job = self.ctx.allocate(task, hostname)
        if self.pred_alloc is not None:
            self.pred_alloc(self._event_cls(task))
        return job


def _make_ctx(mod, jobs, nodes, drf_attrs, drf_pairs, drf_ns_attrs,
              prop_attrs):
    from volcano_tpu_torch.api.node_info import NodeState
    from volcano_tpu_torch.api.types import NodePhase
    from volcano_tpu_torch.utils.assertions import assertf

    return mod.TransCtx(
        jobs, nodes, drf_attrs, drf_pairs, drf_ns_attrs, prop_attrs,
        TaskStatus.PENDING, TaskStatus.ALLOCATED, TaskStatus.PIPELINED,
        TaskStatus.RELEASING, TaskStatus.RUNNING, TaskStatus.BINDING,
        assertf, NodeState, NodePhase.NOT_READY, logger)


def build(ssn) -> Optional[FastTrans]:
    """A FastTrans over the session, or None (callers stay on the Python
    path). Recognition is strict: every registered event handler must be
    tagged by a stock plugin, else no fast path."""
    mod = _native.get_fasttrans_nowait()
    if mod is None:
        return None
    drf_plugin = prop_plugin = None
    drf_ns_enabled = False
    pred_alloc = pred_dealloc = None
    for eh in ssn.event_handlers:
        origin = getattr(eh, "origin", None)
        if origin is None:
            return None  # custom handler: Python path keeps full fidelity
        kind = origin[0]
        if kind == "drf":
            drf_plugin = origin[1]
            drf_ns_enabled = origin[2]
        elif kind == "proportion":
            prop_plugin = origin[1]
        elif kind == "predicates":
            pred_alloc = eh.allocate_func
            pred_dealloc = eh.deallocate_func
        else:
            return None
    drf_attrs = drf_pairs = drf_ns_attrs = None
    if drf_plugin is not None:
        total = drf_plugin.total_resource
        drf_pairs = [(rn, total.get(rn)) for rn in total.resource_names()]
        drf_attrs = drf_plugin.job_attrs
        if drf_ns_enabled:
            drf_ns_attrs = drf_plugin.namespace_opts
    prop_attrs = prop_plugin.queue_opts if prop_plugin is not None else None
    try:
        ctx = _make_ctx(mod, ssn.jobs, ssn.nodes,
                        drf_attrs, drf_pairs, drf_ns_attrs, prop_attrs)
    except Exception:
        logger.exception("fasttrans ctx build failed; using Python path")
        return None
    return FastTrans(ctx, pred_alloc, pred_dealloc)


def native_settled() -> bool:
    """True once the native loader has a definitive answer for the
    fasttrans module (built, failed, or env-disabled); False while a
    background compile is still in flight. Long-lived callers (the cache
    mirror) must not latch a None result before this settles."""
    return _native.settled("_fasttrans")


def build_mirror(jobs, nodes):
    """A plugin-free TransCtx over the CACHE's jobs/nodes maps, for the
    effector-side mutations of SchedulerCache.bind/evict. Returns the raw
    ctx (mirror_evict/mirror_bind) or None."""
    mod = _native.get_fasttrans_nowait()
    if mod is None:
        return None
    try:
        return _make_ctx(mod, jobs, nodes, None, None, None, None)
    except Exception:
        logger.exception("fasttrans mirror ctx build failed; using Python path")
        return None
