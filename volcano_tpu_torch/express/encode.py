"""Express live state — dirty-row maintenance of the node axis between
sessions, plus the device-resident buffer cache the express kernel solves
against.

The SnapshotKeeper's axis belongs to the SESSION snapshot and is only
reconciled at ``snapshot()`` time. The express lane places between
sessions, from the CACHE's live truth, so it maintains its own columnar
axis over the live NodeInfo objects and keeps the derived solve buffers
resident on device:

- a dirty-set **shadow** registered with the SnapshotKeeper
  (snapkeeper.add_shadow) receives every mark the keeper receives —
  watch handlers, bind/evict effectors, bulk-apply syncs — without
  consuming the keeper's own sets;
- ``refresh()`` (caller holds the cache lock) drains the shadow: marked
  rows are patched in place via the shared ``nodeaxis.refresh_rows``, an
  accounting-generation sweep catches in-place mutations that have no
  mark (the deferred mirror flush), and membership changes fall back to a
  full recapture — exactly the keeper's own honesty ladder;
- ``stage()`` ships ONLY the patched rows to the device: a bucketed
  index + row-value scatter through K8 (ops/replica.scatter_rows, which
  writes the lane's standing tensors in place), so the per-arrival h2d
  budget is O(rows the cluster actually changed), not O(nodes). A full
  rebuild (first use, membership change, generation bump) re-puts the
  axis wholesale and is counted separately.

The columns live on the lane's device in its dtype (cuda and float32
unless the lane is built otherwise); the host mirror keeps the axis's
own values.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from volcano_tpu_torch.scheduler.cache.nodeaxis import (
    F_BLOCKING_TAINTS,
    F_NET_UNAVAILABLE,
    F_READY,
    F_UNSCHEDULABLE,
    capture_node_axis,
    refresh_rows,
)

# flags a node must / must not carry to take express placements — the
# static half of the default predicate chain (encoder._static_node_ok
# with the pressure checks at their default-off conf)
_BAD_FLAGS = int(F_NET_UNAVAILABLE) | int(F_UNSCHEDULABLE) \
    | int(F_BLOCKING_TAINTS)


def _ok_col(flags: np.ndarray) -> np.ndarray:
    return ((flags & F_READY) != 0) & ((flags & np.uint16(_BAD_FLAGS)) == 0)


class ExpressState:
    """Live node axis + device buffer cache for one SchedulerCache."""

    # dirty-row budget: past this fraction of the axis a wholesale re-put
    # is cheaper than the scatter (and the patch bucket ladder stops
    # paying for itself)
    PATCH_FRACTION = 4

    def __init__(self, cache, device=None, dtype=None):
        from volcano_tpu_torch import device as devmod
        from volcano_tpu_torch.ops.replica import ScatterPlans

        self.cache = cache
        self.device = devmod.resolve_device(device)
        self.dtype = devmod.resolve_dtype(dtype, self.device)
        self.shadow = cache.snap_keeper.add_shadow()
        self.axis = None
        self._index: Dict[str, int] = {}
        self._seen_generation = -1
        self.dev: Optional[dict] = None
        # host twin of the staged column values (ops/replica.py mirror
        # idiom): a marked row whose visible columns did not actually move
        # is dropped before the scatter
        self._mirror: Optional[dict] = None
        # K8's plans of the standing columns (dropped with them)
        self._plans = ScatterPlans()
        self.n = 0
        self.stats = {"rebuilds": 0, "row_patches": 0, "patched_rows": 0,
                      "h2d_puts": 0, "rows_deduped": 0}

    def detach(self) -> None:
        self.cache.snap_keeper.drop_shadow(self.shadow)

    # -- host refresh (caller holds the cache lock) ------------------------

    def _rebuild(self) -> None:
        ready = {name: nd for name, nd in self.cache.nodes.items()
                 if nd.ready()}
        self.axis = capture_node_axis(ready)
        self._index = {name: i for i, name in enumerate(self.axis.names)}
        self._seen_generation = self.shadow.generation
        self.shadow.dirty_nodes.clear()
        self.n = len(self.axis.names)
        self.dev = None  # stage() re-puts wholesale
        self.stats["rebuilds"] += 1

    def refresh(self) -> list:
        """Reconcile the axis with the live cache; returns the patched row
        indices (empty after a wholesale rebuild — ``self.dev is None``
        then signals stage() to re-put)."""
        axis = self.axis
        if axis is None or self._seen_generation != self.shadow.generation:
            self._rebuild()
            return []

        dirty = self.shadow.dirty_nodes
        self.shadow.dirty_nodes = set()
        updates: Dict[int, object] = {}
        index = self._index
        for name in sorted(dirty):
            nd = self.cache.nodes.get(name)
            ready = nd is not None and nd.ready()
            if ready != (name in index):
                self._rebuild()  # membership changed
                return []
            if ready:
                updates[index[name]] = nd
        # unmarked in-place churn: the deferred mirror flush mutates cache
        # twins without a dirty mark; every such mutation bumps _acct_gen,
        # so a generation sweep over the shared live objects catches it
        n = len(axis.nodes)
        if n:
            cur = np.fromiter((nd._acct_gen for nd in axis.nodes),
                              np.int64, n)
            for i in np.nonzero(cur != axis.gens)[0].tolist():
                updates.setdefault(i, axis.nodes[i])
        if not updates:
            return []
        rows = sorted(updates.items())
        if not refresh_rows(axis, rows):
            self._rebuild()  # new scalar dimension reshapes columns
            return []
        # a row whose readiness flag flipped without an add/delete mark
        # (e.g. an OutOfSync trip) changes the ok column, which the patch
        # path carries — no special case needed
        self.stats["row_patches"] += 1
        self.stats["patched_rows"] += len(rows)
        if self.dev is not None and len(rows) * self.PATCH_FRACTION > self.n:
            self.dev = None  # wholesale re-put beats a huge scatter
        return [i for i, _ in rows]

    # -- host columns ------------------------------------------------------

    def _host_cols(self, rows=None):
        """(idle, alloc, cnt, ok, maxt) as dense arrays — full axis, or
        gathered for the given row indices."""
        axis = self.axis
        if rows is None:
            sel = slice(None)
        else:
            sel = np.asarray(rows, np.int32)
        idle = np.stack([axis.cpu["idle"][sel], axis.mem["idle"][sel]],
                        axis=1)
        alloc = np.stack([axis.cpu["alloc"][sel], axis.mem["alloc"][sel]],
                         axis=1)
        cnt = axis.node_cnt[sel].astype(np.int32)
        ok = _ok_col(axis.flags[sel])
        maxt = axis.max_tasks[sel].astype(np.int32)
        return idle, alloc, cnt, ok, maxt

    # -- device staging ----------------------------------------------------

    def stage(self, rows: list) -> dict:
        """Device twins of the axis columns: wholesale put on rebuild,
        dirty-row scatter otherwise. Returns the device tensor dict.

        The scatter is the session replica's shared bucketed kernel
        (ops/replica.scatter_rows, K8) — one row-patch program for the
        whole codebase — and the lane keeps a host mirror of the staged
        values, so a marked row whose columns did not actually move (the
        bulk-apply echo of a placement the lane itself committed and
        already patched, a status-only generation bump) is dropped before
        it re-crosses the link: no more re-patching rows whose staged
        values the last session already landed."""
        from volcano_tpu_torch.ops import replica as replica_mod

        cols = ("idle", "alloc", "cnt", "ok", "maxt")
        if self.dev is None:
            self._plans.clear()
            self._mirror = dict(zip(cols, self._host_cols()))
            self.dev = {k: self._put(v) for k, v in self._mirror.items()}
            self.stats["h2d_puts"] += len(self.dev)
            return self.dev
        if rows:
            sel = np.asarray(rows, np.int32)
            vals = dict(zip(cols, self._host_cols(sel)))
            keep = None
            for k, v in vals.items():
                d = v != self._mirror[k][sel]
                if d.ndim > 1:
                    d = d.any(axis=1)
                keep = d if keep is None else (keep | d)
            live = [r for r, kp in zip(rows, keep) if kp]
            self.stats["rows_deduped"] += len(rows) - len(live)
            if not live:
                return self.dev
            idx = replica_mod.bucket_pad_rows(live)
            pvals = dict(zip(cols, self._host_cols(idx)))
            self.dev = replica_mod.scatter_rows(self.dev, idx, pvals,
                                                plans=self._plans)
            for k in cols:
                self._mirror[k][idx] = pvals[k]
            # counted as the reference counts its puts: the index and the
            # five row blocks, though K8 moves them in one copy and one
            # launch
            self.stats["h2d_puts"] += 6
        return self.dev

    def _put(self, v: np.ndarray):
        """One column on the lane's device: floats in the lane's dtype."""
        t = torch.from_numpy(np.ascontiguousarray(v))
        if t.is_floating_point():
            t = t.to(self.dtype)
        return t.to(self.device, copy=True)
