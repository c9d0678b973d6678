"""Batched victim selection for preempt/reclaim (SURVEY.md §7: the batch
path proposes victims, the host Statement commits/rolls back).

The serial tiered dispatch (framework/session.py `_victims`, mirroring
session_plugins.go:106-187) evaluates every candidate victim through each
plugin's Python closure: drf clones the victim job's allocation and
recomputes the dominant share PER VICTIM (drf.go:120-201), proportion walks
a cumulative queue allocation (proportion.go:174-199). On a node holding
many resident tasks that is the per-(preemptor, node) hot loop of
preempt.go:180-260 / reclaim.go:42-202.

This module computes the SAME tiered intersection over victim arrays:

- gang:        per-job occupancy memo, one lookup per victim
               (gang.go:82-86 semantics);
- conformance: vector mask over priority-class/namespace
               (conformance.go:44-66);
- drf:         per-job cumulative request prefix-sums + vectorized dominant
               share against the cluster total — including the serial
               path's order-dependent cumulative-clone semantics: victims
               of one job are judged against progressively decreasing
               allocation in claimee order;
- proportion:  the reclaim deserved-floor walk, replayed with real Resource
               arithmetic per queue (its conditional skip makes it
               inherently sequential; it is cheap and never the deciding
               tier under the default conf).

Victim ORDER in the result equals the claimee order the serial path
returns, so the caller's lowest-priority-first eviction cut (PriorityQueue
pop + prefix-until-covered) is unchanged and the final victim sets are
bit-identical — asserted by tests/test_victimview.py against the serial
oracle on randomized sessions.

Divergence note: in non-panic assert mode the serial drf path logs a
resource-underflow diagnostic when a victim's request exceeds its job's
tracked allocation before subtracting anyway; the vector path performs the
same arithmetic without the log line. In PANIC mode an underflow watchdog
(epsilon-exact against Resource.sub's assert predicate) replays the serial
walk so the AssertionViolation fires identically.

Sessions registering victim fns from any other plugin fall back to the
serial dispatch entirely (build returns None).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from volcano_tpu_torch.api import objects
from volcano_tpu_torch.scheduler import conf as conf_mod

# plugins whose victim fns have batch twins below; anything else => serial
VECTORIZED = frozenset({"gang", "drf", "proportion", "conformance"})

_FLAGS = {
    "preemptable": "enabled_preemptable",
    "reclaimable": "enabled_reclaimable",
}


def build(ssn, kind: str) -> Optional["VictimSelector"]:
    """A batched selector for ``kind`` in {"preemptable", "reclaimable"},
    or None when the session's registered victim fns cannot be batched."""
    fns = ssn.preemptable_fns if kind == "preemptable" else ssn.reclaimable_fns
    if any(name not in VECTORIZED for name in fns):
        return None
    return VictimSelector(ssn, kind, fns)


class VictimSelector:
    # below this many candidate victims the serial closures win: the numpy
    # fixed overhead (~50us of array building) buys nothing against a
    # handful of dict lookups
    MIN_BATCH = 16

    def __init__(self, ssn, kind: str, fns):
        self.ssn = ssn
        self.kind = kind
        flag = _FLAGS[kind]
        # per-tier registered+enabled plugin names, exactly as
        # session._tier_plugins resolves fns; the first tier with any name
        # decides (candidate lists intersect within it)
        self.tiers: List[List[str]] = []
        for tier in ssn.tiers:
            names = [
                p.name for p in tier.plugins
                if conf_mod.enabled(getattr(p, flag)) and p.name in fns
            ]
            self.tiers.append(names)
        drf = ssn.plugins.get("drf")
        self._drf = drf
        if drf is not None:
            from volcano_tpu_torch.api.resource import (
                MIN_MEMORY, MIN_MILLI_CPU, MIN_MILLI_SCALAR)

            total = drf.total_resource
            self._drf_dims = total.resource_names()
            self._drf_totals = np.array(
                [total.get(rn) for rn in self._drf_dims], np.float64)
            # per-dim epsilon for the underflow watchdog (see
            # _cumulative_shares): a cumulative subtraction that the serial
            # clone's Resource.sub assert would flag
            self._drf_eps = np.array(
                [MIN_MILLI_CPU if rn == "cpu" else
                 MIN_MEMORY if rn == "memory" else MIN_MILLI_SCALAR
                 for rn in self._drf_dims], np.float64)

    # -- public ------------------------------------------------------------

    def victims(self, claimer, claimees: List) -> List:
        if len(claimees) < self.MIN_BATCH:
            return self._serial(claimer, claimees)
        # exact session._victims shape: within-tier intersection keyed by
        # uid, first fn's ORDER (and any duplicate entries the drf
        # namespace/job double-append produces) preserved; first tier with
        # any registered fn decides
        for names in self.tiers:
            victims: Optional[List] = None
            for name in names:
                candidates = self._plugin_victims(name, claimer, claimees)
                if victims is None:
                    victims = candidates
                else:
                    cand_uids = {c.uid for c in candidates}
                    victims = [v for v in victims if v.uid in cand_uids]
            if victims is not None:
                return victims
        return []

    def _serial(self, claimer, claimees):
        if self.kind == "preemptable":
            return self.ssn.preemptable(claimer, claimees)
        return self.ssn.reclaimable(claimer, claimees)

    # -- per-plugin batch twins --------------------------------------------

    def _plugin_victims(self, name: str, claimer, claimees) -> List:
        if name == "drf":
            return self._drf_victims(claimer, claimees)
        if name == "gang":
            mask = self._gang_mask(claimees)
        elif name == "conformance":
            mask = self._conformance_mask(claimees)
        elif name == "proportion":
            mask = self._proportion_mask(claimees)
        else:
            raise AssertionError(name)  # build() gated on VECTORIZED
        return [c for c, ok in zip(claimees, mask) if ok]

    def _gang_mask(self, claimees) -> np.ndarray:
        """gang.go:82-86: victim only while its gang stays intact — a
        per-job occupancy budget decremented per nominated victim, so one
        call nominates at most (ready - minAvailable) victims per gang
        (minAvailable == 1 gangs are unbudgeted, as in the serial fn)."""
        jobs = self.ssn.jobs
        budget = {}
        out = np.empty(len(claimees), bool)
        for i, c in enumerate(claimees):
            state = budget.get(c.job)
            if state is None:
                job = jobs.get(c.job)
                if job is None:
                    state = (0, False)
                else:
                    state = (job.ready_task_num() - job.min_available,
                             job.min_available == 1)
            remaining, unbudgeted = state
            if unbudgeted:
                out[i] = True
            elif remaining > 0:
                out[i] = True
                remaining -= 1
            else:
                out[i] = False
            budget[c.job] = (remaining, unbudgeted)
        return out

    def _conformance_mask(self, claimees) -> np.ndarray:
        out = np.empty(len(claimees), bool)
        for i, c in enumerate(claimees):
            cls = c.pod.spec.priority_class_name if c.pod else ""
            out[i] = not (
                cls in (objects.SYSTEM_CLUSTER_CRITICAL,
                        objects.SYSTEM_NODE_CRITICAL)
                or c.namespace == "kube-system")
        return out

    def _cumulative_shares(self, claimees, group_of, base_alloc) -> np.ndarray:
        """Dominant shares of per-group allocations after subtracting each
        claimee's request cumulatively IN CLAIMEE ORDER (the serial fns
        mutate one clone per group as they walk). base_alloc maps group
        index -> Resource. Returns [k] shares, floored at 0.0 exactly like
        _calculate_share's `s > res` accumulation."""
        dims = self._drf_dims
        totals = self._drf_totals
        k = len(claimees)
        gidx = np.asarray(group_of, np.int64)
        reqs = np.empty((k, len(dims)), np.float64)
        for i, c in enumerate(claimees):
            r = c.resreq
            for d, rn in enumerate(dims):
                reqs[i, d] = r.get(rn)
        base = np.empty((len(base_alloc), len(dims)), np.float64)
        for g, alloc in enumerate(base_alloc):
            for d, rn in enumerate(dims):
                base[g, d] = alloc.get(rn)

        # per-group LEFT-FOLD subtraction in claimee order via
        # np.subtract.accumulate — bit-identical to the serial clone's
        # sequential .sub chain (a plain cumsum would reassociate the
        # floating-point ops and could flip near-SHARE_DELTA verdicts)
        order = np.argsort(gidx, kind="stable")
        gid_s = gidx[order]
        seg_start = np.empty(k, bool)
        seg_start[0] = True
        seg_start[1:] = gid_s[1:] != gid_s[:-1]
        starts = np.nonzero(seg_start)[0]
        ends = np.append(starts[1:], k)
        r_alloc = np.empty((k, len(dims)), np.float64)
        for s, e in zip(starts, ends):
            rows = order[s:e]
            arr = np.empty((e - s + 1, len(dims)), np.float64)
            arr[0] = base[gid_s[s]]
            arr[1:] = reqs[rows]
            r_alloc[rows] = np.subtract.accumulate(arr, axis=0)[1:]

        shares = np.where(
            totals[None, :] == 0,
            np.where(r_alloc == 0, 0.0, 1.0),
            r_alloc / np.where(totals[None, :] == 0, 1.0, totals[None, :]))
        # underflow watchdog: an allocation driven below -eps means the
        # serial clone's Resource.sub assert would have flagged this walk
        underflow = bool((r_alloc <= -self._drf_eps[None, :]).any())
        return np.maximum(shares.max(axis=1), 0.0), underflow

    def _drf_victims(self, claimer, claimees) -> List:
        """drf.go:120-201 (drf.py preemptable_fn), vectorized — including
        the weighted-namespace branch and its serial quirks: a cross-
        namespace claimee judged a namespace victim is ALSO carried into
        the undecided list (and may be appended a second time by the job
        branch), and each namespace/job clone decreases cumulatively in
        claimee order regardless of the verdicts."""
        from volcano_tpu_torch.scheduler.plugins.drf import SHARE_DELTA
        from volcano_tpu_torch.utils.assertions import panic_enabled

        drf = self._drf
        ssn = self.ssn
        victims: List = []
        underflow = False

        if drf.namespace_opts:
            l_ns_info = ssn.namespace_info.get(claimer.namespace)
            l_weight = l_ns_info.get_weight() if l_ns_info else 1
            l_ns_att = drf.namespace_opts[claimer.namespace]
            l_alloc = l_ns_att.allocated.clone().add(claimer.resreq)
            _, l_share = drf._calculate_share(l_alloc, drf.total_resource)
            l_weighted = l_share / l_weight

            cross_idx = [i for i, c in enumerate(claimees)
                         if c.namespace != claimer.namespace]
            if cross_idx:
                cross = [claimees[i] for i in cross_idx]
                ns_ids: dict = {}
                group_of = []
                for c in cross:
                    group_of.append(ns_ids.setdefault(c.namespace, len(ns_ids)))
                base = [None] * len(ns_ids)
                for ns, g in ns_ids.items():
                    base[g] = drf.namespace_opts[ns].allocated
                r_share, uf = self._cumulative_shares(cross, group_of, base)
                underflow |= uf
                weights = np.array([
                    (ssn.namespace_info[c.namespace].get_weight()
                     if c.namespace in ssn.namespace_info else 1)
                    for c in cross], np.float64)
                r_weighted = r_share / weights
                ns_victim = l_weighted < r_weighted
                decided = (l_weighted - r_weighted) > SHARE_DELTA
                victims.extend(c for c, v in zip(cross, ns_victim) if v)
                drop = {cross_idx[i] for i in np.nonzero(decided)[0]}
                undecided = [c for i, c in enumerate(claimees) if i not in drop]
            else:
                undecided = list(claimees)
        else:
            undecided = claimees

        if undecided:
            l_att = drf.job_attrs[claimer.job]
            l_alloc = l_att.allocated.clone().add(claimer.resreq)
            _, ls = drf._calculate_share(l_alloc, drf.total_resource)
            job_ids: dict = {}
            group_of = []
            for c in undecided:
                group_of.append(job_ids.setdefault(c.job, len(job_ids)))
            base = [None] * len(job_ids)
            for uid, g in job_ids.items():
                base[g] = drf.job_attrs[uid].allocated
            rs, uf = self._cumulative_shares(undecided, group_of, base)
            underflow |= uf
            ok = (ls < rs) | (np.abs(ls - rs) <= SHARE_DELTA)
            victims.extend(c for c, v in zip(undecided, ok) if v)
        if underflow and panic_enabled():
            # the serial clone walk would raise AssertionViolation at the
            # offending claimee; replay it so panic mode fails identically
            # loudly instead of the batch path masking a broken invariant
            fns = (self.ssn.preemptable_fns if self.kind == "preemptable"
                   else self.ssn.reclaimable_fns)
            return fns["drf"](claimer, claimees)
        return victims

    def _proportion_mask(self, claimees) -> np.ndarray:
        """proportion.go:174-199 deserved-floor walk. The conditional skip
        (a victim whose request exceeds the remaining queue allocation does
        NOT consume it) makes this a true sequential scan; replayed with
        the real Resource epsilon arithmetic per queue — same cost as the
        serial fn, kept here so proportion composes with batched tiers."""
        prop = self.ssn.plugins["proportion"]
        jobs = self.ssn.jobs
        allocations = {}
        out = np.zeros(len(claimees), bool)
        for i, c in enumerate(claimees):
            job = jobs.get(c.job)
            if job is None:
                continue
            attr = prop.queue_opts[job.queue]
            allocated = allocations.get(job.queue)
            if allocated is None:
                allocated = allocations[job.queue] = attr.allocated.clone()
            if allocated.less(c.resreq):
                continue
            allocated.sub(c.resreq)
            out[i] = attr.deserved.less_equal(allocated)
        return out
