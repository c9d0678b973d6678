"""Dense (preemptor x node) view for preempt/reclaim acceleration.

The serial preempt/reclaim hot loop (reference
pkg/scheduler/actions/preempt/preempt.go:180-260, reclaim.go:42-202) pays
O(nodes) Python predicate closures + O(nodes) score closures PER preemptor
task before it ever looks at victims. This view batches exactly that part —
per-signature static feasibility rows and vectorized numpy scoring over the
same matrices the TPU encoder ships (ops/encoder.py) — while the victim
selection, Statement evict/pipeline, and commit/rollback authority stay on
the host, unchanged (SURVEY.md §7 "Preempt/reclaim on TPU": device/batch
proposes, host commits).

Bit-parity with the serial path is preserved:
- the round-robin sampling window (scheduler_helper.predicate_nodes) is
  replicated including its shared cross-action cursor;
- candidate order is the stable descending-score order of
  prioritize_nodes + sort_nodes (ties keep circular visit order);
- scores use the same floor/weight arithmetic as the serial plugins (the
  formulas fused_scores mirrors, numpy instead of jnp);
- anything the view does not model (preemptor pod affinity / host ports,
  resident required anti-affinity symmetry, custom plugins) returns None
  and the caller runs the serial sweep for that task or session.

State tracking: within preempt/reclaim, node `used`/pod-count change ONLY on
pipeline (evict flips a task to RELEASING, which keeps `used` and the task
map entry — node_info.add_task/remove_task), so the actions report
pipeline/un-pipeline events and the view updates two vectors.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from volcano_tpu_torch.api.resource import (
    MIN_MEMORY,
    MIN_MILLI_CPU,
    MIN_MILLI_SCALAR,
)
from volcano_tpu_torch.ops import encoder as enc_mod
from volcano_tpu_torch.scheduler import conf
from volcano_tpu_torch.scheduler.plugins import nodeorder as nodeorder_mod
from volcano_tpu_torch.scheduler.plugins import predicates as predicates_mod
from volcano_tpu_torch.scheduler.util import scheduler_helper as helper

MAX_PRIORITY = nodeorder_mod.MAX_PRIORITY


def build(ssn) -> Optional["DensePreemptView"]:
    """A view over the session, or None when the session uses constructs the
    dense rows cannot model (the caller then runs fully serial).

    The view is built ONCE per session and shared by backfill/preempt/
    reclaim: every mutation those actions perform is routed through the
    view's on_(un)pipeline hooks, so the shared instance tracks exactly the
    state a fresh build would capture — and its per-class score/eligibility
    caches stay warm across the actions. (The allocate-residue variant
    below tracks extra state and is NOT shared.)"""
    if getattr(ssn, "batch_allocator", None) is None:
        return None  # tpuscore off => bit-identical serial behavior
    cached = getattr(ssn, "_dense_preempt_view", False)
    if cached is not False:
        # a placement the view was not notified of (another action ran in
        # between — e.g. a conf ordering allocate after preempt) makes the
        # cached used/pod-count state stale: rebuild. Unsupported (None)
        # stays unsupported — residents only accumulate within a session.
        if cached is None or cached._synced_gen == ssn._placement_gen:
            return cached
    try:
        view = DensePreemptView(ssn)
    except _Unsupported:
        view = None
    ssn._dense_preempt_view = view
    return view


def build_alloc_assist(ssn) -> Optional["DensePreemptView"]:
    """Allocate-residue variant: tolerates resident pods with REQUIRED
    (anti-)affinity terms (feasibility comes from the live residual chain,
    not cached masks) and additionally tracks node idle/releasing for the
    vectorized resource-fit window. None => fully serial residue pass."""
    if getattr(ssn, "batch_allocator", None) is None:
        return None
    try:
        return DensePreemptView(ssn, for_allocate=True)
    except _Unsupported:
        return None


class _Unsupported(Exception):
    pass


def _window_sel(idx: np.ndarray, rr: int, num_to_find: int, n: int):
    """The round-robin sampling window over the sorted eligible-node index
    array: (sel, processed) exactly as predicate_nodes' circular visit
    computes it. ONE definition — the candidates() fast/fallback paths and
    the C twin (fasttrans.c pick_first) all mirror this arithmetic."""
    split = int(np.searchsorted(idx, rr))
    found_total = idx.size
    if found_total >= num_to_find:
        # circular visit order: tail from split, then wrap; slicing views
        # the cached array (no copy) in the common no-wrap case
        take_tail = min(num_to_find, found_total - split)
        sel = idx[split:split + take_tail]
        if take_tail < num_to_find:
            sel = np.concatenate([sel, idx[: num_to_find - take_tail]])
        processed = (int(sel[-1]) - rr) % n + 1
    else:
        sel = np.concatenate([idx[split:], idx[:split]]) if split else idx
        processed = n
    return sel, processed


class DensePreemptView:
    def __init__(self, ssn, for_allocate: bool = False):
        self.ssn = ssn
        self.for_allocate = for_allocate

        # capability gates mirror the encoder's: only the stock predicates /
        # nodeorder / binpack contribute to the vectorized rows
        predicates_on = enc_mod._enabled_plugins(
            ssn, "enabled_predicate", ssn.predicate_fns)
        if any(p not in enc_mod.SUPPORTED_PREDICATES for p in predicates_on):
            raise _Unsupported(predicates_on)
        node_order = enc_mod._enabled_plugins(
            ssn, "enabled_node_order", ssn.node_order_fns)
        if any(p not in enc_mod.SUPPORTED_NODE_ORDER for p in node_order):
            raise _Unsupported(node_order)
        batch_order = enc_mod._enabled_plugins(
            ssn, "enabled_node_order", ssn.batch_node_order_fns)
        if any(p not in ("nodeorder",) for p in batch_order):
            raise _Unsupported(batch_order)
        if ssn.node_map_fns or ssn.node_reduce_fns:
            raise _Unsupported("node map/reduce fns")
        self.check_pod_count = bool(predicates_on)

        self.node_names = sorted(ssn.nodes)
        self.nodes: List = [ssn.nodes[n] for n in self.node_names]
        n = len(self.nodes)
        self.n = n

        # resident pods with (anti-)affinity make candidate masks/scores
        # depend on pairwise label matching: anti-affinity symmetry changes
        # feasibility, and PREFERRED pod_affinity terms feed nodeorder's
        # InterPodAffinity batch score. Preempt/reclaim/backfill views fall
        # back entirely (their cached masks would go stale); the allocate
        # assist tolerates REQUIRED-only terms — feasibility is re-checked
        # live by the residual chain per candidate — and bails only when a
        # resident's preferred terms could move the batch score
        batch_on = "nodeorder" in batch_order
        self._batch_on = batch_on
        for node in self.nodes:
            for t in node.tasks.values():
                pod = t.pod
                if pod is not None and pod.spec.affinity is not None and (
                        pod.spec.affinity.pod_affinity is not None
                        or pod.spec.affinity.pod_anti_affinity is not None):
                    if not for_allocate:
                        raise _Unsupported("resident pod (anti-)affinity")
                    aff = pod.spec.affinity
                    if batch_on and (
                            (aff.pod_affinity is not None
                             and aff.pod_affinity.preferred_terms)
                            or (aff.pod_anti_affinity is not None
                                and aff.pod_anti_affinity.preferred_terms)):
                        raise _Unsupported(
                            "resident preferred pod-affinity terms")

        # resource axis: cpu/memory + scalars seen on nodes OR requested by
        # pending tasks — a requested-but-absent scalar must still sit in
        # the binpack weight sum with zero contribution, exactly like the
        # serial plugin's capacity-0 dimension (binpack.go:249-261)
        scalars: set = set()
        for node in self.nodes:
            if node.allocatable.scalar_resources:
                scalars.update(node.allocatable.scalar_resources)
        from volcano_tpu_torch.api.types import TaskStatus

        for job in ssn.jobs.values():
            for t in job.task_status_index.get(TaskStatus.PENDING, {}).values():
                if t.resreq.scalar_resources:
                    scalars.update(t.resreq.scalar_resources)
        self.rnames = ["cpu", "memory", *sorted(scalars)]
        R = len(self.rnames)

        def mat(attr: str) -> np.ndarray:
            m = np.zeros((n, R), np.float64)
            ress = [getattr(nd, attr) for nd in self.nodes]
            m[:, 0] = [r.milli_cpu for r in ress]
            m[:, 1] = [r.memory for r in ress]
            for si, rn in enumerate(self.rnames[2:], start=2):
                m[:, si] = [(r.scalar_resources or {}).get(rn, 0.0) for r in ress]
            return m

        self.alloc = mat("allocatable")
        self.used = mat("used")
        if for_allocate:
            # exact mirrors of node.idle / node.releasing, updated by the
            # alloc hooks with the same per-dim +=/-= sequence Resource
            # arithmetic performs, so verdicts stay bit-identical
            self.idle = mat("idle")
            self.rel = mat("releasing")
            self._eps = np.array(
                [MIN_MILLI_CPU, MIN_MEMORY]
                + [MIN_MILLI_SCALAR] * (len(self.rnames) - 2),
                np.float64)
            self._is_scalar = np.array(
                [False, False] + [True] * (len(self.rnames) - 2))
        self.cnt = np.array([len(nd.tasks) for nd in self.nodes], np.int64)
        self.max_tasks = np.array(
            [nd.allocatable.max_task_num for nd in self.nodes], np.int64)

        # static node predicate parts (conditions/unschedulable/pressure)
        # with the predicates plugin absent the serial predicate chain is
        # EMPTY (every node feasible) — selector/taint/condition masking
        # must then be skipped entirely, not just the pressure checks
        self.predicates_on = bool(predicates_on)
        pred_args = enc_mod._plugin_args(ssn, "predicates")
        memory_p = pred_args.get_bool(predicates_mod.MEMORY_PRESSURE_PREDICATE, False)
        disk_p = pred_args.get_bool(predicates_mod.DISK_PRESSURE_PREDICATE, False)
        pid_p = pred_args.get_bool(predicates_mod.PID_PRESSURE_PREDICATE, False)
        self._node_ok = np.array([
            enc_mod._static_node_ok(nd, memory_p, disk_p, pid_p)
            for nd in self.nodes]) if predicates_on else np.ones(n, bool)

        # score weights (same sourcing as the encoder)
        self.use_nodeorder = "nodeorder" in node_order
        no_args = enc_mod._plugin_args(ssn, "nodeorder")
        self.least_req_w = float(no_args.get_int(nodeorder_mod.LEAST_REQUESTED_WEIGHT, 1))
        self.balanced_w = float(no_args.get_int(nodeorder_mod.BALANCED_RESOURCE_WEIGHT, 1))
        self.node_aff_w = float(no_args.get_int(nodeorder_mod.NODE_AFFINITY_WEIGHT, 1))
        self.use_binpack = "binpack" in node_order
        self.binpack_weight = 0.0
        self.binpack_w = np.zeros(R, np.float64)
        if self.use_binpack:
            bp = ssn.plugins.get("binpack")
            w = bp.weight
            if w.binpacking_weight == 0:
                self.use_binpack = False
            else:
                self.binpack_weight = float(w.binpacking_weight)
                for ri, rn in enumerate(self.rnames):
                    if rn == "cpu":
                        self.binpack_w[ri] = w.binpacking_cpu
                    elif rn == "memory":
                        self.binpack_w[ri] = w.binpacking_memory
                    elif rn in w.binpacking_resources:
                        self.binpack_w[ri] = w.binpacking_resources[rn]

        # session placement generation this view is synced to: captured at
        # build, advanced by each hook notification. build() compares it
        # to ssn._placement_gen — equality proves every placement-shaped
        # mutation since build was routed through the hooks
        self._synced_gen = getattr(ssn, "_placement_gen", 0)
        # native candidate-head pick (fasttrans.c pick_first); None keeps
        # the pure-Python window selection
        from volcano_tpu_torch import _native

        _mod = _native.get_fasttrans_nowait()
        self._pick_first = getattr(_mod, "pick_first", None) \
            if _mod is not None else None
        self._sig_mask: Dict[str, np.ndarray] = {}
        self._sig_aff: Dict[str, Optional[np.ndarray]] = {}
        self._node_idx = {name: i for i, name in enumerate(self.node_names)}
        # pod-count feasibility cached; invalidated only by on_(un)pipeline
        self._cnt_ok = self.cnt < self.max_tasks
        self._poisoned = False
        # per-class cached [N] score rows: scores depend only on (class,
        # node used-state) and used changes ONE node per pipeline, so each
        # row replays the touched-node log instead of recomputing N scores
        # per preemptor. _touched grows by ~1 per pipeline; rows sync
        # lazily. A key is only PROMOTED to a full cached row on its second
        # sighting (heterogeneous one-off requests would otherwise pay
        # full-N scoring for zero hits), and the cache is bounded.
        self._score_rows: Dict[tuple, list] = {}  # key -> [row, sync_pos]
        self._seen_keys: set = set()
        self._touched: List[int] = []
        # per-(signature, pod-count-applies) cached SORTED eligible-node
        # index arrays; same touched-log replay discipline as _score_rows.
        # Eligibility moves only when a pipeline flips a node's pod-count
        # headroom, so each repair touches ~1 node instead of re-running
        # mask & cnt_ok + nonzero over N per candidate stream.
        self._elig_rows: Dict[tuple, list] = {}  # key -> [idx, sync_pos]

    _SCORE_ROW_CAP = 256  # distinct promoted classes per action
    _ELIG_ROW_CAP = 256

    def poison(self) -> None:
        """A pod with (anti-)affinity was PLACED by the serial fallback
        mid-action: resident-affinity state now affects every later task's
        feasibility/score (the predicates plugin tracks it via allocate
        events), so the view retires and the rest of the action runs fully
        serial. Callers gate on needs_poison — a resident host-ports-only
        pod constrains only ports-carrying candidates, which already fall
        back serially."""
        self._poisoned = True

    def poison_state(self) -> bool:
        """Opaque snapshot for restore_poison (statement-scoped save)."""
        return self._poisoned

    def restore_poison(self, state: bool) -> None:
        """Statement discard: un-does any poison raised inside the
        statement (the un-modeled pod is resident no longer). Kept as a
        method so future poison side effects restore in one place."""
        self._poisoned = state

    @staticmethod
    def needs_poison(task) -> bool:
        """True when placing `task` invalidates cached masks/scores for
        OTHER tasks (it carries pod (anti-)affinity terms)."""
        from volcano_tpu_torch.api.pod_traits import has_pod_affinity

        return has_pod_affinity(task.pod)

    # -- per-signature static rows ----------------------------------------

    def _rows(self, task) -> Optional[Tuple[str, np.ndarray, Optional[np.ndarray]]]:
        if self._poisoned:
            return None
        pod = task.pod
        if pod is None:
            # podless tasks pass the whole predicate chain (predicates.py
            # early-return); preferred-affinity score is zero
            ones = self._sig_mask.get("<none>")
            if ones is None:
                ones = self._sig_mask["<none>"] = np.ones(self.n, bool)
                self._sig_aff["<none>"] = None
            return "<none>", ones, None
        key, ports, aff = enc_mod._pod_encode_traits(pod)
        if (ports or aff) and not self.for_allocate:
            # preempt/reclaim/backfill views have no residual hook — the
            # serial sweep handles traited tasks; the allocate assist
            # checks ports/affinity live per candidate instead
            return None
        mask = self._sig_mask.get(key)
        if mask is None:
            if self.predicates_on:
                row = np.array([
                    predicates_mod.pod_matches_node_selector(pod, nd)
                    and predicates_mod.tolerates_taints(pod, nd)
                    for nd in self.nodes])
                mask = self._node_ok & row
            else:
                mask = np.ones(self.n, bool)
            self._sig_mask[key] = mask
            na = pod.spec.affinity.node_affinity if pod.spec.affinity else None
            if self.use_nodeorder and na is not None and na.preferred_terms:
                self._sig_aff[key] = np.array([
                    nodeorder_mod.node_affinity_score(task, nd)
                    for nd in self.nodes], np.float64)
            else:
                self._sig_aff[key] = None
        return key, mask, self._sig_aff[key]

    # -- scoring (numpy mirror of kernels.fused_scores) --------------------

    def _row_key(self, task):
        res = task.resreq
        return (
            enc_mod._pod_encode_traits(task.pod)[0] if task.pod is not None
            else "<none>",
            res.milli_cpu, res.memory,
            tuple(sorted((res.scalar_resources or {}).items())),
        )

    def _score_row_full(self, task, aff: Optional[np.ndarray],
                        key=None, register: bool = False
                        ) -> Optional[np.ndarray]:
        """The class's repaired FULL [N] score row, or None when the class
        is not promoted to a cached row (first sighting / cache full).
        ``register`` marks a first sighting as seen (promotion happens on
        the SECOND sighting) — native-path PEEKS must leave it False, or a
        probe would spend a promotion on a class the windowed path was
        about to score once and never see again. Lazily replays recomputes
        for nodes touched by pipelines since last sync; callers must treat
        the row as read-only."""
        if key is None:
            key = self._row_key(task)
        cached = self._score_rows.get(key)
        touched = self._touched
        if cached is None:
            if (key not in self._seen_keys
                    or len(self._score_rows) >= self._SCORE_ROW_CAP):
                if register:
                    self._seen_keys.add(key)
                return None
            row = self._scores(task, np.arange(self.n), aff)
            self._score_rows[key] = [row, len(touched)]
            return row
        row, sync = cached
        if sync < len(touched):
            stale = sorted(set(touched[sync:]))
            if len(stale) <= 4:
                # scalar replay: numpy's fixed per-op overhead dwarfs the
                # work for 1-2 nodes (the common one-pipeline-per-call case)
                for i in stale:
                    row[i] = self._score_one(task, i, aff)
            else:
                stale_arr = np.asarray(stale, np.int64)
                row[stale_arr] = self._scores(task, stale_arr, aff)
            cached[1] = len(touched)
        return row

    def _score_row(self, task, aff: Optional[np.ndarray],
                   sel: np.ndarray) -> np.ndarray:
        """Scores for the selected nodes, via the class's cached [N] row
        when the class repeats; one-off classes compute only the window."""
        key = self._row_key(task)
        row = self._score_row_full(task, aff, key=key, register=True)
        if row is None:
            return self._scores(task, sel, aff)
        return row[sel]

    def _score_one(self, task, i: int, aff: Optional[np.ndarray]) -> float:
        """Scalar twin of _scores for one node — Python floats are IEEE
        f64, so with the same operation order the result is bit-identical
        to the vectorized path (asserted by tests/test_preemptview.py)."""
        res = task.resreq
        cpu = res.milli_cpu
        mem = res.memory
        nz_cpu = cpu if cpu else nodeorder_mod.DEFAULT_MILLI_CPU_REQUEST
        nz_mem = mem if mem else nodeorder_mod.DEFAULT_MEMORY_REQUEST
        alloc = self.alloc[i]
        used = self.used[i]
        score = 0.0
        if self.use_nodeorder:
            cap_cpu = float(alloc[0]); cap_mem = float(alloc[1])
            want_cpu = float(used[0]) + nz_cpu
            want_mem = float(used[1]) + nz_mem
            d_cpu = ((cap_cpu - want_cpu) * MAX_PRIORITY / (cap_cpu if cap_cpu > 0 else 1.0)
                     if (cap_cpu > 0 and want_cpu <= cap_cpu) else 0.0)
            d_mem = ((cap_mem - want_mem) * MAX_PRIORITY / (cap_mem if cap_mem > 0 else 1.0)
                     if (cap_mem > 0 and want_mem <= cap_mem) else 0.0)
            least = math.floor((d_cpu + d_mem) / 2.0)
            cpu_frac = want_cpu / (cap_cpu if cap_cpu > 0 else 1.0)
            mem_frac = want_mem / (cap_mem if cap_mem > 0 else 1.0)
            balanced = (math.floor(MAX_PRIORITY - abs(cpu_frac - mem_frac) * MAX_PRIORITY)
                        if (cap_cpu > 0 and cap_mem > 0
                            and cpu_frac < 1.0 and mem_frac < 1.0) else 0.0)
            score += least * self.least_req_w + balanced * self.balanced_w
            if aff is not None:
                score += float(aff[i]) * self.node_aff_w
        if self.use_binpack:
            req = [cpu, mem]
            for rn in self.rnames[2:]:
                req.append((res.scalar_resources or {}).get(rn, 0.0))
            w_sum = 0.0
            raw = 0.0
            for ri, r in enumerate(req):
                w = self.binpack_w[ri] if r > 0 else 0.0
                w_sum += w
                a = float(alloc[ri])
                want = r + float(used[ri])
                if a > 0 and want <= a:
                    raw += want * w / a
            if w_sum > 0:
                score += raw / w_sum * MAX_PRIORITY * self.binpack_weight
        return score

    def _scores(self, task, sel: np.ndarray, aff: Optional[np.ndarray]) -> np.ndarray:
        req = np.zeros(len(self.rnames), np.float64)
        req[0] = task.resreq.milli_cpu
        req[1] = task.resreq.memory
        for si, rn in enumerate(self.rnames[2:], start=2):
            req[si] = (task.resreq.scalar_resources or {}).get(rn, 0.0)
        nz_cpu = req[0] if req[0] else nodeorder_mod.DEFAULT_MILLI_CPU_REQUEST
        nz_mem = req[1] if req[1] else nodeorder_mod.DEFAULT_MEMORY_REQUEST

        alloc = self.alloc[sel]
        used = self.used[sel]
        score = np.zeros(len(sel), np.float64)
        if self.use_nodeorder:
            cap_cpu, cap_mem = alloc[:, 0], alloc[:, 1]
            want_cpu = used[:, 0] + nz_cpu
            want_mem = used[:, 1] + nz_mem

            def dim(cap, want):
                ok = (cap > 0) & (want <= cap)
                return np.where(ok, (cap - want) * MAX_PRIORITY
                                / np.where(cap > 0, cap, 1.0), 0.0)

            least = np.floor((dim(cap_cpu, want_cpu) + dim(cap_mem, want_mem)) / 2.0)
            cpu_frac = want_cpu / np.where(cap_cpu > 0, cap_cpu, 1.0)
            mem_frac = want_mem / np.where(cap_mem > 0, cap_mem, 1.0)
            bal_ok = (cap_cpu > 0) & (cap_mem > 0) & (cpu_frac < 1.0) & (mem_frac < 1.0)
            balanced = np.where(
                bal_ok,
                np.floor(MAX_PRIORITY - np.abs(cpu_frac - mem_frac) * MAX_PRIORITY),
                0.0)
            score += least * self.least_req_w + balanced * self.balanced_w
            if aff is not None:
                score += aff[sel] * self.node_aff_w
        if self.use_binpack:
            w_eff = np.where(req > 0, self.binpack_w, 0.0)
            w_sum = w_eff.sum()
            if w_sum > 0:
                want = req[None, :] + used
                ok = (alloc > 0) & (want <= alloc)
                part = np.where(ok, want * w_eff[None, :]
                                / np.where(alloc > 0, alloc, 1.0), 0.0)
                score += part.sum(axis=1) / w_sum * MAX_PRIORITY * self.binpack_weight
        return score

    # -- candidate streams -------------------------------------------------

    def _elig_idx(self, task):
        """(sorted eligible-node index array, aff row) for `task`, or None
        for serial fallback. The index array (signature mask ∧ pod-count
        headroom) is cached per signature and repaired from the touched-node
        log: a pipeline flips eligibility at ONE node, so replaying the log
        beats re-running mask & cnt_ok + nonzero over N per candidate
        stream. Callers must treat the array as read-only."""
        rows = self._rows(task)
        if rows is None:
            return None
        key, mask, aff = rows
        use_cnt = self.check_pod_count and task.pod is not None
        ekey = (key, use_cnt)
        cached = self._elig_rows.get(ekey)
        touched = self._touched
        if cached is None:
            idx = np.nonzero(mask & self._cnt_ok if use_cnt else mask)[0]
            if len(self._elig_rows) < self._ELIG_ROW_CAP:
                self._elig_rows[ekey] = [idx, len(touched)]
            return idx, aff
        idx, sync = cached
        if use_cnt and sync < len(touched):
            stale = sorted(set(touched[sync:]))
            if len(stale) > 32:
                idx = np.nonzero(mask & self._cnt_ok)[0]
            else:
                for i in stale:
                    elig = bool(mask[i]) and bool(self._cnt_ok[i])
                    pos = int(np.searchsorted(idx, i))
                    present = pos < idx.size and idx[pos] == i
                    if elig and not present:
                        idx = np.insert(idx, pos, i)
                    elif not elig and present:
                        idx = np.delete(idx, pos)
            cached[0] = idx
        cached[1] = len(touched)
        return idx, aff

    def candidates(self, task):
        """Feasible nodes for `task` in EXACT serial order: the round-robin
        sampling window of predicate_nodes, then sort_nodes's stable
        descending-score order. Returns a LAZY iterator (the consumer
        usually takes the first workable node; materializing a NodeInfo
        list per preemptor is pure overhead). None => serial sweep."""
        rows = self._elig_idx(task)
        if rows is None:
            return None
        idx, aff = rows

        n = self.n
        if n == 0:
            return iter(())
        num_to_find = helper.calculate_num_of_feasible_nodes_to_find(n)
        # reduce the shared cross-cycle cursor mod n up front: after a
        # cluster shrink the raw cursor may exceed n, and predicate_nodes
        # starts at nodes[cursor % n] — the window and the post-advance
        # cursor are identical either way (both arithmetics are mod n)
        rr = helper._last_processed_node_index % n
        nodes = self.nodes

        # native head pick (the depth-1 hot path): C computes the window
        # and its first-max in one pass over the repaired full score row;
        # the Python machinery below stays as the oracle, the no-row /
        # no-native fallback, and the (rare) continuation. The PEEK must
        # not register first sightings (see _score_row_full).
        if self._pick_first is not None and idx.size:
            row = self._score_row_full(task, aff)
            if row is not None:
                best_pos, processed = self._pick_first(
                    idx, row, rr, num_to_find, n)
                helper._last_processed_node_index = (rr + processed) % n
                if best_pos < 0:
                    return iter(())
                head = nodes[int(idx[best_pos])]

                def _stream_native():
                    yield head
                    # continuation: rebuild the exact remainder sequence
                    sel, _ = _window_sel(idx, rr, num_to_find, n)
                    scores = row[sel]
                    first = int(np.argmax(scores))
                    order = np.argsort(-scores, kind="stable")
                    for p in order.tolist():
                        if p != first:
                            yield nodes[int(sel[p])]

                return _stream_native()

        sel, processed = _window_sel(idx, rr, num_to_find, n)
        helper._last_processed_node_index = (rr + processed) % n

        if sel.size == 0:
            return iter(())
        scores = self._score_row(task, aff, sel)

        def _stream():
            # consumers almost always stop at the first workable node, so
            # the head comes from argmax (first occurrence of the max ==
            # head of the stable descending sort) and the full sort is paid
            # only if the consumer keeps going
            first = int(np.argmax(scores))
            yield nodes[int(sel[first])]
            order = np.argsort(-scores, kind="stable")
            for p in order.tolist():
                if p != first:
                    yield nodes[int(sel[p])]

        return _stream()

    def masked_nodes_in_name_order(self, task):
        """Reclaim/backfill candidate stream: feasible nodes in name order
        (the serial walks iterate all nodes; no scoring, no sampling
        window — ascending node index IS name order, node_names is sorted).
        Returns a LAZY iterator — backfill normally consumes one element.
        None => serial fallback."""
        rows = self._elig_idx(task)
        if rows is None:
            return None
        return map(self.nodes.__getitem__, rows[0])

    # -- state updates (pipeline is the only op that moves `used`/cnt) -----

    def _node_delta(self, node_name: str, task, sign: int) -> None:
        self._synced_gen += 1
        i = self._node_idx.get(node_name)
        if i is None:
            return
        self.used[i, 0] += sign * task.resreq.milli_cpu
        self.used[i, 1] += sign * task.resreq.memory
        for si, rn in enumerate(self.rnames[2:], start=2):
            self.used[i, si] += sign * (task.resreq.scalar_resources or {}).get(rn, 0.0)
        self.cnt[i] += sign
        self._cnt_ok[i] = self.cnt[i] < self.max_tasks[i]
        self._touched.append(i)

    def on_pipeline(self, node_name: str, task) -> None:
        self._node_delta(node_name, task, 1)

    def on_unpipeline(self, node_name: str, task) -> None:
        self._node_delta(node_name, task, -1)

    # -- allocate-assist surface (for_allocate views only) -----------------

    def _req_vec(self, res) -> np.ndarray:
        v = np.zeros(len(self.rnames), np.float64)
        v[0] = res.milli_cpu
        v[1] = res.memory
        for si, rn in enumerate(self.rnames[2:], start=2):
            v[si] = (res.scalar_resources or {}).get(rn, 0.0)
        return v

    def alloc_best_node(self, task, residual=None):
        """Serial-parity predicate window + prioritize + select for the
        allocate residue pass: the round-robin window over nodes passing
        signature mask ∧ pod-count ∧ epsilon resource fit (idle OR
        releasing) ∧ the live `residual` check (ports/affinity), then the
        cached score rows and select_best_node's max-score/min-name pick.

        Returns the chosen NodeInfo, or None when the caller must run the
        legacy sweep — unsupported task, or ZERO feasible nodes (the
        cursor is left unadvanced then; the legacy rerun advances it by
        exactly the full circle, which is what the serial path does)."""
        if not self.for_allocate or self._poisoned:
            return None
        pod = task.pod
        if pod is not None and self._batch_on and pod.spec.affinity is not None:
            aff = pod.spec.affinity
            if ((aff.pod_affinity is not None
                 and aff.pod_affinity.preferred_terms)
                    or (aff.pod_anti_affinity is not None
                        and aff.pod_anti_affinity.preferred_terms)):
                return None  # incoming preferred terms move the batch score
        res = self._elig_idx(task)
        if res is None:
            return None
        idx, aff_row = res
        n = self.n
        if n == 0 or idx.size == 0:
            return None
        # epsilon resource fit (Resource.less_equal arithmetic) against
        # idle OR releasing, vectorized over the sig∧cnt-eligible subset
        req = self._req_vec(task.init_resreq)
        skip = self._is_scalar & (req <= MIN_MILLI_SCALAR)
        fit_idle = ((req[None, :] < self.idle[idx] + self._eps[None, :])
                    | skip[None, :]).all(axis=1)
        fit_rel = ((req[None, :] < self.rel[idx] + self._eps[None, :])
                   | skip[None, :]).all(axis=1)
        cand = idx[fit_idle | fit_rel]
        if cand.size == 0:
            return None
        num_to_find = helper.calculate_num_of_feasible_nodes_to_find(n)
        rr = helper._last_processed_node_index % n
        split = int(np.searchsorted(cand, rr))
        if residual is None:
            total = cand.size
            if total >= num_to_find:
                take_tail = min(num_to_find, total - split)
                found = cand[split:split + take_tail]
                if take_tail < num_to_find:
                    found = np.concatenate(
                        [found, cand[: num_to_find - take_tail]])
                processed = (int(found[-1]) - rr) % n + 1
            else:
                found = np.concatenate([cand[split:], cand[:split]]) \
                    if split else cand
                processed = n
        else:
            nodes = self.nodes
            found_l = []
            last = -1
            for i in np.concatenate([cand[split:], cand[:split]]).tolist():
                if residual(nodes[i]):
                    found_l.append(i)
                    if len(found_l) >= num_to_find:
                        last = i
                        break
            if not found_l:
                return None  # cursor untouched; legacy does the full scan
            processed = ((last - rr) % n + 1) if last >= 0 else n
            found = np.asarray(found_l, np.int64)
        if found.size == 0:
            return None
        helper._last_processed_node_index = (rr + processed) % n
        scores = self._score_row(task, aff_row, found)
        m = scores.max()
        best = int(found[scores == m].min())  # select_best_node tie-break
        return self.nodes[best]

    def _alloc_delta(self, node_name: str, task, sign: int,
                     pipelined: bool) -> None:
        self._synced_gen += 1
        i = self._node_idx.get(node_name)
        if i is None:
            return
        req = self._req_vec(task.resreq)
        if pipelined:
            self.rel[i] -= sign * req  # placement onto releasing capacity
        else:
            self.idle[i] -= sign * req
        self.used[i] += sign * req
        self.cnt[i] += sign
        self._cnt_ok[i] = self.cnt[i] < self.max_tasks[i]
        self._touched.append(i)

    def on_allocate(self, node_name: str, task) -> None:
        self._alloc_delta(node_name, task, 1, pipelined=False)

    def on_unallocate(self, node_name: str, task) -> None:
        self._alloc_delta(node_name, task, -1, pipelined=False)

    def on_pipeline_alloc(self, node_name: str, task) -> None:
        self._alloc_delta(node_name, task, 1, pipelined=True)

    def on_unpipeline_alloc(self, node_name: str, task) -> None:
        self._alloc_delta(node_name, task, -1, pipelined=True)
