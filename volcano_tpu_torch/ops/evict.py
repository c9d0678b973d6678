"""Batched eviction, host half: preempt/reclaim/backfill as one device
dispatch each, on PyTorch and CUDA.

Port of the host half of volcano_tpu/ops/evict.py: the op-log constants
and ``EvictSpec``, the envelope gates (``build``), the dense encode of a
session into the action arrays (``_EvictPlan``, ``_BackfillPlan``), and
the replay of a fetched result through the real Statement/session
mutators (``consume``, ``_replay``). The device half, the three state
machines, lives in ops/evict_kernels.py: K9 preempt, K10 reclaim and K11
backfill, each a hand-written CUDA kernel (csrc/evict_*.cu) with its
plain PyTorch version beside the wrapper.

The contract is the reference's: the machine replays the serial control
flow exactly (per-queue job heaps with heapq sift mechanics under live
keys, round-robin candidate windows with fused scores, tiered victim
masks, the eviction cuts, statement commit/discard as an append/rewind op
log whose discard replays inverse float ops in reverse order) and returns
one packed int32 array, the op log and a 6-wide tail. The host fetches it
once and applies the committed ops in serial order, so events, cache
effectors, SnapshotKeeper dirty-sets and metrics see what the serial walk
would have produced. A machine that runs out of its step or log budget
(``fail``), or underflows a share under panic mode, applies nothing and
the action runs its serial walk (``VOLCANO_TPU_EVICT=0`` forces that walk
as the parity oracle). A build or launch failure raises.

Outside the envelope ``build`` returns None and the serial walk runs:

- scalar resource dimensions (R > 2) — the Resource nil-map comparison
  asymmetries are not mirrored;
- victim fns outside {gang, conformance, drf, proportion}, weighted-
  namespace drf, job-order plugins outside {priority, gang, drf},
  non-gang job_pipelined fns, custom task-order comparators;
- preemptor/backfill tasks carrying host ports or pod (anti-)affinity,
  or a session the dense view itself cannot model.

Exactness holds under float64 (the CPU tests); float32 on the card shares
the allocate solver's documented approximation caveat.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from volcano_tpu_torch.api.resource import MIN_MEMORY, MIN_MILLI_CPU
from volcano_tpu_torch.api.types import TaskStatus
from volcano_tpu_torch.ops.solver import _bucket
from volcano_tpu_torch.scheduler import conf as conf_mod
from volcano_tpu_torch.scheduler.plugins import nodeorder as nodeorder_mod

logger = logging.getLogger(__name__)

# op log kinds (packed int32 rows [kind, a, b])
# OP_EVICT carries (node, slot) as separate columns: the flat
# node * V + slot encoding overflows int32 once NODES_PAD * V_WIDTH
# crosses 2^31 (cfg7 x victim-bucket extents reach ~6.6e9)
OP_EVICT = 0      # a = node, b = slot
OP_PIPELINE = 1   # a = preemptor task index, b = node
OP_COMMIT = 2     # statement commit marker (preempt only)

# packed result tail: [log_len, rr, victims_total, attempts_total,
#                      fail, underflow]
TAIL = 6

VECTORIZED_VICTIM_FNS = frozenset(
    {"gang", "conformance", "drf", "proportion"})
SUPPORTED_JOB_ORDER = ("priority", "gang", "drf")

# preempt machine modes
M_QUEUE, M_POP_JOB, M_TASK, M_STMT_END, M_UNDER, M_DONE = 0, 1, 2, 3, 4, 5


class EvictSpec(NamedTuple):
    """Static eviction-solve configuration (the reference's jit key
    fields); every churny count lives in bucketed array shapes."""

    kind: str                    # "preempt" | "reclaim" | "backfill"
    job_order_keys: tuple        # enabled job-order plugins, tier order
    victim_fns: tuple            # deciding-tier victim fn names, tier order
    check_pod_count: bool
    use_nodeorder: bool
    use_binpack: bool
    use_gang_pipelined: bool
    use_prop_overused: bool = False
    use_prop_queue_order: bool = False


class _Unsupported(Exception):
    pass


# ---------------------------------------------------------------------------
# host: capability gates + session -> dense encode
# ---------------------------------------------------------------------------


def _solve(ssn, spec: EvictSpec, arrays) -> np.ndarray:
    """Stage an action's arrays on the session's device (one copy per
    dtype class, solver.from_numpy_encoded), run its machine
    (ops/evict_kernels.solve_packed: K9/K10/K11) and fetch the packed
    int32 result once."""
    from volcano_tpu_torch.ops import evict_kernels
    from volcano_tpu_torch.ops.solver import from_numpy_encoded
    from volcano_tpu_torch.utils import devprof

    alloc = ssn.batch_allocator
    enc = from_numpy_encoded(arrays, device=alloc.device, dtype=alloc.dtype)
    return devprof.fetch(evict_kernels.solve_packed(spec, enc))


def _profile(ssn) -> dict:
    p = ssn.plugins.get("tpuscore")
    return p.profile if p is not None else {}


def _note_fallback(prof: dict, key: str, reason: str) -> None:
    """Record an honesty fallback in the session profile AND the
    process-wide fallback counter (metrics.register_fallback)."""
    from volcano_tpu_torch.scheduler import metrics

    prof[key + "_fallback"] = reason
    metrics.register_fallback(key)


def _common_view(ssn, view=None):
    if os.environ.get("VOLCANO_TPU_EVICT", "1") == "0":
        raise _Unsupported("VOLCANO_TPU_EVICT=0")
    if getattr(ssn, "batch_allocator", None) is None:
        raise _Unsupported("tpuscore off")
    if view is None:
        from volcano_tpu_torch.ops import preemptview

        view = preemptview.build(ssn)
    if view is None:
        raise _Unsupported("dense view unsupported for this session")
    if len(view.rnames) != 2:
        # the Resource nil-map comparison asymmetries (less/less_equal over
        # scalar dicts) are not mirrored on device; scalar-free sessions are
        # the modeled envelope
        raise _Unsupported("scalar resource dimensions not modeled")
    return view


def _f_dtype(ssn):
    """The host float type of the encode: the tpuscore plugin's dtype."""
    return np.float64 if ssn.batch_allocator.dtype == torch.float64 \
        else np.float32


def _eligible_jobs(ssn):
    """The preempt/reclaim registration filter (preempt.py:55-63), in
    ssn.jobs iteration order."""
    from volcano_tpu_torch.api import objects

    out = []
    for job in ssn.jobs.values():
        if job.pod_group.status.phase == objects.PodGroupPhase.PENDING:
            continue
        vr = ssn.job_valid(job)
        if vr is not None and not vr.pass_:
            continue
        if ssn.queues.get(job.queue) is None:
            continue
        out.append(job)
    return out


def _check_victim_tier(ssn, kind: str, drf) -> List[str]:
    """The deciding victim tier for ``kind``, gate-checked (raises
    _Unsupported outside the vectorized envelope)."""
    decide = _deciding_victim_tier(ssn, kind)
    if any(n not in VECTORIZED_VICTIM_FNS for n in decide):
        raise _Unsupported(f"unsupported victim plugins: {decide}")
    if "drf" in decide:
        if drf is None:
            raise _Unsupported("drf victims without the drf plugin")
        if drf.namespace_opts and len(
                {j.namespace for j in ssn.jobs.values()}) > 1:
            # the weighted-namespace branch only acts on CROSS-namespace
            # claimee pairs; with one namespace it is provably a no-op
            raise _Unsupported(
                "weighted-namespace drf victims over multiple "
                "namespaces not modeled")
    return decide


def _deciding_victim_tier(ssn, kind: str) -> List[str]:
    flag = "enabled_preemptable" if kind == "preempt" \
        else "enabled_reclaimable"
    fns = ssn.preemptable_fns if kind == "preempt" else ssn.reclaimable_fns
    for tier in ssn.tiers:
        names = [p.name for p in tier.plugins
                 if conf_mod.enabled(getattr(p, flag)) and p.name in fns]
        if names:
            return names
    return []


def build(ssn, kind: str):
    """A batched-eviction plan for ``kind`` in {"preempt", "reclaim",
    "backfill"}, or None when the session leaves the modeled envelope
    (the action then runs its old path — the parity oracle)."""
    prof = _profile(ssn)
    try:
        if kind == "backfill":
            return _BackfillPlan(ssn)
        return _EvictPlan(ssn, kind)
    except _Unsupported as e:
        reason = str(e)
        if reason in ("VOLCANO_TPU_EVICT=0", "tpuscore off"):
            # the device path is not armed at all (serial conf / env
            # oracle) — a mode choice, not an envelope miss: keep the
            # profile reason but do not charge the fallback-rate budget
            prof[f"evict_{kind}_fallback"] = reason
        else:
            _note_fallback(prof, f"evict_{kind}", reason)
        return None


class _EvictPlan:
    """One encoded preempt/reclaim action: the action arrays + the decode
    maps the host replay needs. Pure until run() applies a successful
    solve."""

    def __init__(self, ssn, kind: str, view=None):
        from volcano_tpu_torch.ops import encoder as enc_mod

        t0 = time.perf_counter()
        self.ssn = ssn
        self.kind = kind
        view = _common_view(ssn, view)
        self.view = view

        job_order = enc_mod._enabled_plugins(
            ssn, "enabled_job_order", ssn.job_order_fns)
        if any(p not in SUPPORTED_JOB_ORDER for p in job_order):
            raise _Unsupported(f"unsupported job-order plugins: {job_order}")
        pipelined_names = enc_mod._enabled_plugins(
            ssn, "enabled_job_pipelined", ssn.job_pipelined_fns)
        if any(p != "gang" for p in pipelined_names):
            raise _Unsupported(
                f"unsupported job-pipelined plugins: {pipelined_names}")
        if any(p != "proportion" for p in ssn.overused_fns):
            raise _Unsupported("unsupported overused plugins")
        queue_order = enc_mod._enabled_plugins(
            ssn, "enabled_queue_order", ssn.queue_order_fns)
        if any(p != "proportion" for p in queue_order):
            raise _Unsupported(
                f"unsupported queue-order plugins: {queue_order}")
        task_key = ssn.stock_task_order_key()
        if task_key is None:
            raise _Unsupported("custom task-order comparator")
        drf = ssn.plugins.get("drf")
        decide = _check_victim_tier(ssn, kind, drf)

        fdt = _f_dtype(ssn)
        node_names = view.node_names
        nodes = view.nodes
        n = view.n
        if n == 0:
            raise _Unsupported("no nodes")

        # ---- eligible jobs + per-kind registration (exact serial order) --
        eligible = _eligible_jobs(ssn)
        jobs = list(ssn.jobs.values())
        jidx = {job.uid: i for i, job in enumerate(jobs)}
        j_real = len(jobs)
        jb = _bucket(max(j_real, 1))

        qnames: Dict[str, int] = {}
        for job in jobs:
            qnames.setdefault(job.queue, len(qnames))
        for qname in ssn.queues:
            qnames.setdefault(qname, len(qnames))
        qb = _bucket(max(len(qnames), 1))

        # ---- preemptor task axis -----------------------------------------
        pre_jobs = [job for job in eligible
                    if job.task_status_index.get(TaskStatus.PENDING)]
        self.trivial = not pre_jobs
        if self.trivial:
            return
        p_tasks: List = []
        job_task_start = np.zeros(jb, np.int32)
        job_task_end = np.zeros(jb, np.int32)
        for job in pre_jobs:
            pend = list(job.task_status_index[TaskStatus.PENDING].values())
            pend.sort(key=task_key)  # SortedTaskQueue order (stable)
            ji = jidx[job.uid]
            job_task_start[ji] = len(p_tasks)
            p_tasks.extend(pend)
            job_task_end[ji] = len(p_tasks)
        t_real = len(p_tasks)
        tb = _bucket(max(t_real, 1))

        # per-signature rows from the shared dense view (reused encodes)
        sig_ids: Dict[str, int] = {}
        sig_rows: List[np.ndarray] = []
        sig_affs: List[Optional[np.ndarray]] = []
        p_sig = np.zeros(tb, np.int32)
        p_has_pod = np.zeros(tb, bool)
        p_req = np.zeros((tb, 2), fdt)
        p_init = np.zeros((tb, 2), fdt)
        p_job = np.zeros(tb, np.int32)
        for ti, task in enumerate(p_tasks):
            rows = view._rows(task)
            if rows is None:
                raise _Unsupported(
                    "preemptor with host ports / pod affinity")
            key, mask, aff = rows
            si = sig_ids.get(key)
            if si is None:
                si = sig_ids[key] = len(sig_rows)
                sig_rows.append(mask)
                sig_affs.append(aff)
            p_sig[ti] = si
            p_has_pod[ti] = task.pod is not None
            p_req[ti] = (task.resreq.milli_cpu, task.resreq.memory)
            p_init[ti] = (task.init_resreq.milli_cpu, task.init_resreq.memory)
            p_job[ti] = jidx[task.job]
        sb = _bucket(max(len(sig_rows), 1))
        sig_mask = np.zeros((sb, n), bool)
        affinity = np.zeros((sb, n), fdt)
        for si, row in enumerate(sig_rows):
            sig_mask[si] = row
            if sig_affs[si] is not None:
                affinity[si] = sig_affs[si]
        p_nz_cpu = np.where(p_req[:, 0] != 0, p_req[:, 0],
                            nodeorder_mod.DEFAULT_MILLI_CPU_REQUEST)
        p_nz_mem = np.where(p_req[:, 1] != 0, p_req[:, 1],
                            nodeorder_mod.DEFAULT_MEMORY_REQUEST)

        # ---- victim axis (claimee order = node.tasks iteration order) ----
        vic_rows: List[List] = []
        for node in nodes:
            vic_rows.append([
                t for t in node.tasks.values()
                if t.status == TaskStatus.RUNNING and t.job in ssn.jobs])
        self.vic_rows = vic_rows
        v = _bucket(max(1, max((len(r) for r in vic_rows), default=1)))
        vic_req = np.zeros((n, v, 2), fdt)
        vic_job = np.zeros((n, v), np.int32)
        vic_valid = np.zeros((n, v), bool)
        vic_conf = np.zeros((n, v), bool)
        vic_cut_perm = np.full((n, v), -1, np.int32)
        total_victims = 0
        from volcano_tpu_torch.api import objects

        for ni, row in enumerate(vic_rows):
            total_victims += len(row)
            for vi, t in enumerate(row):
                vic_req[ni, vi] = (t.resreq.milli_cpu, t.resreq.memory)
                vic_job[ni, vi] = jidx[t.job]
                vic_valid[ni, vi] = True
                cls = t.pod.spec.priority_class_name if t.pod else ""
                vic_conf[ni, vi] = not (
                    cls in (objects.SYSTEM_CLUSTER_CRITICAL,
                            objects.SYSTEM_NODE_CRITICAL)
                    or t.namespace == "kube-system")
            if kind == "preempt" and row:
                order = sorted(range(len(row)),
                               key=lambda i: task_key(row[i]), reverse=True)
                vic_cut_perm[ni, :len(order)] = order

        # ---- job / queue state axes --------------------------------------
        job_prio = np.zeros(jb, np.int32)
        job_min_av = np.zeros(jb, np.int32)
        job_ready0 = np.zeros(jb, np.int32)
        job_wait0 = np.zeros(jb, np.int32)
        job_queue = np.zeros(jb, np.int32)
        job_alloc0 = np.zeros((jb, 2), fdt)
        for i, job in enumerate(jobs):
            job_prio[i] = job.priority
            job_min_av[i] = job.min_available
            job_ready0[i] = job.ready_task_num()
            job_wait0[i] = job.waiting_task_num()
            job_queue[i] = qnames[job.queue]
            if drf is not None:
                attr = drf.job_attrs.get(job.uid)
                if attr is not None:
                    job_alloc0[i] = (attr.allocated.milli_cpu,
                                     attr.allocated.memory)
        job_tie = np.full(jb, np.iinfo(np.int32).max - 1, np.int32)
        if j_real:
            ctimes = np.fromiter((j.creation_timestamp for j in jobs),
                                 np.float64, j_real)
            uids = np.array([j.uid for j in jobs])
            order = np.lexsort((uids, ctimes))
            job_tie[order] = np.arange(j_real, dtype=np.int32)

        prop = ssn.plugins.get("proportion")
        queue_alloc0 = np.zeros((qb, 2), fdt)
        queue_deserved = np.zeros((qb, 2), fdt)
        queue_has_attr = np.zeros(qb, bool)
        for qname, qi in qnames.items():
            attr = prop.queue_opts.get(qname) if prop is not None else None
            if attr is not None:
                queue_alloc0[qi] = (attr.allocated.milli_cpu,
                                    attr.allocated.memory)
                queue_deserved[qi] = (attr.deserved.milli_cpu,
                                      attr.deserved.memory)
                queue_has_attr[qi] = True
        queue_tie = np.full(qb, np.iinfo(np.int32).max - 1, np.int32)
        known = [(qi, ssn.queues[qn]) for qn, qi in qnames.items()
                 if qn in ssn.queues]
        known.sort(key=lambda p: (p[1].queue.metadata.creation_timestamp,
                                  p[1].uid))
        for rank, (qi, _) in enumerate(known):
            queue_tie[qi] = rank

        # pad slots alias queue 0 (gather-safe); every use gates on valid
        vic_queue = np.where(vic_valid, job_queue[vic_job], 0).astype(
            np.int32)

        arrays = dict(
            eps=np.array([MIN_MILLI_CPU, MIN_MEMORY], fdt),
            node_used=view.used.astype(fdt).copy(),
            node_alloc=view.alloc.astype(fdt, copy=False),
            node_cnt=view.cnt.astype(np.int32).copy(),
            node_max=view.max_tasks.astype(np.int32),
            affinity_score=affinity,
            sig_mask=sig_mask,
            least_req_weight=np.asarray(view.least_req_w, fdt),
            balanced_weight=np.asarray(view.balanced_w, fdt),
            node_affinity_weight=np.asarray(view.node_aff_w, fdt),
            binpack_w=view.binpack_w.astype(fdt),
            binpack_weight=np.asarray(view.binpack_weight, fdt),
            drf_total=(np.array([drf.total_resource.milli_cpu,
                                 drf.total_resource.memory], fdt)
                       if drf is not None else np.zeros(2, fdt)),
            p_req=p_req, p_init=p_init,
            p_nz_cpu=p_nz_cpu.astype(fdt), p_nz_mem=p_nz_mem.astype(fdt),
            p_sig=p_sig, p_has_pod=p_has_pod, p_job=p_job,
            job_task_start=job_task_start, job_task_end=job_task_end,
            job_prio=job_prio, job_min_av=job_min_av,
            job_ready0=job_ready0, job_wait0=job_wait0,
            job_queue=job_queue, job_alloc0=job_alloc0, job_tie=job_tie,
            queue_alloc0=queue_alloc0, queue_deserved=queue_deserved,
            queue_has_attr=queue_has_attr, queue_tie=queue_tie,
            vic_req=vic_req, vic_job=vic_job, vic_queue=vic_queue,
            vic_valid=vic_valid, vic_alive0=vic_valid.copy(),
            vic_conf=vic_conf,
            # real-slot mask + count (the reference's layout, where a mesh
            # pad may append node slots; the port never pads, so every
            # slot is real)
            node_real=np.ones(n, bool),
            real_n=np.int32(n),
            rr0=np.int32(0),
            num_to_find=np.int32(0),
        )
        if kind == "preempt":
            arrays["vic_cut_perm"] = vic_cut_perm
            from volcano_tpu_torch.scheduler.util import scheduler_helper as helper

            arrays["rr0"] = np.int32(helper._last_processed_node_index)
            arrays["num_to_find"] = np.int32(
                helper.calculate_num_of_feasible_nodes_to_find(n))
        tiers_union = set(decide)
        if "drf" in tiers_union or "gang" in tiers_union:
            vj = np.where(vic_valid, vic_job, -1 - np.arange(v)[None, :])
            arrays["vic_samejob"] = vj[:, :, None] == vj[:, None, :]
        if "proportion" in tiers_union:
            vq = np.where(vic_valid, vic_queue, -1 - np.arange(v)[None, :])
            arrays["vic_samequeue"] = vq[:, :, None] == vq[:, None, :]
        # live-pointer permutation: identity on the per-action path (the
        # candidate axis holds exactly the still-pending tasks)
        arrays["p_next"] = np.arange(tb, dtype=np.int32)

        # ---- heaps (initial arrays built by the REAL PriorityQueue at
        # encode-time keys — every initial push happens before any state
        # mutation, so the extracted heap list is exact) -------------------
        from volcano_tpu_torch.scheduler.util.priority_queue import PriorityQueue

        jcap = _bucket(max(1, max(
            (sum(1 for j in pre_jobs if j.queue == qn) for qn in qnames),
            default=1)))
        if kind == "preempt":
            proc_queues: List[int] = []
            seen_q: Dict[str, PriorityQueue] = {}
            under: List[int] = []
            for job in eligible:
                if job.queue not in seen_q:
                    seen_q[job.queue] = PriorityQueue(
                        cmp_fn=ssn.job_order_cmp)
                    proc_queues.append(qnames[job.queue])
                if job.task_status_index.get(TaskStatus.PENDING):
                    seen_q[job.queue].push(job)
                    under.append(jidx[job.uid])
            qp = _bucket(max(len(proc_queues), 1))
            heap0 = np.zeros((qp, jcap), np.int32)
            hsize0 = np.zeros(qp, np.int32)
            queue_real = np.zeros(qp, bool)
            for pi, (qn, pq) in enumerate(seen_q.items()):
                row = [jidx[it.value.uid] for it in pq._heap]
                heap0[pi, :len(row)] = row
                hsize0[pi] = len(row)
                queue_real[pi] = True
            ju = _bucket(max(len(under), 1))
            under_jobs = np.full(ju, -1, np.int32)
            under_jobs[:len(under)] = under
            arrays.update(heap0=heap0, hsize0=hsize0,
                          queue_real=queue_real, under_jobs=under_jobs)
        else:
            queues_pq = PriorityQueue(cmp_fn=ssn.queue_order_cmp)
            seen_qs: Dict[str, PriorityQueue] = {}
            for job in eligible:
                if job.queue not in seen_qs:
                    seen_qs[job.queue] = PriorityQueue(
                        cmp_fn=ssn.job_order_cmp)
                    queues_pq.push(ssn.queues[job.queue])
                if job.task_status_index.get(TaskStatus.PENDING):
                    seen_qs[job.queue].push(job)
            heap0 = np.zeros((qb, jcap), np.int32)
            hsize0 = np.zeros(qb, np.int32)
            for qn, pq in seen_qs.items():
                qi = qnames[qn]
                row = [jidx[it.value.uid] for it in pq._heap]
                heap0[qi, :len(row)] = row
                hsize0[qi] = len(row)
            qh = _bucket(max(len(queues_pq), 1))
            qheap0 = np.zeros(qh, np.int32)
            qrow = [qnames[it.value.uid] for it in queues_pq._heap]
            qheap0[:len(qrow)] = qrow
            arrays.update(heap0=heap0, hsize0=hsize0, qheap0=qheap0,
                          qhsize0=np.int32(len(qrow)))

        # live log ≤ committed evicts (each victim commits at most once) +
        # committed pipelines + commit markers (≤ job pops + phase-2 tasks)
        # + one open statement's ops; overflow just fails to the old path
        self.log_rows = _bucket(2 * total_victims + 4 * tb + jb + 64)
        arrays["log0"] = np.zeros((self.log_rows, 3), np.int32)

        self.arrays = arrays
        self.p_tasks = p_tasks
        self.node_names = node_names
        self.n = n
        self.v = v
        self.spec = EvictSpec(
            kind=kind,
            job_order_keys=tuple(job_order),
            victim_fns=tuple(decide),
            check_pod_count=view.check_pod_count,
            use_nodeorder=view.use_nodeorder,
            use_binpack=view.use_binpack,
            use_gang_pipelined="gang" in pipelined_names,
            use_prop_overused="proportion" in ssn.overused_fns,
            use_prop_queue_order="proportion" in queue_order,
        )
        self.jidx = jidx
        self.qnames = qnames
        self.t_real = t_real
        self.tb = tb
        self.encode_s = time.perf_counter() - t0

    # -- run: dispatch once, fetch once, replay committed ops --------------

    def run(self) -> bool:
        prof = _profile(self.ssn)
        key = f"evict_{self.kind}"
        if self.trivial:
            prof[key] = {"trivial": True}
            return True
        t0 = time.perf_counter()
        # one dispatch of the action's machine, one int32 fetch (the
        # action's one sync point); a build or launch failure raises
        out = _solve(self.ssn, self.spec, self.arrays)
        return self.consume(out, time.perf_counter() - t0)

    def consume(self, out: np.ndarray, solve_s: float,
                kind: Optional[str] = None) -> bool:
        """Validate + replay a fetched packed result. False => nothing was
        applied and the caller must run the serial walk."""
        kind = kind or self.kind
        prof = _profile(self.ssn)
        key = f"evict_{kind}"
        t1 = time.perf_counter()
        lr = self.log_rows
        tail = out[lr * 3:]
        log_len, rr, victims, attempts, fail, underflow = (
            int(tail[0]), int(tail[1]), int(tail[2]), int(tail[3]),
            int(tail[4]), int(tail[5]))
        if fail:
            _note_fallback(prof, key,
                           "kernel step/log budget exhausted")
            return False
        if underflow:
            from volcano_tpu_torch.utils.assertions import panic_enabled

            if panic_enabled():
                # the serial walk raises AssertionViolation at the
                # offending claimee; rerun it so panic mode fails
                # identically loudly (nothing was applied)
                _note_fallback(prof, key,
                               "resource underflow under panic mode")
                return False
        log = out[:log_len * 3].reshape(log_len, 3)
        self._replay(log, victims, attempts, rr, kind=kind)
        prof[key] = {
            "solve_s": solve_s, "apply_s": time.perf_counter() - t1,
            "encode_s": self.encode_s, "ops": log_len,
            "victims": victims, "attempts": attempts,
        }
        return True

    def _replay(self, log: np.ndarray, victims: int, attempts: int,
                rr: int, kind: Optional[str] = None) -> None:
        """Apply the committed op log in exact serial order through the
        real Statement/session mutators (events, cache effectors, and
        SnapshotKeeper dirty-sets all fire as the serial walk would)."""
        from volcano_tpu_torch.scheduler import metrics
        from volcano_tpu_torch.scheduler.util import scheduler_helper as helper

        ssn = self.ssn
        if (kind or self.kind) == "preempt":
            stmt = None
            for kind_, a, b in log.tolist():
                if kind_ == OP_EVICT:
                    if stmt is None:
                        stmt = ssn.statement()
                    task = self.vic_rows[a][b]
                    try:
                        stmt.evict(task.shared_clone(), "preempt")
                    except Exception as e:
                        logger.error("Failed to preempt Task <%s/%s>: %s",
                                     task.namespace, task.name, e)
                elif kind_ == OP_PIPELINE:
                    if stmt is None:
                        stmt = ssn.statement()
                    stmt.pipeline(self.p_tasks[a], self.node_names[b])
                else:  # OP_COMMIT
                    if stmt is not None:
                        stmt.commit()
                        stmt = None
            if stmt is not None:  # pragma: no cover - kernel always marks
                stmt.commit()
            if victims:
                metrics.update_preemption_victims(victims)
            if attempts:
                metrics.register_preemption_attempts(attempts)
            helper._last_processed_node_index = rr % max(self.n, 1)
        else:
            for kind_, a, b in log.tolist():
                if kind_ == OP_EVICT:
                    task = self.vic_rows[a][b]
                    try:
                        ssn.evict(task.shared_clone(), "reclaim")
                    except (KeyError, RuntimeError) as e:
                        logger.error("Failed to reclaim %s/%s: %s",
                                     task.namespace, task.name, e)
                elif kind_ == OP_PIPELINE:
                    ssn.pipeline(self.p_tasks[a], self.node_names[b])


class _BackfillPlan:
    """Batched backfill: the device decides every zero-request placement
    (first feasible node in name order under the evolving pod-count), the
    host replays through ssn.allocate and keeps the serial-fidelity
    FitErrors machinery — including the bounded diagnostics replay."""

    def __init__(self, ssn, view=None):
        from volcano_tpu_torch.api import objects

        t0 = time.perf_counter()
        self.ssn = ssn
        view = _common_view(ssn, view)
        self.view = view
        tasks: List = []
        jobs_of: List = []
        sig_ids: Dict[str, int] = {}
        sig_rows: List[np.ndarray] = []
        sigs: List[int] = []
        for job in list(ssn.jobs.values()):
            if job.pod_group.status.phase == objects.PodGroupPhase.PENDING:
                continue
            vr = ssn.job_valid(job)
            if vr is not None and not vr.pass_:
                continue
            for task in list(job.task_status_index.get(
                    TaskStatus.PENDING, {}).values()):
                if not task.init_resreq.is_empty():
                    continue
                rows = view._rows(task)
                if rows is None:
                    raise _Unsupported(
                        "backfill task with host ports / pod affinity")
                key, mask, _ = rows
                si = sig_ids.get(key)
                if si is None:
                    si = sig_ids[key] = len(sig_rows)
                    sig_rows.append(mask)
                sigs.append(si)
                tasks.append(task)
                jobs_of.append(job)
        self.tasks = tasks
        self.jobs_of = jobs_of
        self.trivial = not tasks
        if self.trivial:
            return
        n = view.n
        if n == 0:
            raise _Unsupported("no nodes")
        tb = _bucket(len(tasks))
        sb = _bucket(max(len(sig_rows), 1))
        sig_mask = np.zeros((sb, n), bool)
        for si, row in enumerate(sig_rows):
            sig_mask[si] = row
        b_sig = np.zeros(tb, np.int32)
        b_sig[:len(sigs)] = sigs
        b_has_pod = np.zeros(tb, bool)
        b_has_pod[:len(tasks)] = [t.pod is not None for t in tasks]
        b_real = np.zeros(tb, bool)
        b_real[:len(tasks)] = True
        self.arrays = dict(
            sig_mask=sig_mask,
            node_cnt=view.cnt.astype(np.int32).copy(),
            node_max=view.max_tasks.astype(np.int32),
            b_sig=b_sig, b_has_pod=b_has_pod, b_real=b_real,
        )
        self.node_names = view.node_names
        self.spec = EvictSpec(
            kind="backfill", job_order_keys=(), victim_fns=(),
            check_pod_count=view.check_pod_count,
            use_nodeorder=False, use_binpack=False,
            use_gang_pipelined=False)
        self.encode_s = time.perf_counter() - t0

    def run(self) -> bool:
        prof = _profile(self.ssn)
        if self.trivial:
            prof["evict_backfill"] = {"trivial": True}
            return True
        t0 = time.perf_counter()
        assign = _solve(self.ssn, self.spec, self.arrays)
        return self.consume(assign, time.perf_counter() - t0)

    def consume(self, assign: np.ndarray, solve_s: float,
                all_nodes=None) -> bool:
        """Replay a fetched backfill assignment."""
        from volcano_tpu_torch.api.unschedule_info import FitErrors, FitFailure
        from volcano_tpu_torch.scheduler.util import scheduler_helper as helper

        ssn = self.ssn
        prof = _profile(ssn)
        t1 = time.perf_counter()
        if all_nodes is None:
            all_nodes = helper.get_node_list(ssn.nodes)
        # budget for full per-node diagnostics replay on failures — same
        # contract as the dense-view path (backfill.py replay_budget)
        replay_budget = 8
        placed = 0
        for i, task in enumerate(self.tasks):
            job = self.jobs_of[i]
            ni = int(assign[i])
            allocated = False
            tried = 0
            if ni >= 0:
                tried = 1
                try:
                    ssn.allocate(task, self.node_names[ni])
                    allocated = True
                except (KeyError, RuntimeError) as err:
                    logger.error("Failed to bind Task %s on %s: %s",
                                 task.uid, self.node_names[ni], err)
                    # the serial walk continues with the next feasible
                    # node; recover through the live dense view stream
                    from volcano_tpu_torch.ops import preemptview

                    view2 = preemptview.build(ssn)
                    cands = view2.masked_nodes_in_name_order(task) \
                        if view2 is not None else ()
                    for nd in cands or ():
                        if nd.name == self.node_names[ni]:
                            continue
                        tried += 1
                        try:
                            ssn.allocate(task, nd.name)
                            allocated = True
                            break
                        except (KeyError, RuntimeError) as err2:
                            logger.error(
                                "Failed to bind Task %s on %s: %s",
                                task.uid, nd.name, err2)
            if allocated:
                placed += 1
                continue
            fe = FitErrors()
            if tried == 0 and replay_budget > 0:
                # dense failure path: replay the serial predicate chain to
                # recover the per-node reasons the serial walk records
                replay_budget -= 1
                for nd in all_nodes:
                    try:
                        ssn.predicate_fn(task, nd)
                    except FitFailure as err:
                        fe.set_node_error(nd.name, err.fit_error(task, nd))
            if not fe.nodes:
                fe.set_error(
                    "0/%d nodes are feasible for backfill"
                    % len(all_nodes) if tried == 0 else
                    "%d feasible nodes rejected the backfill "
                    "allocation" % tried)
            job.nodes_fit_errors[task.uid] = fe
        prof["evict_backfill"] = {
            "solve_s": solve_s, "apply_s": time.perf_counter() - t1,
            "encode_s": self.encode_s,
            "tasks": len(self.tasks), "placed": placed,
        }
        return True
