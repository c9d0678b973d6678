"""K9 preempt, K10 reclaim and K11 backfill: the eviction state machines,
each a hand-written CUDA kernel beside its plain PyTorch version, and the
packed dispatch that stands in for the reference's K12.

Port of the device half of volcano_tpu/ops/evict.py:

- K9 ``solve_preempt`` (:828, ``preempt_machine`` :678, ``_preempt_walk``
  :552, ``_cut_preempt`` :527) -> csrc/evict_preempt.cu;
- K10 ``solve_reclaim`` (:1009, ``reclaim_machine`` :942,
  ``_reclaim_walk`` :861, ``_cut_reclaim`` :839) -> csrc/evict_reclaim.cu;
- K11 ``solve_backfill`` (:1020) -> csrc/evict_backfill.cu;
- K12 ``_solve_packed`` (:1175) is only a dispatch on ``spec.kind``; here
  it is ``solve_packed``, plain Python with no kernel of its own;
- the device work of the fused session chain (volcano_tpu/ops/
  session_fuse.py, K13): the carry bridges and the live-task maps as torch
  ops (``alloc_bridge``, ``backfill_bridge``, ``live_next``,
  ``live_job_mask``), the heap rebuilds under carried keys as
  csrc/fuse_heaps.cu (``fuse_heaps``; plain version ``fuse_heaps_plain``,
  the kernel's design step by step in ``fuse_heaps_rows_plain`` with its
  packed keys ``job_key_code``), and K9 and K10 fed the carried state, K9
  handing its final state on (``preempt_fused``, ``reclaim_fused``).

Each wrapper launches its kernel for CUDA tensors (and raises when it
cannot) and runs the plain version for CPU tensors; it never falls back
from one to the other. A launch adds one to the kernel's count in
volcano_tpu_torch.device.LAUNCHES.

The plain versions are the reference's machines in PyTorch, with Python
control flow where the reference has ``lax.while_loop``/``cond``: the
[N, V] victim folds and the node-axis window are tensor ops on the input
device, the control state (modes, heaps, pointers, the log length) is
Python. Float state keeps the reference's operation order: slot-order
folds, one accumulation per evicted victim in cut order, and discard by
inverse ops in reverse log order. The result is the reference's packed
int32 layout: the flattened [L, 3] op log (rows past ``log_len`` keep
whatever a discarded statement wrote there), then the 6-wide tail
[log_len, rr, victims, attempts, fail, underflow]. Both versions keep the
consumed-candidate mask ``p_done`` as the reference does (from
``p_done0``, zeros when the encode has none; set on pipeline, cleared on
discard): the fused chain carries it from preempt to reclaim.
"""

from __future__ import annotations

import ctypes
import functools
import math
import struct
from typing import Dict, List

import torch

from volcano_tpu_torch import device as devmod
from volcano_tpu_torch.ops import kernels as kmod
from volcano_tpu_torch.ops.rounds_kernels import _stream
from volcano_tpu_torch.ops.evict import (
    M_DONE,
    M_POP_JOB,
    M_QUEUE,
    M_STMT_END,
    M_TASK,
    M_UNDER,
    OP_COMMIT,
    OP_EVICT,
    OP_PIPELINE,
    TAIL,
    EvictSpec,
)
from volcano_tpu_torch.scheduler.plugins.drf import SHARE_DELTA

# the work the last plain run's data needed: walk steps (``folds``), the
# nodes whose victim rows a step must fold (``fold_nodes``: a preempt
# step the window's nodes, a reclaim step the feasible nodes up to the
# one that qualifies), walks (``walks``: one eligibility test over the
# node axis each), candidate windows (one per preempt walk: a scan over
# the node axis) and the window nodes that need a fused score
# (``scored``); for the last plain heap rebuild (K13) its pushes and key
# comparisons; the chip smoke counts a kernel's operations from these,
# since the work depends on the data
STATS: Dict[str, int] = {"folds": 0, "fold_nodes": 0, "walks": 0,
                         "windows": 0, "scored": 0, "pushes": 0,
                         "compares": 0}

# ---------------------------------------------------------------------------
# plain versions: shared arithmetic
# ---------------------------------------------------------------------------


def _le2(l, r, eps):
    """Resource.less_equal for scalar-free [..., 2] rows (per-dim
    epsilon)."""
    return torch.all((l < r) | (torch.abs(l - r) < eps), dim=-1)


def _lt2(l, r):
    """Resource.less: strictly less on every dimension."""
    return torch.all(l < r, dim=-1)


def _share2(alloc, total):
    """drf/proportion share over [R] denominators: max over dims,
    share(l, 0) = 1 when l != 0, floored at 0."""
    pos = total > 0
    one = torch.ones_like(alloc)
    s = torch.where(pos, alloc / torch.where(pos, total, torch.ones_like(total)),
                    torch.where(alloc == 0, torch.zeros_like(alloc), one))
    return torch.clamp(torch.amax(s, dim=-1), min=0.0)


def _window(elig, rr, num_to_find, real, real_n):
    """The serial round-robin sampling window: (selected mask, circular
    positions from rr, processed count). Candidate order within the
    window is circular-from-rr order."""
    n = elig.shape[0]
    dev = elig.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    rn = max(real_n, 1)
    circ = torch.where(real, torch.remainder(idx - rr, rn),
                       torch.full_like(idx, n))
    er = elig & real
    pos = torch.clamp(circ, max=n - 1)
    cnt = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
        0, pos, (er & real).to(torch.int64))
    c = torch.cumsum(cnt, 0)
    found_total = int(c[n - 1])
    sel = er & (c[pos] <= num_to_find)
    if found_total >= num_to_find:
        processed = int(torch.argmax((c >= num_to_find).to(torch.uint8))) + 1
    else:
        processed = rn
    return sel, circ, processed


class _Plain:
    """Machine state of one plain run: tensors for the numeric state on
    the input device, Python for the control state."""

    def __init__(self, spec: EvictSpec, enc: Dict[str, torch.Tensor]):
        STATS.update(folds=0, fold_nodes=0, walks=0, windows=0, scored=0)
        self.spec = spec
        self.enc = enc
        self.dev = enc["node_used"].device
        self.used = enc["node_used"].clone()
        self.cnt = enc["node_cnt"].clone()
        self.alive = enc["vic_alive0"].clone()
        self.ready = enc["job_ready0"].clone()
        self.wait = enc["job_wait0"].clone()
        self.job_alloc = enc["job_alloc0"].clone()
        self.queue_alloc = enc["queue_alloc0"].clone()
        self.log = enc["log0"].clone()
        self.log_rows = self.log.shape[0]
        p_done0 = enc.get("p_done0")
        self.p_done = p_done0.clone() if p_done0 is not None else torch.zeros(
            enc["p_req"].shape[0], dtype=torch.bool, device=self.dev)
        self.log_len = 0
        self.rr = int(enc["rr0"])
        self.victims = 0
        self.attempts = 0
        self.fail = False
        self.underflow = False
        self.steps = 0
        # static per-job/per-task inputs the control flow reads
        self.ptr: List[int] = enc["job_task_start"].tolist()
        self.task_end: List[int] = enc["job_task_end"].tolist()
        self.p_next: List[int] = enc["p_next"].tolist()
        self.heap: List[List[int]] = enc["heap0"].tolist()
        self.hsize: List[int] = enc["hsize0"].tolist()
        self.prio: List[int] = enc["job_prio"].tolist()
        self.min_av: List[int] = enc["job_min_av"].tolist()
        self.job_tie: List[int] = enc["job_tie"].tolist()
        self.queue_tie: List[int] = enc["queue_tie"].tolist()
        self.p_job: List[int] = enc["p_job"].tolist()
        self.job_queue: List[int] = enc["job_queue"].tolist()
        self.eps = enc["eps"]
        self.eps_host = enc["eps"].cpu()
        self.n, self.v = enc["vic_job"].shape
        self.real_n = int(enc["real_n"])
        self.num_to_find = int(enc["num_to_find"])

    # -- keys --------------------------------------------------------------

    def job_less(self, a: int, b: int) -> bool:
        """job_order_cmp as less(a, b): enabled plugin keys in tier order
        (priority desc, gang non-ready first, drf share asc), then the
        (ctime, uid) rank."""
        for key in self.spec.job_order_keys:
            if key == "priority":
                pa, pb = self.prio[a], self.prio[b]
                if pa != pb:
                    return pa > pb
            elif key == "gang":
                ra = int(self.ready[a]) >= self.min_av[a]
                rb = int(self.ready[b]) >= self.min_av[b]
                if ra != rb:
                    return (not ra) and rb
            elif key == "drf":
                total = self.enc["drf_total"]
                sa = _share2(self.job_alloc[a], total)
                sb = _share2(self.job_alloc[b], total)
                if bool(sa != sb):
                    return bool(sa < sb)
        return self.job_tie[a] < self.job_tie[b]

    def queue_less(self, a: int, b: int) -> bool:
        """queue_order_cmp: proportion share (vs deserved), then rank."""
        if self.spec.use_prop_queue_order:
            des = self.enc["queue_deserved"]
            sa = _share2(self.queue_alloc[a], des[a])
            sb = _share2(self.queue_alloc[b], des[b])
            if bool(sa != sb):
                return bool(sa < sb)
        return self.queue_tie[a] < self.queue_tie[b]

    # -- heapq mechanics (exact heappop / heappush sift order) --------------

    @staticmethod
    def heap_pop(row: List[int], size: int, less):
        root = row[0]
        last = row[size - 1]
        nsize = size - 1
        if nsize > 0:
            pos = 0
            while 2 * pos + 1 < nsize:
                child = 2 * pos + 1
                right = child + 1
                if right < nsize and not less(row[child], row[right]):
                    child = right
                row[pos] = row[child]
                pos = child
            row[pos] = last
            while pos > 0 and less(last, row[(pos - 1) // 2]):
                parent = (pos - 1) // 2
                row[pos] = row[parent]
                pos = parent
            row[pos] = last
        return root, nsize

    @staticmethod
    def heap_push(row: List[int], size: int, item: int, less) -> int:
        row[size] = item
        pos = size
        while pos > 0 and less(item, row[(pos - 1) // 2]):
            parent = (pos - 1) // 2
            row[pos] = row[parent]
            pos = parent
        row[pos] = item
        return size + 1

    def has_live(self, j: int) -> bool:
        p, end = self.ptr[j], self.task_end[j]
        t_total = len(self.p_next)
        nxt = self.p_next[min(max(p, 0), t_total - 1)]
        return p < end and nxt < end

    # -- state mutators (session-event twins) -------------------------------

    def log_append(self, kind: int, a: int, b: int, active: bool) -> None:
        if active:
            i = min(self.log_len, self.log_rows - 1)
            self.log[i, 0] = kind
            self.log[i, 1] = a
            self.log[i, 2] = b
            self.log_len += 1
        self.fail = self.fail or self.log_len >= self.log_rows

    def evict_slot(self, node: int, slot: int, active: bool) -> None:
        if active:
            enc = self.enc
            jv = int(enc["vic_job"][node, slot])
            qv = int(enc["vic_queue"][node, slot])
            req = enc["vic_req"][node, slot]
            self.alive[node, slot] = False
            self.ready[jv] -= 1
            self.job_alloc[jv] -= req
            self.queue_alloc[qv] -= req
        self.log_append(OP_EVICT, node, slot, active)

    def pipeline(self, t: int, node: int) -> None:
        req = self.enc["p_req"][t]
        j = self.p_job[t]
        q = self.job_queue[j]
        self.used[node] += req
        self.cnt[node] += 1
        self.wait[j] += 1
        self.job_alloc[j] += req
        self.queue_alloc[q] += req
        self.p_done[t] = True
        self.log_append(OP_PIPELINE, t, node, True)

    def discard(self, stmt_start: int) -> None:
        """Statement.discard: undo the open segment's ops in reverse order
        by inverse float ops (the serial discard re-adds what it
        subtracted; (x - r) + r need not equal a saved x)."""
        enc = self.enc
        while self.log_len > stmt_start:
            i = self.log_len - 1
            kind, a, b = self.log[i].tolist()
            if kind == OP_EVICT:
                jv = int(enc["vic_job"][a, b])
                qv = int(enc["vic_queue"][a, b])
                req = enc["vic_req"][a, b]
                self.alive[a, b] = True
                self.ready[jv] += 1
                self.job_alloc[jv] += req
                self.queue_alloc[qv] += req
            elif kind == OP_PIPELINE:
                req = enc["p_req"][a]
                pj = self.p_job[a]
                pq = self.job_queue[pj]
                self.used[b] -= req
                self.cnt[b] -= 1
                self.wait[pj] -= 1
                self.job_alloc[pj] -= req
                self.queue_alloc[pq] -= req
                self.p_done[a] = False
            self.log_len = i

    # -- victim tier masks ([N, V], session victim-fn twins) ----------------

    def gang_verdict(self, claimees):
        """gang.go:82-86: per-job occupancy budget decremented per
        nominated victim, walked in claimee order."""
        enc = self.enc
        jv = enc["vic_job"].long()
        min_av = enc["job_min_av"][jv]
        budget0 = torch.clamp(self.ready[jv] - min_av, min=0)
        used = torch.zeros_like(budget0)
        out = torch.zeros_like(claimees)
        same = enc["vic_samejob"]
        for v in range(self.v):
            allow = (min_av[:, v] == 1) | (used[:, v] < budget0[:, v])
            nominate = claimees[:, v] & allow
            out[:, v] = nominate
            used = used + (nominate[:, None] & same[:, v, :]).to(used.dtype)
        return out

    def drf_verdict(self, claimees, claimer_job: int, claimer_req):
        """drf.preemptable_fn: per-node cumulative-clone walk in claimee
        order; also the per-node sub-underflow."""
        enc = self.enc
        total = enc["drf_total"]
        ls = _share2(self.job_alloc[claimer_job] + claimer_req, total)
        jobcur = self.job_alloc[enc["vic_job"].long()]            # [N, V, R]
        same = enc["vic_samejob"]
        verdict = torch.zeros_like(claimees)
        under = torch.zeros(self.n, dtype=torch.bool, device=self.dev)
        for v in range(self.v):
            a = claimees[:, v]
            req = enc["vic_req"][:, v]
            cur = jobcur[:, v]
            under = under | (a & ~_le2(req, cur, self.eps))
            rs = _share2(cur - req, total)
            verdict[:, v] = (ls < rs) | (torch.abs(ls - rs) <= SHARE_DELTA)
            upd = (a[:, None] & same[:, v, :])[..., None]
            jobcur = torch.where(upd, jobcur - req[:, None, :], jobcur)
        return claimees & verdict, under

    def prop_verdict(self, claimees):
        """proportion.reclaimable_fn: per-node deserved-floor walk in
        claimee order with the conditional skip."""
        enc = self.enc
        qv = enc["vic_queue"].long()
        qcur = self.queue_alloc[qv]                                # [N, V, R]
        des = enc["queue_deserved"][qv]
        same = enc["vic_samequeue"]
        out = torch.zeros_like(claimees)
        under = torch.zeros(self.n, dtype=torch.bool, device=self.dev)
        for v in range(self.v):
            a = claimees[:, v]
            req = enc["vic_req"][:, v]
            cur = qcur[:, v]
            do = a & ~_lt2(cur, req)
            under = under | (do & ~_le2(req, cur, self.eps))
            out[:, v] = do & _le2(des[:, v], cur - req, self.eps)
            upd = (do[:, None] & same[:, v, :])[..., None]
            qcur = torch.where(upd, qcur - req[:, None, :], qcur)
        return out, under

    def victim_masks(self, claimees, claimer_job: int, claimer_req):
        """Deciding-tier intersection, each fn over the full claimee mask.
        Returns (victims [N, V], per-node underflow [N])."""
        m = claimees
        under = torch.zeros(self.n, dtype=torch.bool, device=self.dev)
        for name in self.spec.victim_fns:
            if name == "gang":
                m = m & self.gang_verdict(claimees)
            elif name == "conformance":
                m = m & self.enc["vic_conf"]
            elif name == "drf":
                dm, u = self.drf_verdict(claimees, claimer_job, claimer_req)
                m = m & dm
                under = under | u
            elif name == "proportion":
                pm, u = self.prop_verdict(claimees)
                m = m & pm
                under = under | u
        return m, under

    def fold(self, filt, t: int, j: int):
        """One walk iteration's node folds: victims, underflow, victim
        count and slot-order request sum per node, and validate."""
        enc = self.enc
        STATS["folds"] += 1
        claim = self.alive & enc["vic_valid"] & filt
        vm, under = self.victim_masks(claim, j, enc["p_req"][t])
        vcnt = vm.to(torch.int32).sum(dim=1, dtype=torch.int32)
        vsum = torch.zeros_like(enc["vic_req"][:, 0])
        for v in range(self.v):
            vsum = vsum + torch.where(vm[:, v, None], enc["vic_req"][:, v],
                                      torch.zeros_like(vsum))
        validate = (vcnt > 0) & ~_lt2(vsum, enc["p_init"][t])
        return vm, under, vcnt, validate

    def elig(self, t: int):
        enc = self.enc
        STATS["walks"] += 1
        mask = enc["sig_mask"][int(enc["p_sig"][t])]
        if self.spec.check_pod_count:
            mask = mask & ((self.cnt < enc["node_max"]) | ~enc["p_has_pod"][t])
        return mask

    def cut(self, t: int, node: int, vmask, perm=None) -> bool:
        """The eviction cut at ``node``: victims in ``perm`` order (preempt's
        reverse task order; claimee order when None), evicted one by one
        until the init request is covered. ``got`` accumulates on the host
        in the state dtype, one add per evicted victim, as the reference's
        sequential fori does."""
        enc = self.enc
        need = enc["p_init"][t].cpu()
        reqs = enc["vic_req"][node].cpu()
        sel = vmask.tolist()
        order = perm if perm is not None else list(range(self.v))
        got = torch.zeros_like(need)
        covered = False
        for p in range(self.v):
            pv = order[p]
            slot = max(pv, 0)
            selp = pv >= 0 and bool(sel[slot]) and not covered
            self.evict_slot(node, slot, selp)
            if not selp:
                continue
            got = got + reqs[slot]
            covered = bool(_le2(need, got, self.eps_host))
        return covered

    def tail(self) -> torch.Tensor:
        tail = torch.tensor([self.log_len, self.rr, self.victims,
                             self.attempts, int(self.fail),
                             int(self.underflow)], dtype=torch.int32)
        return torch.cat([self.log.reshape(-1), tail.to(self.log.device)])

    def carry(self) -> Dict[str, torch.Tensor]:
        """The final state the fused chain hands to the next stage."""
        return dict(used=self.used, cnt=self.cnt, alive=self.alive,
                    ready=self.ready, wait=self.wait,
                    job_alloc=self.job_alloc, queue_alloc=self.queue_alloc,
                    skip=self.p_done)


# ---------------------------------------------------------------------------
# K9 plain: the preempt machine
# ---------------------------------------------------------------------------


def _preempt_walk(m: _Plain, t: int, j: int, intra: bool) -> int:
    """_preempt for one preemptor task: round-robin window + fused-score
    candidate order, then the forward node walk (every visited node counts
    its victims, the first validate-passing node takes the cut, success
    pipelines). Returns the host node or -1."""
    enc = m.enc
    spec = m.spec
    n = m.n
    elig = m.elig(t)
    STATS["windows"] += 1
    sel, circ, processed = _window(elig, m.rr, m.num_to_find,
                                   enc["node_real"], m.real_n)
    m.rr = (m.rr + processed) % max(m.real_n, 1)
    STATS["scored"] += int(torch.sum(sel))
    score = kmod.fused_scores(spec, enc, m.used, enc["p_req"][t],
                              enc["p_nz_cpu"][t], enc["p_nz_mem"][t],
                              int(enc["p_sig"][t]))
    qj = m.job_queue[j]
    if intra:
        filt = enc["vic_job"] == j
    else:
        filt = (enc["vic_queue"] == qj) & (enc["vic_job"] != j)
    v_total = n * m.v
    first = True
    cs = None
    cc = -1
    iters = 0
    host = -1
    while True:
        vm, under, vcnt, validate = m.fold(filt, t, j)
        if first:
            after = torch.ones_like(sel)
        else:
            after = (score < cs) | ((score == cs) & (circ > cc))
        pa = sel & validate & after
        any_p = bool(torch.any(pa))
        if any_p:
            best = torch.max(torch.where(pa, score,
                                         torch.full_like(score, float("-inf"))))
            cand = pa & (score == best)
            chosen = int(torch.argmin(torch.where(
                cand, circ, torch.full_like(circ, n))))
            s_c, c_c = score[chosen], int(circ[chosen])
            vis_end = (score > s_c) | ((score == s_c) & (circ <= c_c))
            visited = sel & after & vis_end
        else:
            visited = sel & after
        STATS["fold_nodes"] += int(torch.sum(sel))
        m.victims += int(torch.sum(torch.where(visited, vcnt,
                                               torch.zeros_like(vcnt))))
        m.underflow = m.underflow or bool(torch.any(visited & under))
        iters += 1
        m.fail = m.fail or iters > v_total + 2
        covered = False
        if any_p:
            m.attempts += 1
            perm = enc["vic_cut_perm"][chosen].tolist()
            covered = m.cut(t, chosen, vm[chosen], perm)
            if covered:
                m.pipeline(t, chosen)
        done = (not any_p) or covered
        if done:
            host = chosen if covered else -1
        first = False
        if any_p:
            cs, cc = s_c, c_c
        if done or m.fail:
            return host


def preempt_plain(spec: EvictSpec, enc: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The plain version of K9: the whole preempt action (per-queue phase
    1 job heap pops with per-job statements and gang commit/discard, then
    phase 2 intra-job task-vs-task with per-task commits), as the
    reference's preempt_machine runs it. Returns the packed int32
    result."""
    return _preempt_run(spec, enc).tail()


def _preempt_run(spec: EvictSpec, enc: Dict[str, torch.Tensor]) -> _Plain:
    m = _Plain(spec, enc)
    queue_real = enc["queue_real"].tolist()
    under_jobs = enc["under_jobs"].tolist()
    qp, ju = len(queue_real), len(under_jobs)
    t_total = len(m.p_next)
    j_total = len(m.prio)
    step_budget = 8 * (t_total + j_total + qp + ju) + 64
    mode, qi, cur_job = M_QUEUE, 0, 0
    phase2 = assigned = False
    stmt_start = u2 = 0

    def pipelined(j: int) -> bool:
        if not spec.use_gang_pipelined:
            return True
        return int(m.wait[j]) + int(m.ready[j]) >= m.min_av[j]

    while mode != M_DONE and not m.fail:
        m.steps += 1
        m.fail = m.fail or m.steps > step_budget
        if mode == M_TASK:
            j = cur_job
            if not m.has_live(j):
                mode = M_UNDER if phase2 else M_STMT_END
                if phase2:
                    u2 += 1
                continue
            t = m.p_next[min(max(m.ptr[j], 0), t_total - 1)]
            m.ptr[j] = t + 1
            if phase2:
                stmt_start = m.log_len
            host = _preempt_walk(m, t, j, phase2)
            assigned = assigned or (not phase2 and host >= 0)
            pl = pipelined(j)
            m.log_append(OP_COMMIT, 0, 0, phase2 and m.log_len > stmt_start)
            miss2 = phase2 and host < 0
            if miss2:
                u2 += 1
                mode = M_UNDER
            elif not phase2 and pl:
                mode = M_STMT_END
            else:
                mode = M_TASK
        elif mode == M_QUEUE:
            past = qi >= qp
            real = queue_real[min(qi, qp - 1)]
            if past:
                mode = M_DONE
            elif real:
                mode = M_POP_JOB
            else:
                qi += 1
        elif mode == M_POP_JOB:
            if m.hsize[qi] == 0:
                u2 = 0
                mode = M_UNDER
            else:
                cur_job, m.hsize[qi] = m.heap_pop(m.heap[qi], m.hsize[qi],
                                                  m.job_less)
                stmt_start = m.log_len
                assigned = False
                phase2 = False
                mode = M_TASK
        elif mode == M_STMT_END:
            j = cur_job
            if pipelined(j):
                m.log_append(OP_COMMIT, 0, 0, m.log_len > stmt_start)
                if assigned:
                    m.hsize[qi] = m.heap_push(m.heap[qi], m.hsize[qi], j,
                                              m.job_less)
            else:
                m.discard(stmt_start)
            mode = M_POP_JOB
        elif mode == M_UNDER:
            past = u2 >= ju
            j = under_jobs[min(u2, ju - 1)]
            has = (not past) and j >= 0 and m.has_live(max(j, 0))
            if has:
                cur_job = j
            phase2 = True
            if past:
                mode = M_QUEUE
                qi += 1
            elif has:
                mode = M_TASK
            else:
                u2 += 1
    return m


# ---------------------------------------------------------------------------
# K10 plain: the reclaim machine
# ---------------------------------------------------------------------------


def _reclaim_walk(m: _Plain, t: int, j: int) -> bool:
    """One reclaimer task over feasible nodes in name order: the first
    node whose cross-queue victims validate takes the cut; an uncovered
    cut persists and the walk continues strictly forward."""
    enc = m.enc
    n = m.n
    elig = m.elig(t)
    filt = enc["vic_queue"] != m.job_queue[j]
    idx = torch.arange(n, device=m.dev)
    v_total = n * m.v
    cursor = -1
    iters = 0
    assigned = False
    while True:
        vm, under, _, validate = m.fold(filt, t, j)
        fwd = elig & (idx > cursor)
        pa = fwd & validate
        any_p = bool(torch.any(pa))
        if any_p:
            chosen = int(torch.argmax(pa.to(torch.uint8)))
            visited = fwd & (idx <= chosen)
        else:
            visited = fwd
        STATS["fold_nodes"] += int(torch.sum(visited))
        m.underflow = m.underflow or bool(torch.any(visited & under))
        iters += 1
        m.fail = m.fail or iters > v_total + 2
        covered = False
        if any_p:
            covered = m.cut(t, chosen, vm[chosen])
            if covered:
                m.pipeline(t, chosen)
            cursor = chosen
        assigned = assigned or covered
        if (not any_p) or covered or m.fail:
            return assigned


def reclaim_plain(spec: EvictSpec, enc: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The plain version of K10: the whole reclaim action (queue heap
    rotation, overused queues dropping out un-re-pushed, one job pop and
    one task per queue visit, direct evict/pipeline ops), as the
    reference's reclaim_machine runs it."""
    m = _Plain(spec, enc)
    qheap: List[int] = enc["qheap0"].tolist()
    qhsize = int(enc["qhsize0"])
    has_attr = enc["queue_has_attr"].tolist()
    t_total = len(m.p_next)
    step_budget = 4 * (t_total + len(m.prio) + m.queue_alloc.shape[0]) + 64
    while qhsize > 0 and not m.fail:
        m.steps += 1
        m.fail = m.fail or m.steps > step_budget
        q, qhsize = m.heap_pop(qheap, qhsize, m.queue_less)
        if spec.use_prop_overused and has_attr[q] and not bool(_le2(
                m.queue_alloc[q], enc["queue_deserved"][q], m.eps)):
            continue
        if m.hsize[q] == 0:
            continue
        j, m.hsize[q] = m.heap_pop(m.heap[q], m.hsize[q], m.job_less)
        if not m.has_live(j):
            continue
        t = m.p_next[min(max(m.ptr[j], 0), t_total - 1)]
        m.ptr[j] = t + 1
        if _reclaim_walk(m, t, j):
            qhsize = m.heap_push(qheap, qhsize, q, m.queue_less)
    return m.tail()


# ---------------------------------------------------------------------------
# K11 plain: backfill
# ---------------------------------------------------------------------------


def backfill_plain(spec: EvictSpec, enc: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The plain version of K11: each zero-request task in walk order takes
    the first feasible node in name order under the pod counts the
    earlier placements consumed. Returns assign [T] int32 (node or -1)."""
    cnt = enc["node_cnt"].clone()
    b_sig = enc["b_sig"].tolist()
    b_real = enc["b_real"].tolist()
    t_total = len(b_sig)
    assign = torch.full((t_total,), -1, dtype=torch.int32,
                        device=cnt.device)
    for t in range(t_total):
        mask = enc["sig_mask"][b_sig[t]]
        if spec.check_pod_count:
            mask = mask & ((cnt < enc["node_max"]) | ~enc["b_has_pod"][t])
        node = int(torch.argmax(mask.to(torch.uint8)))
        if bool(mask[node]) and b_real[t]:
            assign[t] = node
            cnt[node] += 1
    return assign


# ---------------------------------------------------------------------------
# the fused session chain's device helpers (torch ops)
# ---------------------------------------------------------------------------


def live_next(live: torch.Tensor) -> torch.Tensor:
    """[T] bool -> [T] int32: for each i the smallest j >= i with live[j]
    (T when none), a reversed running minimum (reference evict.py:232).
    Candidate tasks are contiguous per job, so p_next[ptr] is the next
    task the serial walk would pop once earlier stages consumed some."""
    t_total = live.shape[0]
    idx = torch.arange(t_total, dtype=torch.int32, device=live.device)
    cand = torch.where(live, idx, torch.full_like(idx, t_total))
    return torch.flip(torch.cummin(torch.flip(cand, (0,)), 0).values, (0,))


def live_job_mask(enc, p_next: torch.Tensor) -> torch.Tensor:
    """[J] bool: the job still has an unconsumed candidate task (reference
    session_fuse.py:69)."""
    t_total = p_next.shape[0]
    start = enc["job_task_start"]
    end = enc["job_task_end"]
    nxt = p_next[torch.clamp(start, 0, t_total - 1).long()]
    return (start < end) & (nxt < end)


def _mark(mask: torch.Tensor, idx: torch.Tensor, on: torch.Tensor) -> torch.Tensor:
    """``mask`` with ``mask[idx[i]]`` set where ``on[i]``: an idempotent
    boolean set (every write is True; the rows that are off write to a
    spare slot past the end), so duplicate indices cannot race."""
    n = mask.shape[0]
    buf = torch.cat([mask, mask.new_zeros(1)])
    tgt = torch.where(on, idx, torch.full_like(idx, n)).long()
    buf.index_put_((tgt,), torch.ones_like(on))
    return buf[:n]


def _add(size, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """zeros(size) scatter-added at ``idx`` (index_put_ with accumulate,
    whose CUDA form sorts the indices: deterministic; the sums it bridges
    are integral, so exact in any order)."""
    out = torch.zeros(size, dtype=vals.dtype, device=vals.device)
    return out.index_put_((idx.long(),), vals, accumulate=True)


def alloc_bridge(enc, maps, assign: torch.Tensor, sizes) -> Dict[str, torch.Tensor]:
    """The carry of the allocate stage (reference session_fuse.py:100-126):
    per-evict-axis deltas of everything the allocate apply changes on the
    host (node used/cnt, job ready/alloc, queue alloc) and the consumed
    candidates. ``enc`` is the rounds encode, ``maps`` the index maps from
    its axes to the evict axes, ``sizes`` (nodes, jobs, queues, tasks)."""
    n_ev, j_ev, q_ev, tc = sizes
    req = enc["cls_req"][enc["task_cls"].long()]               # [T, 2]
    pm = assign >= 0
    nb_r = enc["node_idle"].shape[0]
    enode = maps["r2e_node"][torch.clamp(assign, 0, nb_r - 1).long()]
    ejob = maps["r2e_job"][enc["task_job"].long()]
    ok_n = pm & (enode >= 0)
    ok_j = pm & (ejob >= 0)
    zero = torch.zeros((), dtype=req.dtype, device=req.device)
    reqn = torch.where(ok_n[:, None], req, zero)
    reqj = torch.where(ok_j[:, None], req, zero)
    en = torch.clamp(enode, 0, n_ev - 1)
    ejc = torch.clamp(ejob, 0, j_ev - 1)
    equeue = torch.clamp(maps["e_job_queue"][ejc.long()], 0, q_ev - 1)
    ct = maps["r2e_task"]
    skip = _mark(torch.zeros(tc, dtype=torch.bool, device=req.device), ct,
                 pm & (ct >= 0))
    return dict(used_add=_add((n_ev, 2), en, reqn),
                cnt_add=_add(n_ev, en, ok_n.to(torch.int32)),
                ready_add=_add(j_ev, ejc, ok_j.to(torch.int32)),
                alloc_add=_add((j_ev, 2), ejc, reqj),
                qalloc_add=_add((q_ev, 2), equeue, reqj),
                skip=skip)


def backfill_bridge(carry, maps, assign: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The carry after the backfill stage (reference session_fuse.py:149-
    160): zero-request placements move pod counts, readiness and the
    consumed candidates only."""
    pm = assign >= 0
    cnt_add = carry["cnt_add"]
    n_ev = cnt_add.shape[0]
    ejob = maps["b_ejob"]
    ready_add = carry["ready_add"]
    j_ev = ready_add.shape[0]
    ok_j = pm & (ejob >= 0)
    b2c = maps["b2cand"]
    return dict(
        carry,
        cnt_add=cnt_add + _add(n_ev, torch.clamp(assign, 0, n_ev - 1),
                               pm.to(torch.int32)),
        ready_add=ready_add + _add(j_ev, torch.clamp(ejob, 0, j_ev - 1),
                                   ok_j.to(torch.int32)),
        skip=_mark(carry["skip"], b2c, pm & (b2c >= 0)))


def job_keys_plain(enc, st) -> List[tuple]:
    """Every job's job_order key under the carried state: (priority, gang
    readiness, drf share, rank), the fields K13 computes once a pushed job.
    Each share is the state dtype's own value (``_share2`` over the whole
    axis), so a comparison decides as the kernel's does."""
    share = _share2(st["job_alloc"], enc["drf_total"]).tolist()
    ready = (st["ready"] >= enc["job_min_av"]).tolist()
    return list(zip(enc["job_prio"].tolist(), ready, share,
                    enc["job_tie"].tolist()))


def job_key_code(spec: EvictSpec, key: tuple) -> int:
    """A job's key packed as K13 packs it: one unsigned number whose order
    is job_order's. The enabled keys' fields in tier order, most
    significant first, then the rank: priority (desc) as its 32 biased
    bits inverted, gang readiness (non-ready first) as one bit, the drf
    share (asc; never below zero) as its float64 bits with -0.0 taken as
    +0.0 (the kernel packs float32 shares' bits, an order of the same
    values), the rank's 32 biased bits."""
    code = 0
    for name in spec.job_order_keys:
        if name == "priority":
            code = (code << 32) | (0xFFFFFFFF - ((key[0] + 2 ** 31) & 0xFFFFFFFF))
        elif name == "gang":
            code = (code << 1) | int(bool(key[1]))
        elif name == "drf":
            share = 0 if key[2] == 0 else struct.unpack("<Q", struct.pack("<d", key[2]))[0]
            code = (code << 63) | share
    return (code << 32) | ((key[3] + 2 ** 31) & 0xFFFFFFFF)


def queue_keys_plain(spec: EvictSpec, enc, st) -> List[tuple]:
    """Every queue row's queue_order key: (proportion share at the carried
    queue_alloc, or 0 when the order has no share; rank)."""
    tie = enc["queue_tie"].tolist()
    if not spec.use_prop_queue_order:
        return [(0.0, t) for t in tie]
    share = _share2(st["queue_alloc"], enc["queue_deserved"]).tolist()
    return list(zip(share, tie))


def queue_key_less(spec: EvictSpec, a: tuple, b: tuple) -> bool:
    """queue_order_cmp as less(a, b) on two keys: share, then rank."""
    if spec.use_prop_queue_order and a[0] != b[0]:
        return a[0] < b[0]
    return a[1] < b[1]


class _HostKeys:
    """job_order_cmp and queue_order_cmp as less(a, b) over keys read to
    the host once: a heap rebuild runs under fixed keys."""

    def __init__(self, spec: EvictSpec, enc, st):
        self.spec = spec
        self.min_av = enc["job_min_av"].tolist()
        self.jcodes = [job_key_code(spec, k) for k in job_keys_plain(enc, st)]
        self.qkeys = queue_keys_plain(spec, enc, st) \
            if "queue_alloc" in st else None

    def job_less(self, a: int, b: int) -> bool:
        return self.jcodes[a] < self.jcodes[b]

    def queue_less(self, a: int, b: int) -> bool:
        return queue_key_less(self.spec, self.qkeys[a], self.qkeys[b])


def fuse_heaps_plain(kind: str, spec: EvictSpec, enc, st, rows: int,
                     jcap: int, qh: int = 0,
                     use_gang_valid: bool = False) -> Dict[str, torch.Tensor]:
    """The plain version of K13: heapq's push mechanics, in the static push
    order, under the carried keys. ``st`` holds ``live_job`` [J] and the
    carried ``ready`` and ``job_alloc`` (reclaim: also ``queue_alloc`` and
    the victims' ``alive`` mask). Returns the int32 tensors ``heap``
    [rows, jcap] and ``hsize`` [rows], and ``under_jobs`` (preempt) or
    ``qheap`` [qh] and ``qhsize`` [] (reclaim)."""
    keys = _HostKeys(spec, enc, st)
    STATS.update(pushes=0, compares=0)

    def counted(less):
        def fn(a: int, b: int) -> bool:
            STATS["compares"] += 1
            return less(a, b)
        return fn

    job_less, queue_less = counted(keys.job_less), counted(keys.queue_less)
    dev = st["ready"].device
    live = st["live_job"].tolist()
    j_total = len(live)
    heap = [[0] * jcap for _ in range(rows)]
    hsize = [0] * rows
    if kind == "preempt":
        under = []
        for j, row in zip(enc["f_push_jobs"].tolist(),
                          enc["f_push_row"].tolist()):
            pushable = j >= 0 and live[min(max(j, 0), j_total - 1)]
            under.append(j if pushable else -1)
            if pushable:
                r = min(max(row, 0), rows - 1)
                hsize[r] = _Plain.heap_push(heap[r], hsize[r], j, job_less)
                STATS["pushes"] += 1
        out = dict(under_jobs=under)
    else:
        evicted = _evicted(enc, st).tolist()
        elig0 = enc["f_elig0"].tolist()
        vtn0 = enc["f_vtn0"].tolist()
        qheap = [0] * qh
        qhsize = 0
        qpushed = [False] * rows
        for j, qrow in zip(enc["f_ev_jobs"].tolist(),
                           enc["f_ev_qrow"].tolist()):
            jc = min(max(j, 0), j_total - 1)
            q = min(max(qrow, 0), rows - 1)
            elig = j >= 0 and elig0[jc]
            if use_gang_valid:
                elig = elig and vtn0[jc] - evicted[jc] >= keys.min_av[jc]
            if elig and not qpushed[q]:
                qhsize = _Plain.heap_push(qheap, qhsize, q, queue_less)
                qpushed[q] = True
                STATS["pushes"] += 1
            if elig and live[jc]:
                hsize[q] = _Plain.heap_push(heap[q], hsize[q], j, job_less)
                STATS["pushes"] += 1
        out = dict(qheap=qheap, qhsize=qhsize)
    out.update(heap=heap, hsize=hsize)
    return {k: torch.tensor(v, dtype=torch.int32, device=dev)
            for k, v in out.items()}


def _evicted(enc, st) -> torch.Tensor:
    """Every job's evictions during preempt, from the carried alive mask."""
    dead = (enc["vic_valid"] & ~st["alive"]).reshape(-1).to(torch.int32)
    return _add(enc["job_prio"].shape[0], enc["vic_job"].reshape(-1), dead)


def _push_at_once(row: List[int], size: int, item: int, less) -> int:
    """heapq.heappush as K13's warp makes it: ``item`` is compared with
    every ancestor of the new leaf at once (the m-th ancestor of 1-based
    slot q is q >> m), rises past the ancestors before the first one it is
    not less than, and those move down a level each. The same comparisons,
    in the same outcome, as the sift's one by one."""
    q = size + 1
    depth = q.bit_length() - 1
    anc = [row[(q >> m) - 1] for m in range(1, depth + 1)]
    lt = [less(item, a) for a in anc]
    up = lt.index(False) if False in lt else depth
    for m in range(1, up + 1):
        row[(q >> (m - 1)) - 1] = anc[m - 1]
    row[(q >> up) - 1] = item
    return size + 1


def fuse_heaps_rows_plain(kind: str, spec: EvictSpec, enc, st, rows: int,
                          jcap: int, qh: int = 0,
                          use_gang_valid: bool = False) -> Dict[str, torch.Tensor]:
    """K13's design step by step, the same outputs as ``fuse_heaps_plain``:
    every slot's decision at once, the job pushes in slot order, each
    pushed job's key once, then each row's pushes replayed on their own
    (a push sifts only within its row; each push compares its ancestors at
    once, ``_push_at_once``), and the queue pushes in the order of each
    queue row's first eligible slot."""
    dev = st["ready"].device
    j_total = enc["job_prio"].shape[0]
    live = st["live_job"]
    if kind == "preempt":
        jobs = enc["f_push_jobs"].long()
        push = (jobs >= 0) & live[jobs.clamp(0, j_total - 1)]
        row = enc["f_push_row"].long().clamp(0, rows - 1)
        out = dict(under_jobs=torch.where(push, jobs, -1).tolist())
    else:
        jobs = enc["f_ev_jobs"].long()
        jc = jobs.clamp(0, j_total - 1)
        row = enc["f_ev_qrow"].long().clamp(0, rows - 1)
        elig = (jobs >= 0) & enc["f_elig0"][jc]
        if use_gang_valid:
            elig = elig & (enc["f_vtn0"][jc] - _evicted(enc, st)[jc]
                           >= enc["job_min_av"][jc])
        push = elig & live[jc]
        slot = torch.arange(jobs.shape[0], device=dev)
        first = torch.full((rows,), jobs.shape[0], dtype=torch.long, device=dev)
        first = first.scatter_reduce(0, row[elig], slot[elig], "amin")
        order = [q for _, q in sorted((f, q) for q, f in enumerate(first.tolist())
                                      if f < jobs.shape[0])]
        qkeys = queue_keys_plain(spec, enc, st)
        qheap = [0] * qh
        for n, q in enumerate(order):
            _Plain.heap_push(qheap, n, q, lambda a, b: queue_key_less(
                spec, qkeys[a], qkeys[b]))
        out = dict(qheap=qheap, qhsize=len(order))
    ev_job, ev_row = jobs[push].tolist(), row[push].tolist()
    codes = [job_key_code(spec, k) for k in job_keys_plain(enc, st)]
    heap = [[0] * jcap for _ in range(rows)]
    hsize = [0] * rows
    for r in range(rows):
        for j in (j for j, rr in zip(ev_job, ev_row) if rr == r):
            hsize[r] = _push_at_once(heap[r], hsize[r], j,
                                     lambda a, b: codes[a] < codes[b])
    out.update(heap=heap, hsize=hsize)
    return {k: torch.tensor(v, dtype=torch.int32, device=dev)
            for k, v in out.items()}


# ---------------------------------------------------------------------------
# wrappers: the hand-written kernels (csrc/evict_*.cu)
# ---------------------------------------------------------------------------

# argument tables of K9/K10, in the order csrc/evict_common.cuh fixes
# (checked against the library's ev_ptr_names()/ev_dim_names())
_INPUTS = (
    "eps", "node_used", "node_alloc", "node_cnt", "node_max",
    "affinity_score", "sig_mask", "weights", "binpack_w", "drf_total",
    "p_req", "p_init", "p_nz_cpu", "p_nz_mem", "p_sig", "p_has_pod", "p_job",
    "job_task_start", "job_task_end", "job_prio", "job_min_av", "job_ready0",
    "job_wait0", "job_queue", "job_alloc0", "job_tie", "queue_alloc0",
    "queue_deserved", "queue_has_attr", "queue_tie", "vic_req", "vic_job",
    "vic_queue", "vic_valid", "vic_alive0", "vic_conf", "vic_cut_perm",
    "vic_samejob", "vic_samequeue", "node_real", "real_n", "rr0",
    "num_to_find", "p_next", "heap0", "hsize0", "queue_real", "under_jobs",
    "qheap0", "qhsize0", "p_done0")
_SCRATCH = (
    "used", "cnt", "alive", "ready", "wait", "job_alloc", "queue_alloc",
    "ptr", "heap", "hsize", "qheap", "score", "circ", "flags", "vcnt",
    "under", "vm", "iwork", "fwork", "cpos", "out", "p_done")
# the machine state the fused chain carries on (reference
# session_fuse.py:237-240), beside p_done as the skip mask
_CARRY = ("used", "cnt", "alive", "ready", "wait", "job_alloc",
          "queue_alloc")
_DIMS = (
    "N", "V", "T", "J", "Q", "QP", "JCAP", "L", "JU", "QH", "check_pod",
    "use_nodeorder", "use_binpack", "use_gang_pipelined",
    "use_prop_overused", "use_prop_queue_order", "n_keys", "key0", "key1",
    "key2", "n_fns", "fn0", "fn1", "fn2", "fn3")
_KEY_CODES = {"priority": 0, "gang": 1, "drf": 2}
_FN_CODES = {"gang": 0, "conformance": 1, "drf": 2, "proportion": 3}
_FLOATS = frozenset({
    "eps", "node_used", "node_alloc", "affinity_score", "weights",
    "binpack_w", "drf_total", "p_req", "p_init", "p_nz_cpu", "p_nz_mem",
    "job_alloc0", "queue_alloc0", "queue_deserved", "vic_req"})
_BOOLS = frozenset({
    "sig_mask", "p_has_pod", "queue_has_attr", "vic_valid", "vic_alive0",
    "vic_conf", "vic_samejob", "vic_samequeue", "node_real", "queue_real",
    "p_done0"})


def _check_order(lib) -> None:
    for fn, want in ((lib.ev_ptr_names, _INPUTS + _SCRATCH),
                     (lib.ev_dim_names, _DIMS)):
        fn.restype = ctypes.c_char_p
        got = tuple(x for x in fn().decode().split(",") if x)
        if got != want:
            raise RuntimeError(f"evict kernel argument order mismatch: {got}")


# K9's and K10's victim widths folded in registers (the encoder's buckets
# up to 256); a wider row folds from global scratch rows
K9_V = (16, 32, 64, 128, 256)


def _layout(kind: str, n: int, v: int, dtype) -> tuple:
    from volcano_tpu_torch import _build

    fn = getattr(_build.library(f"evict_{kind}"), f"evict_{kind}_plan")
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 3)()
    fn(n, v, int(dtype == torch.float64), out)
    return out[0], out[1], out[2]


@functools.lru_cache(maxsize=None)
def preempt_layout(n: int, v: int, dtype) -> tuple:
    """K9's launch at N nodes and V victim slots: (CTAs in its cluster, 16;
    0 where the card does not run it), each CTA's dynamic shared-memory
    bytes, and the bytes of the global buffer that holds the node slices
    where they do not fit shared memory (else 0). Needs the card."""
    return _layout("preempt", n, v, dtype)


@functools.lru_cache(maxsize=None)
def reclaim_layout(n: int, v: int, dtype) -> tuple:
    """K10's launch at N nodes and V victim slots, as ``preempt_layout``
    gives K9's. Needs the card."""
    return _layout("reclaim", n, v, dtype)


def _machine_cuda(kind: str, spec: EvictSpec, enc,
                  fused: bool = False) -> Dict[str, torch.Tensor]:
    """Launch K9 (kind "preempt") or K10 ("reclaim") on the encoded arrays
    (``fused``: on the fused chain's carried state, counted apart); returns
    the kernel's scratch, whose ``out`` is the packed int32 result (log
    then tail) and whose state tensors hold the machine's final state."""
    from volcano_tpu_torch import _build

    ref = enc["node_used"]
    dev, dt = ref.device, ref.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"node_used: dtype {dt}")
    n, v = enc["vic_job"].shape
    if tuple(ref.shape) != (n, 2):
        raise ValueError("evict kernels take exactly two resource dims "
                         f"(node_used {tuple(ref.shape)})")
    t_total = enc["p_req"].shape[0]
    j_total = enc["job_prio"].shape[0]
    q_total = enc["queue_alloc0"].shape[0]
    qp, jcap = enc["heap0"].shape
    log_rows = enc["log0"].shape[0]
    sb = enc["sig_mask"].shape[0]
    preempt = kind == "preempt"
    ju = enc["under_jobs"].shape[0] if preempt else 0
    qh = 0 if preempt else enc["qheap0"].shape[0]
    fns = [_FN_CODES[f] for f in spec.victim_fns]
    keys = [_KEY_CODES[k] for k in spec.job_order_keys]
    shapes = {
        "eps": (2,), "node_used": (n, 2), "node_alloc": (n, 2),
        "node_cnt": (n,), "node_max": (n,), "affinity_score": (sb, n),
        "sig_mask": (sb, n), "weights": (4,), "binpack_w": (2,),
        "drf_total": (2,), "p_req": (t_total, 2), "p_init": (t_total, 2),
        "p_nz_cpu": (t_total,), "p_nz_mem": (t_total,), "p_sig": (t_total,),
        "p_has_pod": (t_total,), "p_job": (t_total,), "p_next": (t_total,),
        "job_task_start": (j_total,), "job_task_end": (j_total,),
        "job_prio": (j_total,), "job_min_av": (j_total,),
        "job_ready0": (j_total,), "job_wait0": (j_total,),
        "job_queue": (j_total,), "job_alloc0": (j_total, 2),
        "job_tie": (j_total,), "queue_alloc0": (q_total, 2),
        "queue_deserved": (q_total, 2), "queue_has_attr": (q_total,),
        "queue_tie": (q_total,), "vic_req": (n, v, 2), "vic_job": (n, v),
        "vic_queue": (n, v), "vic_valid": (n, v), "vic_alive0": (n, v),
        "vic_conf": (n, v), "node_real": (n,), "real_n": (), "rr0": (),
        "num_to_find": (), "heap0": (qp, jcap), "hsize0": (qp,),
    }
    if preempt:
        shapes.update(vic_cut_perm=(n, v), queue_real=(qp,),
                      under_jobs=(ju,))
    else:
        shapes.update(qheap0=(qh,), qhsize0=())
    if "p_done0" in enc:
        shapes["p_done0"] = (t_total,)
    if _FN_CODES["gang"] in fns or _FN_CODES["drf"] in fns:
        shapes["vic_samejob"] = (n, v, v)
    if _FN_CODES["proportion"] in fns:
        shapes["vic_samequeue"] = (n, v, v)
    weights = torch.stack([
        enc["least_req_weight"], enc["balanced_weight"],
        enc["node_affinity_weight"], enc["binpack_weight"]]).to(dt).contiguous()
    args = {}
    for name, shape in shapes.items():
        t = weights if name == "weights" else enc[name]
        want = dt if name in _FLOATS else (
            torch.bool if name in _BOOLS else torch.int32)
        if t.device != dev:
            raise ValueError(f"{name}: on {t.device}, expected {dev}")
        kmod._check(t, name, want, shape)
        args[name] = t

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    i32 = torch.int32
    scratch = dict(
        used=empty((n, 2), dt), cnt=empty(n, i32), alive=empty((n, v), torch.bool),
        ready=empty(j_total, i32), wait=empty(j_total, i32),
        job_alloc=empty((j_total, 2), dt), queue_alloc=empty((q_total, 2), dt),
        ptr=empty(j_total, i32), heap=empty((qp, jcap), i32), hsize=empty(qp, i32),
        qheap=empty(max(qh, 1), i32), out=empty(log_rows * 3 + TAIL, i32),
        p_done=empty(t_total, torch.bool))
    if v in K9_V:
        if not preempt:
            # K10: a validating node's victim mask, one word a 64 slots
            scratch["vm"] = empty((n, (v + 63) // 64), torch.int64)
    else:
        # a row wider than the register fold's: its fold rows
        scratch.update(vm=empty((n, v), torch.uint8), iwork=empty((n, v), i32),
                       fwork=empty((n, v, 2), dt))
    spill = (preempt_layout if preempt else reclaim_layout)(n, v, dt)[2]
    if spill:
        # the node slices, where they do not fit shared memory
        scratch["cpos"] = empty(spill, torch.uint8)
    dims = dict(
        N=n, V=v, T=t_total, J=j_total, Q=q_total, QP=qp, JCAP=jcap,
        L=log_rows, JU=ju, QH=qh, check_pod=int(spec.check_pod_count),
        use_nodeorder=int(spec.use_nodeorder),
        use_binpack=int(spec.use_binpack),
        use_gang_pipelined=int(spec.use_gang_pipelined),
        use_prop_overused=int(spec.use_prop_overused),
        use_prop_queue_order=int(spec.use_prop_queue_order),
        n_keys=len(keys), n_fns=len(fns))
    for i in range(3):
        dims[f"key{i}"] = keys[i] if i < len(keys) else -1
    for i in range(4):
        dims[f"fn{i}"] = fns[i] if i < len(fns) else -1

    name = f"evict_{kind}"
    lib = _build.library(name)
    _check_order(lib)
    if "vic_samejob" in args and args["vic_samejob"].data_ptr() % 8:
        # the gang fold reads a same-job row as 8-byte words; a staged view
        # inside a packed buffer may start off that alignment
        args["vic_samejob"] = args["vic_samejob"].clone()
    ptrs = (ctypes.c_void_p * (len(_INPUTS) + len(_SCRATCH)))(*[
        (args[k].data_ptr() if k in args else 0) for k in _INPUTS] + [
        (scratch[k].data_ptr() if k in scratch else 0) for k in _SCRATCH])
    dvals = (ctypes.c_int * len(_DIMS))(*[dims[k] for k in _DIMS])
    fn = getattr(lib, f"{name}_f64" if dt == torch.float64 else f"{name}_f32")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(ptrs, dvals, _stream(ref))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    devmod.count_launch(name + "_fused" if fused else name)
    # the scratch the caller drops and the stacked weights are freed when
    # this returns; the caching allocator hands their blocks out again only
    # to later work on this stream, which runs after the kernel
    return scratch


# where K11 keeps its state (csrc/evict_backfill.cu): "shared" (dynamic
# shared memory) or "global" (scratch the wrapper allocates)
BACKFILL_PLACEMENTS = ("shared", "global")


def _bf_lib():
    """K11's library, its argtypes set once, when it loads."""
    from volcano_tpu_torch import _build

    lib = _build.library("evict_backfill")
    if lib.evict_backfill.argtypes is None:
        lib.evict_backfill.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 9
        lib.evict_backfill.restype = ctypes.c_int
        lib.evict_backfill_scratch_bytes.argtypes = [ctypes.c_int] * 3
        lib.evict_backfill_scratch_bytes.restype = ctypes.c_longlong
    return lib


def _bf_scratch(lib, n: int, s: int, t: int) -> int:
    need = lib.evict_backfill_scratch_bytes(n, s, t)
    if need < 0:
        raise ValueError(f"evict_backfill: sizes N={n} S={s} T={t} not supported")
    return need


def backfill_placement(n: int, s: int, t: int) -> str:
    """Where K11 keeps its state at these sizes on the card (one of
    BACKFILL_PLACEMENTS): the sizes alone choose."""
    return BACKFILL_PLACEMENTS[_bf_scratch(_bf_lib(), n, s, t) > 0]


def _backfill_cuda(spec: EvictSpec, enc) -> torch.Tensor:
    sig_mask = enc["sig_mask"]
    cnt0 = enc["node_cnt"]
    dev = cnt0.device
    sb, n = sig_mask.shape
    t_total = enc["b_sig"].shape[0]
    for name, t, want, shape in (
            ("sig_mask", sig_mask, torch.bool, (sb, n)),
            ("node_cnt", cnt0, torch.int32, (n,)),
            ("node_max", enc["node_max"], torch.int32, (n,)),
            ("b_sig", enc["b_sig"], torch.int32, (t_total,)),
            ("b_has_pod", enc["b_has_pod"], torch.bool, (t_total,)),
            ("b_real", enc["b_real"], torch.bool, (t_total,))):
        if t.device != dev:
            raise ValueError(f"{name}: on {t.device}, expected {dev}")
        kmod._check(t, name, want, shape)
    lib = _bf_lib()
    need = _bf_scratch(lib, n, sb, t_total)
    scratch = torch.empty(need, dtype=torch.uint8, device=dev) if need else None
    assign = torch.empty(t_total, dtype=torch.int32, device=dev)
    rc = lib.evict_backfill(
        n, sb, t_total, int(spec.check_pod_count), kmod._ptr(sig_mask),
        kmod._ptr(cnt0), kmod._ptr(enc["node_max"]), kmod._ptr(enc["b_sig"]),
        kmod._ptr(enc["b_has_pod"]), kmod._ptr(enc["b_real"]),
        kmod._ptr(scratch), kmod._ptr(assign), _stream(cnt0))
    if rc != 0:
        raise RuntimeError(f"evict_backfill kernel launch failed: CUDA error {rc}")
    devmod.count_launch("evict_backfill")
    return assign


def preempt(spec: EvictSpec, enc) -> torch.Tensor:
    """K9: the preempt machine's packed int32 result. csrc/evict_preempt.cu
    on CUDA tensors (raising if it cannot launch), the plain version on CPU
    tensors."""
    if devmod.on_cuda(*enc.values()):
        return _machine_cuda("preempt", spec, enc)["out"]
    return preempt_plain(spec, enc)


def reclaim(spec: EvictSpec, enc) -> torch.Tensor:
    """K10: the reclaim machine's packed int32 result (csrc/evict_reclaim.cu
    on CUDA tensors, the plain version on CPU tensors)."""
    if devmod.on_cuda(*enc.values()):
        return _machine_cuda("reclaim", spec, enc)["out"]
    return reclaim_plain(spec, enc)


def backfill(spec: EvictSpec, enc) -> torch.Tensor:
    """K11: backfill's assign [T] int32 (csrc/evict_backfill.cu on CUDA
    tensors, the plain version on CPU tensors)."""
    if devmod.on_cuda(*enc.values()):
        return _backfill_cuda(spec, enc)
    return backfill_plain(spec, enc)


def preempt_fused_plain(spec: EvictSpec, enc):
    """The plain version of ``preempt_fused``."""
    m = _preempt_run(spec, enc)
    return m.tail(), m.carry()


def preempt_fused(spec: EvictSpec, enc):
    """K9 on the fused chain (reference session_fuse.py:235-241): ``enc``
    holds the carried state as the machine's initial state and the carried
    skip mask as ``p_done0``. Returns (packed result, carry): the machine's
    final used, cnt, alive, ready, wait, job_alloc, queue_alloc and skip
    (p_done), on CUDA the kernel's own scratch, left on the card."""
    if devmod.on_cuda(*enc.values()):
        sc = _machine_cuda("preempt", spec, enc, fused=True)
        return sc["out"], dict({k: sc[k] for k in _CARRY}, skip=sc["p_done"])
    return preempt_fused_plain(spec, enc)


def reclaim_fused(spec: EvictSpec, enc) -> torch.Tensor:
    """K10 on the fused chain (reference session_fuse.py:327): the reclaim
    machine from the carried state; its plain version is
    ``reclaim_plain``."""
    if devmod.on_cuda(*enc.values()):
        return _machine_cuda("reclaim", spec, enc, fused=True)["out"]
    return reclaim_plain(spec, enc)


# argument tables of K13, in the order csrc/fuse_heaps.cu fixes (checked
# against the library's fh_ptr_names()/fh_dim_names() once a library)
_FH_PTRS = (
    "job_prio", "job_min_av", "job_tie", "drf_total", "queue_deserved",
    "queue_tie", "ready", "job_alloc", "queue_alloc", "live_job",
    "push_jobs", "push_row", "ev_jobs", "ev_qrow", "elig0", "vtn0",
    "vic_job", "vic_valid", "alive", "heap", "hsize", "under", "qheap",
    "qhsize", "evicted", "qpushed", "work", "spill")
_FH_DIMS = (
    "J", "ROWS", "JCAP", "PB", "EB", "NV", "QH", "use_gang_valid", "n_keys",
    "key0", "key1", "key2", "use_prop_queue_order", "cap")
# K13's libraries whose argument order was checked and argtypes set
_FH_LIBS: dict = {}
# one scratch plan a bucket (library, device, dtype, kind, sizes), its
# inputs checked at the first call; the newest _FH_MAX_BUCKETS kept. Every
# call of a bucket reuses its scratch: the calls run in order on the
# caller's stream
_FH_BUCKETS: dict = {}
_FH_MAX_BUCKETS = 16


def _fh_lib(lib):
    fns = _FH_LIBS.get(lib)
    if fns is None:
        for fn, want in ((lib.fh_ptr_names, _FH_PTRS), (lib.fh_dim_names, _FH_DIMS)):
            fn.restype = ctypes.c_char_p
            got = tuple(x for x in fn().decode().split(",") if x)
            if got != want:
                raise RuntimeError(f"fuse_heaps argument order mismatch: {got}")
        for fn in (lib.fuse_heaps_f32, lib.fuse_heaps_f64):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.fuse_heaps_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.fuse_heaps_plan.restype = ctypes.c_int
        fns = _FH_LIBS[lib] = (lib.fuse_heaps_f32, lib.fuse_heaps_f64,
                               lib.fuse_heaps_plan)
    return fns


def _fh_inputs(kind, enc, st):
    """{name: (tensor, dtype, shape)} of K13's inputs for ``kind``."""
    ja = st["job_alloc"]
    dt = ja.dtype
    j_total = enc["job_prio"].shape[0]
    q_total = enc["queue_tie"].shape[0]
    n, v = enc["vic_job"].shape
    i32, b8 = torch.int32, torch.bool
    ins = {
        "job_prio": (enc["job_prio"], i32, (j_total,)),
        "job_min_av": (enc["job_min_av"], i32, (j_total,)),
        "job_tie": (enc["job_tie"], i32, (j_total,)),
        "drf_total": (enc["drf_total"], dt, (2,)),
        "queue_deserved": (enc["queue_deserved"], dt, (q_total, 2)),
        "queue_tie": (enc["queue_tie"], i32, (q_total,)),
        "ready": (st["ready"], i32, (j_total,)),
        "job_alloc": (ja, dt, (j_total, 2)),
        "live_job": (st["live_job"], b8, (j_total,)),
    }
    if kind == "reclaim":
        eb = enc["f_ev_jobs"].shape[0]
        ins.update({
            "queue_alloc": (st["queue_alloc"], dt, (q_total, 2)),
            "ev_jobs": (enc["f_ev_jobs"], i32, (eb,)),
            "ev_qrow": (enc["f_ev_qrow"], i32, (eb,)),
            "elig0": (enc["f_elig0"], b8, (j_total,)),
            "vtn0": (enc["f_vtn0"], i32, (j_total,)),
            "vic_job": (enc["vic_job"], i32, (n, v)),
            "vic_valid": (enc["vic_valid"], b8, (n, v)),
            "alive": (st["alive"], b8, (n, v)),
        })
    else:
        pb = enc["f_push_jobs"].shape[0]
        ins.update({
            "push_jobs": (enc["f_push_jobs"], i32, (pb,)),
            "push_row": (enc["f_push_row"], i32, (pb,)),
        })
    return ins


def _fh_bucket(lib, plan_fn, kind, spec, enc, st, rows, jcap, qh, use_gang_valid):
    """The bucket's launch recipe, built and its inputs checked at its first
    call: (the pointer table, its input entries (index, from the carried
    state, key), its output entries (index, output), the outputs' names,
    shapes and offsets in one buffer, the dims table, the scratch)."""
    ja = st["job_alloc"]
    dev, dt = ja.device, ja.dtype
    reclaim = kind == "reclaim"
    slots = enc["f_ev_jobs" if reclaim else "f_push_jobs"].shape[0]
    key = (lib, dev, dt, kind, spec.job_order_keys, spec.use_prop_queue_order,
           tuple(enc["job_prio"].shape), tuple(enc["queue_tie"].shape),
           tuple(enc["vic_job"].shape), slots, rows, jcap, qh, use_gang_valid)
    got = _FH_BUCKETS.get(key)
    if got is not None:
        return got
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"job_alloc: dtype {dt}")
    ins = _fh_inputs(kind, enc, st)
    for name, (t, want, shape) in ins.items():
        if t.device != dev:
            raise ValueError(f"{name}: on {t.device}, expected {dev}")
        kmod._check(t, name, want, shape)
    plan = (ctypes.c_longlong * 4)()
    rc = plan_fn(slots, rows, int(dt == torch.float64), plan)
    if rc != 0:
        raise RuntimeError(f"fuse_heaps scratch plan failed: CUDA error {rc}")
    j_total = enc["job_prio"].shape[0]
    n, v = enc["vic_job"].shape
    keys = [_KEY_CODES[k] for k in spec.job_order_keys]
    dims = dict(J=j_total, ROWS=rows, JCAP=jcap, PB=0 if reclaim else slots,
                EB=slots if reclaim else 0, NV=n * v, QH=qh,
                use_gang_valid=int(use_gang_valid), n_keys=len(keys),
                use_prop_queue_order=int(spec.use_prop_queue_order), cap=plan[1])
    for i in range(3):
        dims[f"key{i}"] = keys[i] if i < len(keys) else -1

    def empty(size, dtype=torch.uint8):
        return torch.empty(size, dtype=dtype, device=dev)

    scratch = dict(work=empty(plan[0]),
                   spill=empty(plan[3]) if plan[3] > 0 else None)
    if reclaim:
        scratch.update(evicted=empty(j_total, torch.int32),
                       qpushed=empty(rows, torch.bool))
    # the outputs: views of one int32 buffer a call, at these offsets
    outs = [("heap", (rows, jcap)), ("hsize", (rows,))]
    outs += [("qheap", (qh,)), ("qhsize", ())] if reclaim else [("under_jobs", (slots,))]
    ends = [0]
    for _, shape in outs:
        ends.append(ends[-1] + math.prod(shape))
    outs = [(k, shape, ends[i], ends[i + 1]) for i, (k, shape) in enumerate(outs)]
    slot_of = {"under" if k == "under_jobs" else k: i for i, (k, *_) in enumerate(outs)}
    # the pointer table: the scratch's entries set once, the inputs' and
    # outputs' at each call
    ptrs = (ctypes.c_void_p * len(_FH_PTRS))()
    from_in, from_out = [], []
    for i, k in enumerate(_FH_PTRS):
        if k in ins:
            src = _FH_SRC.get(k, k)
            from_in.append((i, src == "st", k if src == "st" else src))
        elif k in slot_of:
            from_out.append((i, slot_of[k]))
        elif scratch.get(k) is not None:
            ptrs[i] = scratch[k].data_ptr()
    got = (ptrs, from_in, from_out, outs,
           (ctypes.c_int * len(_FH_DIMS))(*[dims[k] for k in _FH_DIMS]), scratch)
    while len(_FH_BUCKETS) >= _FH_MAX_BUCKETS:
        _FH_BUCKETS.pop(next(iter(_FH_BUCKETS)))
    _FH_BUCKETS[key] = got
    return got


_FH_SRC = {  # where each input of K13 lies: enc or the carried state
    "ready": "st", "job_alloc": "st", "live_job": "st", "queue_alloc": "st",
    "alive": "st", "push_jobs": "f_push_jobs", "push_row": "f_push_row",
    "ev_jobs": "f_ev_jobs", "ev_qrow": "f_ev_qrow", "elig0": "f_elig0",
    "vtn0": "f_vtn0"}


def _fuse_heaps_cuda(kind, spec, enc, st, rows, jcap, qh, use_gang_valid):
    from volcano_tpu_torch import _build

    lib = _build.library("fuse_heaps")
    f32, f64, plan_fn = _fh_lib(lib)
    ptrs, from_in, from_out, outs, dims, _ = _fh_bucket(
        lib, plan_fn, kind, spec, enc, st, rows, jcap, qh, use_gang_valid)
    ja = st["job_alloc"]
    buf = torch.empty(outs[-1][3], dtype=torch.int32, device=ja.device)
    parts = [buf[a:b].view(shape) for _, shape, a, b in outs]
    for i, is_st, key in from_in:
        ptrs[i] = (st if is_st else enc)[key].data_ptr()
    for i, j in from_out:
        ptrs[i] = parts[j].data_ptr()
    fn = f64 if ja.dtype == torch.float64 else f32
    rc = fn(ptrs, dims, int(kind == "reclaim"), devmod.raw_stream(ja.device))
    if rc != 0:
        raise RuntimeError(f"fuse_heaps kernel launch failed: CUDA error {rc}")
    devmod.count_launch(f"fuse_heaps_{kind}")
    return {k: p for (k, *_), p in zip(outs, parts)}


def fuse_heaps(kind: str, spec: EvictSpec, enc, st, rows: int, jcap: int,
               qh: int = 0, use_gang_valid: bool = False) -> Dict[str, torch.Tensor]:
    """K13: the fused chain's heap rebuild for ``kind`` ("preempt":
    reference session_fuse.py:196-215; "reclaim": :268-312), under the
    carried keys in ``st`` (see ``fuse_heaps_plain``). csrc/fuse_heaps.cu
    on CUDA tensors (raising if it cannot launch), the plain version on CPU
    tensors."""
    if st["job_alloc"].is_cuda:   # every input's device is checked at a bucket's first call
        return _fuse_heaps_cuda(kind, spec, enc, st, rows, jcap, qh,
                                use_gang_valid)
    return fuse_heaps_plain(kind, spec, enc, st, rows, jcap, qh,
                            use_gang_valid)


_PLAIN = {"preempt": preempt_plain, "reclaim": reclaim_plain,
          "backfill": backfill_plain}
_KERNEL = {"preempt": preempt, "reclaim": reclaim, "backfill": backfill}


def solve_packed(spec: EvictSpec, enc) -> torch.Tensor:
    """The reference's K12 (_solve_packed): dispatch the staged action
    arrays to the machine of ``spec.kind``. A Python dispatch with no
    kernel of its own."""
    return _KERNEL[spec.kind](spec, enc)


def solve_plain(spec: EvictSpec, enc) -> torch.Tensor:
    """The plain version of ``solve_packed`` on any device (the tests and
    the chip smoke compare the kernels with it)."""
    return _PLAIN[spec.kind](spec, enc)
