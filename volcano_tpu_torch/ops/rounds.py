"""Rounds-mode throughput solver: bulk-synchronous batched placement.

Port of volcano_tpu/ops/rounds.py (see its docstring for the algorithm
and its documented divergences from the serial oracle). Each function keeps
its counterpart's name and arithmetic; on the same padded arrays in
float64 on the CPU, ``solve_rounds`` returns the reference's ``assign``,
round count, placed histogram, full-sweep count and touched-node mask bit
for bit (tests/test_torch_rounds.py).

What differs from the reference is where the loop runs. The reference is
one jitted program with ``lax.while_loop``s; here the round, rollback,
straggler and tail loops are driven from the host, and every loop test
reads back the few scalars it needs in ONE transfer, counted as a sync
point (utils/devprof.py). A windowed round that is not a stall retry reads
one more scalar (does any class lack coverage). Moving the loop onto the
device is later work.

The kernel-shaped steps run through hand-written CUDA kernels on the card:
K1 ``score_block`` (ops/kernels.py) for the full and the dirty-column
score refresh and the tail pass, K2 ``window_topk``, K4
``resolve_prefix`` and K5 ``queue_budget`` (ops/rounds_kernels.py). Sorts,
gathers and scatters around them are torch ops. Scatter-adds of float
state use ``index_put_(accumulate=True)``, which accumulates the updates
of one row in their original order on both devices (on CUDA it sorts the
indices stably first instead of using atomics), so a solve is run-to-run
deterministic and matches the reference's sequential scatter.
"""

from __future__ import annotations

import torch

from volcano_tpu_torch.ops.kernels import (
    CHUNK,
    SolveSpec,
    _le_eps,
    _share,
    score_block,
)
from volcano_tpu_torch.ops.rounds_kernels import (
    INT32_MAX,
    queue_budget,
    resolve_prefix,
    window_topk,
)
from volcano_tpu_torch.utils import devprof


# per-round profile exported through the packed single-fetch result:
# node-count header (sizes the touched-node mask that precedes the tail),
# placed-per-round histogram slots plus the scalar tail (round-count limbs,
# tail_placed, full-sweep round count, capped flag)
PROF_SLOTS = 64
PROF_TAIL = 6 + PROF_SLOTS


def _lexsort(keys):
    """jnp.lexsort: indices sorting by the LAST key first, ties broken by
    the earlier keys, then by position (chained stable sorts)."""
    idx = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in keys:
        if k.dtype == torch.bool:
            k = k.to(torch.int8)
        idx = idx[torch.argsort(k[idx], stable=True)]
    return idx


def _inverse(order: torch.Tensor) -> torch.Tensor:
    """zeros.at[order].set(arange) as int32."""
    inv = torch.empty(order.shape[0], dtype=torch.int32, device=order.device)
    inv[order] = torch.arange(order.shape[0], dtype=torch.int32,
                              device=order.device)
    return inv


def _pair_order(primary: torch.Tensor, secondary: torch.Tensor):
    """jnp.lexsort((secondary, primary)) for int32 keys, as one stable sort
    of the injective int64 key (primary, secondary)."""
    key = primary.to(torch.int64) * (1 << 32) + (secondary.to(torch.int64)
                                                 + (1 << 31))
    return torch.argsort(key, stable=True)


def _scatter_add(base, idx, vals):
    """base.at[idx].add(vals): updates of one row land in index order."""
    return base.index_put((idx,), vals, accumulate=True)


def _scatter_any(size, idx, vals):
    """zeros(size, bool).at[idx].max(vals)."""
    out = torch.zeros(size, dtype=torch.int8, device=idx.device)
    return out.scatter_reduce(0, idx, vals.to(torch.int8), "amax").bool()


def _to_i32(x):
    """XLA's float -> int32 convert: truncation, saturating at the int32
    range, NaN -> 0."""
    x = torch.nan_to_num(x, nan=0.0)
    return torch.clamp(x, -2.0**31, 2.0**31 - 1).to(torch.int32)


def _job_rank(spec: SolveSpec, enc, job_placed, job_alloc):
    """[J] dense rank from the tiered job-order keys (low = first)."""
    keys = [enc["job_tie_rank"]]
    for name in reversed(spec.job_order_keys):
        if name == "priority":
            keys.append(-enc["job_priority"])
        elif name == "gang":
            ready = (enc["job_ready_base"] + job_placed) >= enc["job_min_available"]
            keys.append(ready.to(torch.int32))
        elif name == "drf":
            keys.append(_share(job_alloc, enc["drf_total"][None, :],
                               enc["drf_present"][None, :]))
    return _inverse(_lexsort(keys))


def _dirty_cols(dirty, n_dirty: int, dirty_k: int):
    """jnp.nonzero(dirty, size=dirty_k, fill_value=0) without a dynamic
    shape: a stable sort brings the dirty columns first, ascending."""
    n_total = dirty.shape[0]
    srt = torch.argsort((~dirty).to(torch.int8), stable=True).to(torch.int32)
    if dirty_k > n_total:
        srt = torch.cat([srt, torch.zeros(dirty_k - n_total, dtype=torch.int32,
                                          device=dirty.device)])
    else:
        srt = srt[:dirty_k]
    pos = torch.arange(dirty_k, device=dirty.device)
    return torch.where(pos < n_dirty, srt, torch.zeros_like(srt))


def _rescore_dirty(spec, enc, idle, used, cnt, excl_occ, scores, dirty,
                   n_dirty: int):
    """Dirty-column rescoring: K1 over the <= dirty_k columns the previous
    round touched, written into the carried matrix in place. Padding slots
    of the column list alias column 0 and rewrite identical values."""
    cols = _dirty_cols(dirty, n_dirty, spec.dirty_k)
    return score_block(spec, enc, idle, used, cnt, excl_occ, scores, cols=cols)


def _cap_walk(spec: SolveSpec, enc, order, score_ord, req, exl, has_pod,
              frac, idle, cnt, t_cap):
    """Capacity estimates and equal-score group structure along an ORDERED
    candidate axis (the full stable-argsort order or its top-k prefix).
    order/score_ord: [rows, W]. Returns (ccap, g_start, g_size,
    ccap_before), all int32 [rows, W]."""
    rows, width = order.shape
    dev = order.device
    feas = score_ord > float("-inf")
    idle_w = idle[order.long()]                               # [rows, W, R]
    eps = enc["eps"]
    safe_req = torch.maximum(req, eps[None, :])
    cap_dim = idle_w / safe_req[:, None, :]
    cap = torch.amin(
        torch.where((req > 0)[:, None, :], cap_dim,
                    torch.full_like(cap_dim, float("inf"))), dim=-1)
    big = torch.full_like(cap, float(t_cap))
    cap = torch.minimum(torch.where(torch.isinf(cap), big, cap), big)
    if spec.use_binpack:
        cap = cap * frac[:, None]
    if spec.use_exclusion:
        # at most one group member per node, ever
        cap = torch.where((exl >= 0)[:, None],
                          torch.clamp(cap, max=1.0), cap)
    if spec.check_pod_count:
        pod_room = (enc["node_max_tasks"] - cnt)[order.long()].to(cap.dtype)
        cap = torch.where(has_pod[:, None], torch.minimum(cap, pod_room), cap)
    zero = torch.zeros_like(cap)
    cap = torch.where(feas, torch.floor(cap), zero)
    cap = torch.maximum(cap, torch.where(feas, torch.ones_like(cap), zero))
    cap_i = cap.to(torch.int32)
    # saturating prefix sum at t_cap: for non-negative terms it equals the
    # exact prefix sum clamped at t_cap
    ccap = torch.clamp(torch.cumsum(cap_i.to(torch.int64), dim=1),
                       max=t_cap).to(torch.int32)

    pos = torch.arange(width, dtype=torch.int32, device=dev)[None, :].expand(rows, width)
    is_start = torch.ones((rows, width), dtype=torch.bool, device=dev)
    is_start[:, 1:] = score_ord[:, 1:] != score_ord[:, :-1]
    g_start = torch.cummax(torch.where(is_start, pos, torch.zeros_like(pos)),
                           dim=1).values
    starts = torch.where(is_start, pos, torch.full_like(pos, width))
    sfx = torch.flip(torch.cummin(torch.flip(starts, [1]), dim=1).values, [1])
    g_end = torch.cat(
        [sfx[:, 1:], torch.full((rows, 1), width, dtype=torch.int32, device=dev)],
        dim=1)
    g_size = g_end - g_start
    before = torch.gather(ccap, 1, torch.clamp(g_start - 1, min=0).long())
    ccap_before = torch.where(g_start > 0, before, torch.zeros_like(before))
    return ccap, g_start, g_size, ccap_before


def _nominate_full(spec: SolveSpec, enc, scores, idle, cnt, cls_frac, t_cap):
    """Full-width nomination: stable argsort over all N columns plus the
    capacity walk, chunked over class rows (bounds the [rows, N, R]
    gather)."""
    k_total = scores.shape[0]
    outs = []
    for lo in range(0, k_total, CHUNK):
        sl = slice(lo, min(lo + CHUNK, k_total))
        sc = scores[sl]
        order = torch.argsort(-sc, dim=-1, stable=True).to(torch.int32)
        score_ord = torch.gather(sc, 1, order.long())
        walk = _cap_walk(
            spec, enc, order, score_ord, enc["cls_req"][sl],
            enc["cls_excl"][sl] if spec.use_exclusion else None,
            enc["cls_has_pod"][sl],
            cls_frac[sl] if spec.use_binpack else None, idle, cnt, t_cap)
        outs.append((order,) + walk)
    return tuple(torch.cat([o[i] for o in outs], dim=0) for i in range(5))


def _excl_grank(enc, cls_live):
    """Rank of each class among its exclusion group's LIVE classes, lower
    class index first (one stable argsort + segmented prefix count)."""
    exl_all = enc["cls_excl"]
    perm = torch.argsort(exl_all, stable=True)
    sorted_gid = exl_all[perm]
    sorted_live = cls_live[perm].to(torch.int32)
    prefix = torch.cumsum(sorted_live, dim=0).to(torch.int32) - sorted_live
    seg_start = torch.ones_like(sorted_live, dtype=torch.bool)
    seg_start[1:] = sorted_gid[1:] != sorted_gid[:-1]
    seg_base = torch.cummax(torch.where(seg_start, prefix,
                                        torch.zeros_like(prefix)), dim=0).values
    out = torch.zeros(exl_all.shape[0], dtype=torch.int32, device=exl_all.device)
    out[perm] = (prefix - seg_base).to(torch.int32)
    return out


def _rank_in_class(task_cls, active):
    """Rank of each ACTIVE task within its class, in flat order: sort by
    (class, inactive-last, flat index), position inside the segment."""
    t_total = task_cls.shape[0]
    idxs = torch.arange(t_total, dtype=torch.int32, device=task_cls.device)
    ordix = _lexsort([idxs, ~active, task_cls])
    sorted_cls = task_cls[ordix]
    sorted_act = active[ordix]
    seg_start = torch.ones(t_total, dtype=torch.bool, device=task_cls.device)
    seg_start[1:] = (sorted_cls[1:] != sorted_cls[:-1]) \
        | (sorted_act[1:] != sorted_act[:-1])
    start_idx = torch.cummax(torch.where(seg_start, idxs,
                                         torch.zeros_like(idxs)), dim=0).values
    out = torch.zeros(t_total, dtype=torch.int32, device=task_cls.device)
    out[ordix] = idxs - start_idx
    return out


def _select(spec: SolveSpec, enc, task_cls, active, rank, n_feas, grank,
            order, ccap, g_start, g_size, ccap_before):
    """Per-task node choice from an ordered per-class candidate axis of
    width W: binary search of the task's rank in its class's cumulative
    capacity, rotation within equal-score groups (not under binpack),
    exclusion spread. Returns (choice, cons_choice, slot, final)."""
    width = order.shape[1]
    tk = task_cls.long()
    t_total = tk.shape[0]
    dev = tk.device
    lo = torch.zeros(t_total, dtype=torch.int32, device=dev)
    hi = torch.full((t_total,), width, dtype=torch.int32, device=dev)
    for _ in range(max(1, int(width).bit_length())):
        mid = (lo + hi) // 2
        go_right = ccap[tk, torch.clamp(mid, max=width - 1).long()] <= rank
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    slot = lo
    nf = n_feas[tk]
    overflow = slot >= nf
    slot_c = torch.clamp(slot, 0, width - 1)
    slot_l = slot_c.long()
    if spec.use_binpack and not spec.use_exclusion:
        final = slot_c
    else:
        gs = g_start[tk, slot_l]
        gz = torch.clamp(g_size[tk, slot_l], min=1)
        local = rank - ccap_before[tk, slot_l]
        rotated = gs + (torch.clamp(local, min=0) % gz)
        if spec.use_binpack:
            is_excl = enc["cls_excl"][tk] >= 0
            final = torch.where(is_excl, rotated, slot_c)
        else:
            final = rotated
    if spec.use_exclusion:
        is_exg = enc["cls_excl"][tk] >= 0
        spread = torch.minimum(
            torch.clamp(final + grank[tk], min=0),
            torch.clamp(nf - 1, min=0))
        final = torch.where(is_exg, spread, final)
    choice = order[tk, torch.clamp(final, 0, width - 1).long()]
    feasible = (nf > 0) & ~overflow & active
    minus1 = torch.full_like(choice, -1)
    cons_choice = torch.where((nf > 0) & active, order[tk, 0], minus1)
    return torch.where(feasible, choice, minus1), cons_choice, slot, final


def _quantize(enc):
    """Integer units of the exact acceptance scans: ceil(task_req / unit)
    as int64, and eps / unit truncated to int32 (as the reference)."""
    unit = enc["res_unit"]
    req_i = _to_i32(torch.ceil(enc["task_req"] / unit[None, :])).to(torch.int64)
    eps_i = _to_i32(enc["eps"] / unit)
    return unit, req_i, eps_i


def _resolve(spec: SolveSpec, enc, idle, cnt, choice, task_rank):
    """Per-node prefix acceptance: sort by (node, rank), accept the longest
    priority-prefix whose cumulative request fits (K4). Returns accept [T]
    bool."""
    t_total = choice.shape[0]
    unit, req_i, eps_i = _quantize(enc)
    idle_i = _to_i32(torch.floor(idle / unit[None, :]))
    bound = (idle_i + eps_i[None, :]).to(torch.int64)  # int32 add, widened
    node_key = torch.where(choice >= 0, choice,
                           torch.full_like(choice, INT32_MAX))
    order = _pair_order(node_key, task_rank)
    ch_s = node_key[order].contiguous()
    pod_s = (enc["task_has_pod"][order] & (ch_s != INT32_MAX)).contiguous()
    accept_s = resolve_prefix(
        ch_s, req_i[order].contiguous(), pod_s, bound.contiguous(),
        enc["is_scalar"], cnt, enc["node_max_tasks"], spec.check_pod_count)
    accept = torch.empty(t_total, dtype=torch.bool, device=choice.device)
    accept[order] = accept_s
    return accept


def _queue_budget(enc, queue_alloc, accept, task_rank, task_queue, task_job):
    """Job-granular queue fair-share cap inside a round (K5): for accepted
    tasks ordered (queue, rank), a job's tasks survive iff queue_alloc +
    contributions of higher-ranked jobs in the same queue fit under
    deserved with the epsilon comparison."""
    t_total = accept.shape[0]
    unit, req_i, eps_i = _quantize(enc)
    req = torch.where(accept[:, None], req_i, torch.zeros_like(req_i))
    order = _pair_order(task_queue, task_rank)
    alloc_i = _to_i32(torch.ceil(queue_alloc / unit[None, :])).to(torch.int64)
    deserved_i = _to_i32(torch.floor(enc["queue_deserved"] / unit[None, :]))
    bound = (deserved_i + eps_i[None, :]).to(torch.int64)
    ok_s = queue_budget(
        task_queue[order].contiguous(), task_job[order].contiguous(),
        req[order].contiguous(), accept[order].contiguous(),
        alloc_i.contiguous(), bound.contiguous(), enc["is_scalar"])
    out = torch.empty(t_total, dtype=torch.bool, device=accept.device)
    out[order] = ok_s
    return out


def unpack_layout(layout, bufs):
    """Split packed flat buffers (solver._pack) into the enc dict: static
    slices viewed in place. Plain keys beside the packed "group.kind"
    buffers are merged as they are."""
    enc = {
        name: bufs[key][off:off + size].reshape(shape)
        for name, key, off, size, shape in layout
    }
    for key in bufs:
        if "." not in key:
            enc[key] = bufs[key]
    return enc


def pack_result(enc, raw):
    """Pack a solve_rounds result tuple into ONE array: assign, the
    touched-node mask, then a PROF_TAIL-long profile tail (node-count
    header, round-counter limbs, tail_placed, full-sweep round count,
    capped flag, the placed-per-round histogram); int16 when the node
    count allows."""
    (assign, n_rounds, tail_placed, full_sweeps, capped, placed_hist,
     touched) = raw
    n_total = enc["node_idle"].shape[0]
    tail = [n_total, n_rounds & 0x7FFF, n_rounds >> 15,
            min(tail_placed, 0x7FFF), min(full_sweeps, 0x7FFF), int(capped)]
    tail += [min(int(x), 0x7FFF) for x in placed_hist]
    dt = torch.int16 if n_total <= 32766 else torch.int32
    tail_t = torch.tensor(tail, dtype=torch.int32).to(assign.device)
    return torch.cat([assign.to(dt), touched.to(dt), tail_t.to(dt)])


class _Dims:
    """Shapes and per-task columns every phase of one solve reads."""

    def __init__(self, enc):
        self.t = enc["task_cls"].shape[0]
        self.j = enc["job_tie_rank"].shape[0]
        self.k = enc["cls_req"].shape[0]
        self.n = enc["node_idle"].shape[0]
        self.dev = enc["cls_req"].device
        self.dt = enc["cls_req"].dtype
        self.task_cls = enc["task_cls"]
        self.task_cls_l = enc["task_cls"].long()
        self.task_job = enc["task_job"]
        self.task_job_l = enc["task_job"].long()
        self.task_queue = enc["job_queue"][self.task_job_l]
        self.task_queue_l = self.task_queue.long()
        self.task_ns_l = enc["job_ns"][self.task_job_l].long()
        self.task_excl = enc["cls_excl"][self.task_cls_l]
        ar = torch.arange(self.t, dtype=torch.int32, device=self.dev)
        self.task_in_job = ar - enc["job_task_start"][self.task_job_l]
        self.task_valid = (ar < (enc["job_task_start"][self.task_job_l]
                                 + enc["job_task_count"][self.task_job_l])) \
            & enc["job_active0"][self.task_job_l]


def _round(spec, enc, d, st, cons: bool, n_dirty: int, t_cap: int):
    """One bulk-synchronous round (the reference's round_body). Returns
    the new state and the host-side facts of the round: placed count,
    still-active count, next round's dirty count, full-width flag."""
    job_rank = _job_rank(spec, enc, st["job_placed"], st["job_alloc"])
    task_rank = job_rank[d.task_job_l] * d.t + d.task_in_job  # int32, as ref
    active = st["active"]
    if spec.use_prop_overused:
        over = ~_le_eps(st["queue_alloc"], enc["queue_deserved"],
                             enc["eps"], enc["is_scalar"])
        active = active & ~over[d.task_queue_l]
    idle, used, cnt = st["idle"], st["used"], st["cnt"]
    occ = st.get("excl_occ")

    # carried scores: patch the dirty columns, or rebuild past the budget
    scores = st["scores"]
    if spec.dirty_k > 0 and n_dirty <= spec.dirty_k:
        _rescore_dirty(spec, enc, idle, used, cnt, occ, scores, st["dirty"],
                       n_dirty)
    else:
        # full-width refresh, every class row, live or not: a class
        # revived by a rollback must find current scores
        score_block(spec, enc, idle, used, cnt, occ, scores)
    n_feas = torch.sum(scores > float("-inf"), dim=-1).to(torch.int32)

    cls_live = _scatter_any(d.k, d.task_cls_l, active)
    cls_frac = None
    if spec.use_binpack:
        cls_demand = torch.zeros(d.k, dtype=torch.int32, device=d.dev) \
            .index_add_(0, d.task_cls_l, active.to(torch.int32))
        cls_frac = cls_demand.to(d.dt) / torch.clamp(
            torch.sum(cls_demand), min=1).to(d.dt)
    grank = _excl_grank(enc, cls_live) if spec.use_exclusion else None
    rank = _rank_in_class(d.task_cls, active)
    excl_cls = enc["cls_excl"] if spec.use_exclusion else None

    if spec.window_k > 0:
        k_eff = spec.window_k
        top_s, top_i = window_topk(scores, k_eff)
        nom_w = _cap_walk(spec, enc, top_i, top_s, enc["cls_req"], excl_cls,
                          enc["cls_has_pod"], cls_frac, idle, cnt, t_cap)
        choice_w, cons_choice, slot_w, final_w = _select(
            spec, enc, d.task_cls, active, rank, n_feas, grank, top_i, *nom_w)
        # coverage bit: is the windowed answer provably full-width?
        g_start_w = nom_w[1]
        all_in = n_feas <= k_eff
        full_k = torch.full((d.k,), k_eff, dtype=torch.int32, device=d.dev)
        if spec.use_binpack and not spec.use_exclusion:
            safe_end = full_k
        elif spec.use_binpack:
            safe_end = torch.where(enc["cls_excl"] >= 0,
                                   g_start_w[:, k_eff - 1], full_k)
        else:
            safe_end = g_start_w[:, k_eff - 1]
        safe_end = torch.where(all_in, full_k, safe_end)[d.task_cls_l]
        exact = all_in[d.task_cls_l] | ((slot_w < safe_end) & (final_w < safe_end))
        uncovered = _scatter_any(d.k, d.task_cls_l, active & ~exact)
        # stall rounds take cons_choice (exact by construction), so only a
        # real windowed round asks whether any class lacks coverage
        run_full = (not cons) and bool(devprof.readback(torch.any(uncovered)))
        if run_full:
            nom_f = _nominate_full(spec, enc, scores, idle, cnt, cls_frac, t_cap)
            choice_full = _select(spec, enc, d.task_cls, active, rank,
                                  n_feas, grank, *nom_f)[0]
            choice = torch.where(uncovered[d.task_cls_l], choice_full, choice_w)
            touched = torch.ones_like(st["touched"])
        else:
            choice = torch.where(uncovered[d.task_cls_l],
                                 torch.full_like(choice_w, -1), choice_w)
            touched = st["touched"].index_put(
                (top_i.reshape(-1).long(),),
                torch.ones((), dtype=torch.bool, device=d.dev))
        did_full = run_full
    else:
        nom_f = _nominate_full(spec, enc, scores, idle, cnt, cls_frac, t_cap)
        choice, cons_choice, _, _ = _select(
            spec, enc, d.task_cls, active, rank, n_feas, grank, *nom_f)
        did_full = True
        touched = torch.ones_like(st["touched"])
    if cons:
        choice = cons_choice
    task_excl = d.task_excl
    if spec.use_exclusion:
        # within-round mutual exclusion: one winner per (group, node), the
        # best-ranked task, by a scatter-min of the (unique) task rank
        isx = (task_excl >= 0) & (choice >= 0)
        flat = (torch.clamp(task_excl, min=0).long() * d.n
                + torch.clamp(choice, 0, d.n - 1).long())
        big = torch.full_like(task_rank, 2**30)
        n_groups = enc["excl_occ0"].shape[0]
        winner = torch.full((n_groups * d.n,), 2**30, dtype=torch.int32,
                            device=d.dev).scatter_reduce(
            0, flat, torch.where(isx, task_rank, big), "amin")
        keepm = ~isx | (task_rank == winner[flat])
        choice = torch.where(keepm, choice, torch.full_like(choice, -1))
    accept = _resolve(spec, enc, st["idle"], st["cnt"], choice, task_rank)
    if spec.use_prop_overused:
        accept = _queue_budget(enc, st["queue_alloc"], accept, task_rank,
                               d.task_queue, d.task_job)

    node = torch.clamp(choice, 0, d.n - 1).long()
    dreq = torch.where(accept[:, None], enc["task_req"],
                       torch.zeros_like(enc["task_req"]))
    acc_i = accept.to(torch.int32)
    new_active = st["active"] & ~accept
    dirty = _scatter_any(d.n, node, accept)
    out = dict(
        st,
        idle=_scatter_add(st["idle"], node, -dreq),
        used=_scatter_add(st["used"], node, dreq),
        cnt=st["cnt"].index_add(0, node, acc_i),
        assign=torch.where(accept, choice, st["assign"]),
        active=new_active,
        job_placed=st["job_placed"].index_add(0, d.task_job_l, acc_i),
        job_alloc=_scatter_add(st["job_alloc"], d.task_job_l, dreq),
        queue_alloc=_scatter_add(st["queue_alloc"], d.task_queue_l, dreq),
        ns_alloc=_scatter_add(st["ns_alloc"], d.task_ns_l, dreq),
        scores=scores, dirty=dirty, touched=touched)
    if spec.use_exclusion:
        g_flat = torch.clamp(task_excl, min=0).long() * d.n + node
        occ_flat = st["excl_occ"].reshape(-1).to(torch.int8).scatter_reduce(
            0, g_flat, (accept & (task_excl >= 0)).to(torch.int8), "amax")
        out["excl_occ"] = occ_flat.bool().reshape(st["excl_occ"].shape)
    placed_n, remaining, n_dirty_next = (int(x) for x in devprof.readback(
        torch.stack([acc_i.sum(), new_active.sum(), dirty.sum()])))
    return out, placed_n, remaining, n_dirty_next, did_full


def _rollback(spec, enc, d, st):
    """Retire the WORST-ranked gang still short of min_available
    (Statement.Discard semantics), one job per fixpoint iteration.
    Returns (state, any candidate, dirty count, still-active count)."""
    short = (enc["job_ready_base"] + st["job_placed"]) < enc["job_ready_threshold"]
    cand = short & (st["job_placed"] > 0)
    job_rank = _job_rank(spec, enc, st["job_placed"], st["job_alloc"])
    worst = torch.argmax(torch.where(cand, job_rank, torch.full_like(job_rank, -1)))
    roll_job = cand & (torch.arange(d.j, device=d.dev) == worst)
    dead_task = roll_job[d.task_job_l]
    roll = dead_task & (st["assign"] >= 0)
    node = torch.clamp(st["assign"], 0, d.n - 1).long()
    dreq = torch.where(roll[:, None], enc["task_req"],
                       torch.zeros_like(enc["task_req"]))
    out = dict(
        st,
        idle=_scatter_add(st["idle"], node, dreq),
        used=_scatter_add(st["used"], node, -dreq),
        cnt=st["cnt"].index_add(0, node, -roll.to(torch.int32)),
        assign=torch.where(roll, torch.full_like(st["assign"], -1), st["assign"]),
        active=st["active"] & ~dead_task,
        job_placed=torch.where(roll_job, torch.zeros_like(st["job_placed"]),
                               st["job_placed"]),
        job_alloc=_scatter_add(st["job_alloc"], d.task_job_l, -dreq),
        queue_alloc=_scatter_add(st["queue_alloc"], d.task_queue_l, -dreq),
        ns_alloc=_scatter_add(st["ns_alloc"], d.task_ns_l, -dreq),
        dirty=st["dirty"] | _scatter_any(d.n, node, roll))
    if spec.use_exclusion:
        # free the rolled members' group slots
        g_flat = torch.clamp(d.task_excl, min=0).long() * d.n + node
        occ_flat = st["excl_occ"].reshape(-1).to(torch.int8).scatter_reduce(
            0, g_flat, (~(roll & (d.task_excl >= 0))).to(torch.int8), "amin")
        out["excl_occ"] = occ_flat.bool().reshape(st["excl_occ"].shape)
    any_cand, n_dirty, remaining = (int(x) for x in devprof.readback(
        torch.stack([cand.any().to(torch.int64), out["dirty"].sum(),
                     out["active"].sum()])))
    return out, bool(any_cand), n_dirty, remaining


def _tail_pass(spec, enc, d, st, remaining: int):
    """Sequential per-task placement of the diminishing-returns remainder,
    in the serial visit order: one task per step (lowest live task rank),
    its class row of K1 (feasibility mask + fused score), argmax node
    (first max = lowest index, the serial tie-break), scatter-commit.
    Returns (state, tail_placed, tail_failed)."""
    tail_budget = 8 * max(spec.round_min_progress, 1) + 16
    tail_failed = torch.zeros_like(st["active"])
    tail_placed = 0
    steps = 0
    scratch = torch.empty((d.k, d.n), dtype=d.dt, device=d.dev)
    stuck = False
    while remaining > 0 and not stuck and steps < tail_budget:
        eligible = st["active"]
        if spec.use_prop_overused:
            over = ~_le_eps(st["queue_alloc"], enc["queue_deserved"],
                                 enc["eps"], enc["is_scalar"])
            eligible = eligible & ~over[d.task_queue_l]
        # lexicographic argmin over the job-order keys, then task order
        levels = []
        for name in spec.job_order_keys:
            if name == "priority":
                levels.append((-enc["job_priority"])[d.task_job_l])
            elif name == "gang":
                ready = ((enc["job_ready_base"] + st["job_placed"])
                         >= enc["job_min_available"])
                levels.append(ready.to(torch.int32)[d.task_job_l])
            elif name == "drf":
                share = _share(st["job_alloc"], enc["drf_total"][None, :],
                               enc["drf_present"][None, :])
                levels.append(share[d.task_job_l])
        levels.append(enc["job_tie_rank"][d.task_job_l])
        levels.append(d.task_in_job)
        cand = eligible
        for lv in levels:
            if lv.dtype.is_floating_point:
                sentinel = torch.full_like(lv, float("inf"))
            else:
                sentinel = torch.full_like(lv, torch.iinfo(lv.dtype).max)
            m = torch.amin(torch.where(cand, lv, sentinel))
            cand = cand & (lv == m)
        t = torch.argmax(cand.to(torch.int8))
        has = eligible.any()
        c = d.task_cls_l[t]
        score_block(spec, enc, st["idle"], st["used"], st["cnt"],
                    st.get("excl_occ"), scratch)
        row = scratch[c]
        node = torch.argmax(row)
        ok = has & (row[node] > float("-inf"))
        req = enc["cls_req"][c]
        dreq = torch.where(ok, req, torch.zeros_like(req))
        ok_i = ok.to(torch.int32)
        job = d.task_job_l[t]
        out = dict(
            st,
            idle=st["idle"].index_put((node[None],), -dreq[None], accumulate=True),
            used=st["used"].index_put((node[None],), dreq[None], accumulate=True),
            cnt=st["cnt"].index_put((node[None],), ok_i[None], accumulate=True),
            assign=st["assign"].index_put(
                (t[None],), torch.where(ok, node.to(torch.int32),
                                        st["assign"][t])[None]),
            active=st["active"].index_put(
                (t[None],), (st["active"][t] & ~has)[None]),
            job_placed=st["job_placed"].index_put((job[None],), ok_i[None],
                                                  accumulate=True),
            job_alloc=st["job_alloc"].index_put((job[None],), dreq[None],
                                                accumulate=True),
            queue_alloc=st["queue_alloc"].index_put(
                (d.task_queue_l[t][None],), dreq[None], accumulate=True),
            ns_alloc=st["ns_alloc"].index_put(
                (d.task_ns_l[t][None],), dreq[None], accumulate=True))
        if spec.use_exclusion:
            g = d.task_excl[t]
            gi = torch.clamp(g, min=0).long()
            occ = st["excl_occ"].clone()
            occ[gi, node] = occ[gi, node] | (ok & (g >= 0))
            out["excl_occ"] = occ
        tail_failed = tail_failed.index_put(
            (t[None],), (tail_failed[t] | (has & ~ok))[None])
        st = out
        steps += 1
        has_h, ok_h, remaining = (int(x) for x in devprof.readback(
            torch.stack([has.to(torch.int64), ok.to(torch.int64),
                         st["active"].sum()])))
        stuck = not has_h
        tail_placed += ok_h
    return st, tail_placed, tail_failed


def solve_rounds(spec: SolveSpec, enc: dict):
    """Batched allocate session. Returns (assign [T] int32 node or -1/-2,
    rounds used, tail_placed, full-sweep rounds, capped flag,
    placed-per-round histogram [PROF_SLOTS] as a list, touched-node mask
    [N] bool).

    ``enc`` holds the padded encoded arrays as tensors on one device
    (ops/solver.from_numpy_encoded). Per-task request/has-pod columns are
    derived from the class arrays (task_req = cls_req[task_cls])."""
    enc = dict(
        enc,
        task_req=enc["cls_req"][enc["task_cls"].long()],
        task_has_pod=enc["cls_has_pod"][enc["task_cls"].long()],
    )
    d = _Dims(enc)
    t_cap = d.t + 1  # capacity clamp: ranks never reach it
    st = dict(
        idle=enc["node_idle"].clone(), used=enc["node_used"].clone(),
        cnt=enc["node_cnt"].clone(),
        assign=torch.full((d.t,), -1, dtype=torch.int32, device=d.dev),
        active=d.task_valid,
        job_placed=torch.zeros(d.j, dtype=torch.int32, device=d.dev),
        job_alloc=enc["job_alloc0"], queue_alloc=enc["queue_alloc0"],
        ns_alloc=enc["ns_alloc0"],
        # carried masked score matrix + dirty-column set: all columns start
        # dirty, so the first round always takes a full refresh (or an
        # all-column gather when dirty_k covers the whole axis)
        scores=torch.zeros((d.k, d.n), dtype=d.dt, device=d.dev),
        dirty=torch.ones(d.n, dtype=torch.bool, device=d.dev),
        touched=torch.zeros(d.n, dtype=torch.bool, device=d.dev),
    )
    if spec.use_exclusion:
        st["excl_occ"] = enc["excl_occ0"].clone()
    round_budget = 2 * (d.t + d.j) + 8
    rounds = 0
    progress, tried_cons, dead, capped = True, False, False, False
    placed_hist = [0] * PROF_SLOTS
    full_sweeps = 0
    n_dirty = d.n
    remaining = int(devprof.readback(d.task_valid.sum()))
    rmp = spec.round_min_progress

    def one_round(st, cons):
        nonlocal rounds, progress, tried_cons, capped, full_sweeps, n_dirty, remaining
        st, placed_n, still, n_dirty, did_full = _round(
            spec, enc, d, st, cons, n_dirty, t_cap)
        if rmp > 1:
            # diminishing-returns exit: a nonzero round below the progress
            # floor with a small remainder hands it to the stragglers/tail
            capped = capped or (0 < placed_n < rmp and 0 < still <= 8 * rmp)
        placed_hist[min(rounds, PROF_SLOTS - 1)] += placed_n
        rounds += 1
        progress = placed_n > 0
        tried_cons = cons and not progress
        full_sweeps += int(did_full)
        remaining = still
        return st

    while not dead and rounds < round_budget:
        while (progress or not tried_cons) and remaining > 0 \
                and rounds < round_budget and not capped:
            st = one_round(st, cons=not progress)
        if capped:
            dead = True
        else:
            st, any_cand, n_dirty, remaining = _rollback(spec, enc, d, st)
            progress = True
            dead = not any_cand
        tried_cons = False

    if rmp > 1 and spec.straggler_rounds > 0:
        # batched straggler rounds over the capped remainder before the
        # sequential tail pass
        extra = 0
        progress = True
        while capped and progress and remaining > 0 \
                and extra < spec.straggler_rounds and rounds < round_budget:
            st = one_round(st, cons=not progress)
            extra += 1

    tail_placed = 0
    tail_failed = None
    if rmp > 1:
        tail_failed = torch.zeros_like(st["active"])
        if capped:
            st, tail_placed, tail_failed = _tail_pass(spec, enc, d, st, remaining)
    # structural gang-atomicity net (a no-op on a normal exit)
    short = (enc["job_ready_base"] + st["job_placed"]) < enc["job_ready_threshold"]
    minus = torch.full_like(st["assign"], -1)
    assign = torch.where(short[d.task_job_l], minus, st["assign"])
    # capped exit: still-wanting tasks go to the serial residue retry (-2)
    strip_retry = short & (st["job_placed"] > 0)
    want_retry = st["active"] | (strip_retry[d.task_job_l] & d.task_valid)
    if tail_failed is not None:
        want_retry = want_retry | (tail_failed & d.task_valid)
    if capped:
        assign = torch.where(want_retry & (assign < 0),
                             torch.full_like(assign, -2), assign)
    touched = torch.ones_like(st["touched"]) if capped else st["touched"]
    return (assign, rounds, tail_placed, full_sweeps, capped, placed_hist,
            touched)
