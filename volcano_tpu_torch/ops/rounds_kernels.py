"""K2 window_topk, K2b cap_walk, K6 job_rank, K3 round_select (with K6's
in-class and exclusion-group ranks), K4 resolve_prefix, K5 queue_budget,
K7a rounds_ctl, K7b tail_pass and K7c round_commit (the round's commit and
the rollback's undo): the wrappers of the hand-written CUDA kernels of the
rounds solver, each beside its plain PyTorch version.

A wrapper launches its kernel (csrc/<name>.cu) for CUDA tensors, raising
when it cannot, and runs the plain version for CPU tensors; it never falls
back from one to the other. Each launch adds one to its count in
volcano_tpu_torch.device.LAUNCHES.
"""

from __future__ import annotations

import ctypes

import torch

from volcano_tpu_torch import device as devmod
from volcano_tpu_torch.ops.kernels import (  # noqa: F401 (score_weights re-exported)
    MIN_MILLI_SCALAR,
    _check,
    _ptr,
    _share,
    score_weights,
)

INT32_MAX = 2**31 - 1


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _same_device(ref, **tensors):
    for name, t in tensors.items():
        if t.device != ref.device:
            raise ValueError(f"{name}: on {t.device}, expected {ref.device}")


# -- K2: per-row stable top-k window ----------------------------------------

def order_key(x: torch.Tensor) -> torch.Tensor:
    """The bits of a float32/float64 tensor as integers that order like
    the floats under IEEE 754's total order: -inf lowest, -0.0 below +0.0
    (the order lax.top_k sorts by). NaN lies outside the domain."""
    if x.dtype == torch.float64:
        bits, low = x.view(torch.int64), (1 << 63) - 1
    elif x.dtype == torch.float32:
        bits, low = x.view(torch.int32), (1 << 31) - 1
    else:
        raise TypeError(f"order_key: dtype {x.dtype}")
    return bits ^ ((bits >> (bits.element_size() * 8 - 1)) & low)


def window_topk_plain(scores: torch.Tensor, k: int):
    """The first k entries of each row's stable descending order under the
    total order (+0.0 ahead of -0.0, ties to the lower index, -inf an
    ordinary key): the exact prefix that volcano_tpu/ops/rounds.py:754
    lax.top_k returns. (values, int32 idx)."""
    order = torch.argsort(order_key(scores), dim=1, descending=True,
                          stable=True)[:, :k]
    return torch.gather(scores, 1, order), order.to(torch.int32)


def window_topk(scores: torch.Tensor, k: int):
    """K2 (csrc/window_topk.cu) on CUDA, the plain version on the CPU."""
    if not devmod.on_cuda(scores):
        return window_topk_plain(scores, k)
    if scores.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"scores: dtype {scores.dtype}")
    if scores.dim() != 2 or not scores.is_contiguous():
        raise ValueError("scores: expected a contiguous [K, N] matrix")
    rows, n = scores.shape
    if not 0 < k <= n:
        raise ValueError(f"window_topk: k={k} outside (0, {n}]")
    top_s = torch.empty((rows, k), dtype=scores.dtype, device=scores.device)
    top_i = torch.empty((rows, k), dtype=torch.int32, device=scores.device)
    # the k survivors of each row's radix select, in any order: their keys
    # (int64) then their inverted indices (int32); inside a graph capture
    # the graph's pool serves it
    scratch = torch.empty(3 * rows * k, dtype=torch.int32, device=scores.device)
    window_topk_launch(scores, k, top_s, top_i, scratch)
    return top_s, top_i


_TOPK_FNS = {}


def window_topk_launch(scores, k, top_s, top_i, scratch) -> None:
    """One launch of K2 into the caller's outputs and scratch (int32,
    3 x rows x k), all on the card and checked by ``window_topk``."""
    fn = _TOPK_FNS.get(scores.dtype)
    if fn is None:
        from volcano_tpu_torch import _build

        lib = _build.library("window_topk")
        fn = lib.window_topk_f64 if scores.dtype == torch.float64 else lib.window_topk_f32
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6
        fn.restype = ctypes.c_int
        _TOPK_FNS[scores.dtype] = fn
    rows, n = scores.shape
    base = scratch.data_ptr()
    rc = fn(rows, n, k, scores.data_ptr(), top_s.data_ptr(), top_i.data_ptr(),
            base, base + 8 * rows * k, _stream(scores))
    if rc != 0:
        raise RuntimeError(f"window_topk kernel launch failed: CUDA error {rc}")
    devmod.count_launch("window_topk")


# each kernel library's entry points, their argtypes set once a library
_FNS: dict = {}


def _entry(lib_name, *fn_names, argtypes):
    """The named entry points of the kernel library, argtypes set once."""
    from volcano_tpu_torch import _build

    lib = _build.library(lib_name)
    fns = _FNS.get((lib, fn_names))
    if fns is None:
        fns = tuple(getattr(lib, n) for n in fn_names)
        for fn in fns:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _FNS[(lib, fn_names)] = fns
    return fns


# -- K2b: the capacity walk ----------------------------------------------------

def cap_walk_plain(spec, order, score_ord, req, exl, has_pod, frac, idle, cnt,
                   nmax, eps, t_cap: int):
    """Capacity estimates and equal-score group structure along an ORDERED
    candidate axis (volcano_tpu/ops/rounds.py:190 ``_cap_walk``): the full
    stable-argsort order or its top-k prefix. order int32 / score_ord
    [rows, W]; req [rows, R]; exl int32 [rows] (None without exclusion);
    frac [rows] (None without binpack); idle [N, R]; eps [R]; has_pod bool
    [rows] and cnt, nmax int32 [N] (read with the pod check). Returns
    (ccap, g_start, g_size, ccap_before), all int32 [rows, W]."""
    rows, width = order.shape
    dev = order.device
    feas = score_ord > float("-inf")
    idle_w = idle[order.long()]                               # [rows, W, R]
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
        pod_room = (nmax - cnt)[order.long()].to(cap.dtype)
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


class _WalkArgs(ctypes.Structure):
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "order", "score", "req", "exl", "has_pod", "frac", "idle", "cnt",
        "nmax", "eps", "ccap", "g_start", "g_size", "ccap_before")]
        + [(name, ctypes.c_int) for name in ("rows", "W", "N", "R", "t_cap", "flags")])


def cap_walk(spec, order, score_ord, req, exl, has_pod, frac, idle, cnt, nmax,
             eps, t_cap: int):
    """K2b (csrc/cap_walk.cu, a CTA a row) on CUDA, the plain version on
    the CPU; the same arguments and results as ``cap_walk_plain``. Its
    only memory is its output (from the graph's pool while a solve is
    captured)."""
    if not devmod.on_cuda(order, score_ord, idle):
        return cap_walk_plain(spec, order, score_ord, req, exl, has_pod, frac,
                              idle, cnt, nmax, eps, t_cap)
    rows, width = order.shape
    n, r = idle.shape
    dt = idle.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"idle: dtype {dt}")
    if not 0 <= int(t_cap) < 2**31 - 1:
        raise ValueError(f"cap_walk: t_cap {t_cap} outside the int32 range")
    i32 = torch.int32
    checks = [("order", order, i32, (rows, width)),
              ("score_ord", score_ord, dt, (rows, width)), ("req", req, dt, (rows, r)),
              ("idle", idle, dt, (n, r)), ("eps", eps, dt, (r,))]
    if spec.check_pod_count:
        checks += [("has_pod", has_pod, torch.bool, (rows,)), ("cnt", cnt, i32, (n,)),
                   ("nmax", nmax, i32, (n,))]
    if spec.use_exclusion:
        checks.append(("exl", exl, i32, (rows,)))
    if spec.use_binpack:
        checks.append(("frac", frac, dt, (rows,)))
    _check_all(order, checks)
    out = torch.empty((4, rows, width), dtype=i32, device=order.device)
    a = _WalkArgs(
        order=order.data_ptr(), score=score_ord.data_ptr(), req=req.data_ptr(),
        exl=exl.data_ptr() if spec.use_exclusion else None,
        frac=frac.data_ptr() if spec.use_binpack else None, idle=idle.data_ptr(),
        eps=eps.data_ptr(),
        ccap=out[0].data_ptr(), g_start=out[1].data_ptr(), g_size=out[2].data_ptr(),
        ccap_before=out[3].data_ptr(), rows=rows, W=width, N=n, R=r, t_cap=int(t_cap),
        flags=int(spec.use_binpack) | 2 * int(spec.use_exclusion)
        | 4 * int(spec.check_pod_count))
    if spec.check_pod_count:
        a.has_pod, a.cnt, a.nmax = has_pod.data_ptr(), cnt.data_ptr(), nmax.data_ptr()
    f32, f64 = _entry("cap_walk", "cap_walk_f32", "cap_walk_f64",
                      argtypes=[ctypes.POINTER(_WalkArgs), ctypes.c_void_p])
    rc = (f64 if dt == torch.float64 else f32)(
        ctypes.byref(a), devmod.raw_stream(order.device))
    if rc != 0:
        raise RuntimeError(f"cap_walk kernel launch failed: CUDA error {rc}")
    devmod.count_launch("cap_walk")
    return out[0], out[1], out[2], out[3]


# -- K6: the job ranks ------------------------------------------------------------

# the job columns the ranks read (beside the state's job_placed, job_alloc)
JOB_COLS = ("job_priority", "job_ready_base", "job_min_available", "job_tie_rank",
            "drf_total", "drf_present")


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


def job_rank_plain(spec, cols, job_placed, job_alloc):
    """Plain version of K6's job ranks (volcano_tpu/ops/rounds.py:91
    ``_job_rank``): the jobs ordered by the job-order keys in tier order
    (-priority, gang readiness, the drf share), then the tie rank, then
    the index, by chained stable sorts. ``cols`` holds JOB_COLS. Returns
    (rank int32 [J], order int64 [J])."""
    keys = [cols["job_tie_rank"]]
    for name in reversed(spec.job_order_keys):
        if name == "priority":
            keys.append(-cols["job_priority"])
        elif name == "gang":
            ready = (cols["job_ready_base"] + job_placed) >= cols["job_min_available"]
            keys.append(ready.to(torch.int32))
        elif name == "drf":
            keys.append(_share(job_alloc, cols["drf_total"][None, :],
                               cols["drf_present"][None, :]))
    order = _lexsort(keys)
    return _inverse(order), order


class _RankArgs(ctypes.Structure):
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "priority", "ready_base", "min_available", "tie_rank", "placed", "alloc",
        "drf_total", "drf_present", "scratch", "rank", "order")]
        + [(name, ctypes.c_int) for name in (
            "J", "R", "n_keys", "key0", "key1", "key2", "idx_bits", "words")])


def rank_words(spec, j: int, dtype) -> int:
    """The 64-bit words of K6's packed job keys: the tiers the spec
    names, the tie rank and the bits J - 1 needs (two or three)."""
    codes = [JOB_KEY_CODES[k] for k in spec.job_order_keys if k in JOB_KEY_CODES]
    width = sum({0: 32, 1: 1, 2: 8 * dtype.itemsize}[c] for c in codes) \
        + 32 + max(1, (j - 1).bit_length())
    if len(codes) > 3 or width > 192:
        raise ValueError(f"job_order_keys {spec.job_order_keys!r}: the keys pass "
                         "the kernel's 192 bits")
    return 2 if width <= 128 else 3


def job_rank(spec, cols, job_placed, job_alloc, count: bool = True):
    """K6's job ranks (csrc/job_rank.cu: two launches, the tile sorts
    ``job_rank`` and the count ``job_rank_count``, each counted) on CUDA,
    the plain version on the CPU; the same arguments and results as
    ``job_rank_plain``. ``count=False`` launches the tile sorts alone,
    to time them apart (rank and order are then not written). Its
    memory is its outputs (from the graph's pool while a solve is
    captured) and one scratch block (the kernel's keys, sorted tiles and
    chunk counters), planned once a size."""
    if not devmod.on_cuda(job_placed, job_alloc):
        return job_rank_plain(spec, cols, job_placed, job_alloc)
    j, r = job_alloc.shape
    dt = job_alloc.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"job_alloc: dtype {dt}")
    i32 = torch.int32
    _check_all(job_placed, [
        ("job_priority", cols["job_priority"], i32, (j,)),
        ("job_ready_base", cols["job_ready_base"], i32, (j,)),
        ("job_min_available", cols["job_min_available"], i32, (j,)),
        ("job_tie_rank", cols["job_tie_rank"], i32, (j,)),
        ("job_placed", job_placed, i32, (j,)), ("job_alloc", job_alloc, dt, (j, r)),
        ("drf_total", cols["drf_total"], dt, (r,)),
        ("drf_present", cols["drf_present"], torch.bool, (r,))])
    words = rank_words(spec, j, dt)
    codes = [JOB_KEY_CODES[k] for k in spec.job_order_keys if k in JOB_KEY_CODES]
    idx_bits = max(1, (j - 1).bit_length())
    size_fn, = _entry("job_rank", "job_rank_scratch_bytes", argtypes=[ctypes.c_int] * 2)
    size_fn.restype = ctypes.c_longlong
    buf = _scratch("job_rank", job_placed.device, -(-size_fn(j, words) // 8))
    rank = torch.empty(j, dtype=i32, device=job_placed.device)
    order = torch.empty(j, dtype=torch.int64, device=job_placed.device)
    n_keys = len(codes)
    codes += [-1] * (3 - n_keys)
    a = _RankArgs(
        priority=cols["job_priority"].data_ptr(), ready_base=cols["job_ready_base"].data_ptr(),
        min_available=cols["job_min_available"].data_ptr(),
        tie_rank=cols["job_tie_rank"].data_ptr(), placed=job_placed.data_ptr(),
        alloc=job_alloc.data_ptr(), drf_total=cols["drf_total"].data_ptr(),
        drf_present=cols["drf_present"].data_ptr(), scratch=buf.data_ptr(),
        rank=rank.data_ptr(), order=order.data_ptr(), J=j, R=r,
        n_keys=n_keys, key0=codes[0], key1=codes[1], key2=codes[2], idx_bits=idx_bits,
        words=words)
    f32, f64, count_fn = _entry("job_rank", "job_rank_f32", "job_rank_f64",
                                "job_rank_count",
                                argtypes=[ctypes.POINTER(_RankArgs), ctypes.c_void_p])
    stream = devmod.raw_stream(job_placed.device)
    launches = [("job_rank", f64 if dt == torch.float64 else f32)]
    if count:
        launches.append(("job_rank_count", count_fn))
    for name, fn in launches:
        rc = fn(ctypes.byref(a), stream)
        if rc != 0:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
        devmod.count_launch(name)
    return rank, order


# -- K3 with K6's ranks: the round's task-axis select --------------------------

SELECT_CHUNK = 1024  # tasks a CTA of csrc/round_select.cu takes (kChunk)


def class_order(task_cls, cls_excl):
    """The solve's class order, computed once in its head (a task's class
    never changes within a solve): ``perm`` the tasks stably sorted by
    class (one torch sort), ``cls_s`` their classes, ``off`` [K+1] each
    class's first position, ``chunk_first`` [K+1] each class's first chunk
    of SELECT_CHUNK tasks; for the exclusion groups, ``excl_perm`` the
    classes stably sorted by group, ``excl_start`` the first position of
    each class's group there, ``excl_pos`` the class's own position; and
    ``task_cls`` and ``cls_excl`` themselves."""
    k = cls_excl.shape[0]
    dev = task_cls.device
    i32 = torch.int32
    cls_s, perm = torch.sort(task_cls, stable=True)
    classes = torch.arange(k + 1, dtype=cls_s.dtype, device=dev)
    off = torch.searchsorted(cls_s, classes, out_int32=True)
    n_chunks = (off[1:] - off[:-1] + SELECT_CHUNK - 1) // SELECT_CHUNK
    chunk_first = torch.cat([torch.zeros(1, dtype=i32, device=dev),
                             torch.cumsum(n_chunks, 0).to(i32)])
    ex_s, excl_perm = torch.sort(cls_excl, stable=True)
    excl_pos = torch.empty(k, dtype=i32, device=dev).scatter_(
        0, excl_perm, torch.arange(k, dtype=i32, device=dev))
    return dict(
        task_cls=task_cls, cls_excl=cls_excl, perm=perm.to(i32), cls_s=cls_s,
        off=off, chunk_first=chunk_first, excl_perm=excl_perm.to(i32),
        excl_start=torch.searchsorted(ex_s, cls_excl, out_int32=True),
        excl_pos=excl_pos)


def rank_in_class(corder, active):
    """(rank, live): each task's rank within its class in flat order,
    active and inactive tasks counted apart (volcano_tpu/ops/rounds.py:319
    ``_rank_in_class``), by a scan of ``active`` along the class order;
    and each class's live bit (an active task)."""
    perm, off = corder["perm"].long(), corder["off"].long()
    cls_s = corder["cls_s"].long()
    act = active[perm]
    a64 = act.to(torch.int64)
    cum0 = torch.cat([torch.zeros(1, dtype=torch.int64, device=act.device),
                      torch.cumsum(a64, 0)])
    base = cum0[off]                               # active before each class
    ahead = cum0[:-1] - base[cls_s]                # active before, in class
    pos = torch.arange(perm.shape[0], dtype=torch.int64, device=act.device)
    in_cls = pos - off[cls_s]
    rank_s = torch.where(act, ahead, in_cls - ahead).to(torch.int32)
    rank = torch.empty_like(rank_s).scatter_(0, perm, rank_s)
    return rank, (base[1:] - base[:-1]) > 0


def excl_grank(corder, live):
    """Rank of each class among its exclusion group's live classes, lower
    class index first (volcano_tpu/ops/rounds.py:293 ``_excl_grank``), on
    the head's group order."""
    sl = live[corder["excl_perm"].long()].to(torch.int64)
    prefix = torch.cumsum(sl, 0) - sl
    return (prefix[corder["excl_pos"].long()]
            - prefix[corder["excl_start"].long()]).to(torch.int32)


def select_plain(spec, cls_excl, task_cls, active, rank, n_feas, grank, order,
                 ccap, g_start, g_size, ccap_before):
    """Per-task node choice from an ordered per-class candidate axis of
    width W (volcano_tpu/ops/rounds.py:336 ``_select``): binary search of
    the task's rank in its class's cumulative capacity, rotation within
    equal-score groups (not under binpack), exclusion spread. Returns
    (choice, cons_choice, slot, final)."""
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
            is_excl = cls_excl[tk] >= 0
            final = torch.where(is_excl, rotated, slot_c)
        else:
            final = rotated
    if spec.use_exclusion:
        is_exg = cls_excl[tk] >= 0
        spread = torch.minimum(
            torch.clamp(final + grank[tk], min=0),
            torch.clamp(nf - 1, min=0))
        final = torch.where(is_exg, spread, final)
    choice = order[tk, torch.clamp(final, 0, width - 1).long()]
    feasible = (nf > 0) & ~overflow & active
    minus1 = torch.full_like(choice, -1)
    cons_choice = torch.where((nf > 0) & active, order[tk, 0], minus1)
    return torch.where(feasible, choice, minus1), cons_choice, slot, final


def coverage_plain(spec, cls_excl, task_cls, active, n_feas, g_start, slot,
                   final):
    """The window's coverage test (volcano_tpu/ops/rounds.py:766-786): a
    class is uncovered when an active task's windowed answer is not
    provably the full-width one. Returns bool [K]."""
    k_total, width = g_start.shape
    tk = task_cls.long()
    all_in = n_feas <= width
    full_k = torch.full((k_total,), width, dtype=torch.int32, device=tk.device)
    if spec.use_binpack and not spec.use_exclusion:
        safe_end = full_k
    elif spec.use_binpack:
        safe_end = torch.where(cls_excl >= 0, g_start[:, width - 1], full_k)
    else:
        safe_end = g_start[:, width - 1]
    safe_end = torch.where(all_in, full_k, safe_end)[tk]
    exact = all_in[tk] | ((slot < safe_end) & (final < safe_end))
    bad = (active & ~exact).to(torch.int8)
    return torch.zeros(k_total, dtype=torch.int8, device=tk.device).scatter_reduce(
        0, tk, bad, "amax").bool()


def round_select_plain(spec, corder, active, n_feas, order, walk, coverage=False):
    """Plain version of K3 with K6's ranks: the in-class ranks and the
    exclusion-group ranks on the head's class order, the select, and (on
    the window, ``coverage``) the uncovered classes. Returns (choice,
    cons_choice, slot, final, uncovered or None)."""
    task_cls, cls_excl = corder["task_cls"], corder["cls_excl"]
    rank, live = rank_in_class(corder, active)
    grank = excl_grank(corder, live) if spec.use_exclusion else None
    sel = select_plain(spec, cls_excl, task_cls, active, rank, n_feas, grank,
                       order, *walk)
    unc = None
    if coverage:
        unc = coverage_plain(spec, cls_excl, task_cls, active, n_feas, walk[1],
                             sel[2], sel[3])
    return sel + (unc,)


class _SelArgs(ctypes.Structure):
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "perm", "off", "chunk_first", "excl_perm", "excl_start", "excl_pos",
        "cls_excl", "active", "n_feas", "order", "ccap", "g_start", "g_size",
        "ccap_before", "choice", "cons_choice", "slot", "final_", "uncovered")]
        + [(name, ctypes.c_int) for name in (
            "T", "K", "W", "steps", "flags", "chunk")])


def round_select(spec, corder, active, n_feas, order, walk, coverage=False):
    """K3 with K6's ranks (csrc/round_select.cu, a CTA a chunk of a class's
    tasks) on CUDA, the plain version on the CPU; the same arguments and
    results as ``round_select_plain``. ``walk`` is K2b's (ccap, g_start,
    g_size, ccap_before) over ``order`` [K, W]. The outputs are its only
    memory (allocated from the graph's pool while a solve is captured)."""
    if not devmod.on_cuda(active, order, n_feas):
        return round_select_plain(spec, corder, active, n_feas, order, walk,
                                  coverage)
    k_total, width = order.shape
    t_total = active.shape[0]
    i32 = torch.int32
    cls_excl = corder["cls_excl"]
    _same_device(order, active=active, n_feas=n_feas, cls_excl=cls_excl,
                 perm=corder["perm"])
    _check(active, "active", torch.bool, (t_total,))
    _check(n_feas, "n_feas", i32, (k_total,))
    _check(cls_excl, "cls_excl", i32, (k_total,))
    for name, t in zip(("order", "ccap", "g_start", "g_size", "ccap_before"),
                       (order,) + tuple(walk)):
        _check(t, name, i32, (k_total, width))
    for name, shape in (("perm", (t_total,)), ("off", (k_total + 1,)),
                        ("chunk_first", (k_total + 1,)), ("excl_perm", (k_total,)),
                        ("excl_start", (k_total,)), ("excl_pos", (k_total,))):
        _check(corder[name], name, i32, shape)
    out = torch.empty((4, t_total), dtype=i32, device=order.device)
    unc = torch.empty(k_total, dtype=torch.bool, device=order.device) if coverage else None
    a = _SelArgs(
        perm=corder["perm"].data_ptr(), off=corder["off"].data_ptr(),
        chunk_first=corder["chunk_first"].data_ptr(),
        excl_perm=corder["excl_perm"].data_ptr(),
        excl_start=corder["excl_start"].data_ptr(),
        excl_pos=corder["excl_pos"].data_ptr(), cls_excl=cls_excl.data_ptr(),
        active=active.data_ptr(), n_feas=n_feas.data_ptr(),
        order=order.data_ptr(), ccap=walk[0].data_ptr(),
        g_start=walk[1].data_ptr(), g_size=walk[2].data_ptr(),
        ccap_before=walk[3].data_ptr(), choice=out[0].data_ptr(),
        cons_choice=out[1].data_ptr(), slot=out[2].data_ptr(),
        final_=out[3].data_ptr(), uncovered=unc.data_ptr() if coverage else None,
        T=t_total, K=k_total, W=width, steps=max(1, int(width).bit_length()),
        flags=int(spec.use_binpack) | 2 * int(spec.use_exclusion) | 4 * int(coverage),
        chunk=SELECT_CHUNK)
    fn, = _entry("round_select", "round_select",
                 argtypes=[ctypes.POINTER(_SelArgs), ctypes.c_void_p])
    rc = fn(ctypes.byref(a), devmod.raw_stream(order.device))
    if rc != 0:
        raise RuntimeError(f"round_select kernel launch failed: CUDA error {rc}")
    devmod.count_launch("round_select")
    return out[0], out[1], out[2], out[3], unc


# -- segment helpers of the plain scans --------------------------------------

def _seg_start_idx(head: torch.Tensor) -> torch.Tensor:
    idx = torch.arange(head.shape[0], device=head.device)
    return torch.cummax(torch.where(head, idx, torch.zeros_like(idx)), dim=0).values


def _seg_cumsum(x: torch.Tensor, start_idx: torch.Tensor) -> torch.Tensor:
    """Segment-inclusive cumulative sums along dim 0, exact in int64."""
    cs = torch.cumsum(x, dim=0)
    prev = torch.clamp(start_idx - 1, min=0)
    base = cs[prev]
    has = start_idx > 0
    if x.dim() > 1:
        has = has[:, None]
    return cs - torch.where(has, base, torch.zeros_like(base))


def _heads(key: torch.Tensor) -> torch.Tensor:
    head = torch.ones(key.shape[0], dtype=torch.bool, device=key.device)
    head[1:] = key[1:] != key[:-1]
    return head


# -- the integer units of K4 and K5 -------------------------------------------

def to_i32(x):
    """XLA's float -> int32 convert: truncation, saturating at the int32
    range, NaN -> 0."""
    x = torch.nan_to_num(x, nan=0.0)
    return torch.clamp(x, -2.0**31, 2.0**31 - 1).to(torch.int32)


# scratch of K4 and K5 a (kind, device, sizes), allocated zeroed once and
# never freed: a captured solve graph keeps its pointers. Every launch of
# one scratch runs in order on the caller's stream; each leaves it ready
# for the next (K4's status words carry the launch's epoch, K5's last CTA
# zeroes what it summed)
_SCRATCH: dict = {}


def _scratch(kind, dev, n_i64):
    key = (kind, dev, n_i64)
    buf = _SCRATCH.get(key)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{kind}: scratch first asked for inside a graph "
                               "capture (its eager warm-up pass must plan it)")
        buf = _SCRATCH[key] = torch.zeros(n_i64, dtype=torch.int64, device=dev)
    return buf


def _check_all(ref, checks):
    for name, t, dtype, shape in checks:
        if t.device != ref.device:
            raise ValueError(f"{name}: on {t.device}, expected {ref.device}")
        _check(t, name, dtype, shape)


# -- K4: per-node prefix acceptance -------------------------------------------

def resolve_prefix_plain(order, choice, req_i, has_pod, idle, unit, eps_i,
                         is_scalar, cnt, nmax, check_pod: bool):
    """Plain version of K4. Row i of the sorted axis is task order[i]
    (tasks sorted by (node key, rank), the key a task's choice or
    INT32_MAX without one, last); a row is accepted iff it and every
    earlier row of its node segment fit: cumulative int64 request <
    max(bound, 0) per dim, bound = int32(floor(idle / unit)) + eps_i (an
    int32 add, widened), scalar dims at or under MIN_MILLI_SCALAR of the
    row's own request skipped, and with check_pod the node's pod room. The
    infeasible segment is all rejected. Returns accept [T] bool by task."""
    key = torch.where(choice >= 0, choice, torch.full_like(choice, INT32_MAX))
    key_s = key[order]
    req_s = req_i[order]
    pod_s = has_pod[order] & (key_s != INT32_MAX)
    bound = (to_i32(torch.floor(idle / unit[None, :])) + eps_i[None, :]).to(torch.int64)
    head = _heads(key_s)
    start_idx = _seg_start_idx(head)
    seg = _seg_cumsum(req_s, start_idx)
    feas = key_s != INT32_MAX
    node = torch.clamp(key_s, 0, bound.shape[0] - 1).long()
    le = seg < torch.clamp(bound[node], min=0)
    skip = is_scalar[None, :] & (req_s <= MIN_MILLI_SCALAR)
    cond = torch.all(le | skip, dim=-1) & feas
    if check_pod:
        seg_pods = _seg_cumsum(pod_s.to(torch.int64), start_idx)
        pods_ok = ~pod_s | (cnt[node].to(torch.int64) + seg_pods
                            <= nmax[node].to(torch.int64))
        cond = cond & pods_ok
    rej = _seg_cumsum((~cond).to(torch.int64), start_idx)
    accept = torch.empty(order.shape[0], dtype=torch.bool, device=order.device)
    accept[order] = cond & (rej == 0)
    return accept


class _ResolveArgs(ctypes.Structure):
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "order", "choice", "req", "has_pod", "idle", "unit", "eps",
        "is_scalar", "cnt", "nmax", "accept", "ctr", "st1", "st2", "agg",
        "inc")]
        + [(name, ctypes.c_int) for name in ("T", "R", "G", "check_pod")])


def resolve_layout():
    """(rows a CTA of K4 takes, payload lanes a tile status holds)."""
    fn_tile, fn_stride = _entry("resolve_prefix", "resolve_prefix_tile",
                                "resolve_prefix_stride", argtypes=[])
    return fn_tile(), fn_stride()


def resolve_prefix(order, choice, req_i, has_pod, idle, unit, eps_i,
                   is_scalar, cnt, nmax, check_pod: bool):
    """K4 (csrc/resolve_prefix.cu, a CTA a tile of rows chained by a
    look-back) on CUDA, the plain version on the CPU; the same arguments
    and result as ``resolve_prefix_plain``. order int64 [T]; choice int32
    [T]; req_i int64 [T, R]; has_pod bool [T]; idle [N, R] and unit [R] of
    one float dtype; eps_i int32 [R]; is_scalar bool [R]; cnt, nmax int32
    [N]. Its only memory is its output (from the graph's pool while a
    solve is captured) and its tile status, planned once a size."""
    if not devmod.on_cuda(order, choice, idle):
        return resolve_prefix_plain(order, choice, req_i, has_pod, idle, unit,
                                    eps_i, is_scalar, cnt, nmax, check_pod)
    t = order.shape[0]
    n, r = idle.shape
    dt = idle.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"idle: dtype {dt}")
    _check_all(order, (
        ("order", order, torch.int64, (t,)), ("choice", choice, torch.int32, (t,)),
        ("req_i", req_i, torch.int64, (t, r)), ("has_pod", has_pod, torch.bool, (t,)),
        ("idle", idle, dt, (n, r)), ("unit", unit, dt, (r,)),
        ("eps_i", eps_i, torch.int32, (r,)), ("is_scalar", is_scalar, torch.bool, (r,)),
        ("cnt", cnt, torch.int32, (n,)), ("nmax", nmax, torch.int32, (n,))))
    tile, stride = resolve_layout()
    g = (t + tile - 1) // tile
    buf = _scratch("resolve_prefix", order.device, 1 + 2 * g + 2 * g * stride)
    base = buf.data_ptr()
    out = torch.empty(t, dtype=torch.bool, device=order.device)
    a = _ResolveArgs(
        order=order.data_ptr(), choice=choice.data_ptr(), req=req_i.data_ptr(),
        has_pod=has_pod.data_ptr(), idle=idle.data_ptr(), unit=unit.data_ptr(),
        eps=eps_i.data_ptr(), is_scalar=is_scalar.data_ptr(), cnt=cnt.data_ptr(),
        nmax=nmax.data_ptr(), accept=out.data_ptr(), ctr=base, st1=base + 8,
        st2=base + 8 * (1 + g), agg=base + 8 * (1 + 2 * g),
        inc=base + 8 * (1 + 2 * g + g * stride),
        T=t, R=r, G=g, check_pod=int(check_pod))
    f32, f64 = _entry("resolve_prefix", "resolve_prefix_f32", "resolve_prefix_f64",
                      argtypes=[ctypes.POINTER(_ResolveArgs), ctypes.c_void_p])
    rc = (f64 if dt == torch.float64 else f32)(
        ctypes.byref(a), devmod.raw_stream(order.device))
    if rc != 0:
        raise RuntimeError(f"resolve_prefix kernel launch failed: CUDA error {rc}")
    devmod.count_launch("resolve_prefix")
    return out


# -- K5: job-granular queue budget ---------------------------------------------

def queue_budget_plain(accept, task_job, req_i, jq, job_queue, queue_alloc,
                       unit, bound, is_scalar):
    """Plain version of K5, on the job axis: each job's accepted requests
    summed (int64), their exclusive sums over the jobs of each queue in the
    order ``jq`` (jobs by queue, then rank), and a task survives iff it was
    accepted and its queue's allocation, int32(ceil(queue_alloc / unit))
    widened, plus what the jobs of its queue before its job took fits under
    max(bound, 0) per dim (scalar dims at or under MIN_MILLI_SCALAR
    skipped). Returns bool [T]."""
    j_total = job_queue.shape[0]
    req = torch.where(accept[:, None], req_i, torch.zeros_like(req_i))
    jsum = torch.zeros((j_total, req_i.shape[1]), dtype=torch.int64,
                       device=req_i.device).index_add_(0, task_job.long(), req)
    s = jsum[jq]
    q_s = job_queue[jq].long()
    before = _seg_cumsum(s, _seg_start_idx(_heads(q_s))) - s
    alloc_i = to_i32(torch.ceil(queue_alloc / unit[None, :])).to(torch.int64)
    tot = alloc_i[q_s] + before
    le = tot < torch.clamp(bound[q_s], min=0)
    skip = is_scalar[None, :] & (tot <= MIN_MILLI_SCALAR)
    job_ok = torch.empty(j_total, dtype=torch.bool, device=req_i.device)
    job_ok[jq] = torch.all(le | skip, dim=-1)
    return accept & job_ok[task_job.long()]


class _BudgetArgs(ctypes.Structure):
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "accept", "task_job", "req", "jq", "job_queue", "queue_alloc", "unit",
        "bound", "is_scalar", "out", "jsum", "arrived", "job_ok")]
        + [(name, ctypes.c_int) for name in ("T", "R", "J")])


def queue_budget(accept, task_job, req_i, jq, job_queue, queue_alloc, unit,
                 bound, is_scalar, parts=("sums", "mask")):
    """K5 (csrc/queue_budget.cu: ``queue_budget``, the per-job sums and the
    queue scan, then ``queue_budget_mask``) on CUDA, the plain version on
    the CPU; the same arguments and result as ``queue_budget_plain``.
    accept bool [T]; task_job int32 [T]; req_i int64 [T, R]; jq int64 [J];
    job_queue int32 [J]; queue_alloc [Q, R] and unit [R] of one float
    dtype; bound int64 [Q, R]; is_scalar bool [R]. Its only memory is its
    output and its job rows, planned once a size. ``parts`` names the
    launches to make (a measurement times the mask alone after a whole
    call: the job decisions stay in the scratch)."""
    if not devmod.on_cuda(accept, req_i, queue_alloc):
        return queue_budget_plain(accept, task_job, req_i, jq, job_queue,
                                  queue_alloc, unit, bound, is_scalar)
    t, r = req_i.shape
    j_total = job_queue.shape[0]
    nq = queue_alloc.shape[0]
    dt = queue_alloc.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"queue_alloc: dtype {dt}")
    _check_all(accept, (
        ("accept", accept, torch.bool, (t,)), ("task_job", task_job, torch.int32, (t,)),
        ("req_i", req_i, torch.int64, (t, r)), ("jq", jq, torch.int64, (j_total,)),
        ("job_queue", job_queue, torch.int32, (j_total,)),
        ("queue_alloc", queue_alloc, dt, (nq, r)), ("unit", unit, dt, (r,)),
        ("bound", bound, torch.int64, (nq, r)), ("is_scalar", is_scalar, torch.bool, (r,))))
    # the job rows, the arrival counter, then ok a job (bytes)
    buf = _scratch("queue_budget", accept.device, j_total * r + 1 + (j_total + 7) // 8)
    base = buf.data_ptr()
    out = torch.empty(t, dtype=torch.bool, device=accept.device)
    a = _BudgetArgs(
        accept=accept.data_ptr(), task_job=task_job.data_ptr(), req=req_i.data_ptr(),
        jq=jq.data_ptr(), job_queue=job_queue.data_ptr(),
        queue_alloc=queue_alloc.data_ptr(), unit=unit.data_ptr(),
        bound=bound.data_ptr(), is_scalar=is_scalar.data_ptr(), out=out.data_ptr(),
        jsum=base, arrived=base + 8 * j_total * r,
        job_ok=base + 8 * (j_total * r + 1), T=t, R=r, J=j_total)
    f32, f64, mask = _entry("queue_budget", "queue_budget_f32", "queue_budget_f64",
                            "queue_budget_mask",
                            argtypes=[ctypes.POINTER(_BudgetArgs), ctypes.c_void_p])
    stream = devmod.raw_stream(accept.device)
    for part, name, fn in (("sums", "queue_budget", f64 if dt == torch.float64 else f32),
                           ("mask", "queue_budget_mask", mask)):
        if part in parts:
            rc = fn(ctypes.byref(a), stream)
            if rc != 0:
                raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
            devmod.count_launch(name)
    return out


# -- K7c: the round's commit and the rollback's undo ------------------------------

def round_commit_plain(spec, tc, st, choice, accept, did_full, ctl) -> None:
    """Plain version of K7c: the commit of one round (volcano_tpu/ops/
    rounds.py:838-870). The accepted tasks' requests are scatter-added
    into idle (subtracted), used, job_alloc, queue_alloc and ns_alloc
    with ``index_put_(accumulate=True)``, which on the CPU adds a row's
    updates one after another in task order, to the row's value, as XLA's
    scatter does (float64 always; float32 on one thread: past 32k
    elements torch adds float32 rows with atomics from several threads);
    then the counts, assign, active, the exclusion occupancy and the dirty
    columns; the counters go to ctl[C_PLACED .. C_DID_FULL]. ``tc`` holds
    the task columns task_req, task_job, task_queue, task_ns, task_excl,
    job_task_start and job_task_count; ``st`` is updated in place."""
    n = st["idle"].shape[0]
    node = torch.clamp(choice, 0, n - 1).long()
    req = tc["task_req"]
    dreq = torch.where(accept[:, None], req, torch.zeros_like(req))
    acc_i = accept.to(torch.int32)
    dirty = torch.zeros(n, dtype=torch.int8, device=node.device).scatter_reduce(
        0, node, accept.to(torch.int8), "amax").bool()
    if spec.use_exclusion:
        occ, task_excl = st["excl_occ"], tc["task_excl"]
        g_flat = torch.clamp(task_excl, min=0).long() * n + node
        occ_flat = occ.reshape(-1).to(torch.int8).scatter_reduce(
            0, g_flat, (accept & (task_excl >= 0)).to(torch.int8), "amax")
        occ.copy_(occ_flat.bool().reshape(occ.shape))
    st["idle"].index_put_((node,), -dreq, accumulate=True)
    st["used"].index_put_((node,), dreq, accumulate=True)
    st["cnt"].index_add_(0, node, acc_i)
    st["assign"].copy_(torch.where(accept, choice, st["assign"]))
    st["active"].logical_and_(~accept)
    job = tc["task_job"].long()
    st["job_placed"].index_add_(0, job, acc_i)
    st["job_alloc"].index_put_((job,), dreq, accumulate=True)
    st["queue_alloc"].index_put_((tc["task_queue"].long(),), dreq, accumulate=True)
    st["ns_alloc"].index_put_((tc["task_ns"].long(),), dreq, accumulate=True)
    st["dirty"].copy_(dirty)
    ctl[C_PLACED:C_DID_FULL + 1] = torch.stack([
        acc_i.sum(), st["active"].sum(), dirty.sum(), did_full])


def round_rollback_plain(spec, tc, st, roll_job, any_cand, ctl) -> None:
    """Plain version of K7c's rollback mode: the scatters of the rollback
    (volcano_tpu/ops/rounds.py:886-922) once the gang to retire is chosen.
    ``roll_job`` [J] bool marks it (or nothing); its placed tasks' requests
    go back into their nodes and allocations (``index_put_``, as in
    ``round_commit_plain``), their assignments are cleared, the gang's
    tasks leave the active set, the freed nodes join the dirty set; the
    counters go to ctl[C_STILL .. C_ANY_CAND] (``any_cand``: a 0-d int64,
    whether any gang was a candidate)."""
    n = st["idle"].shape[0]
    job = tc["task_job"].long()
    dead_task = roll_job[job]
    roll = dead_task & (st["assign"] >= 0)
    node = torch.clamp(st["assign"], 0, n - 1).long()
    req = tc["task_req"]
    dreq = torch.where(roll[:, None], req, torch.zeros_like(req))
    if spec.use_exclusion:
        # free the rolled members' group slots
        occ, task_excl = st["excl_occ"], tc["task_excl"]
        g_flat = torch.clamp(task_excl, min=0).long() * n + node
        occ_flat = occ.reshape(-1).to(torch.int8).scatter_reduce(
            0, g_flat, (~(roll & (task_excl >= 0))).to(torch.int8), "amin")
        occ.copy_(occ_flat.bool().reshape(occ.shape))
    st["idle"].index_put_((node,), dreq, accumulate=True)
    st["used"].index_put_((node,), -dreq, accumulate=True)
    st["cnt"].index_add_(0, node, -roll.to(torch.int32))
    st["assign"].masked_fill_(roll, -1)
    st["active"].logical_and_(~dead_task)
    st["job_placed"].masked_fill_(roll_job, 0)
    st["job_alloc"].index_put_((job,), -dreq, accumulate=True)
    st["queue_alloc"].index_put_((tc["task_queue"].long(),), -dreq, accumulate=True)
    st["ns_alloc"].index_put_((tc["task_ns"].long(),), -dreq, accumulate=True)
    st["dirty"].logical_or_(torch.zeros(n, dtype=torch.int8, device=node.device)
                            .scatter_reduce(0, node, roll.to(torch.int8), "amax").bool())
    zero = torch.zeros((), dtype=torch.int64, device=node.device)
    ctl[C_STILL:C_ANY_CAND + 1] = torch.stack([
        st["active"].sum(), st["dirty"].sum(), zero, any_cand])


_COMMIT_PTRS = ("node", "mask", "task_req", "task_job", "task_queue",
                "task_ns", "task_excl", "job_start", "job_count", "roll_job",
                "key_s", "perm_s", "flag", "idle", "used", "cnt", "assign",
                "active", "job_placed", "job_alloc", "queue_alloc",
                "ns_alloc", "excl_occ", "dirty", "ctl")


class _CommitArgs(ctypes.Structure):
    _fields_ = ([(name, ctypes.c_void_p) for name in _COMMIT_PTRS]
                + [(name, ctypes.c_int) for name in (
                    "T", "N", "R", "J", "Q", "S", "use_excl", "mode", "nb_node",
                    "nb_job")])


def _commit_launch(spec, tc, st, node, mask, roll_job, flag, ctl, mode) -> None:
    """One launch of K7c (csrc/round_commit.cu) behind one stable torch sort
    of the masked tasks by node: mode 0 commits the ``mask``ed (accepted)
    tasks onto ``node`` (their choice), mode 1 gives the ``mask``ed
    (rolled) tasks back from ``node`` (their assignment)."""
    idle = st["idle"]
    dt = idle.dtype
    n, r = idle.shape
    t = node.shape[0]
    j = st["job_placed"].shape[0]
    q = st["queue_alloc"].shape[0]
    s_rows = st["ns_alloc"].shape[0]
    i32 = torch.int32
    checks = [("node", node, i32, (t,)), ("mask", mask, torch.bool, (t,)),
              ("task_req", tc["task_req"], dt, (t, r)),
              ("task_job", tc["task_job"], i32, (t,)),
              ("task_queue", tc["task_queue"], i32, (t,)),
              ("task_ns", tc["task_ns"], i32, (t,)),
              ("job_task_start", tc["job_task_start"], i32, (j,)),
              ("job_task_count", tc["job_task_count"], i32, (j,)),
              ("flag", flag, torch.int64, ()),
              ("idle", idle, dt, (n, r)), ("used", st["used"], dt, (n, r)),
              ("cnt", st["cnt"], i32, (n,)), ("assign", st["assign"], i32, (t,)),
              ("active", st["active"], torch.bool, (t,)),
              ("job_placed", st["job_placed"], i32, (j,)),
              ("job_alloc", st["job_alloc"], dt, (j, r)),
              ("queue_alloc", st["queue_alloc"], dt, (q, r)),
              ("ns_alloc", st["ns_alloc"], dt, (s_rows, r)),
              ("dirty", st["dirty"], torch.bool, (n,)), ("ctl", ctl, i32, (CTL_LEN,))]
    if mode:
        checks.append(("roll_job", roll_job, torch.bool, (j,)))
    if spec.use_exclusion:
        checks += [("task_excl", tc["task_excl"], i32, (t,)),
                   ("excl_occ", st["excl_occ"], torch.bool,
                    (st["excl_occ"].shape[0], n))]
    _check_all(idle, checks)
    key_s, perm_s = torch.sort(torch.where(mask, node, torch.full_like(node, n)),
                               stable=True)
    ptrs = dict(node=node, mask=mask, task_req=tc["task_req"],
                task_job=tc["task_job"], task_queue=tc["task_queue"],
                task_ns=tc["task_ns"], job_start=tc["job_task_start"],
                job_count=tc["job_task_count"], key_s=key_s, perm_s=perm_s,
                flag=flag, idle=idle, used=st["used"], cnt=st["cnt"],
                assign=st["assign"], active=st["active"],
                job_placed=st["job_placed"], job_alloc=st["job_alloc"],
                queue_alloc=st["queue_alloc"], ns_alloc=st["ns_alloc"],
                dirty=st["dirty"], ctl=ctl)
    if mode:
        ptrs["roll_job"] = roll_job
    if spec.use_exclusion:
        ptrs.update(task_excl=tc["task_excl"], excl_occ=st["excl_occ"])
    a = _CommitArgs(**{k: v.data_ptr() for k, v in ptrs.items()},
                    T=t, N=n, R=r, J=j, Q=q, S=s_rows,
                    use_excl=int(spec.use_exclusion), mode=mode,
                    nb_node=(n + 255) // 256, nb_job=(j + 255) // 256)
    f32, f64 = _entry("round_commit", "round_commit_f32", "round_commit_f64",
                      argtypes=[ctypes.POINTER(_CommitArgs), ctypes.c_void_p])
    rc = (f64 if dt == torch.float64 else f32)(
        ctypes.byref(a), devmod.raw_stream(idle.device))
    if rc != 0:
        raise RuntimeError(f"round_commit kernel launch failed: CUDA error {rc}")
    devmod.count_launch("round_commit")


def round_commit(spec, tc, st, choice, accept, did_full, ctl) -> None:
    """K7c (csrc/round_commit.cu) on CUDA, the plain version on the CPU;
    the same arguments and effects as ``round_commit_plain``. Its only
    memory is its sort's output (from the graph's pool while a solve is
    captured)."""
    if not devmod.on_cuda(choice, st["idle"], ctl):
        round_commit_plain(spec, tc, st, choice, accept, did_full, ctl)
        return
    _commit_launch(spec, tc, st, choice, accept, None, did_full, ctl, 0)


def round_rollback(spec, tc, st, roll_job, any_cand, ctl) -> None:
    """K7c in its rollback mode on CUDA, the plain version on the CPU; the
    same arguments and effects as ``round_rollback_plain``."""
    if not devmod.on_cuda(roll_job, st["idle"], ctl):
        round_rollback_plain(spec, tc, st, roll_job, any_cand, ctl)
        return
    roll = roll_job[tc["task_job"].long()] & (st["assign"] >= 0)
    _commit_launch(spec, tc, st, st["assign"], roll, roll_job, any_cand, ctl, 1)


# -- K7a: the rounds solve's loop control ------------------------------------
#
# The loop of the rounds solve (volcano_tpu/ops/rounds.py:925-975 and the
# lax.cond at :1101) as a flat step machine whose state is one int32 vector
# on the card. After every step the controller folds the step's counters
# into that state and decides the next step; the predicates it writes gate
# the step bodies (CUDA graph IF nodes, or Python ifs on the host).

# the int32 control vector: the loop state, then the counters a step writes
# (C_PLACED .. C_ANY_CAND), then the placed-per-round histogram
(C_ROUNDS, C_PROGRESS, C_TRIED, C_CAPPED, C_DEAD, C_EXTRA, C_PHASE,
 C_FULL_SWEEPS, C_REMAINING, C_NDIRTY, C_STEPS, C_LAST, C_CONS,
 C_TAIL_PLACED, C_PLACED, C_STILL, C_NDIRTY_NEXT, C_DID_FULL,
 C_ANY_CAND, C_ERR) = range(20)
C_HIST = 20
PROF_SLOTS = 64
CTL_LEN = C_HIST + PROF_SLOTS
# phases of the machine: the outer fixpoint's test, its inner round loop,
# the straggler rounds (set-up, loop), the tail pass, done
PH_INIT, PH_OUTER, PH_INNER, PH_STRAG_INIT, PH_STRAG, PH_TAIL, PH_DONE = range(7)
# the kinds of step
ST_NONE, ST_ROUND, ST_STRAG, ST_ROLLBACK, ST_TAIL = range(5)
# the predicates (bool vector): a step runs, it is a round (plain or
# straggler), the round is conservative, it refreshes every score column,
# it rescores the dirty columns (K1's round entry takes that choice itself
# from C_NDIRTY, the same way), it is the rollback, the tail, the machine
# is done
(P_ACTIVE, P_ROUND, P_CONS, P_FULL, P_DIRTY, P_ROLLBACK, P_TAIL,
 P_DONE) = range(8)
NPRED = 8


def ctl_params(spec, t_total: int, j_total: int, n_total: int):
    """The controller's static arguments: (round budget, round_min_progress,
    straggler_rounds, dirty_k, node count, step cap). The cap lies past any
    run the budget allows (rounds, one rollback a retired job, the
    stragglers, the tail): reaching it marks C_ERR and stops the machine,
    so a fault can never spin the card."""
    budget = 2 * (t_total + j_total) + 8
    return (budget, int(spec.round_min_progress), int(spec.straggler_rounds),
            int(spec.dirty_k), int(n_total),
            budget + j_total + int(spec.straggler_rounds) + 8)


def _ctl_fold_decide(c, params):
    """One controller call on the host list ``c`` (in place). Returns the
    predicates."""
    budget, rmp, sr, dirty_k, n_nodes, max_steps = params
    last = c[C_LAST]
    if c[C_PHASE] == PH_INIT:
        c[C_PROGRESS], c[C_NDIRTY], c[C_PHASE] = 1, n_nodes, PH_OUTER
    elif last in (ST_ROUND, ST_STRAG):
        placed, still = c[C_PLACED], c[C_STILL]
        if rmp > 1 and 0 < placed < rmp and 0 < still <= 8 * rmp:
            # diminishing-returns exit: the stragglers and the tail own
            # the small remainder
            c[C_CAPPED] = 1
        c[C_HIST + min(c[C_ROUNDS], PROF_SLOTS - 1)] += placed
        c[C_ROUNDS] += 1
        c[C_PROGRESS] = int(placed > 0)
        c[C_TRIED] = int(c[C_CONS] != 0 and placed == 0)
        c[C_FULL_SWEEPS] += c[C_DID_FULL]
        c[C_REMAINING] = still
        c[C_NDIRTY] = c[C_NDIRTY_NEXT]
        if last == ST_STRAG:
            c[C_EXTRA] += 1
    elif last == ST_ROLLBACK:
        c[C_PROGRESS], c[C_DEAD], c[C_TRIED] = 1, int(c[C_ANY_CAND] == 0), 0
        c[C_NDIRTY], c[C_REMAINING] = c[C_NDIRTY_NEXT], c[C_STILL]
    nxt, cons = ST_NONE, 0
    while True:
        ph = c[C_PHASE]
        if ph == PH_OUTER:
            c[C_PHASE] = PH_INNER if (not c[C_DEAD] and c[C_ROUNDS] < budget) \
                else PH_STRAG_INIT
        elif ph == PH_INNER:
            if (c[C_PROGRESS] or not c[C_TRIED]) and c[C_REMAINING] > 0 \
                    and c[C_ROUNDS] < budget and not c[C_CAPPED]:
                nxt, cons = ST_ROUND, int(not c[C_PROGRESS])
                break
            c[C_PHASE] = PH_OUTER
            if c[C_CAPPED]:
                # a capped exit is terminal: no rollback
                c[C_DEAD], c[C_TRIED] = 1, 0
            else:
                nxt = ST_ROLLBACK
                break
        elif ph == PH_STRAG_INIT:
            if rmp > 1 and sr > 0:
                c[C_EXTRA], c[C_PROGRESS] = 0, 1
            c[C_PHASE] = PH_STRAG
        elif ph == PH_STRAG:
            if rmp > 1 and sr > 0 and c[C_CAPPED] and c[C_PROGRESS] \
                    and c[C_REMAINING] > 0 and c[C_EXTRA] < sr \
                    and c[C_ROUNDS] < budget:
                nxt, cons = ST_STRAG, int(not c[C_PROGRESS])
                break
            c[C_PHASE] = PH_TAIL
        elif ph == PH_TAIL:
            c[C_PHASE] = PH_DONE
            if rmp > 1 and c[C_CAPPED]:
                nxt = ST_TAIL
                break
        else:
            break
    if nxt != ST_NONE and c[C_STEPS] >= max_steps:
        c[C_ERR], c[C_PHASE], nxt, cons = 1, PH_DONE, ST_NONE, 0
    c[C_LAST], c[C_CONS] = nxt, cons
    if nxt != ST_NONE:
        c[C_STEPS] += 1
    dirty = dirty_k > 0 and c[C_NDIRTY] <= dirty_k
    return [nxt != ST_NONE, nxt in (ST_ROUND, ST_STRAG), bool(cons), not dirty,
            dirty, nxt == ST_ROLLBACK, nxt == ST_TAIL, nxt == ST_NONE]


def rounds_ctl_plain(ctl: torch.Tensor, pred: torch.Tensor, params):
    """Plain version of K7a on the int32 control vector ``ctl``
    [CTL_LEN] and the bool predicates ``pred`` [NPRED], updated in place
    (any device; it reads them to the host). Returns the predicates as a
    host list."""
    c = ctl.tolist()
    p = _ctl_fold_decide(c, params)
    ctl.copy_(torch.tensor(c, dtype=torch.int32))
    pred.copy_(torch.tensor(p, dtype=torch.bool))
    return p


def rounds_ctl(ctl: torch.Tensor, pred: torch.Tensor, params) -> None:
    """K7a (csrc/rounds_ctl.cu, one thread) on CUDA, the plain version on
    the CPU: fold the last step's counters into ``ctl`` and write the next
    step's predicates into ``pred``, in place."""
    if not devmod.on_cuda(ctl, pred):
        rounds_ctl_plain(ctl, pred, params)
        return
    from volcano_tpu_torch import _build

    _same_device(ctl, pred=pred)
    _check(ctl, "ctl", torch.int32, (CTL_LEN,))
    _check(pred, "pred", torch.bool, (NPRED,))
    lib = _build.library("rounds_ctl")
    fn = lib.rounds_ctl
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(_ptr(ctl), _ptr(pred), *(int(x) for x in params), _stream(ctl))
    if rc != 0:
        raise RuntimeError(f"rounds_ctl kernel launch failed: CUDA error {rc}")
    devmod.count_launch("rounds_ctl")


# the graph's hit counters a K7a pass bumps (ops/rounds.py BODIES, in that
# order): the pass itself, then the step body it chose
H_STEP, H_ROUND, H_COVER, H_ROLLBACK, H_TAIL = range(5)


class _GraphCtl(ctypes.Structure):
    _fields_ = [("h_while", ctypes.c_ulonglong), ("h_round", ctypes.c_ulonglong),
                ("h_rollback", ctypes.c_ulonglong), ("h_tail", ctypes.c_ulonglong),
                ("hits", ctypes.c_void_p)]


def rounds_ctl_graph(ctl: torch.Tensor, pred: torch.Tensor, params, handles,
                     hits: torch.Tensor) -> None:
    """K7a as the first node of the solve graph's WHILE body: the same fold
    and decision, then the conditions of the step's IF nodes set from the
    predicates (``handles``: the WHILE node's, then the round's, the
    rollback's and the tail's, all of the graph being captured or of its
    parent), and the graph's hit counters (``hits``, int32, indexed by
    H_*) bumped for the pass and the step it chose."""
    from volcano_tpu_torch import _build

    _same_device(ctl, pred=pred, hits=hits)
    _check(ctl, "ctl", torch.int32, (CTL_LEN,))
    _check(pred, "pred", torch.bool, (NPRED,))
    _check(hits, "hits", torch.int32, None)
    if hits.numel() <= H_TAIL or len(handles) != 4:
        raise ValueError("rounds_ctl_graph: hits or handles too short")
    lib = _build.library("rounds_ctl")
    fn = lib.rounds_ctl_graph
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 \
        + [ctypes.POINTER(_GraphCtl), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    g = _GraphCtl(*handles, hits.data_ptr())
    rc = fn(_ptr(ctl), _ptr(pred), *(int(x) for x in params), ctypes.byref(g),
            _stream(ctl))
    if rc != 0:
        raise RuntimeError(f"rounds_ctl kernel launch failed: CUDA error {rc}")
    devmod.count_launch("rounds_ctl")


# -- K7b: the sequential tail pass --------------------------------------------

# the job-order key codes the tail kernel reads, in tier order
JOB_KEY_CODES = {"priority": 0, "gang": 1, "drf": 2}

# what one tail pass reads (enc) and updates in place (st): the names the
# kernel's argument block lists, with their element kinds
TAIL_INPUTS = (
    ("task_cls", "i"), ("task_job", "i"), ("task_queue", "i"),
    ("task_ns", "i"), ("task_in_job", "i"), ("task_excl", "i"),
    ("job_priority", "i"), ("job_ready_base", "i"),
    ("job_min_available", "i"), ("job_tie_rank", "i"),
    ("drf_total", "f"), ("drf_present", "b"), ("queue_deserved", "f"),
    ("eps", "f"), ("is_scalar", "b"), ("cls_req", "f"),
    ("cls_initreq", "f"), ("cls_sig", "i"), ("cls_nz_cpu", "f"),
    ("cls_nz_mem", "f"), ("cls_has_pod", "b"), ("sig_mask", "b"),
    ("node_max_tasks", "i"), ("node_alloc", "f"), ("affinity_score", "f"),
    ("binpack_w", "f"), ("score_weights", "f"),
)
TAIL_STATE = (
    ("idle", "f"), ("used", "f"), ("cnt", "i"), ("assign", "i"),
    ("active", "b"), ("job_placed", "i"), ("job_alloc", "f"),
    ("queue_alloc", "f"), ("ns_alloc", "f"), ("excl_occ", "b"),
    ("tail_failed", "b"),
)


def tail_budget(spec) -> int:
    """Steps a tail pass may take (the reference's tail_budget)."""
    return 8 * max(spec.round_min_progress, 1) + 16


def tail_row_plain(spec, enc, c: int, idle, used, cnt, occ):
    """The feasibility mask and the masked fused score of class row ``c``
    over every node (volcano_tpu/ops/rounds.py:1046-1060): one class row,
    not the K x N block."""
    from volcano_tpu_torch.ops.kernels import _score_block_plain

    sl = slice(c, c + 1)
    row = _score_block_plain(
        spec, enc, enc["cls_req"][sl], enc["cls_initreq"][sl],
        enc["cls_sig"][sl].long(), enc["cls_nz_cpu"][sl], enc["cls_nz_mem"][sl],
        enc["cls_has_pod"][sl],
        enc["cls_excl"][sl].long() if spec.use_exclusion else None,
        idle, used, cnt, occ, enc["sig_mask"], enc["node_max_tasks"],
        enc["node_alloc"], enc["affinity_score"])[0]
    return row


def tail_pass_plain(spec, enc, st, ctl) -> None:
    """Plain version of K7b (the reference's tail_pass, rounds.py:980):
    one task a step in the serial visit order (the lexicographic argmin of
    the job-order keys, tie rank and task_in_job over the live tasks of
    queues under their share), its class row's mask and fused score, the
    first max node, and the commit. Updates ``st`` in place and writes the
    tasks placed into ctl[C_TAIL_PLACED]."""
    from volcano_tpu_torch.ops.kernels import _le_eps, _share

    tj = enc["task_job"].long()
    tq = enc["task_queue"].long()
    tns = enc["task_ns"].long()
    placed = 0
    for _ in range(tail_budget(spec)):
        if not bool(st["active"].any()):
            break
        eligible = st["active"]
        if spec.use_prop_overused:
            over = ~_le_eps(st["queue_alloc"], enc["queue_deserved"],
                            enc["eps"], enc["is_scalar"])
            eligible = eligible & ~over[tq]
        levels = []
        for name in spec.job_order_keys:
            if name == "priority":
                levels.append((-enc["job_priority"])[tj])
            elif name == "gang":
                ready = (enc["job_ready_base"] + st["job_placed"]) \
                    >= enc["job_min_available"]
                levels.append(ready.to(torch.int32)[tj])
            elif name == "drf":
                levels.append(_share(st["job_alloc"], enc["drf_total"][None, :],
                                     enc["drf_present"][None, :])[tj])
        levels += [enc["job_tie_rank"][tj], enc["task_in_job"]]
        cand = eligible
        for lv in levels:
            if lv.dtype.is_floating_point:
                sentinel = torch.full_like(lv, float("inf"))
            else:
                sentinel = torch.full_like(lv, torch.iinfo(lv.dtype).max)
            cand = cand & (lv == torch.amin(torch.where(cand, lv, sentinel)))
        t = int(torch.argmax(cand.to(torch.int8)))
        has = bool(eligible.any())
        c = int(enc["task_cls"][t])
        row = tail_row_plain(spec, enc, c, st["idle"], st["used"], st["cnt"],
                             st.get("excl_occ"))
        node = int(torch.argmax(row))
        ok = has and bool(row[node] > float("-inf"))
        req = enc["cls_req"][c]
        dreq = req if ok else torch.zeros_like(req)
        job, q, ns = int(tj[t]), int(tq[t]), int(tns[t])
        st["idle"][node] = st["idle"][node] + (-dreq)
        st["used"][node] = st["used"][node] + dreq
        st["cnt"][node] += int(ok)
        if ok:
            st["assign"][t] = node
        if has:
            st["active"][t] = False
        if has and not ok:
            st["tail_failed"][t] = True
        st["job_placed"][job] += int(ok)
        st["job_alloc"][job] = st["job_alloc"][job] + dreq
        st["queue_alloc"][q] = st["queue_alloc"][q] + dreq
        st["ns_alloc"][ns] = st["ns_alloc"][ns] + dreq
        if spec.use_exclusion:
            g = int(enc["task_excl"][t])
            if ok and g >= 0:
                st["excl_occ"][g, node] = True
        placed += int(ok)
        if not has:
            break
    ctl[C_TAIL_PLACED] = placed


class _TailParams(ctypes.Structure):
    _fields_ = ([(name, ctypes.c_void_p) for name, _ in TAIL_INPUTS]
                + [(name, ctypes.c_void_p) for name, _ in TAIL_STATE]
                + [("ctl", ctypes.c_void_p), ("scratch", ctypes.c_void_p)]
                + [(name, ctypes.c_int) for name in (
                    "T", "N", "R", "J", "Q", "S", "G", "K", "budget", "n_job_keys",
                    "key0", "key1", "key2", "use_prop_overused",
                    "check_pod_count", "use_exclusion", "use_nodeorder",
                    "use_binpack")])


def _tail_lib():
    from volcano_tpu_torch import _build

    lib = _build.library("tail_pass")
    if lib.tail_pass_f32.argtypes is None:
        for fn in (lib.tail_pass_f32, lib.tail_pass_f64):
            fn.argtypes = [ctypes.POINTER(_TailParams), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.tail_pass_scratch_bytes.argtypes = [ctypes.c_int] * 2
        lib.tail_pass_scratch_bytes.restype = ctypes.c_longlong
        lib.tail_pass_placement.argtypes = [ctypes.c_int] * 8
        lib.tail_pass_placement.restype = ctypes.c_int
    return lib


TAIL_PLACEMENTS = ("global", "shared")


def tail_placement(T: int, N: int, R: int, J: int, Q: int, S: int, K: int, dtype) -> str:
    """Where K7b keeps the pass's state and class columns at these sizes on
    the card (one of TAIL_PLACEMENTS): "shared" (staged in shared memory
    for the whole pass, where they all fit) or "global"."""
    fits = _tail_lib().tail_pass_placement(T, N, R, J, Q, S, K, int(dtype == torch.float64))
    if fits < 0:
        raise ValueError(f"tail_pass: {Q} queues exceed the shared-memory gate")
    return TAIL_PLACEMENTS[fits]


def tail_pass(spec, enc, st, ctl) -> None:
    """K7b (csrc/tail_pass.cu, one block, one launch for the whole tail)
    on CUDA, the plain version on the CPU. ``enc`` holds TAIL_INPUTS,
    ``st`` TAIL_STATE (updated in place); the tasks placed land in
    ctl[C_TAIL_PLACED]. The sizes choose the kernel's placement
    (``tail_placement``)."""
    if not devmod.on_cuda(st["idle"], ctl):
        tail_pass_plain(spec, enc, st, ctl)
        return
    dev = ctl.device
    dt = st["idle"].dtype
    kinds = {"f": dt, "i": torch.int32, "b": torch.bool}
    T = enc["task_cls"].shape[0]
    N, R = st["idle"].shape
    J = enc["job_tie_rank"].shape[0]
    Q = enc["queue_deserved"].shape[0]
    S = st["ns_alloc"].shape[0]
    G = enc["sig_mask"].shape[0]
    shapes = {"task_cls": (T,), "cls_req": (enc["cls_req"].shape[0], R),
              "job_alloc": (J, R), "queue_alloc": (Q, R), "ns_alloc": (S, R),
              "sig_mask": (G, N), "affinity_score": (G, N), "assign": (T,),
              "active": (T,), "tail_failed": (T,), "cnt": (N,),
              "used": (N, R), "node_alloc": (N, R), "score_weights": (4,)}
    if spec.use_exclusion and st["excl_occ"].shape[1] != N:
        raise ValueError("excl_occ: node axis mismatch")
    if len(spec.job_order_keys) > 3 or any(
            k not in JOB_KEY_CODES for k in spec.job_order_keys):
        raise ValueError(f"job_order_keys {spec.job_order_keys!r} not supported")
    if Q > 32768:
        raise ValueError(f"tail_pass: {Q} queues exceed the shared-memory gate")
    p = _TailParams()
    for group in (TAIL_INPUTS, TAIL_STATE):
        src = enc if group is TAIL_INPUTS else st
        for name, kind in group:
            t = src.get(name)
            if t is None and name == "excl_occ" and not spec.use_exclusion:
                setattr(p, name, 0)
                continue
            if t.device != dev:
                raise ValueError(f"{name}: on {t.device}, expected {dev}")
            _check(t, name, kinds[kind], shapes.get(name))
            setattr(p, name, t.data_ptr())
    _check(ctl, "ctl", torch.int32, (CTL_LEN,))
    p.ctl = ctl.data_ptr()
    lib = _tail_lib()
    # the per-segment scratch, planned once a size (rebuilt by every launch)
    p.scratch = _scratch("tail_pass", dev, -(-lib.tail_pass_scratch_bytes(T, J) // 8)).data_ptr()
    codes = [JOB_KEY_CODES[k] for k in spec.job_order_keys] + [-1] * 3
    ints = dict(T=T, N=N, R=R, J=J, Q=Q, S=S, G=G, K=enc["cls_req"].shape[0],
                budget=tail_budget(spec),
                n_job_keys=len(spec.job_order_keys), key0=codes[0],
                key1=codes[1], key2=codes[2],
                use_prop_overused=int(spec.use_prop_overused),
                check_pod_count=int(spec.check_pod_count),
                use_exclusion=int(spec.use_exclusion),
                use_nodeorder=int(spec.use_nodeorder),
                use_binpack=int(spec.use_binpack))
    for name, val in ints.items():
        setattr(p, name, val)
    fn = lib.tail_pass_f64 if dt == torch.float64 else lib.tail_pass_f32
    rc = fn(ctypes.byref(p), _stream(ctl))
    if rc != 0:
        raise RuntimeError(f"tail_pass kernel launch failed: CUDA error {rc}")
    devmod.count_launch("tail_pass")
