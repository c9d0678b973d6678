"""K2 window_topk, K4 resolve_prefix and K5 queue_budget: the wrappers of
the hand-written CUDA kernels of the rounds solver, each beside its plain
PyTorch version.

A wrapper launches its kernel (csrc/<name>.cu) for CUDA tensors, raising
when it cannot, and runs the plain version for CPU tensors; it never falls
back from one to the other. Each launch adds one to its count in
volcano_tpu_torch.device.LAUNCHES.
"""

from __future__ import annotations

import ctypes

import torch

from volcano_tpu_torch import device as devmod
from volcano_tpu_torch.ops.kernels import MIN_MILLI_SCALAR, _check, _ptr

INT32_MAX = 2**31 - 1


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _same_device(ref, **tensors):
    for name, t in tensors.items():
        if t.device != ref.device:
            raise ValueError(f"{name}: on {t.device}, expected {ref.device}")


# -- K2: per-row stable top-k window ----------------------------------------

def window_topk_plain(scores: torch.Tensor, k: int):
    """The first k entries of each row's stable descending order (ties to
    the lower index, -inf an ordinary key): the exact prefix that
    volcano_tpu/ops/rounds.py:754 lax.top_k returns. (values, int32 idx)."""
    order = torch.argsort(-scores, dim=1, stable=True)[:, :k]
    return torch.gather(scores, 1, order), order.to(torch.int32)


def window_topk(scores: torch.Tensor, k: int):
    """K2 (csrc/window_topk.cu) on CUDA, the plain version on the CPU."""
    if not devmod.on_cuda(scores):
        return window_topk_plain(scores, k)
    from volcano_tpu_torch import _build

    if scores.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"scores: dtype {scores.dtype}")
    if scores.dim() != 2 or not scores.is_contiguous():
        raise ValueError("scores: expected a contiguous [K, N] matrix")
    rows, n = scores.shape
    if not 0 < k <= n:
        raise ValueError(f"window_topk: k={k} outside (0, {n}]")
    top_s = torch.empty((rows, k), dtype=scores.dtype, device=scores.device)
    top_i = torch.empty((rows, k), dtype=torch.int32, device=scores.device)
    lib = _build.library("window_topk")
    fn = lib.window_topk_f64 if scores.dtype == torch.float64 else lib.window_topk_f32
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    rc = fn(rows, n, k, _ptr(scores), _ptr(top_s), _ptr(top_i), _stream(scores))
    if rc != 0:
        raise RuntimeError(f"window_topk kernel launch failed: CUDA error {rc}")
    devmod.count_launch("window_topk")
    return top_s, top_i


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


def _heads(*keys: torch.Tensor) -> torch.Tensor:
    head = torch.zeros(keys[0].shape[0], dtype=torch.bool, device=keys[0].device)
    head[0] = True
    for key in keys:
        head[1:] |= key[1:] != key[:-1]
    return head


# -- K4: per-node prefix acceptance -------------------------------------------

def resolve_prefix_plain(key_s, req_s, pod_s, bound, is_scalar, cnt, nmax,
                         check_pod: bool):
    """Plain version of K4 over rows sorted by (node key, rank): the row
    is accepted iff it and every earlier row of its node segment fit —
    cumulative int64 request < max(bound, 0) per dim (scalar dims at or
    under MIN_MILLI_SCALAR skipped) and, with check_pod, the node's pod
    room. Key INT32_MAX is the infeasible segment (all rejected)."""
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
    return cond & (rej == 0)


def resolve_prefix(key_s, req_s, pod_s, bound, is_scalar, cnt, nmax,
                   check_pod: bool):
    """K4 (csrc/resolve_prefix.cu) on CUDA, the plain version on the CPU.
    key_s int32 [T], req_s int64 [T, R], pod_s bool [T], bound int64
    [N, R], is_scalar bool [R], cnt/nmax int32 [N]. Returns bool [T]."""
    if not devmod.on_cuda(key_s, req_s, bound):
        return resolve_prefix_plain(key_s, req_s, pod_s, bound, is_scalar,
                                    cnt, nmax, check_pod)
    from volcano_tpu_torch import _build

    t, r = req_s.shape
    n = bound.shape[0]
    _same_device(key_s, req_s=req_s, pod_s=pod_s, bound=bound,
                 is_scalar=is_scalar, cnt=cnt, nmax=nmax)
    _check(key_s, "key_s", torch.int32, (t,))
    _check(req_s, "req_s", torch.int64, (t, r))
    _check(pod_s, "pod_s", torch.bool, (t,))
    _check(bound, "bound", torch.int64, (n, r))
    _check(is_scalar, "is_scalar", torch.bool, (r,))
    _check(cnt, "cnt", torch.int32, (n,))
    _check(nmax, "nmax", torch.int32, (n,))
    out = torch.zeros(t, dtype=torch.bool, device=key_s.device)
    lib = _build.library("resolve_prefix")
    fn = lib.resolve_prefix
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 \
        + [ctypes.c_int] + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    rc = fn(t, r, _ptr(key_s), _ptr(req_s), _ptr(pod_s), _ptr(bound),
            _ptr(is_scalar), _ptr(cnt), _ptr(nmax), int(check_pod),
            _ptr(out), _stream(key_s))
    if rc != 0:
        raise RuntimeError(f"resolve_prefix kernel launch failed: CUDA error {rc}")
    devmod.count_launch("resolve_prefix")
    return out


# -- K5: job-granular queue budget ---------------------------------------------

def queue_budget_plain(q_s, job_s, req_s, acc_s, alloc_i, bound, is_scalar):
    """Plain version of K5 over rows sorted by (queue, rank): a row
    survives iff it was accepted and its queue's allocation plus what the
    higher-ranked jobs of the queue took fits under max(bound, 0) per dim
    (scalar dims at or under MIN_MILLI_SCALAR skipped). Exact int64."""
    q_head = _heads(q_s)
    j_head = _heads(q_s, job_s)
    qsum = _seg_cumsum(req_s, _seg_start_idx(q_head))
    jsum = _seg_cumsum(req_s, _seg_start_idx(j_head))
    q = q_s.long()
    tot = alloc_i[q] + (qsum - jsum)
    le = tot < torch.clamp(bound[q], min=0)
    skip = is_scalar[None, :] & (tot <= MIN_MILLI_SCALAR)
    return acc_s & torch.all(le | skip, dim=-1)


def queue_budget(q_s, job_s, req_s, acc_s, alloc_i, bound, is_scalar):
    """K5 (csrc/queue_budget.cu) on CUDA, the plain version on the CPU.
    q_s/job_s int32 [T], req_s int64 [T, R], acc_s bool [T], alloc_i and
    bound int64 [Q, R], is_scalar bool [R]. Returns bool [T]."""
    if not devmod.on_cuda(q_s, req_s, alloc_i):
        return queue_budget_plain(q_s, job_s, req_s, acc_s, alloc_i, bound,
                                  is_scalar)
    from volcano_tpu_torch import _build

    t, r = req_s.shape
    nq = alloc_i.shape[0]
    _same_device(q_s, job_s=job_s, req_s=req_s, acc_s=acc_s, alloc_i=alloc_i,
                 bound=bound, is_scalar=is_scalar)
    _check(q_s, "q_s", torch.int32, (t,))
    _check(job_s, "job_s", torch.int32, (t,))
    _check(req_s, "req_s", torch.int64, (t, r))
    _check(acc_s, "acc_s", torch.bool, (t,))
    _check(alloc_i, "alloc_i", torch.int64, (nq, r))
    _check(bound, "bound", torch.int64, (nq, r))
    _check(is_scalar, "is_scalar", torch.bool, (r,))
    out = torch.empty(t, dtype=torch.bool, device=q_s.device)
    lib = _build.library("queue_budget")
    fn = lib.queue_budget
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 9
    fn.restype = ctypes.c_int
    rc = fn(t, r, _ptr(q_s), _ptr(job_s), _ptr(req_s), _ptr(acc_s),
            _ptr(alloc_i), _ptr(bound), _ptr(is_scalar), _ptr(out),
            _stream(q_s))
    if rc != 0:
        raise RuntimeError(f"queue_budget kernel launch failed: CUDA error {rc}")
    devmod.count_launch("queue_budget")
    return out
