"""Express placement kernel — one narrow windowed round on the device.

Port of volcano_tpu/express/place.py. The full session solves placement
in bulk-synchronous rounds over the whole pending set (ops/rounds.py). An
express batch is the opposite shape: a handful of freshly arrived tasks
against a long-lived node axis that is already resident on the device.
One call does the whole thing:

1. batch-wide masked scores over the node axis (the same fused
   least-requested + balanced-resource scoring the serial loop and the
   rounds kernel use — ``ops.kernels.fused_scores``), one candidate
   window per task: the first ``window_k`` entries of the stable
   descending order (ties to the lower node index), width off the solver
   bucket ladder;
2. a sequential walk over the (tiny, bucketed) task axis in the serial
   visit order: per step, feasibility + FRESH scores are recomputed on the
   task's window columns only, and the best surviving candidate in window
   order wins;
3. a per-step coverage check proves the windowed answer equals the
   full-width one: placements only shrink idle, so every node outside the
   window is bounded above by the window's last initial score — a fresh
   in-window winner strictly above that bound cannot be beaten outside.
   Uncovered steps (or steps whose window ran dry) take a full-width
   fresh sweep instead (lowest node index among the maxima), counted in
   the profile tail;
4. a gang strip retires every job that could not place ALL of its batch
   tasks (express is all-or-nothing per job — partial gangs are deferred
   to the full session, never half-committed).

The solve never mutates the lane's tensors: the committed binds flow
through the real cache effectors host-side, the SnapshotKeeper marks the
touched rows, and the next express refresh patches exactly those rows
(express/encode.py). The result is ONE packed int32 tensor (assign +
profile tail) so the lane pays a single D2H fetch.

``solve_express`` launches K14 (csrc/express_place.cu) on CUDA tensors,
raising if it cannot, and runs ``solve_express_plain`` on CPU tensors, the
way ``ops/kernels.py:score_block`` dispatches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from volcano_tpu_torch import device as devmod
from volcano_tpu_torch.ops.kernels import (
    MIN_MEMORY,
    MIN_MILLI_CPU,
    _check,
    fused_scores,
)
from volcano_tpu_torch.ops.rounds_kernels import window_topk_plain
from volcano_tpu_torch.ops.solver import _bucket

# packed-result tail: [full_sweep_steps, placed_total]
PROF_TAIL = 2

EXPRESS_MAX_BATCH = 64


class ExpressSpec(NamedTuple):
    """Static express-solve configuration.

    ``tb``/``jb`` are the PADDED task/job buckets (solver._bucket);
    ``window_k`` comes off the same ladder (0 = full width, the small-axis
    and parity mode)."""

    tb: int
    jb: int
    window_k: int = 0
    check_pod_count: bool = True
    # fused_scores flags: express models the default conf's nodeorder
    # scoring; binpack sessions are outside the express envelope
    # (trigger.py gates on plugin names), so the flag exists only to keep
    # the shared scorer's signature honest
    use_nodeorder: bool = True
    use_binpack: bool = False


def window_for(n_nodes: int, batch: int) -> int:
    """Candidate-window width for an express batch, off the solver bucket
    ladder. 0 (full width) when the window would span most of the axis
    anyway — pruning buys nothing below a few hundred nodes."""
    k = _bucket(max(32, 4 * batch))
    if 2 * k > n_nodes:
        return 0
    return k


def task_bucket(n_tasks: int) -> int:
    return _bucket(max(n_tasks, 1))


def solve_express_plain(spec: ExpressSpec, idle, alloc, cnt, ok, maxt,
                        task_initreq, task_req, task_nzc, task_nzm,
                        task_valid, task_job, task_has_pod, job_need,
                        weights) -> torch.Tensor:
    """The plain version of K14: the reference's loop step by step."""
    n = idle.shape[0]
    tb = spec.tb
    dt, dev = idle.dtype, idle.device
    eps = torch.tensor([MIN_MILLI_CPU, MIN_MEMORY], dtype=dt, device=dev)
    neg = torch.full((), float("-inf"), dtype=dt, device=dev)

    # scoring context for the shared fused scorer: no affinity signatures
    # in the express envelope (trigger gates on <plain> pods), so the
    # signature axis collapses to one zero row
    aff = torch.zeros((1, n), dtype=dt, device=dev)
    enc = {
        "least_req_weight": weights[0],
        "balanced_weight": weights[1],
        "node_affinity_weight": torch.zeros((), dtype=dt, device=dev),
        "affinity_score": aff,
        "node_alloc": alloc,
    }
    sig = torch.zeros((tb,), dtype=torch.long, device=dev)
    sig0 = torch.zeros((), dtype=torch.long, device=dev)

    used0 = alloc - idle
    scores0 = fused_scores(spec, enc, used0, task_req, task_nzc, task_nzm,
                           sig)                                   # [tb, N]
    scores0 = torch.where(ok[None, :], scores0, neg)
    if spec.window_k > 0:
        top_s, top_i = window_topk_plain(scores0, spec.window_k)  # [tb, W]
        top_i = top_i.long()

    def fit_of(idle_c, cnt_c, t, cols=None):
        ic = idle_c if cols is None else idle_c[cols]
        fit = torch.all(task_initreq[t][None, :] < ic + eps[None, :], dim=-1)
        fit = fit & (ok if cols is None else ok[cols])
        if spec.check_pod_count:
            cc = cnt_c if cols is None else cnt_c[cols]
            mt = maxt if cols is None else maxt[cols]
            fit = fit & ((cc < mt) | ~task_has_pod[t])
        return fit

    def fresh_full(idle_c, cnt_c, t):
        """Full-width fresh feasibility + scores for task t (the
        exactness fallback and the window_k == 0 path): the lowest node
        index among the maxima, node 0 when every score is -inf."""
        fit = fit_of(idle_c, cnt_c, t)
        sc = fused_scores(spec, enc, alloc - idle_c, task_req[t],
                          task_nzc[t], task_nzm[t], sig0)
        node = int(torch.argmax(torch.where(fit, sc, neg)))
        return node, bool(fit[node])

    idle_c = idle.clone()
    cnt_c = cnt.clone()
    assign = [-1] * tb
    job_placed = [0] * spec.jb
    fulls = placed_n = 0
    valid_l = task_valid.tolist()
    job_l = task_job.tolist()
    for t in range(tb):
        if not valid_l[t]:
            continue  # a pad task never places and never sweeps
        if spec.window_k > 0:
            cols = top_i[t]                                       # [W]
            fit_w = fit_of(idle_c, cnt_c, t, cols)
            sc_w = fused_scores(
                spec, enc, alloc[cols] - idle_c[cols], task_req[t],
                task_nzc[t], task_nzm[t], sig0,
                alloc=alloc[cols], aff=aff[:, cols])              # [W]
            sc_wm = torch.where(fit_w, sc_w, neg)
            best_w = int(torch.argmax(sc_wm))
            # coverage: idle only shrinks inside the batch, so every
            # out-of-window node's fresh score <= its initial score <= the
            # window's last initial value; a strictly-greater in-window
            # winner is provably the full-width winner (ties fall back —
            # the full-width tie-break may prefer a lower out-of-window
            # index)
            covered = bool(fit_w.any()) and bool(
                sc_wm[best_w] > top_s[t, spec.window_k - 1])
            if covered:
                node, feas = int(cols[best_w]), True
            else:
                node, feas = fresh_full(idle_c, cnt_c, t)
                fulls += 1
        else:
            node, feas = fresh_full(idle_c, cnt_c, t)
            fulls += 1
        if feas:
            idle_c[node] = idle_c[node] + (-task_req[t])
            cnt_c[node] += 1
            assign[t] = node
            job_placed[job_l[t]] += 1
            placed_n += 1

    # all-or-nothing per job: a batch job that could not place EVERY task
    # is stripped (deferred to the full session); no capacity refund is
    # needed, the walked idle/cnt are discarded
    need = job_need.tolist()
    for t in range(tb):
        if assign[t] >= 0 and job_placed[job_l[t]] < need[job_l[t]]:
            assign[t] = -1
            placed_n -= 1
    return torch.tensor(assign + [fulls, placed_n], dtype=torch.int32,
                        device=dev)


_ARGTYPES = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 22
# the kernel library's entry points, their argtypes set once a library
_FNS: dict = {}
# one launch plan and its scratch a bucket (library, device, dtype, N, tb,
# jb, W, check_pod), its inputs checked once; the newest _MAX_BUCKETS kept.
# Every call of a bucket reuses its scratch: the calls run in order on the
# caller's stream (the lane's), so none overwrites another's in flight
_BUCKETS: dict = {}
_MAX_BUCKETS = 16


def _lib_fns(lib):
    fns = _FNS.get(lib)
    if fns is None:
        for fn in (lib.express_place_f32, lib.express_place_f64):
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
        lib.express_place_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.express_place_plan.restype = ctypes.c_int
        fns = _FNS[lib] = (lib.express_place_f32, lib.express_place_f64,
                           lib.express_place_plan)
    return fns


def _check_inputs(spec, args) -> None:
    (idle, alloc, cnt, ok, maxt, task_initreq, task_req, task_nzc, task_nzm,
     task_valid, task_job, task_has_pod, job_need, weights) = args
    dt, dev = idle.dtype, idle.device
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"idle: dtype {dt}")
    n = idle.shape[0]
    tb, jb, w = spec.tb, spec.jb, spec.window_k
    if spec.use_binpack or not spec.use_nodeorder:
        raise ValueError("express_place scores nodeorder only")
    if not 0 <= w <= n:
        raise ValueError(f"express_place: window_k={w} outside [0, {n}]")
    b, i32 = torch.bool, torch.int32
    checks = [
        ("idle", idle, dt, (n, 2)), ("alloc", alloc, dt, (n, 2)),
        ("cnt", cnt, i32, (n,)), ("ok", ok, b, (n,)), ("maxt", maxt, i32, (n,)),
        ("task_initreq", task_initreq, dt, (tb, 2)),
        ("task_req", task_req, dt, (tb, 2)), ("task_nzc", task_nzc, dt, (tb,)),
        ("task_nzm", task_nzm, dt, (tb,)), ("task_valid", task_valid, b, (tb,)),
        ("task_job", task_job, i32, (tb,)),
        ("task_has_pod", task_has_pod, b, (tb,)),
        ("job_need", job_need, i32, (jb,)), ("weights", weights, dt, (2,)),
    ]
    for name, t, want, shape in checks:
        if t.device != dev:
            raise ValueError(f"{name}: on {t.device}, expected {dev}")
        _check(t, name, want, shape)


def _bucket_of(lib, plan_fn, spec, args):
    """The bucket's (scratch pointers, scratch tensors): built, and the
    inputs checked, at its first call."""
    idle = args[0]
    key = (lib, idle.device, idle.dtype, idle.shape[0], spec.tb, spec.jb,
           spec.window_k, spec.check_pod_count)
    got = _BUCKETS.get(key)
    if got is not None:
        return got
    _check_inputs(spec, args)
    n, tb, w = idle.shape[0], spec.tb, spec.window_k
    plan = (ctypes.c_longlong * 3)()
    rc = plan_fn(n, tb, w, int(idle.dtype == torch.float64), plan)
    if rc != 0:
        raise RuntimeError(f"express_place launch plan failed: CUDA error {rc}")

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=idle.device)

    scratch = (
        empty(plan[0], torch.uint8) if plan[0] > 0 else None,   # window keys
        empty((tb, w), idle.dtype) if w > 0 else None,          # top_s
        empty((tb, w), torch.int32) if w > 0 else None,         # top_i
        empty((tb, w), torch.int64) if w > 0 else None,         # select list
        empty((tb, w), torch.int32) if w > 0 else None,
        empty(spec.jb, torch.int32),                            # job_placed
    )
    ptrs = tuple(t.data_ptr() if t is not None else None for t in scratch)
    while len(_BUCKETS) >= _MAX_BUCKETS:
        _BUCKETS.pop(next(iter(_BUCKETS)))
    got = _BUCKETS[key] = (ptrs, scratch)
    return got


def _solve_express_cuda(spec: ExpressSpec, *args) -> torch.Tensor:
    from volcano_tpu_torch import _build

    lib = _build.library("express_place")
    f32, f64, plan_fn = _lib_fns(lib)
    idle = args[0]
    ptrs, _ = _bucket_of(lib, plan_fn, spec, args)
    out = torch.empty(spec.tb + PROF_TAIL, dtype=torch.int32, device=idle.device)
    fn = f64 if idle.dtype == torch.float64 else f32
    rc = fn(idle.shape[0], spec.tb, spec.jb, spec.window_k,
            int(spec.check_pod_count), *[t.data_ptr() for t in args], *ptrs,
            out.data_ptr(), devmod.raw_stream(idle.device))
    if rc != 0:
        raise RuntimeError(f"express_place kernel launch failed: CUDA error {rc}")
    devmod.count_launch("express_place")
    return out


def solve_express(spec: ExpressSpec, idle, alloc, cnt, ok, maxt,
                  task_initreq, task_req, task_nzc, task_nzm,
                  task_valid, task_job, task_has_pod, job_need,
                  weights) -> torch.Tensor:
    """One express round. Node tensors are the lane's resident live axis
    (express/encode.py); task/job tensors are the bucketed arrival batch.

    Returns one packed int32 [tb + PROF_TAIL]: per-task node index (or -1
    deferred), then [full-width fallback steps, placed count]. K14 on
    CUDA tensors, the plain version on CPU tensors."""
    args = (spec, idle, alloc, cnt, ok, maxt, task_initreq, task_req,
            task_nzc, task_nzm, task_valid, task_job, task_has_pod,
            job_need, weights)
    if idle.is_cuda:   # every input's device is checked at a bucket's first call
        return _solve_express_cuda(*args)
    return solve_express_plain(*args)
