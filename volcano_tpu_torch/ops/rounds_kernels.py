"""K2 window_topk, K4 resolve_prefix, K5 queue_budget, K7a rounds_ctl and
K7b tail_pass: the wrappers of the hand-written CUDA kernels of the rounds
solver, each beside its plain PyTorch version.

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
# it rescores the dirty columns, it is the rollback, the tail, the machine
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


def rounds_ctl_while(ctl: torch.Tensor, pred: torch.Tensor, params,
                     handle: int) -> None:
    """K7a inside the body of the solve graph's WHILE node: the same step,
    then the node's condition (``handle``) set to pred[P_ACTIVE]."""
    from volcano_tpu_torch import _build

    _check(ctl, "ctl", torch.int32, (CTL_LEN,))
    _check(pred, "pred", torch.bool, (NPRED,))
    lib = _build.library("rounds_ctl")
    fn = lib.rounds_ctl_while
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 \
        + [ctypes.c_ulonglong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(_ptr(ctl), _ptr(pred), *(int(x) for x in params),
            ctypes.c_ulonglong(handle), _stream(ctl))
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


def score_weights(enc) -> torch.Tensor:
    """[least-requested, balanced, node-affinity, binpack] weights."""
    dt = enc["cls_req"].dtype
    return torch.stack([
        enc["least_req_weight"], enc["balanced_weight"],
        enc["node_affinity_weight"], enc["binpack_weight"]]).to(dt).contiguous()


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
                + [("ctl", ctypes.c_void_p)]
                + [(name, ctypes.c_int) for name in (
                    "T", "N", "R", "J", "Q", "S", "G", "budget", "n_job_keys",
                    "key0", "key1", "key2", "use_prop_overused",
                    "check_pod_count", "use_exclusion", "use_nodeorder",
                    "use_binpack")])


def tail_pass(spec, enc, st, ctl) -> None:
    """K7b (csrc/tail_pass.cu, one block, one launch for the whole tail)
    on CUDA, the plain version on the CPU. ``enc`` holds TAIL_INPUTS,
    ``st`` TAIL_STATE (updated in place); the tasks placed land in
    ctl[C_TAIL_PLACED]."""
    if not devmod.on_cuda(st["idle"], ctl):
        tail_pass_plain(spec, enc, st, ctl)
        return
    from volcano_tpu_torch import _build

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
    codes = [JOB_KEY_CODES[k] for k in spec.job_order_keys] + [-1] * 3
    ints = dict(T=T, N=N, R=R, J=J, Q=Q, S=S, G=G, budget=tail_budget(spec),
                n_job_keys=len(spec.job_order_keys), key0=codes[0],
                key1=codes[1], key2=codes[2],
                use_prop_overused=int(spec.use_prop_overused),
                check_pod_count=int(spec.check_pod_count),
                use_exclusion=int(spec.use_exclusion),
                use_nodeorder=int(spec.use_nodeorder),
                use_binpack=int(spec.use_binpack))
    for name, val in ints.items():
        setattr(p, name, val)
    lib = _build.library("tail_pass")
    fn = lib.tail_pass_f64 if dt == torch.float64 else lib.tail_pass_f32
    fn.argtypes = [ctypes.POINTER(_TailParams), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(ctypes.byref(p), _stream(ctl))
    if rc != 0:
        raise RuntimeError(f"tail_pass kernel launch failed: CUDA error {rc}")
    devmod.count_launch("tail_pass")
