"""K15: the parity scan, the sequential allocate kernel.

Port of volcano_tpu/ops/kernels.py:52-118 (``_lex_argmin``, ``_fits``,
``_le_eps``, ``_share``, ``_sample_window``) and :221-431
(``_node_score``, ``_job_keys``, ``_queue_share``, ``_inner_task_loop``,
``_make_visit``, ``solve_allocate``). The scan emulates the serial
allocate action visit by visit: namespace -> queue (overused queues purged
for good) -> job by lexicographic argmin over the job-order keys in tier
order, then the job's tasks one at a time through the feasibility mask,
the round-robin sampling window, the fused score and the arg-max, and
finally the gang commit or an exact roll back. Its binds equal the serial
loop's (``tpuscore.mode: parity``), which is what makes it the oracle
surface of tests/test_tpu_parity.py.

``solve_allocate(spec, enc, rr0, num_to_find)`` returns one int32 tensor
``[T + 1]``: ``assign`` (node index or -1 per padded task) followed by the
final round-robin index. On CUDA tensors it launches the hand-written
kernel csrc/parity_scan.cu once (and raises if it cannot); on CPU tensors
it runs ``solve_allocate_plain``, a host-driven loop of torch ops with the
reference's names and arithmetic. The plain version is held bit for bit
against the jitted JAX ``solve_allocate`` (tests/test_torch_parity.py), and
the kernel against the plain version on the card (chip_smoke.py).
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from volcano_tpu_torch import device as devmod
from volcano_tpu_torch.ops.kernels import (
    MIN_MILLI_SCALAR,
    SolveSpec,
    _le_eps,
    _share,
    fused_scores,
)

# the job-order key codes the kernel reads, in tier order
JOB_KEY_CODES = {"priority": 0, "gang": 1, "drf": 2}

# what the last plain run did, for the work a session's data needs:
# visits, the job rows they scanned, task steps, the real nodes the
# windows walked (the reference's `processed`) and the nodes scored
STATS = {"visits": 0, "job_rows": 0, "steps": 0, "examined": 0, "scored": 0}


def _lex_argmin(valid, keys):
    """Index of the valid element minimizing ``keys`` lexicographically,
    and whether any element is valid: each key level keeps the elements
    equal to the level's minimum (+inf for float keys, the integer max for
    int keys where masked out); the lowest index left wins."""
    mask = valid
    for k in keys:
        if k.dtype.is_floating_point:
            sentinel = torch.full_like(k, float("inf"))
        else:
            sentinel = torch.full_like(k, torch.iinfo(k.dtype).max)
        kv = torch.where(mask, k, sentinel)
        mask = mask & (kv == kv.min())
    return int(torch.argmax(mask.to(torch.uint8))), bool(valid.any())


def _fits(req, avail, eps, is_scalar):
    """Per-node epsilon feasibility of ``req`` [R] against ``avail``
    [N, R] (resource_info.go:267-301: scalar dims <= 10 milli are
    skipped)."""
    le = req[None, :] < avail + eps[None, :]
    skip = is_scalar[None, :] & (req[None, :] <= MIN_MILLI_SCALAR)
    return torch.all(le | skip, dim=-1)


def _sample_window(mask, node_real, real_n, rr, num_to_find):
    """The round-robin feasible-node window (scheduler_helper.go:64-118):
    starting at ``rr``, keep the first ``num_to_find`` feasible nodes.
    Returns (selected mask, real nodes examined, found any)."""
    rolled = torch.roll(mask & node_real, -rr)
    rolled_real = torch.roll(node_real, -rr).to(torch.int32)
    c = torch.cumsum(rolled.to(torch.int32), 0)
    found_total = int(c[-1])
    sel_rolled = rolled & (c <= num_to_find)
    kth = int(torch.argmax((c >= num_to_find).to(torch.uint8)))
    examined = torch.cumsum(rolled_real, 0)
    processed = int(examined[kth]) if found_total >= num_to_find else int(real_n)
    sel = torch.roll(sel_rolled, rr)
    return sel, processed, found_total > 0


def _node_score(spec: SolveSpec, used, enc, t):
    """[N] scores for one task index."""
    return fused_scores(spec, enc, used, enc["task_req"][t],
                        enc["task_nz_cpu"][t], enc["task_nz_mem"][t],
                        enc["task_sig"][t].long())


def _job_keys(spec: SolveSpec, st, enc):
    """Job-order key arrays [J] in the configured tier order, with the
    (creation, uid) rank as the final tie-break."""
    keys = []
    for name in spec.job_order_keys:
        if name == "priority":
            keys.append(-enc["job_priority"])
        elif name == "gang":
            ready = (enc["job_ready_base"] + st["job_placed"]) >= enc["job_min_available"]
            keys.append(ready.to(torch.int32))  # non-ready (0) first
        elif name == "drf":
            keys.append(_share(st["job_alloc"], enc["drf_total"][None, :],
                               enc["drf_present"][None, :]))
    keys.append(enc["job_tie_rank"])
    return keys


def _queue_share(st, enc):
    return _share(st["queue_alloc"], enc["queue_deserved"], enc["queue_present"])


def _inner_task_loop(spec: SolveSpec, enc, st, j):
    """Place tasks of job ``j`` until gang-ready, exhausted or infeasible
    (allocate.go:160-243), on the state ``st`` in place. Returns the
    visit's (ptr, placed, placed_req, broke)."""
    start = int(enc["job_task_start"][j])
    count = int(enc["job_task_count"][j])
    threshold = int(enc["job_ready_threshold"][j])
    base = int(enc["job_ready_base"][j]) + int(st["job_placed"][j])
    eps, is_scalar = enc["eps"], enc["is_scalar"]
    real_n = int(enc["real_n"])
    ptr = int(st["job_ptr"][j]) - start
    placed = 0
    placed_req = torch.zeros_like(eps)
    broke = False
    while ptr < count and not broke:
        t = start + ptr
        sig = int(enc["task_sig"][t])
        fit = _fits(enc["task_initreq"][t], st["idle"], eps, is_scalar)
        mask = enc["sig_mask"][sig] & fit
        if spec.check_pod_count:
            # podless tasks skip the whole predicate chain, pod cap included
            mask = mask & ((st["cnt"] < enc["node_max_tasks"])
                           | ~enc["task_has_pod"][t])
        sel, processed, found = _sample_window(
            mask, enc["node_real"], real_n, st["rr"], st["num_to_find"])
        st["rr"] = (st["rr"] + processed) % real_n
        STATS["steps"] += 1
        STATS["examined"] += processed
        STATS["scored"] += int(sel.sum())
        if not found:
            break
        score = _node_score(spec, st["used"], enc, t)
        n = int(torch.argmax(torch.where(
            sel, score, torch.full_like(score, float("-inf")))))
        req = enc["task_req"][t]
        st["idle"][n] = st["idle"][n] + (-req)
        st["used"][n] = st["used"][n] + req
        st["cnt"][n] += 1
        st["assign"][t] = n
        placed += 1
        placed_req = placed_req + req
        ptr += 1
        broke = (base + placed) >= threshold
    return ptr, placed, placed_req, broke


def _visit(spec: SolveSpec, enc, st) -> None:
    """One scheduling visit on the state ``st`` (in place)."""
    # 1. namespace: weighted DRF share when enabled, else static rank
    ns_keys = []
    if spec.use_drf_ns_order:
        ns_share = _share(st["ns_alloc"], enc["drf_total"][None, :],
                          enc["drf_present"][None, :])
        ns_keys.append(ns_share / enc["ns_weight"])
    ns_keys.append(enc["ns_rank"])
    ns, _ = _lex_argmin(st["ns_active"], ns_keys)

    # 2. queue, purging overused queues permanently
    q_in = st["q_in_ns"][ns]
    if spec.use_prop_overused:
        overused = ~_le_eps(st["queue_alloc"], enc["queue_deserved"],
                            enc["eps"][None, :], enc["is_scalar"][None, :])
        q_in = q_in & ~overused
    st["q_in_ns"][ns] = q_in
    q_keys = []
    if spec.use_prop_queue_order:
        q_keys.append(_queue_share(st, enc))
    q_keys.append(enc["queue_tie_rank"])
    q, q_any = _lex_argmin(q_in, q_keys)

    # 3. job
    j_valid = st["job_active"] & (enc["job_queue"] == q) & (enc["job_ns"] == ns)
    j, j_any = _lex_argmin(j_valid, _job_keys(spec, st, enc))
    st["visits"] += 1
    STATS["visits"] += 1
    STATS["job_rows"] += int(j_valid.shape[0]) if q_any else 0
    if not (q_any and j_any):
        # all queues overused / the selected queue empty: the namespace
        # is popped and never re-pushed (allocate.go:125-157)
        st["ns_active"][ns] = False
        return

    saved = (st["idle"].clone(), st["used"].clone(), st["cnt"].clone())
    ptr, placed, placed_req, broke = _inner_task_loop(spec, enc, st, j)
    start = int(enc["job_task_start"][j])
    ready = (int(enc["job_ready_base"][j]) + int(st["job_placed"][j]) + placed
             ) >= int(enc["job_ready_threshold"][j])
    if ready:
        st["job_alloc"][j] = st["job_alloc"][j] + placed_req
        st["queue_alloc"][q] = st["queue_alloc"][q] + placed_req
        st["ns_alloc"][ns] = st["ns_alloc"][ns] + placed_req
        st["job_placed"][j] += placed
        st["job_ptr"][j] = start + ptr
        # re-pushed only on the gang-ready break (allocate.go:238-240)
        st["job_active"][j] = broke
    else:
        # roll the tentative placements back (statement.go:309-322): the
        # pre-visit rows come back as they were, never by subtraction
        st["idle"], st["used"], st["cnt"] = saved
        st["assign"][start + ptr - placed:start + ptr] = -1
        st["job_active"][j] = False


def solve_allocate_plain(spec: SolveSpec, enc: Dict[str, torch.Tensor],
                         rr0: int, num_to_find: int) -> torch.Tensor:
    """The plain version of K15 on any device: the whole allocate session
    as a host-driven loop of visits. Returns int32 ``[T + 1]``: assign,
    then the final round-robin index."""
    T = enc["task_req"].shape[0]
    for key in STATS:
        STATS[key] = 0
    st = dict(
        idle=enc["node_idle"].clone(),
        used=enc["node_used"].clone(),
        cnt=enc["node_cnt"].clone(),
        assign=torch.full((T,), -1, dtype=torch.int32,
                          device=enc["task_req"].device),
        rr=int(rr0),
        num_to_find=int(num_to_find),
        job_ptr=enc["job_task_start"].clone(),
        job_placed=torch.zeros_like(enc["job_task_start"]),
        job_alloc=enc["job_alloc0"].clone(),
        queue_alloc=enc["queue_alloc0"].clone(),
        ns_alloc=enc["ns_alloc0"].clone(),
        job_active=enc["job_active0"].clone(),
        ns_active=enc["ns_active0"].clone(),
        q_in_ns=enc["q_in_ns0"].clone(),
        visits=0,
    )
    # runaway backstop from the padded shapes; the real exit is the
    # namespace drain
    max_visits = (enc["ns_active0"].shape[0]
                  + enc["job_task_start"].shape[0] + T + 8)
    while bool(st["ns_active"].any()) and st["visits"] < max_visits:
        _visit(spec, enc, st)
    rr = torch.tensor([st["rr"]], dtype=torch.int32, device=st["assign"].device)
    return torch.cat([st["assign"], rr])


# -- the CUDA kernel ----------------------------------------------------------

# enc arrays the kernel reads, in the order of ParityParams' pointer block
# in csrc/parity_scan.cu: (name, kind) with kind f (score dtype), i (int32),
# b (bool)
_INPUTS = (
    ("task_req", "f"), ("task_initreq", "f"), ("task_nz_cpu", "f"),
    ("task_nz_mem", "f"), ("task_sig", "i"), ("task_has_pod", "b"),
    ("node_idle", "f"), ("node_used", "f"), ("node_cnt", "i"),
    ("node_alloc", "f"), ("node_max_tasks", "i"), ("node_real", "b"),
    ("real_n", "i"), ("sig_mask", "b"), ("affinity_score", "f"),
    ("eps", "f"), ("is_scalar", "b"), ("binpack_w", "f"),
    ("job_task_start", "i"), ("job_task_count", "i"), ("job_queue", "i"),
    ("job_ns", "i"), ("job_priority", "i"), ("job_min_available", "i"),
    ("job_ready_base", "i"), ("job_ready_threshold", "i"),
    ("job_tie_rank", "i"), ("job_alloc0", "f"), ("job_active0", "b"),
    ("queue_deserved", "f"), ("queue_present", "b"), ("queue_alloc0", "f"),
    ("queue_tie_rank", "i"), ("ns_alloc0", "f"), ("ns_active0", "b"),
    ("ns_rank", "i"), ("ns_weight", "f"), ("q_in_ns0", "b"),
    ("drf_total", "f"), ("drf_present", "b"),
)
# device scratch the kernel carries its state in: (name, kind, shape key)
_SCRATCH = (
    ("idle", "f", "NR"), ("used", "f", "NR"), ("cnt", "i", "N"),
    ("job_ptr", "i", "J"), ("job_placed", "i", "J"), ("job_alloc", "f", "JR"),
    ("queue_alloc", "f", "QR"), ("ns_alloc", "f", "SR"),
    ("job_active", "b", "J"), ("ns_active", "b", "S"), ("q_in_ns", "b", "SQ"),
    ("undo_node", "i", "T"), ("undo_cnt", "i", "T"),
    ("undo_idle", "f", "TR"), ("undo_used", "f", "TR"),
)
_INTS = ("T", "N", "R", "J", "Q", "S", "G", "rr0", "num_to_find",
         "n_job_keys", "key0", "key1", "key2", "use_drf_ns_order",
         "use_prop_queue_order", "use_prop_overused", "check_pod_count",
         "use_nodeorder", "use_binpack")


class _Params(ctypes.Structure):
    _fields_ = ([(name, ctypes.c_void_p) for name, _ in _INPUTS]
                + [("weights", ctypes.c_void_p)]
                + [(name, ctypes.c_void_p) for name, _, _ in _SCRATCH]
                + [("out", ctypes.c_void_p)]
                + [(name, ctypes.c_int) for name in _INTS])


def _solve_cuda(spec: SolveSpec, enc, rr0: int, num_to_find: int) -> torch.Tensor:
    from volcano_tpu_torch import _build
    from volcano_tpu_torch.ops.kernels import _check

    dev = enc["task_req"].device
    dt = enc["node_idle"].dtype
    T, R = enc["task_req"].shape
    N = enc["node_idle"].shape[0]
    J = enc["job_task_start"].shape[0]
    Q = enc["queue_deserved"].shape[0]
    S = enc["ns_active0"].shape[0]
    G = enc["sig_mask"].shape[0]
    kinds = {"f": dt, "i": torch.int32, "b": torch.bool}
    for name, kind in _INPUTS:
        t = enc[name]
        if t.device != dev:
            raise ValueError(f"{name}: on {t.device}, expected {dev}")
        _check(t, name, kinds[kind])
    shapes = {"task_initreq": (T, R), "node_used": (N, R), "node_alloc": (N, R),
              "sig_mask": (G, N), "affinity_score": (G, N), "job_alloc0": (J, R),
              "queue_alloc0": (Q, R), "queue_present": (Q, R),
              "ns_alloc0": (S, R), "q_in_ns0": (S, Q)}
    for name, shape in shapes.items():
        if tuple(enc[name].shape) != shape:
            raise ValueError(f"{name}: shape {tuple(enc[name].shape)}, expected {shape}")
    if len(spec.job_order_keys) > 3 or any(
            k not in JOB_KEY_CODES for k in spec.job_order_keys):
        raise ValueError(f"job_order_keys {spec.job_order_keys!r} not supported")
    dims = {"N": N, "R": R, "J": J, "Q": Q, "S": S, "T": T}
    scratch = {}
    for name, kind, key in _SCRATCH:
        shape = tuple(dims[c] for c in key)
        scratch[name] = torch.empty(shape, dtype=kinds[kind], device=dev)
    out = torch.empty(T + 1, dtype=torch.int32, device=dev)
    weights = torch.stack([
        enc["least_req_weight"], enc["balanced_weight"],
        enc["node_affinity_weight"], enc["binpack_weight"]]).to(dt).contiguous()
    codes = [JOB_KEY_CODES[k] for k in spec.job_order_keys] + [-1] * 3
    p = _Params()
    for name, _ in _INPUTS:
        setattr(p, name, enc[name].data_ptr())
    p.weights = weights.data_ptr()
    for name, t in scratch.items():
        setattr(p, name, t.data_ptr())
    p.out = out.data_ptr()
    ints = dict(T=T, N=N, R=R, J=J, Q=Q, S=S, G=G, rr0=int(rr0), num_to_find=int(num_to_find),
                n_job_keys=len(spec.job_order_keys), key0=codes[0],
                key1=codes[1], key2=codes[2],
                use_drf_ns_order=int(spec.use_drf_ns_order),
                use_prop_queue_order=int(spec.use_prop_queue_order),
                use_prop_overused=int(spec.use_prop_overused),
                check_pod_count=int(spec.check_pod_count),
                use_nodeorder=int(spec.use_nodeorder),
                use_binpack=int(spec.use_binpack))
    for name in _INTS:
        setattr(p, name, ints[name])
    lib = _build.library("parity_scan")
    fn = lib.parity_scan_f64 if dt == torch.float64 else lib.parity_scan_f32
    fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev)
    rc = fn(ctypes.byref(p), ctypes.c_void_p(stream.cuda_stream))
    if rc != 0:
        raise RuntimeError(f"parity_scan kernel launch failed: CUDA error {rc}")
    devmod.count_launch("parity_scan")
    # the scratch and the weights must outlive the asynchronous launch
    for t in (weights, *scratch.values()):
        t.record_stream(stream)
    return out


def solve_allocate(spec: SolveSpec, enc: Dict[str, torch.Tensor], rr0: int,
                   num_to_find: int) -> torch.Tensor:
    """K15: run the whole allocate session as the parity scan. Returns
    int32 ``[T + 1]`` (assign, then the final round-robin index). CUDA
    tensors launch csrc/parity_scan.cu (a failure raises); CPU tensors
    run the plain version."""
    if devmod.on_cuda(enc["task_req"], enc["node_idle"]):
        return _solve_cuda(spec, enc, rr0, num_to_find)
    return solve_allocate_plain(spec, enc, rr0, num_to_find)
