"""Solve configuration, shared arithmetic, and the K1 score kernel.

Port of the parts of volcano_tpu/ops/kernels.py that the rounds solver
uses: ``SolveSpec``, the ``MIN_*`` constants, ``_share``, ``_le_eps`` and
``fused_scores`` (the plain PyTorch version of K1). The parity scan
(``solve_allocate``) belongs to a later slice of the port.

K1 ``score_block`` is the masked fused feasibility + score matrix over
class rows and node columns (volcano_tpu/ops/rounds.py _score_block).
On a CUDA tensor it launches the hand-written kernel in
csrc/score_block.cu; on a CPU tensor it runs the plain version below.

Rounding. Score ties decide placements, so the plain version, the kernel
and the JAX reference must agree bit for bit. Every expression keeps the
reference's order, R-sums run left to right, and where XLA's CPU backend
contracts a multiply-add into one fused rounding (balanced's
``10 - |d| * 10``, and the adds of the weighted affinity and binpack
terms; the binpack term as ``bp * (10 * w)``, the association XLA's
simplifier gives it) both versions use an exact fused multiply-add
(``_fma``). The reference is held to this as it runs, jitted; run eagerly
op by op, JAX rounds these terms twice.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from volcano_tpu_torch import device as devmod
from volcano_tpu_torch.api.resource import (  # noqa: F401 (re-exported)
    MIN_MEMORY,
    MIN_MILLI_CPU,
    MIN_MILLI_SCALAR,
)
from volcano_tpu_torch.scheduler.plugins.nodeorder import MAX_PRIORITY

CHUNK = 128


class SolveSpec(NamedTuple):
    """Static solve configuration (volcano_tpu/ops/kernels.py SolveSpec)."""

    # enabled job-order plugins IN TIER ORDER (the dispatch is first-nonzero
    # across tiers, session_plugins.go:287-303, so ordering is semantic)
    job_order_keys: tuple
    use_drf_ns_order: bool
    use_prop_queue_order: bool
    use_prop_overused: bool
    check_pod_count: bool
    use_binpack: bool
    use_nodeorder: bool
    # device-placed required-anti-affinity exclusion groups
    use_exclusion: bool = False
    # diminishing-returns exit: a round placing fewer than this many tasks
    # (but more than zero) ends the solve and hands the stragglers to the
    # tail pass and the serial residue pass; 0 disables
    round_min_progress: int = 0
    # candidate-window width of the per-class top-k nomination; 0 =
    # full-width sweeps
    window_k: int = 0
    # dirty-column rescoring gather width; 0 = always full refresh
    dirty_k: int = 0
    # extra batched rounds over the diminishing-returns stragglers before
    # the sequential tail pass
    straggler_rounds: int = 0


def _le_eps(l, r, eps, is_scalar):
    """Vectorized Resource.less_equal over rows: l, r are [..., R]."""
    le = l < r + eps
    skip = is_scalar & (l <= MIN_MILLI_SCALAR)
    return torch.all(le | skip, dim=-1)


def _share(alloc, total, present):
    """max_r alloc_r/total_r over present dims, with share(l, 0) = 1 when
    l != 0 (api/share_helpers.py; drf.go:299-311 / proportion.go:44-52)."""
    safe = torch.where(total > 0, total, torch.ones_like(total))
    s = torch.where(total > 0, alloc / safe,
                    torch.where(alloc == 0, torch.zeros_like(alloc),
                                torch.ones_like(alloc)))
    s = torch.where(present, s, torch.full_like(s, float("-inf")))
    # max with initial 0.0 (jnp.max(..., initial=0.0))
    return torch.clamp(torch.amax(s, dim=-1), min=0.0)


_SPLIT = {torch.float64: 134217729.0, torch.float32: 4097.0}  # 2^ceil(p/2)+1


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    """Dekker's error-free product without a hardware FMA: a*b = p + e."""
    c = _SPLIT[a.dtype]

    def split(x):
        t = x * c
        hi = t - (t - x)
        return hi, x - hi

    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _fma(a, b, c):
    """Correctly rounded a*b + c for finite operands of moderate size
    (Boldo & Melquiond's emulation: error-free product and sum, the low
    parts added in round-to-odd, one final rounding). This is the single
    rounding XLA's CPU backend gives the reference where it contracts a
    multiply-add; torch has no fused multiply-add op."""
    a, b, c = torch.broadcast_tensors(a, b, c)
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    # v = RoundToOdd(tl + ul)
    v, err = _two_sum(tl, ul)
    bits = v.view(torch.int64 if v.dtype == torch.float64 else torch.int32)
    even = (bits & 1) == 0
    fix = (err != 0) & even & torch.isfinite(v)
    toward = torch.where(err > 0, torch.full_like(v, float("inf")),
                         torch.full_like(v, float("-inf")))
    v = torch.where(fix, torch.nextafter(v, toward), v)
    return th + v


def _rsum(x):
    """Sum over the last (resource) axis, left to right, as XLA reduces a
    short axis: ((0 + x0) + x1) + ..."""
    acc = torch.zeros_like(x[..., 0])
    for r in range(x.shape[-1]):
        acc = acc + x[..., r]
    return acc


def fused_scores(spec: SolveSpec, enc, used, req, nz_cpu, nz_mem, sig,
                 alloc=None, aff=None):
    """Fused binpack + nodeorder node scores (binpack.go:201-261,
    nodeorder.go:161-200), broadcast over any leading task dims — the plain
    PyTorch version of K1's score.

    used/alloc: [N, R]; req: [..., R]; nz_cpu/nz_mem: [...]; sig: [...] int.
    Returns [..., N] float scores. ``alloc``/``aff`` override the enc-wide
    node_alloc / affinity_score with column-gathered slices; every op is
    column-separable, so a gathered recompute is bit-identical to
    gathering a full recompute."""
    if alloc is None:
        alloc = enc["node_alloc"]
    if aff is None:
        aff = enc["affinity_score"]
    lead = req.shape[:-1]
    dt = used.dtype
    score = torch.zeros(lead + (used.shape[0],), dtype=dt, device=used.device)
    one = torch.ones((), dtype=dt, device=used.device)
    zero = torch.zeros((), dtype=dt, device=used.device)

    if spec.use_nodeorder:
        cap_cpu, cap_mem = alloc[:, 0], alloc[:, 1]
        want_cpu = used[:, 0] + nz_cpu[..., None]
        want_mem = used[:, 1] + nz_mem[..., None]

        def dim(cap, want):
            ok = (cap > 0) & (want <= cap)
            return torch.where(
                ok, (cap - want) * MAX_PRIORITY / torch.where(cap > 0, cap, one),
                zero)

        least = torch.floor((dim(cap_cpu, want_cpu) + dim(cap_mem, want_mem)) / 2.0)
        cpu_frac = want_cpu / torch.where(cap_cpu > 0, cap_cpu, one)
        mem_frac = want_mem / torch.where(cap_mem > 0, cap_mem, one)
        bal_ok = (cap_cpu > 0) & (cap_mem > 0) & (cpu_frac < 1.0) & (mem_frac < 1.0)
        ten = torch.full((), float(MAX_PRIORITY), dtype=dt, device=used.device)
        balanced = torch.where(
            bal_ok,
            torch.floor(_fma(-torch.abs(cpu_frac - mem_frac), ten, ten)),
            zero)
        score = score + least * enc["least_req_weight"] + balanced * enc["balanced_weight"]
        score = _fma(aff[sig], enc["node_affinity_weight"], score)

    if spec.use_binpack:
        w_eff = torch.where(req > 0, enc["binpack_w"], zero)        # [..., R]
        w_sum = _rsum(w_eff)                                         # [...]
        want = req[..., None, :] + used                              # [..., N, R]
        ok = (alloc > 0) & (want <= alloc)
        part = torch.where(
            ok, want * w_eff[..., None, :] / torch.where(alloc > 0, alloc, one),
            zero)
        raw = _rsum(part)                                            # [..., N]
        bp = torch.where((w_sum > 0)[..., None],
                         raw / torch.where(w_sum > 0, w_sum, one)[..., None],
                         zero)
        # XLA reassociates bp * 10 * w into bp * (10 * w) and fuses the add
        score = _fma(bp, MAX_PRIORITY * enc["binpack_weight"], score)

    return score


def _score_block_plain(spec: SolveSpec, enc, req, initreq, sig, nz_cpu,
                       nz_mem, has_pod, exl, idle_c, used_c, cnt_c, occ_c,
                       sigmask_c, nmax_c, alloc_c, aff_c):
    """Plain version of K1: the masked fused feasibility + score block for
    a batch of class ROWS over a batch of node COLUMNS (the signature of
    volcano_tpu/ops/rounds.py _score_block): -inf where the class cannot
    place on the node, the fused score elsewhere."""
    eps = enc["eps"]
    is_scalar = enc["is_scalar"]
    le = initreq[:, None, :] < idle_c[None, :, :] + eps[None, None, :]
    skip = is_scalar[None, None, :] & (initreq[:, None, :] <= MIN_MILLI_SCALAR)
    mask = torch.all(le | skip, dim=-1) & sigmask_c[sig]          # [rows, M]
    if spec.check_pod_count:
        mask = mask & ((cnt_c[None, :] < nmax_c[None, :]) | ~has_pod[:, None])
    if spec.use_exclusion:
        occ = occ_c[torch.clamp(exl, min=0)]                       # [rows, M]
        mask = mask & ~(occ & (exl >= 0)[:, None])
    score = fused_scores(spec, enc, used_c, req, nz_cpu, nz_mem, sig,
                         alloc=alloc_c, aff=aff_c)
    return torch.where(mask, score, torch.full_like(score, float("-inf")))


def _score_rows_plain(spec, enc, idle, used, cnt, occ, cols):
    """All class rows over the columns ``cols`` (every column when None),
    chunked over rows to bound the [rows, M, R] temporaries."""
    if cols is None:
        idle_c, used_c, cnt_c = idle, used, cnt
        occ_c = occ
        sigmask_c, nmax_c = enc["sig_mask"], enc["node_max_tasks"]
        alloc_c, aff_c = enc["node_alloc"], enc["affinity_score"]
    else:
        idle_c, used_c, cnt_c = idle[cols], used[cols], cnt[cols]
        occ_c = occ[:, cols] if spec.use_exclusion else None
        sigmask_c = enc["sig_mask"][:, cols]
        nmax_c = enc["node_max_tasks"][cols]
        alloc_c, aff_c = enc["node_alloc"][cols], enc["affinity_score"][:, cols]
    k_total = enc["cls_req"].shape[0]
    blocks = []
    for lo in range(0, k_total, CHUNK):
        sl = slice(lo, min(lo + CHUNK, k_total))
        blocks.append(_score_block_plain(
            spec, enc, enc["cls_req"][sl], enc["cls_initreq"][sl],
            enc["cls_sig"][sl].long(), enc["cls_nz_cpu"][sl],
            enc["cls_nz_mem"][sl], enc["cls_has_pod"][sl],
            enc["cls_excl"][sl].long() if spec.use_exclusion else None,
            idle_c, used_c, cnt_c, occ_c, sigmask_c, nmax_c, alloc_c, aff_c))
    return torch.cat(blocks, dim=0)


def score_block_plain(spec: SolveSpec, enc, idle, used, cnt, occ,
                      cols: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The [K, M] block K1 computes, by the plain version (any device)."""
    return _score_rows_plain(spec, enc, idle, used, cnt, occ,
                             None if cols is None else cols.long())


def _check(t, name, dtype, shape=None):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


_SCORE_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 20 \
    + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2


def _score_block_cuda(spec, enc, idle, used, cnt, occ, out, cols):
    from volcano_tpu_torch import _build

    dt = idle.dtype
    k_total, r_total = enc["cls_req"].shape
    n_total = idle.shape[0]
    m = n_total if cols is None else cols.shape[0]
    b = torch.bool
    i32 = torch.int32
    checks = [
        ("cls_req", enc["cls_req"], dt, (k_total, r_total)),
        ("cls_initreq", enc["cls_initreq"], dt, (k_total, r_total)),
        ("cls_sig", enc["cls_sig"], i32, (k_total,)),
        ("cls_nz_cpu", enc["cls_nz_cpu"], dt, (k_total,)),
        ("cls_nz_mem", enc["cls_nz_mem"], dt, (k_total,)),
        ("cls_has_pod", enc["cls_has_pod"], b, (k_total,)),
        ("idle", idle, dt, (n_total, r_total)),
        ("used", used, dt, (n_total, r_total)),
        ("node_alloc", enc["node_alloc"], dt, (n_total, r_total)),
        ("cnt", cnt, i32, (n_total,)),
        ("node_max_tasks", enc["node_max_tasks"], i32, (n_total,)),
        ("sig_mask", enc["sig_mask"], b, None),
        ("affinity_score", enc["affinity_score"], dt, None),
        ("eps", enc["eps"], dt, (r_total,)),
        ("is_scalar", enc["is_scalar"], b, (r_total,)),
        ("binpack_w", enc["binpack_w"], dt, (r_total,)),
        ("out", out, dt, (k_total, n_total)),
    ]
    if spec.use_exclusion:
        checks += [("cls_excl", enc["cls_excl"], i32, (k_total,)),
                   ("occ", occ, b, None)]
    if cols is not None:
        checks.append(("cols", cols, i32, (m,)))
    for name, t, want, shape in checks:
        if t.device != idle.device:
            raise ValueError(f"{name}: on {t.device}, expected {idle.device}")
        _check(t, name, want, shape)
    if enc["sig_mask"].shape[1] != n_total or enc["affinity_score"].shape[1] != n_total:
        raise ValueError("sig_mask/affinity_score: node axis mismatch")
    weights = torch.stack([
        enc["least_req_weight"], enc["balanced_weight"],
        enc["node_affinity_weight"], enc["binpack_weight"]]).to(dt).contiguous()
    lib = _build.library("score_block")
    fn = lib.score_block_f64 if dt == torch.float64 else lib.score_block_f32
    fn.argtypes = _SCORE_ARGTYPES
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(idle.device).cuda_stream
    rc = fn(k_total, m, n_total, r_total,
            _ptr(enc["cls_req"]), _ptr(enc["cls_initreq"]), _ptr(enc["cls_sig"]),
            _ptr(enc["cls_nz_cpu"]), _ptr(enc["cls_nz_mem"]),
            _ptr(enc["cls_has_pod"]),
            _ptr(enc["cls_excl"] if spec.use_exclusion else None),
            _ptr(idle), _ptr(used), _ptr(enc["node_alloc"]), _ptr(cnt),
            _ptr(enc["node_max_tasks"]), _ptr(enc["sig_mask"]),
            _ptr(enc["affinity_score"]),
            _ptr(occ if spec.use_exclusion else None),
            _ptr(enc["eps"]), _ptr(enc["is_scalar"]), _ptr(enc["binpack_w"]),
            _ptr(weights), _ptr(cols),
            int(spec.check_pod_count), int(spec.use_exclusion),
            int(spec.use_nodeorder), int(spec.use_binpack),
            _ptr(out), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"score_block kernel launch failed: CUDA error {rc}")
    devmod.count_launch("score_block")
    # the weights tensor must outlive the asynchronous launch: record it on
    # the stream so the caching allocator does not hand it out early
    weights.record_stream(torch.cuda.current_stream(idle.device))


def score_block(spec: SolveSpec, enc, idle, used, cnt, occ, out,
                cols: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1: write the masked fused scores of every class row over the node
    columns ``cols`` (every column when None) into ``out[:, cols]``.

    On a CUDA tensor this launches csrc/score_block.cu (and raises if it
    cannot); on a CPU tensor it runs the plain version. ``cols`` is int32;
    padding slots that repeat a column rewrite identical values."""
    if devmod.on_cuda(idle, used, out):
        _score_block_cuda(spec, enc, idle, used, cnt, occ, out, cols)
        return out
    block = score_block_plain(spec, enc, idle, used, cnt, occ, cols)
    if cols is None:
        out.copy_(block)
    else:
        out[:, cols.long()] = block
    return out
