"""Node-axis shard helpers and the per-device stage probes (K16).

Port of the one-device half of volcano_tpu/ops/shard.py: the shard
arithmetic (``device_count``, ``per_shard``, ``pad_axis_multiple``), the
cache reset the bench's mesh sweep calls (``clear_cache``), and the
bench's per-device stage probes.

The probes time ONE shard's slice of the sharded session stages at
per-shard width N/d, over a config's real encoded arrays (the rounds
prepare's ``prep["arrays"]``, ops/solver.py): on a mesh the shards run
concurrently, so one shard's wall is the stage's critical path up to the
cross-shard reduce.

- K16a ``probe_refresh`` (volcano_tpu/ops/shard.py:191 ``_probe_refresh``):
  ``_PROBE_REPS`` full score refreshes, each K1 (``kernels.score_block``,
  csrc/score_block.cu) over every class row at width N/d, on the idle
  column scaled by the rep's factor; Σ over reps of ``sc[0, 0]``,
  accumulated on the device in the array's dtype, fetched once by the
  caller. 16 K1 launches a probe. The reference's chunking over class
  rows (``CHUNK``) is not carried over: one K1 launch covers every row.
- K16b ``probe_evict_fold`` (``_probe_evict_fold``, :215): 16 reps of the
  proportion deserved-floor victim walk (the ``evict._prop_verdict``
  twin) over [N/d, V] victim slots; the count of victims that both must
  go and fit, as int32. On the card one launch of the hand-written
  csrc/probe_evict_fold.cu.

The rep factor. The reference scales by ``1.0 + i * 1e-12``, computed in
float64 and cast to the array's dtype before the multiply: in float32 it
is exactly 1 for every rep (16 identical refreshes, all still run), in
float64 it is ``fl64(1 + fl64(i) * 1e-12)``. ``probe_factors`` computes
it on the host in double and rounds it to the dtype.

Left to the mesh (ROADMAP Queue 1 item 7): ``stage_node_arrays`` (the
per-shard device cache, which ``clear_cache`` would empty), the shardings
``node_sharding`` / ``replicated_sharding``, ``mesh_key``, and the
solver's, the evictions' and the replica's use of them. With one card
there is one shard: ``device_count(None) == 1``.
"""

from __future__ import annotations

import ctypes
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from volcano_tpu_torch import device as devmod

_PROBE_REPS = 16

# the K16b kernel's register-resident walk is instantiated for these
# victim widths and resource counts (csrc/probe_evict_fold.cu)
FOLD_WIDTHS = (2, 4, 8, 16, 32)
FOLD_RESOURCES = (1, 2, 3, 4)


def clear_cache() -> None:
    """Drop the per-shard device cache: the port stages no shards yet
    (one device), so there is nothing to drop; kept for the bench's mesh
    sweep, which calls it before each device count."""


def device_count(mesh) -> int:
    """Total devices in the mesh (the node-axis shard count)."""
    if mesh is None:
        return 1
    return int(np.prod(list(mesh.shape.values())))


def per_shard(extent: int, shards: int) -> int:
    """Per-shard slice width of a mesh-padded axis. The input extent must
    already be the PADDED (device-multiple) extent."""
    return max(extent // max(int(shards), 1), 1)


def pad_axis_multiple(a: np.ndarray, axis: int, multiple: int, fill=0):
    """Pad ``axis`` up to the next multiple of ``multiple`` (append-only:
    existing indices are unchanged)."""
    n = a.shape[axis]
    if multiple <= 1 or n % multiple == 0:
        return a
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, ((n + multiple - 1) // multiple) * multiple - n)
    return np.pad(a, widths, constant_values=fill)


def probe_factors(reps: int, dtype: torch.dtype) -> list:
    """The rep factors ``1 + i * 1e-12`` in double, rounded to ``dtype``."""
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    return [float(np.asarray(1.0 + i * 1e-12).astype(np_dt))
            for i in range(reps)]


def _factor_tensor(reps, dtype, device):
    return torch.tensor(probe_factors(reps, dtype), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# K16a: repeated full refresh (K1 x reps)
# ---------------------------------------------------------------------------


def _refresh(spec, enc, score, reps):
    idle0 = enc["node_idle"]
    occ = enc.get("excl_occ0") if spec.use_exclusion else None
    factors = _factor_tensor(reps, idle0.dtype, idle0.device)
    out = torch.empty((enc["cls_req"].shape[0], idle0.shape[0]),
                      dtype=idle0.dtype, device=idle0.device)
    acc = torch.zeros((), dtype=idle0.dtype, device=idle0.device)
    for i in range(reps):
        idle = idle0 * factors[i]
        score(spec, enc, idle, enc["node_used"], enc["node_cnt"], occ, out)
        acc = acc + out[0, 0]
    return acc


def probe_refresh_plain(spec, enc: Dict[str, torch.Tensor],
                        reps: int = _PROBE_REPS) -> torch.Tensor:
    """Plain version of K16a: K1's plain version (``score_block_plain``)
    once per rep, on any device."""
    from volcano_tpu_torch.ops import kernels

    def score(spec, enc, idle, used, cnt, occ, out):
        out.copy_(kernels.score_block_plain(spec, enc, idle, used, cnt, occ))

    return _refresh(spec, enc, score, reps)


def probe_refresh(spec, enc: Dict[str, torch.Tensor],
                  reps: int = _PROBE_REPS) -> torch.Tensor:
    """K16a: Σ_reps ``sc[0, 0]`` of a full refresh over one shard's node
    slice, as a 0-d tensor on the slice's device (unfetched). On the card
    each rep launches K1 (``reps`` launches, counted by K1's wrapper); on
    CPU tensors K1's wrapper runs its plain version."""
    from volcano_tpu_torch.ops import kernels

    return _refresh(spec, enc, kernels.score_block, reps)


# ---------------------------------------------------------------------------
# K16b: repeated proportion victim fold
# ---------------------------------------------------------------------------


def probe_evict_fold_plain(vic_req, vic_queue, vic_samequeue, queue_alloc,
                           queue_deserved, eps, reps: int = _PROBE_REPS,
                           stats: Optional[dict] = None) -> torch.Tensor:
    """Plain version of K16b in torch ops (any device): per rep, the
    victims of each row walked in order; ``do = not all(cur < req)``,
    ``fits = all(des < cur - req or |des - (cur - req)| < eps)``; where
    ``do``, every same-queue slot's current drops by ``req``. Returns the
    count of ``do and fits`` over reps, rows and victims (int32, 0-d).
    With ``stats``, adds the slot updates made (``updates``)."""
    v_width = vic_queue.shape[1]
    q = vic_queue.long()
    des = queue_deserved[q]                                   # [W, V, R]
    factors = _factor_tensor(reps, vic_req.dtype, vic_req.device)
    total = torch.zeros((), dtype=torch.int32, device=vic_req.device)
    updates = 0
    for i in range(reps):
        qcur = queue_alloc[q] * factors[i]                    # [W, V, R]
        for v in range(v_width):
            req = vic_req[:, v]
            cur = qcur[:, v]
            do = ~torch.all(cur < req, dim=-1)
            left = cur - req
            fits = torch.all((des[:, v] < left)
                             | (torch.abs(des[:, v] - left) < eps), dim=-1)
            total = total + (do & fits).sum(dtype=torch.int32)
            upd = do[:, None] & vic_samequeue[:, v, :]        # [W, V]
            qcur = torch.where(upd[..., None], qcur - req[:, None, :], qcur)
            if stats is not None:
                updates += int(upd.sum())
    if stats is not None:
        stats["updates"] = stats.get("updates", 0) + updates
    return total


_FOLD_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 8 + [ctypes.c_void_p]


def _fold_cuda(vic_req, vic_queue, vic_samequeue, queue_alloc,
               queue_deserved, eps, reps):
    from volcano_tpu_torch import _build

    dt = vic_req.dtype
    w, v, r = vic_req.shape
    q = queue_alloc.shape[0]
    if v not in FOLD_WIDTHS or r not in FOLD_RESOURCES:
        raise ValueError(f"probe_evict_fold: V={v}, R={r} not instantiated "
                         f"(V in {FOLD_WIDTHS}, R in {FOLD_RESOURCES})")
    checks = [
        ("vic_req", vic_req, dt, (w, v, r)),
        ("vic_queue", vic_queue, torch.int32, (w, v)),
        ("vic_samequeue", vic_samequeue, torch.bool, (w, v, v)),
        ("queue_alloc", queue_alloc, dt, (q, r)),
        ("queue_deserved", queue_deserved, dt, (q, r)),
        ("eps", eps, dt, (r,)),
    ]
    for name, t, want, shape in checks:
        if t.device != vic_req.device:
            raise ValueError(f"{name}: on {t.device}, expected {vic_req.device}")
        if t.dtype != want:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    factors = _factor_tensor(reps, dt, vic_req.device)
    out = torch.empty((), dtype=torch.int32, device=vic_req.device)
    lib = _build.library("probe_evict_fold")
    fn = lib.probe_evict_fold_f64 if dt == torch.float64 else lib.probe_evict_fold_f32
    fn.argtypes = _FOLD_ARGTYPES
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(vic_req.device)
    rc = fn(w, v, r, reps,
            *(ctypes.c_void_p(t.data_ptr()) for t in (
                vic_req, vic_queue, vic_samequeue, queue_alloc,
                queue_deserved, eps, factors, out)),
            ctypes.c_void_p(stream.cuda_stream))
    if rc != 0:
        raise RuntimeError(f"probe_evict_fold kernel launch failed: CUDA error {rc}")
    devmod.count_launch("probe_evict_fold")
    factors.record_stream(stream)
    return out


def probe_evict_fold(vic_req, vic_queue, vic_samequeue, queue_alloc,
                     queue_deserved, eps, reps: int = _PROBE_REPS) -> torch.Tensor:
    """K16b: the victim-fold count (int32, 0-d, unfetched). On CUDA
    tensors one launch of csrc/probe_evict_fold.cu (raises if it cannot);
    on CPU tensors the plain version."""
    if devmod.on_cuda(vic_req, vic_queue, vic_samequeue, queue_alloc,
                      queue_deserved, eps):
        return _fold_cuda(vic_req, vic_queue, vic_samequeue, queue_alloc,
                          queue_deserved, eps, reps)
    return probe_evict_fold_plain(vic_req, vic_queue, vic_samequeue,
                                  queue_alloc, queue_deserved, eps, reps)


# ---------------------------------------------------------------------------
# the bench's per-device stage probe
# ---------------------------------------------------------------------------


def probe_inputs(arrays: Dict[str, np.ndarray], node_axis: Dict[str, int],
                 shards: int, vic_width: int = 8
                 ) -> Tuple[int, Dict[str, np.ndarray], tuple]:
    """One shard's host inputs, as the reference builds them: every
    node-axis array padded to the shard multiple (fill 0) and cut to
    ``[0, N/d)``, the rest as they are; and the fold's seeded victim
    slice (``default_rng(7)``, the arrays' float dtype). Returns (width,
    enc, (vic_req, vic_queue, vic_samequeue, queue_alloc,
    queue_deserved, eps))."""
    n_total = int(np.asarray(arrays["node_idle"]).shape[0])
    width = per_shard(pad_axis_multiple(
        np.zeros(n_total, np.int8), 0, shards).shape[0], shards)
    enc = {}
    for k, v in sorted(arrays.items()):
        v = np.asarray(v)
        axis = node_axis.get(k)
        if axis is None:
            enc[k] = v
            continue
        v = pad_axis_multiple(v, axis, shards)
        idx = [slice(None)] * v.ndim
        idx[axis] = slice(0, width)
        enc[k] = np.ascontiguousarray(v[tuple(idx)])
    rng = np.random.default_rng(7)
    fdt = np.asarray(arrays["node_idle"]).dtype
    vic_req = rng.uniform(100.0, 4000.0, (width, vic_width, 2)).astype(fdt)
    vic_queue = rng.integers(0, 4, (width, vic_width)).astype(np.int32)
    samequeue = vic_queue[:, :, None] == vic_queue[:, None, :]
    queue_alloc = rng.uniform(1e4, 1e6, (4, 2)).astype(fdt)
    queue_deserved = rng.uniform(1e4, 1e6, (4, 2)).astype(fdt)
    eps = np.asarray([0.01, 0.01], fdt)
    return width, enc, (vic_req, vic_queue, samequeue, queue_alloc,
                        queue_deserved, eps)


def stage_probe(arrays, node_axis, shards, vic_width=8, device=None,
                dtype=None):
    """``probe_inputs`` staged on ``device`` (floats in ``dtype``, the
    arrays' own float dtype when None): (width, enc tensors, fold
    tensors)."""
    from volcano_tpu_torch.ops.solver import from_numpy_encoded

    dev = devmod.resolve_device(device)
    if dtype is None:
        dtype = str(np.asarray(arrays["node_idle"]).dtype)
    dt = devmod.resolve_dtype(dtype, dev)
    width, enc_np, fold_np = probe_inputs(arrays, node_axis, shards, vic_width)
    enc = from_numpy_encoded(enc_np, device=dev, dtype=dt)
    np_dt = np.float64 if dt == torch.float64 else np.float32
    fold = tuple(
        torch.from_numpy(np.ascontiguousarray(
            a.astype(np_dt) if a.dtype.kind == "f" else a)).to(dev)
        for a in fold_np)
    return width, enc, fold


def probe_per_device_stage_ms(spec, arrays: Dict[str, np.ndarray],
                              node_axis: Dict[str, int], shards: int,
                              vic_width: int = 8, iters: int = 3,
                              device=None, dtype=None) -> float:
    """Measured wall of ONE shard's slice of the sharded session stages at
    per-shard width N/shards: K16a over the real encoded class/node
    arrays plus K16b at the same node slice, then one wait for both.
    The inputs are staged once, outside the timed calls (the reference
    hands the jitted probes host arrays on every call). Returns the median
    wall in ms across ``iters`` timed repetitions; the first call, which
    builds the kernels, is excluded."""
    _, enc, fold = stage_probe(arrays, node_axis, shards, vic_width,
                               device, dtype)
    on_card = enc["node_idle"].device.type == "cuda"

    def once():
        t0 = time.perf_counter()
        r = probe_refresh(spec, enc)
        f = probe_evict_fold(*fold)
        if on_card:
            torch.cuda.synchronize(r.device)
        r.item(), f.item()
        return (time.perf_counter() - t0) * 1e3

    once()
    walls = sorted(once() for _ in range(max(iters, 1)))
    return round(walls[len(walls) // 2], 3)
