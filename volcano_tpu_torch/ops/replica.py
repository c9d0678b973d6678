"""Device-resident cluster state: the persistent cross-session replica.

Port of volcano_tpu/ops/replica.py. Every session re-staged the
state-dependent accounting arrays — node idle/used/cnt, node capacity, job
ready/alloc, queue and namespace alloc — from host to device, even when
the committed deltas since the last session touched a handful of rows.
The SnapshotKeeper already knows exactly which rows those are (its dirty
sets receive every effector/watch mark). This module keeps the device
copies as a STANDING REPLICA, owned per cache, updated in place by narrow
bucketed scatters instead of wholesale re-staging.

The commit fork: effectors and watch ingestion keep mutating host state
and marking the keeper exactly as before (the host remains the source of
truth and the serial oracle). The replica subscribes to those same marks
through a keeper DirtyShadow (snapkeeper.add_shadow — the express lane's
subscription seam), so every committed mutation is forked host+device:
host now, via the normal effector; device at the next serve, as a row
scatter. Scatter rows are derived by exact comparison against the
replica's held host mirror — a subset of the keeper-marked rows (marks
over-approximate; the mirror diff is the byte-for-byte truth), which is
what keeps ``replica_scatter_rows`` proportional to rows that actually
changed. Witness mode (VOLCANO_TPU_WITNESS=1) closes the other direction:
every scattered row must be EXPLAINED by a keeper mark or an accounting-
generation movement, or the serve raises — an unexplained scatter is an
"unmarked mutation" caught at runtime.

Families and the kernel: one scatter launch per axis family ("node",
"job", "queue", "ns"), row indices padded to the solver's bucket ladder
(solver._bucket) by repeating the first dirty row — duplicate writes of
identical values. On a CUDA tensor the scatter is K8, the hand-written
kernel in csrc/scatter_rows.cu (one launch over the whole family, which
reads the rows from pinned host memory, through a plan a family and bucket
width, ``ScatterPlans``, dropped with the standing buffers); on a CPU
tensor its plain version, ``index_copy_`` per buffer.

In place instead of donation. JAX updates functionally and marks a
consumed (donated) buffer deleted; the port writes the standing tensors
in place and has no deletion. The invariant it keeps instead: no consumer
of a served tensor writes it in place (the rounds solve and the evict
staging clone what they mutate). The "donated" rung checks that
invariant: cheaply on every serve, by each tensor's version counter
(which every in-place torch op bumps) against the one the replica's own
last write left; and under VOLCANO_TPU_WITNESS=1 by content, before the
delta: every row the host did not change since the last serve must still
equal its mirror on the device.

Fallback taxonomy (``replica_rebuild{reason}``): any envelope miss
restages wholesale and counts the reason — "cold" (first serve),
"generation" (keeper wholesale invalidation), "shape"/"dtype" (padded
extent or cast changed), "device" (the serving device or dtype changed;
the reference's "mesh" rung), "axis" (node membership/order), "fence"
(lease fence epoch moved — a takeover must not trust a replica built
under the old term), "dense:<family>" (dirty fraction past
PATCH_FRACTION — a wholesale re-put is cheaper than the scatter),
"donated" (a consumer wrote a standing tensor in place),
"error:<kind>". VOLCANO_TPU_REPLICA=0 disables the replica entirely; the
per-session staging path it replaces is byte-for-byte identical (the
staged VALUES are equal by the mirror-diff construction), so replica-off
is the standing oracle the parity fuzz pins.

Whole-encode reuse: the replica also memoizes the previous session's full
prepare bundle (EncodedSnapshot + spec + staged tensors) keyed on the
cache's pipeline fingerprint plus the encoder's session-external inputs
(round-robin cursor, tiers identity, serving device and dtype, mode). A
steady-state session whose fingerprint is unchanged re-encodes NOTHING:
prepare degenerates to the fingerprint probe, ``h2d_puts == 0``. Any
component moving — a placement, a watch delta, an express commit, a
policy update, a scatter — misses the token and takes the full encode.

Trimmed from the reference: the mesh path (``_node_shards``,
``_scatter_node_shards`` and the sharded branches of ``_rebuild`` and
``_dense_reput``); the port runs on one device. Also trimmed: carry
adoption (``adopt``, ``_strip_adopted``, ``ADOPTABLE``,
``adopt_enabled`` and its VOLCANO_TPU_REPLICA_ADOPT flag). The
reference's adopted carry holds the requests preempt pipelined onto
nodes, which the host drops at session close without a mark, and its
skip leaves node_idle of the rows the chain placed on at the pre-chain
value, so its next session can place on capacity that is gone. Here a
fused chain hands nothing over, and the next serve scatters every
changed row, so replica-on stays equal to replica-off.
"""

from __future__ import annotations

import ctypes
import logging
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from volcano_tpu_torch import device as devmod

logger = logging.getLogger(__name__)

# state-dependent arrays the replica serves, by axis family: exactly the
# solver's "dyn" pack group plus the node-axis capacity arrays. Families
# share a row axis (axis 0) and scatter through one launch each.
FAMILIES: Dict[str, tuple] = {
    "node": ("node_idle", "node_used", "node_alloc", "node_cnt",
             "node_max_tasks"),
    "job": ("job_ready_base", "job_alloc0", "job_active0"),
    "queue": ("queue_deserved", "queue_alloc0"),
    "ns": ("ns_alloc0", "ns_active0"),
}

SERVED = frozenset(n for names in FAMILIES.values() for n in names)

# dirty-row budget, shared rationale with express/encode.py: past this
# fraction of the axis a wholesale re-put beats the scatter
PATCH_FRACTION = 4


def enabled() -> bool:
    return os.environ.get("VOLCANO_TPU_REPLICA", "1") != "0"


def get(cache, create: bool = True) -> Optional["DeviceReplica"]:
    """The cache's standing replica (one per SchedulerCache), created on
    first use. None when disabled or the cache has no snapshot keeper."""
    if not enabled():
        return None
    rep = getattr(cache, "_device_replica", None)
    if rep is None and create:
        keeper = getattr(cache, "snap_keeper", None)
        if keeper is None:
            return None
        rep = DeviceReplica(cache)
        cache._device_replica = rep
    return rep


def detach(cache) -> None:
    """Drop the cache's replica and its keeper shadow (tests/teardown)."""
    rep = getattr(cache, "_device_replica", None)
    if rep is not None:
        rep.detach()
        cache._device_replica = None


# -- K8: the bucketed row scatter --------------------------------------------

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64,
             torch.int32: np.int32, torch.int64: np.int64, torch.bool: np.bool_}


def _host_rows(v, like: torch.Tensor) -> np.ndarray:
    """Source rows as a contiguous host array of ``like``'s dtype."""
    if isinstance(v, torch.Tensor):
        v = v.cpu().numpy()
    return np.ascontiguousarray(
        np.asarray(v).astype(_NP_DTYPE[like.dtype], copy=False))


def scatter_rows_plain(dev: Dict[str, torch.Tensor], idx,
                       rows: Dict[str, object]) -> Dict[str, torch.Tensor]:
    """The plain version of K8: ``index_copy_`` per buffer. Duplicate
    padded indices carry identical rows, so their order does not matter."""
    idx_t = torch.as_tensor(np.asarray(idx, np.int64))
    for k, buf in dev.items():
        src = torch.from_numpy(_host_rows(rows[k], buf)).to(buf.device)
        buf.index_copy_(0, idx_t.to(buf.device), src)
    return dev


def _lib():
    from volcano_tpu_torch import _build

    lib = _build.library("scatter_rows")
    if lib.scatter_plan_run.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.scatter_plan_new.argtypes = [i, vp, vp, vp, i, ctypes.c_longlong]
        lib.scatter_plan_new.restype = vp
        lib.scatter_plan_host.argtypes = [vp, i]
        lib.scatter_plan_host.restype = vp
        lib.scatter_plan_free.argtypes = [vp]
        lib.scatter_plan_free.restype = i
        for fn in (lib.scatter_plan_run, lib.scatter_plan_launch):
            fn.argtypes = [vp, i, vp]
            fn.restype = i
    return lib


def _raw_stream(index: int) -> int:
    """The current CUDA stream of device ``index`` as an integer."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


class ScatterPlan:
    """K8 planned for one family of standing buffers at one padded bucket
    width ``m`` (csrc/scatter_rows.cu): the C plan, which holds the
    buffers' pointers, row widths, copy words and grid and two staging
    slots, each a block of pinned host memory mapped for the card of the
    bucket's size (the int32 index, then each buffer's rows, every section
    16-byte aligned); and numpy views of the blocks. ``run`` writes the
    rows into the current slot's views and makes one C call (the launch,
    which reads them over the bus, the slot's event, the wait for the
    other slot's last launch)."""

    def __init__(self, dev: Dict[str, torch.Tensor], m: int):
        lib = _lib()
        names = tuple(dev)
        if not names or m <= 0:
            raise ValueError("scatter_rows: no buffers or no rows")
        if len(names) > lib.scatter_rows_max_bufs():
            raise ValueError(f"scatter_rows: {len(names)} buffers in one family")
        ref = dev[names[0]]
        offs, widths, shapes = [], [], []
        off = (m * 4 + 15) & ~15
        for k in names:
            buf = dev[k]
            if buf.device != ref.device:
                raise ValueError(f"{k}: on {buf.device}, expected {ref.device}")
            if not buf.is_contiguous() or buf.dim() < 1 or buf.dtype not in _NP_DTYPE:
                raise ValueError(f"{k}: not a contiguous row-major buffer")
            width = buf[0].numel() * buf.element_size()
            if width <= 0:
                raise ValueError(f"{k}: empty rows")
            offs.append(off)
            widths.append(width)
            shapes.append((m,) + tuple(buf.shape[1:]))
            off += (m * width + 15) & ~15
        self.names, self.m, self.bytes = names, m, off
        # what the plan was made for, checked on every call (matches)
        self._bufs = tuple((k, dev[k].data_ptr(), dev[k].dtype, dev[k].shape)
                           for k in names)
        self.index = ref.device.index
        nb = len(names)
        self._lib = lib
        with torch.cuda.device(self.index):
            self.handle = lib.scatter_plan_new(
                nb, (ctypes.c_void_p * nb)(*[dev[k].data_ptr() for k in names]),
                (ctypes.c_int * nb)(*widths), (ctypes.c_longlong * nb)(*offs), m, off)
        if not self.handle:
            raise RuntimeError("scatter_rows: the plan was refused (sizes, blocks or events)")
        # a slot: the index's view, then (name, view) a buffer
        self.views = []
        for slot in range(2):
            hn = np.ctypeslib.as_array(
                (ctypes.c_uint8 * off).from_address(lib.scatter_plan_host(self.handle, slot)))
            self.views.append((hn[:m * 4].view(np.int32), tuple(
                (k, hn[o:o + m * w].view(_NP_DTYPE[dev[k].dtype]).reshape(shape))
                for k, o, w, shape in zip(names, offs, widths, shapes))))
        self.slot = 0

    def matches(self, dev: Dict[str, torch.Tensor]) -> bool:
        """``dev`` holds the buffers the plan was made for: the same names,
        pointers, dtypes and shapes."""
        if len(dev) != len(self._bufs):
            return False
        for k, ptr, dtype, shape in self._bufs:
            t = dev.get(k)
            if t is None or t.data_ptr() != ptr or t.dtype != dtype or t.shape != shape:
                return False
        return True

    def write(self, idx, rows: Dict[str, object]) -> None:
        """The index and each buffer's rows into the current slot's pinned
        block (cast to the buffer's dtype as ``scatter_rows_plain`` casts)."""
        iv, views = self.views[self.slot]
        idx = np.asarray(idx)
        if idx.shape != iv.shape:
            raise ValueError(f"scatter_rows: index {idx.shape} for a plan of {iv.shape}")
        np.copyto(iv, idx, casting="unsafe")
        for k, view in views:
            v = rows[k]
            if isinstance(v, torch.Tensor):
                v = v.cpu().numpy()
            v = np.asarray(v)
            if v.shape != view.shape:
                raise ValueError(f"{k}: rows {v.shape} for buffer rows {view.shape}")
            np.copyto(view, v, casting="unsafe")

    def run(self, idx, rows: Dict[str, object]) -> None:
        """One scatter: the rows staged, then one C call."""
        self.write(idx, rows)
        rc = self._lib.scatter_plan_run(self.handle, self.slot, _raw_stream(self.index))
        if rc != 0:
            raise RuntimeError(f"scatter_rows kernel launch failed: CUDA error {rc}")
        self.slot ^= 1
        devmod.count_launch("scatter_rows")

    def launch(self, slot: int) -> None:
        """Slot ``slot``'s launch alone, with no event and no wait: what a
        CUDA graph captures to time the device's part."""
        rc = self._lib.scatter_plan_launch(self.handle, slot, _raw_stream(self.index))
        if rc != 0:
            raise RuntimeError(f"scatter_rows kernel launch failed: CUDA error {rc}")
        devmod.count_launch("scatter_rows")

    def close(self) -> None:
        """Free the C plan and its blocks once its launches are done (its
        views are dropped first)."""
        if self.handle:
            handle, self.handle = self.handle, None
            self.views = []
            rc = self._lib.scatter_plan_free(handle)
            if rc != 0:
                raise RuntimeError(f"scatter_rows: a launch failed: CUDA error {rc}")

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter shutdown: the library may be gone
            pass


class ScatterPlans:
    """The K8 plans of one owner of standing buffers (the replica, the
    express lane), by the family's first buffer name (a name belongs to
    one family of an owner), then the padded bucket width. The owner drops
    them when it rebuilds its buffers; a plan whose buffers' names,
    pointers, dtypes or shapes no longer match is remade in any case."""

    def __init__(self):
        self._plans: Dict[str, Dict[int, ScatterPlan]] = {}

    def __len__(self) -> int:
        return sum(len(by_m) for by_m in self._plans.values())

    def get(self, dev: Dict[str, torch.Tensor], m: int) -> ScatterPlan:
        for first in dev:
            break
        else:
            raise ValueError("scatter_rows: no buffers")
        by_m = self._plans.get(first)
        if by_m is None:
            by_m = self._plans[first] = {}
        plan = by_m.get(m)
        if plan is None or not plan.matches(dev):
            if plan is not None:
                plan.close()
            plan = by_m[m] = ScatterPlan(dev, m)
        return plan

    def clear(self) -> None:
        plans, self._plans = self._plans, {}
        for by_m in plans.values():
            for plan in by_m.values():
                plan.close()


def scatter_rows(dev: Dict[str, torch.Tensor], idx,
                 rows: Dict[str, object],
                 plans: Optional[ScatterPlans] = None) -> Dict[str, torch.Tensor]:
    """K8, the ONE bucketed row scatter shared by every axis family (and
    by the express lane's column patch — express/encode.py): writes
    ``rows[k]`` into ``dev[k]`` at the row indices ``idx``, in place, and
    returns the same dict (callers read as in the reference, whose update
    is functional). ``idx`` must already be padded to a bucket width
    (bucket_pad_rows). On CUDA tensors this runs csrc/scatter_rows.cu
    through the plan for (family, width) in ``plans``, the buffers'
    owner's (raising if it cannot); on CPU tensors it runs the plain
    version."""
    if devmod.on_cuda(*dev.values()):
        if plans is None:
            raise ValueError("scatter_rows on the card takes the buffers' owner's ScatterPlans")
        plans.get(dev, len(idx)).run(idx, rows)
        return dev
    return scatter_rows_plain(dev, idx, rows)


def bucket_pad_rows(rows: List[int]) -> np.ndarray:
    """Row indices padded to the solver bucket ladder by repeating the
    first dirty row (duplicate writes of identical values are benign)."""
    from volcano_tpu_torch.ops.solver import _bucket

    db = _bucket(max(len(rows), 1))
    return np.asarray([rows[0]] * (db - len(rows)) + list(rows), np.int32)


def _put(arr: np.ndarray, device) -> torch.Tensor:
    """A standing tensor of its own (never a view of the host array: the
    scatter writes it in place)."""
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device, copy=True)


def _witness_on() -> bool:
    from volcano_tpu_torch.analysis import witness

    return witness.enabled()


class DeviceReplica:
    """Standing device replica of the state-dependent solve arrays for
    one SchedulerCache, plus the whole-encode reuse memo. All methods run
    under the session (single-threaded) like the solver that calls them."""

    def __init__(self, cache):
        self.cache = cache
        # the effector fork: every keeper mark (bind/evict/status/watch)
        # lands in this shadow
        self.shadow = cache.snap_keeper.add_shadow()
        self.mirror: Dict[str, np.ndarray] = {}   # host twin of self.dev
        self.dev: Dict[str, torch.Tensor] = {}    # name -> standing tensor
        # each standing tensor's version counter after the replica's own
        # last write (the "donated" rung)
        self._versions: Dict[str, int] = {}
        self._node_names: List[str] = []
        self._place = None                        # (device, dtype) served
        self._fence_epoch = None
        self._generation = None
        # witness-mode explanation baseline: node accounting gens and job
        # status versions as of the last serve
        self._node_gens: Dict[str, int] = {}
        self._job_vers: Dict[str, int] = {}
        self._job_uids: List[str] = []
        # invalidation channel for the replica's consumers (sealed in
        # cache.pipeline_fingerprint): bumps whenever device content
        # moves (scatter, rebuild)
        self.replica_epoch = 0
        # whole-encode reuse memo (serve_prepare / store_prepare)
        self._prep_token = None
        self._prep = None
        # K8's plans of the standing buffers (dropped with them)
        self._plans = ScatterPlans()
        self.stats = {
            "serves": 0, "scatters": 0, "scatter_rows": 0,
            "scatter_ms": 0.0, "rebuilds": {}, "encode_reuses": 0,
            "witness_violations": 0,
        }

    # -- lifecycle ---------------------------------------------------------

    def detach(self) -> None:
        self.cache.snap_keeper.drop_shadow(self.shadow)
        self.invalidate()

    def invalidate(self) -> None:
        """Drop all device state; the next serve rebuilds (counted)."""
        self._plans.clear()
        self.mirror.clear()
        self.dev.clear()
        self._versions.clear()
        self._prep_token = None
        self._prep = None
        self.replica_epoch += 1

    # -- whole-encode reuse ------------------------------------------------

    def encode_token(self, ssn, place, mode: str) -> tuple:
        """Everything the encode reads, as a delta token: the cache's
        pipeline fingerprint (keeper dirty epoch + generation + fence +
        acct/status sums) plus the encoder's session-external inputs: the
        round-robin cursor (enc.rr0), the tiers configuration (structural
        — dataclass repr, so equivalent confs match across fresh Tier
        objects), the serving (device, dtype), solve mode."""
        from volcano_tpu_torch.scheduler.util import scheduler_helper

        return (self.cache.pipeline_fingerprint(),
                tuple(repr(t) for t in ssn.tiers),
                _place_key(place),
                scheduler_helper._last_processed_node_index,
                mode)

    def serve_prepare(self, token: tuple) -> Optional[dict]:
        """The memoized prepare bundle when NOTHING the encode reads has
        moved since it was built — enc, spec and the staged tensors are
        all still exact (a scatter would have moved the fingerprint
        first). None on miss."""
        if self._prep is None or token != self._prep_token:
            return None
        self.stats["encode_reuses"] += 1
        return dict(self._prep)

    def store_prepare(self, token: tuple, prep: dict) -> None:
        self._prep_token = token
        self._prep = dict(prep)

    def forget_prepare(self) -> None:
        """Invalidate only the whole-encode memo (the standing buffers
        stay valid — their mirror diff is state-based, not token-based)."""
        self._prep_token = None
        self._prep = None

    # -- serve -------------------------------------------------------------

    def serve(self, arrays: Dict[str, np.ndarray], ssn, enc, place,
              profile: Optional[dict] = None) -> Dict[str, torch.Tensor]:
        """Device twins of ``arrays`` (the padded+cast SERVED subset) on
        ``place`` = (device, dtype): standing tensors updated by bucketed
        row scatters where the host content moved, wholesale restage on
        any envelope miss (counted by reason). The returned dict merges
        into the solver's staged tensors; values are bit-identical to a
        fresh stage of the same arrays by construction (the mirror diff
        is exact equality)."""
        t0 = time.perf_counter()
        self.stats["serves"] += 1
        reason = self._validate(arrays, enc, place)
        if reason is not None:
            self._rebuild(arrays, enc, place, reason)
        else:
            try:
                self._delta(arrays, ssn, enc)
            except Exception as e:  # defensive envelope: never wedge the
                # session on a replica bug — restage wholesale and count
                logger.exception("replica delta failed; restaging")
                self._rebuild(arrays, enc, place,
                              f"error:{type(e).__name__}")
        # marks are consumed once per serve whether or not they produced
        # rows (the mirror diff is the truth; the shadow is the witness)
        self.shadow.dirty_nodes.clear()
        self.shadow.dirty_jobs.clear()
        self._note_state(ssn, enc)
        if profile is not None:
            profile["replica_rebuilds"] = dict(self.stats["rebuilds"])
            profile["replica_scatter_rows"] = self.stats["scatter_rows"]
            profile["tpu_replica_scatter_ms"] = round(
                self.stats["scatter_ms"] * 1e3, 3)
            profile["replica_epoch"] = self.replica_epoch
            profile["replica_serve_ms"] = round(
                (time.perf_counter() - t0) * 1e3, 3)
        return dict(self.dev)

    # -- envelope ----------------------------------------------------------

    def _validate(self, arrays, enc, place) -> Optional[str]:
        if not self.dev:
            return "cold"
        keeper = self.cache.snap_keeper
        if self._generation != keeper.generation:
            return "generation"
        if self._fence_epoch != getattr(self.cache, "fence_epoch", 0):
            return "fence"
        if _place_key(place) != _place_key(self._place):
            return "device"
        for name, arr in arrays.items():
            mir = self.mirror.get(name)
            if mir is None:
                return "cold"
            if mir.shape != arr.shape:
                return "shape"
            if mir.dtype != arr.dtype:
                return "dtype"
        if list(enc.node_names) != self._node_names:
            return "axis"
        # the in-place invariant: no consumer wrote a standing tensor
        for name, dev in self.dev.items():
            if dev._version != self._versions.get(name):
                return "donated"
        if _witness_on():
            for name, dev in self.dev.items():
                if name not in arrays:
                    continue
                mir = self.mirror[name]
                kept = arrays[name] == mir       # rows the host left alone
                if (kept & (dev.cpu().numpy() != mir)).any():
                    return "donated"
        return None

    def _seal(self, names) -> None:
        """Record the version counters the replica's own writes left."""
        for name in names:
            self._versions[name] = self.dev[name]._version

    # -- wholesale restage --------------------------------------------------

    def _rebuild(self, arrays, enc, place, reason: str) -> None:
        rb = self.stats["rebuilds"]
        rb[reason] = rb.get(reason, 0) + 1
        self._plans.clear()
        self.mirror = dict(arrays)
        self.dev = {}
        self._place = place
        self._fence_epoch = getattr(self.cache, "fence_epoch", 0)
        self._generation = self.cache.snap_keeper.generation
        self._node_names = list(enc.node_names)
        for name, arr in arrays.items():
            self.dev[name] = _put(arr, place[0])
        self._versions = {}
        self._seal(self.dev)
        self.replica_epoch += 1

    # -- delta scatter ------------------------------------------------------

    def _changed_rows(self, family: str, arrays) -> List[int]:
        """Exact row diff against the mirror, unioned over the family's
        members (identity fast path first — the cast/pad pipeline hands
        back the same ndarray objects for untouched state)."""
        mask = None
        for name in FAMILIES[family]:
            if name not in arrays:
                continue
            arr, mir = arrays[name], self.mirror[name]
            if arr is mir:
                continue  # identity => content (pack-cache contract)
            diff = arr != mir
            if diff.ndim > 1:
                diff = diff.any(axis=tuple(range(1, diff.ndim)))
            mask = diff if mask is None else (mask | diff)
        if mask is None:
            return []
        return np.nonzero(mask)[0].tolist()

    def _delta(self, arrays, ssn, enc) -> None:
        moved = False
        for family in FAMILIES:
            rows = self._changed_rows(family, arrays)
            if not rows:
                continue
            self._witness_check(family, rows, ssn, enc)
            n_rows = int(self.mirror[FAMILIES[family][0]].shape[0]) \
                if FAMILIES[family][0] in self.mirror else 0
            if len(rows) * PATCH_FRACTION > max(n_rows, 1):
                self._dense_reput(family, arrays)
            else:
                self._scatter_family(family, rows, arrays)
            for name in FAMILIES[family]:
                if name in arrays:
                    self.mirror[name] = arrays[name]
            moved = True
        if moved:
            self.replica_epoch += 1

    def _shadow_node_rows(self) -> set:
        idx = {n: i for i, n in enumerate(self._node_names)}
        return {idx[n] for n in self.shadow.dirty_nodes if n in idx}

    def _dense_reput(self, family, arrays) -> None:
        """Dirty fraction past the patch budget: wholesale re-put of the
        family (counted as a rebuild reason, NOT as h2d_puts — the solver
        counter keeps meaning 'packed buffers that crossed the link')."""
        rb = self.stats["rebuilds"]
        key = f"dense:{family}"
        rb[key] = rb.get(key, 0) + 1
        for name in FAMILIES[family]:
            if name not in arrays:
                continue
            self.dev[name] = _put(arrays[name], self._place[0])
            self._seal([name])

    def _scatter_family(self, family, rows: List[int], arrays) -> None:
        """One bucketed scatter launch for the family."""
        t0 = time.perf_counter()
        names = [n for n in FAMILIES[family] if n in arrays]
        idx = bucket_pad_rows(rows)
        vals = {n: np.ascontiguousarray(arrays[n][idx]) for n in names}
        out = scatter_rows({n: self.dev[n] for n in names}, idx, vals,
                           plans=self._plans)
        self.dev.update(out)
        self._seal(names)
        self.stats["scatters"] += 1
        self.stats["scatter_rows"] += len(rows)
        self.stats["scatter_ms"] += time.perf_counter() - t0
        _note_overlappable(len(rows))

    # -- witness ------------------------------------------------------------

    def _explained_rows(self, family, ssn, enc) -> Optional[set]:
        """Rows the keeper's marks / generation movements explain, in the
        encoder's row order — None when the family has no row-level
        explanation channel (queue/ns aggregates move whenever any job's
        allocation moves; their explanation is family-level)."""
        if family == "node":
            rows = self._shadow_node_rows()
            idx = {n: i for i, n in enumerate(self._node_names)}
            for name, i in idx.items():
                nd = ssn.nodes.get(name)
                if nd is not None and \
                        self._node_gens.get(name) != nd._acct_gen:
                    rows.add(i)
            return rows
        if family == "job":
            rows = set()
            marked = self.shadow.dirty_jobs
            uids = self._job_uids
            for i, j in enumerate(enc.job_infos):
                # a row whose OCCUPANT changed (membership shift — a job
                # arrived or left upstream of this row) is explained by
                # the membership delta itself, which the keeper marked on
                # the arriving/leaving job
                if j.uid in marked \
                        or i >= len(uids) or uids[i] != j.uid \
                        or self._job_vers.get(j.uid) != \
                        getattr(j, "_status_version", 0):
                    rows.add(i)
            # pad-region rows a SHRINK vacated (occupied last serve, pad
            # fill now) are likewise explained by the membership delta —
            # rows that were pad on both serves stay unexplained, since
            # pad fill is deterministic and must not move
            for i in range(len(enc.job_infos), len(uids)):
                rows.add(i)
            return rows
        return None

    def _witness_check(self, family, rows, ssn, enc) -> None:
        """VOLCANO_TPU_WITNESS=1: every scattered row must be explained
        by a keeper mark or an accounting-generation/status-version
        movement — the runtime check for unmarked mutations reaching the
        device replica."""
        from volcano_tpu_torch.analysis import witness

        if not witness.enabled() or not self._node_gens:
            return
        explained = self._explained_rows(family, ssn, enc)
        if explained is None:
            return  # queue/ns aggregates: family-level channel
        orphan = [r for r in rows if r not in explained]
        if orphan:
            self.stats["witness_violations"] += len(orphan)
            raise witness.WitnessViolation(
                f"replica scatter of {family} rows {orphan[:8]} has no "
                f"explaining keeper mark or generation movement — an "
                f"unmarked mutation reached the device replica")

    def _note_state(self, ssn, enc) -> None:
        """Record the explanation baseline for the next serve (witness
        bookkeeping only — skipped entirely when the witness is off)."""
        if not _witness_on():
            return
        gens: Dict[str, int] = {}
        for name in self._node_names:
            nd = ssn.nodes.get(name)
            if nd is not None:
                gens[name] = nd._acct_gen
        self._node_gens = gens
        self._job_vers = {
            j.uid: getattr(j, "_status_version", 0)
            for j in enc.job_infos}
        self._job_uids = [j.uid for j in enc.job_infos]


def _place_key(place) -> Optional[tuple]:
    """Comparable key of a (device, dtype) pair."""
    if place is None:
        return None
    return (str(torch.device(place[0])), str(place[1]))


def _note_overlappable(rows: int) -> None:
    """Scatter launches are asynchronous device work that overlaps the
    rest of the host-side prepare (never fetched, never fenced here) —
    counted as overlappable dispatches, not sync points
    (utils/devprof.py)."""
    from volcano_tpu_torch.utils import devprof

    devprof.note_overlappable(rows)
