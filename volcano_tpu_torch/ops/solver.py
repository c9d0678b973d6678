"""Batch-allocator orchestration: encode -> pad -> stage -> solve -> apply.

Port of volcano_tpu/ops/solver.py. The tpuscore plugin
(scheduler/plugins/tpuscore.py) attaches a BatchAllocator to the session,
and actions/allocate.py hands the whole placement pass to it. The padded
encoded snapshot is staged on the device by ``from_numpy_encoded``, solved,
fetched back as ONE array, and applied:

- rounds mode: ``rounds.solve_rounds``, the packed result, and the bulk
  writeback with the same end state as the statement path. The
  state-dependent accounting arrays (ops/replica.py SERVED) ride the
  cache's standing device replica: committed deltas since the last
  session become bucketed row scatters (K8) into the standing tensors,
  and an unchanged session reuses the whole previous prepare bundle.
- parity mode: the sequential scan K15 (ops/parity_kernels.py
  ``solve_allocate``), replayed through per-job Statements; its binds
  equal the serial loop's. The round-robin cursor carries into
  ``scheduler_helper._last_processed_node_index`` as the serial helper
  carries it. Parity mode keeps the encoder's session-wide fallback (no
  residue), and the replica is not consulted beyond the whole-encode memo
  probe, which never hits: only rounds prepares are stored, and the token
  carries the mode.

The bulk writeback's per-task loop, its node deltas and the drf share
updates run in the native engine ``_native/fastapply.c`` when it has
loaded (the Python body is the fallback and the oracle; the same end
state either way). A rounds prepare also keeps its padded host arrays
(``prep["arrays"]``), which the bench's per-device stage probes read
(ops/shard.py).

Left out here: the mesh (its per-shard staging), and the serial fallback
on a solve error — in the port a build, launch or solve failure raises.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional

import numpy as np
import torch

from volcano_tpu_torch import device as devmod
from volcano_tpu_torch.ops import rounds as rounds_mod
from volcano_tpu_torch.ops.encoder import EncodedSnapshot, EncoderFallback, encode_session

logger = logging.getLogger(__name__)


def _bucket(n: int) -> int:
    """Next power-of-two bucket to bound the shapes the solve sees as
    task/job counts churn between sessions."""
    if n <= 16:
        return 16
    b = 16
    while b < n:
        b *= 2
    return b


def _window_fields(arrays) -> Dict[str, int]:
    """Candidate-window sizing for the rounds solve, off the bucket ladder
    (volcano_tpu/ops/solver.py _window_fields with one shard): window_k
    from class demand x capacity slack, doubled and bucketed; dirty_k
    bounds the dirty-column rescoring gather. Both 0 (full-width sweeps)
    when the window would cover most of the node axis anyway."""
    nb = int(np.asarray(arrays["node_idle"]).shape[0])
    n_shard = max(nb, 1)
    task_cls = np.asarray(arrays["task_cls"])
    kb = int(np.asarray(arrays["cls_req"]).shape[0])
    demand = np.bincount(task_cls, minlength=kb).astype(np.float64)
    idle = np.asarray(arrays["node_idle"], dtype=np.float64)
    req = np.asarray(arrays["cls_req"], dtype=np.float64)
    mean_idle = idle.mean(axis=0) if idle.size else np.zeros(req.shape[1])
    with np.errstate(divide="ignore", invalid="ignore"):
        per_node = np.where(req > 0, mean_idle[None, :]
                            / np.where(req > 0, req, 1.0), np.inf)
    cap = per_node.min(axis=1)
    cap = np.where(np.isfinite(cap), np.clip(cap, 1.0, None),
                   float(max(task_cls.shape[0], 1)))
    need = int(np.ceil(demand / cap).max(initial=1.0))
    k = _bucket(max(16, 2 * need))
    if 2 * k > n_shard:
        return {"window_k": 0, "dirty_k": 0}
    return {"window_k": k,
            "dirty_k": min(_bucket(max(4 * k, 64)),
                           _bucket(max(n_shard // 8, 64)))}


def _pad_axis(a: np.ndarray, axis: int, size: int, fill=0):
    if a.shape[axis] == size:
        return a
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, size - a.shape[axis])
    return np.pad(a, widths, constant_values=fill)


# plugins whose allocate-time effects the bulk writeback reproduces exactly;
# anything else in the conf forces the serial loop
ROUNDS_SAFE_PLUGINS = frozenset({
    "tpuscore", "priority", "gang", "drf", "proportion",
    "predicates", "nodeorder", "binpack", "conformance",
})

# the node axis of each node-indexed encoded array (the mesh's shard axis;
# ops/shard.py slices one shard's width along it)
_NODE_AXIS = {
    "sig_mask": 1, "affinity_score": 1, "excl_occ0": 1,
    "node_idle": 0, "node_used": 0, "node_alloc": 0,
    "node_cnt": 0, "node_max_tasks": 0, "node_real": 0,
}

# arrays the rounds solve never reads: per-task columns it re-derives from
# the class arrays, plus the parity scan's sampling-window inputs
_ROUNDS_SKIP = frozenset({
    "task_req", "task_initreq", "task_nz_cpu", "task_nz_mem",
    "task_sig", "task_has_pod", "node_real", "real_n",
})


def pad_encoded(enc: EncodedSnapshot) -> Dict[str, np.ndarray]:
    """Pad the churny axes (tasks, jobs, classes, exclusion groups) to
    buckets; the node axis is left as it is. Padded jobs never win
    selection and padded tasks never place."""
    t, n, j, q, ns, s = enc.shape
    tb, jb = _bucket(t), _bucket(j)
    a = dict(enc.arrays)
    for name in ("task_req", "task_initreq", "task_nz_cpu", "task_nz_mem",
                 "task_sig", "task_has_pod", "task_job", "task_cls"):
        a[name] = _pad_axis(a[name], 0, tb)
    kb = _bucket(a["cls_req"].shape[0])
    for name in ("cls_req", "cls_initreq", "cls_nz_cpu", "cls_nz_mem",
                 "cls_sig", "cls_has_pod"):
        a[name] = _pad_axis(a[name], 0, kb,
                            fill=False if name == "cls_has_pod" else 0)
    a["cls_excl"] = _pad_axis(a["cls_excl"], 0, kb, fill=-1)
    gb = _bucket(a["excl_occ0"].shape[0])
    a["excl_occ0"] = _pad_axis(a["excl_occ0"], 0, gb, fill=False)
    for name in (
        "job_task_start", "job_task_count", "job_queue", "job_ns",
        "job_priority", "job_min_available", "job_ready_base",
        "job_ready_threshold", "job_alloc0",
    ):
        a[name] = _pad_axis(a[name], 0, jb)
    a["job_active0"] = _pad_axis(a["job_active0"], 0, jb, fill=False)
    a["job_tie_rank"] = _pad_axis(a["job_tie_rank"], 0, jb, fill=np.iinfo(np.int32).max - 1)
    return a


# change-granularity groups of the packed transfer (the JAX package's
# layout, so rounds.unpack_layout reads the same offsets): arrays of one
# group and dtype class share one flat buffer; unknown names land in "dyn"
_GROUP_OF = {}
for _g, _names in {
    "node": ("node_alloc", "node_max_tasks"),
    "sig": ("sig_mask", "affinity_score"),
    "cls": ("cls_req", "cls_initreq", "cls_nz_cpu", "cls_nz_mem",
            "cls_sig", "cls_has_pod", "cls_excl"),
    "sigx": ("excl_occ0",),
    "task": ("task_cls", "task_job"),
    "job": ("job_task_start", "job_task_count", "job_queue", "job_ns",
            "job_priority", "job_min_available", "job_ready_threshold",
            "job_tie_rank"),
    "conf": ("eps", "is_scalar", "res_unit", "drf_total", "drf_present",
             "binpack_w", "binpack_weight", "least_req_weight",
             "balanced_weight", "node_affinity_weight", "queue_present",
             "queue_tie_rank", "ns_rank", "ns_weight", "q_in_ns0"),
}.items():
    for _n in _names:
        _GROUP_OF[_n] = _g


def _pack(arrays: Dict[str, np.ndarray]):
    """Pack arrays into one flat buffer per (group, dtype class): floats
    keep their common type, ints become int32, bools stay bool. Returns
    (layout, bufs); layout rows are (name, key, offset, size, shape)."""
    parts: Dict[str, list] = {}
    offsets: Dict[str, int] = {}
    layout = []
    for name in sorted(arrays):
        v = np.asarray(arrays[name])
        kind = "f" if v.dtype.kind == "f" else ("b" if v.dtype == np.bool_ else "i")
        key = _GROUP_OF.get(name, "dyn") + "." + kind
        flat = v.ravel()
        layout.append((name, key, offsets.get(key, 0), flat.size, v.shape))
        parts.setdefault(key, []).append(flat)
        offsets[key] = offsets.get(key, 0) + flat.size
    bufs = {}
    for key, ps in parts.items():
        kind = key[-1]
        if kind == "f":
            dt = np.result_type(*[p.dtype for p in ps])
        elif kind == "b":
            dt = np.bool_
        else:
            dt = np.int32
        bufs[key] = np.concatenate(ps).astype(dt, copy=False)
    return tuple(layout), bufs


def cast_arrays(arrays: Dict[str, np.ndarray], dtype) -> Dict[str, np.ndarray]:
    """The host arrays as they are staged: floats cast to ``dtype``, ints
    to int32, bools kept (copy=False keeps the identity of already-typed
    arrays, which the replica's row diff uses as a fast path)."""
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    cast = {}
    for k, v in arrays.items():
        v = np.asarray(v)
        if v.dtype.kind == "f":
            v = v.astype(np_dt, copy=False)
        elif v.dtype.kind in "iu":
            v = v.astype(np.int32, copy=False)
        cast[k] = v
    return cast


def from_numpy_encoded(arrays: Dict[str, np.ndarray], *, device,
                       dtype, profile: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """Stage the padded encoded snapshot (the keys and layout of
    pad_encoded) on ``device``: floats cast to ``dtype``, ints to int32,
    one host-to-device copy per packed group buffer, then viewed back
    into per-array tensors by rounds.unpack_layout. With ``profile``,
    records the buffers that crossed (``h2d_puts``) and their bytes."""
    dev = devmod.resolve_device(device)
    dt = devmod.resolve_dtype(dtype, dev)
    layout, bufs = _pack(cast_arrays(arrays, dt))
    staged = {key: torch.from_numpy(np.ascontiguousarray(buf)).to(dev)
              for key, buf in bufs.items()}
    if profile is not None:
        profile["h2d_puts"] = len(bufs)
        profile["h2d_bytes"] = int(sum(b.nbytes for b in bufs.values()))
    return rounds_mod.unpack_layout(layout, staged)


class BatchAllocator:
    """Callable attached to the session as ``ssn.batch_allocator``.

    Returns True when the batched solve ran; False => the caller runs the
    serial loop (EncoderFallback, no work, or a session below the auto
    threshold).

    mode:
      - "parity": the sequential scan (ops/parity_kernels.py, K15), binds
        identical to the serial loop's (one device step per task);
      - "rounds": the bulk-synchronous solve (ops/rounds.py);
      - "auto" (default): rounds when tasks >= AUTO_ROUNDS_THRESHOLD, else
        the serial host loop.
    """

    AUTO_ROUNDS_THRESHOLD = 2048

    def __init__(self, device=None, dtype=None,
                 profile: Optional[dict] = None, mode: str = "auto"):
        if mode not in ("auto", "parity", "rounds"):
            raise ValueError(f"BatchAllocator mode {mode!r} (auto/parity/rounds)")
        self.device = devmod.resolve_device(device)
        self.dtype = devmod.resolve_dtype(dtype, self.device)
        self.mode = mode
        self.profile = profile if profile is not None else {}

    def _prepare(self, ssn):
        """Encode + gate + pad + stage, WITHOUT solving. Returns a dict
        bundle consumed by __call__, or None after recording the fallback
        reason in the profile (the caller then runs the serial loop)."""
        t0 = time.perf_counter()
        if self.mode in ("rounds", "auto"):
            # the bulk writeback bypasses the Statement event machinery and
            # hardcodes drf/proportion share updates; any other plugin
            # would silently lose its allocate-event effects
            unknown = {
                p.name for tier in ssn.tiers for p in tier.plugins
            } - ROUNDS_SAFE_PLUGINS
            if unknown:
                self.profile["fallback"] = (
                    f"rounds apply cannot honor custom plugins: {sorted(unknown)}")
                return None
        # whole-encode reuse (ops/replica.py): when NOTHING the encode
        # reads has moved since the last prepare — the cache's pipeline
        # fingerprint, the tiers identity, the round-robin cursor, the
        # serving device/dtype and mode — the previous session's entire
        # prepare bundle (enc + spec + staged tensors) is still exact
        from volcano_tpu_torch.ops import replica as replica_mod

        rep = replica_mod.get(getattr(ssn, "cache", None)) \
            if getattr(ssn, "cache", None) is not None else None
        place = (self.device, self.dtype)
        if rep is not None:
            token = rep.encode_token(ssn, place, self.mode)
            prev = rep.serve_prepare(token)
            if prev is not None:
                prev["t0"] = t0
                prev["t1"] = time.perf_counter()
                self.profile["encode_reused"] = True
                self.profile["h2d_puts"] = 0
                self.profile["h2d_bytes"] = 0
                self.profile["replica_epoch"] = rep.replica_epoch
                return prev
        try:
            # rounds mode leaves un-modeled constructs PENDING as a serial
            # residue; parity mode stays bit-exact, so it keeps the
            # session-wide fallback to the serial loop
            enc = encode_session(ssn, allow_residue=self.mode in ("rounds", "auto"))
        except EncoderFallback as e:
            logger.info("tpuscore falling back to serial allocate: %s", e)
            self.profile["fallback"] = str(e)
            return None
        t, n, j, *_ = enc.shape
        if t == 0 or n == 0 or j == 0:
            if enc.residue_count:
                self.profile["fallback"] = (
                    f"all {enc.residue_count} pending tasks are residue "
                    f"(affinity/ports); serial loop handles them")
            return None
        if self.mode == "auto" and t < self.AUTO_ROUNDS_THRESHOLD:
            self.profile["fallback"] = (
                f"auto: {t} tasks below rounds threshold; serial loop "
                f"is cheaper than a device solve")
            return None

        arrays = cast_arrays(pad_encoded(enc), self.dtype)
        # host half of the read set the pipeline seals at a speculative
        # dispatch: the job uids the solve encoded, the queue/namespace
        # rows it consumed, and whether the apply reads the whole node
        # axis serially (residue or releasing capacity)
        readset = dict(job_uids=[j.uid for j in enc.job_infos],
                       queue_ids=list(enc.queue_uids),
                       ns_ids=list(enc.ns_names),
                       read_all_nodes=bool(enc.residue_count or enc.has_releasing))
        if self.mode == "parity":
            t1 = time.perf_counter()
            staged = from_numpy_encoded(arrays, device=self.device,
                                        dtype=self.dtype, profile=self.profile)
            return dict(mode="parity", enc=enc, spec=enc.spec, staged=staged,
                        t0=t0, t1=t1, h2d_s=time.perf_counter() - t1,
                        readset=readset)
        rounds_arrays = {k: v for k, v in arrays.items() if k not in _ROUNDS_SKIP}
        # diminishing-returns floor and straggler rounds, keyed to the
        # padded buckets; only when the class axis spans several chunks
        tb = int(arrays["task_cls"].shape[0])
        kb = int(arrays["cls_req"].shape[0])
        wf = _window_fields(arrays)
        spec = enc.spec._replace(
            round_min_progress=(max(2, tb // 128) if kb > rounds_mod.CHUNK else 0),
            straggler_rounds=4 if kb > rounds_mod.CHUNK else 0,
            window_k=wf["window_k"], dirty_k=wf["dirty_k"])
        t1 = time.perf_counter()
        # the state-dependent accounting arrays leave the pack and ride
        # the standing device replica: committed deltas since the last
        # session become bucketed row scatters into the standing tensors,
        # and the replica's plain-keyed tensors join the unpacked groups
        rep_part = {}
        if rep is not None:
            rep_part = {k: v for k, v in rounds_arrays.items()
                        if k in replica_mod.SERVED}
        rest = {k: v for k, v in rounds_arrays.items() if k not in rep_part}
        staged = from_numpy_encoded(rest, device=self.device,
                                    dtype=self.dtype, profile=self.profile)
        if rep_part:
            staged.update(rep.serve(rep_part, ssn, enc, place, self.profile))
        t2 = time.perf_counter()
        prep = dict(mode="rounds", enc=enc, spec=spec, staged=staged,
                    arrays=rounds_arrays, t0=t0, t1=t1, h2d_s=t2 - t1,
                    readset=readset,
                    # on the card, once the bucket's graph exists: the
                    # encode's copy list into it, so that dispatch() only
                    # launches
                    bound=rounds_mod.bind_packed(spec, staged))
        if rep is not None:
            # token recomputed AFTER the serve: the serve bumps the
            # replica epoch (a fingerprint component), and the stored
            # token must describe the state this bundle was built against
            # so an unchanged next session hits
            rep.store_prepare(rep.encode_token(ssn, place, self.mode), prep)
        return prep

    def parse_packed(self, out: np.ndarray):
        """Split the packed single-fetch result into (assign, meta dict)."""
        pt = rounds_mod.PROF_TAIL
        meta = out[-pt:].astype(np.int64)
        nb = int(meta[0])  # node count: sizes the touched mask
        assign = out[:-(pt + nb)].astype(np.int32, copy=False)
        return assign, dict(
            n_rounds=int(meta[1]) | (int(meta[2]) << 15),
            tail_placed=int(meta[3]),
            full_sweeps=int(meta[4]),
            round_capped=bool(meta[5]),
            placed_hist=meta[6:],
            touched_nodes=np.asarray(out[-(pt + nb):-pt]) != 0,
        )

    def apply_packed(self, ssn, prep: dict, assign: np.ndarray,
                     meta: dict) -> bool:
        """Profile + bulk-apply a rounds result."""
        enc = prep["enc"]
        spec = prep["spec"]
        self.profile["rounds"] = int(meta["n_rounds"])
        self.profile["full_sweep_rounds"] = meta["full_sweeps"]
        self.profile["window_k"] = spec.window_k
        self.profile["dirty_k"] = spec.dirty_k
        self.profile["round_capped"] = meta["round_capped"]
        self.profile["round_placed"] = [
            int(x) for x in meta["placed_hist"][
                :min(int(meta["n_rounds"]), rounds_mod.PROF_SLOTS)]]
        # tail placement ATTEMPTS (the gang strip may revoke some)
        self.profile["tail_placed"] = meta["tail_placed"]
        t2 = time.perf_counter()
        self.profile["mode"] = "rounds"
        self._apply_bulk(ssn, enc, assign)
        t3 = time.perf_counter()
        t, n, j, *_ = enc.shape
        self.profile.update(
            encode_s=prep["t1"] - prep["t0"], solve_s=t2 - prep["t1"],
            apply_s=t3 - t2,
            tasks=t, nodes=n, jobs=j,
            placed=int((assign[: len(enc.task_infos)] >= 0).sum()),
            residue=enc.residue_count,
            has_releasing=enc.has_releasing,
        )
        return True

    @staticmethod
    def dispatch(prep: dict):
        """Launch a rounds prepare's solve; returns the packed result
        (assign, touched mask, profile tail) unfetched, for devprof's fetch.
        On the card this enqueues one graph replay and the result's copy to
        the host, and reads nothing back."""
        return rounds_mod.dispatch_packed(prep["spec"], prep["staged"],
                                          prep.get("bound"))

    def __call__(self, ssn) -> bool:
        from volcano_tpu_torch.utils import devprof

        with devprof.session(self.profile):
            prep = self._prepare(ssn)
            if prep is None:
                return False
            tp = time.perf_counter()
            if prep["mode"] == "parity":
                return self._solve_parity(ssn, prep)
            # ONE fetch of the packed result (assign, touched mask, profile)
            out = devprof.fetch(self.dispatch(prep))
            self.profile["h2d_s"] = prep["h2d_s"]
            self.profile["dispatch_s"] = time.perf_counter() - tp
            assign, meta = self.parse_packed(out)
            return self.apply_packed(ssn, prep, assign, meta)

    def _solve_parity(self, ssn, prep: dict) -> bool:
        """K15 over the staged encode, one fetch of (assign, rr), the
        cursor carried on, and the statement replay."""
        from volcano_tpu_torch.ops import parity_kernels
        from volcano_tpu_torch.scheduler.util import scheduler_helper
        from volcano_tpu_torch.utils import devprof

        enc = prep["enc"]
        out = devprof.fetch(parity_kernels.solve_allocate(
            enc.spec, prep["staged"], enc.rr0, enc.num_to_find))
        assign = out[:-1]
        # the round-robin index continues across sessions exactly like the
        # serial helper's (scheduler_helper.go:38)
        scheduler_helper._last_processed_node_index = int(out[-1])
        t2 = time.perf_counter()
        self.profile["mode"] = "parity"
        self._apply(ssn, enc, assign)
        t3 = time.perf_counter()
        t, n, j, *_ = enc.shape
        self.profile.update(
            encode_s=prep["t1"] - prep["t0"], solve_s=t2 - prep["t1"],
            apply_s=t3 - t2, h2d_s=prep["h2d_s"],
            tasks=t, nodes=n, jobs=j,
            placed=int((assign[: len(enc.task_infos)] >= 0).sum()),
            residue=enc.residue_count,
            has_releasing=enc.has_releasing,
        )
        return True

    def _apply(self, ssn, enc: EncodedSnapshot, assign: np.ndarray) -> None:
        """Replay the parity scan's placements through per-job statements;
        every committed job is gang-ready by construction, so
        stmt.commit() dispatches binds exactly as the serial path would."""
        from volcano_tpu_torch.api.unschedule_info import FitErrors

        start = enc.arrays["job_task_start"]
        count = enc.arrays["job_task_count"]
        for ji, job in enumerate(enc.job_infos):
            lo, hi = int(start[ji]), int(start[ji]) + int(count[ji])
            placed = [
                (ti, int(assign[ti])) for ti in range(lo, hi) if assign[ti] >= 0
            ]
            if len(placed) < hi - lo and not job.ready():
                # the solve left this gang short: record a fit error for
                # the first unplaced task so gang.on_session_close emits the
                # same Unschedulable condition as the serial path
                for ti in range(lo, hi):
                    if assign[ti] < 0:
                        fe = FitErrors()
                        fe.set_error(
                            "0/%d nodes are available in the batched "
                            "feasibility/fit solve" % len(enc.node_names))
                        job.nodes_fit_errors[enc.task_infos[ti].uid] = fe
                        break
            if not placed:
                continue
            stmt = ssn.statement()
            ok = True
            for ti, ni in placed:
                task = enc.task_infos[ti]
                try:
                    stmt.allocate(task, enc.node_names[ni])
                except (KeyError, RuntimeError) as e:  # pragma: no cover
                    logger.error("tpuscore apply failed for %s -> %s: %s",
                                 task.uid, enc.node_names[ni], e)
                    ok = False
                    break
            if ok and ssn.job_ready(job):
                stmt.commit()
            else:  # pragma: no cover - device decisions are gang-consistent
                stmt.discard()

    def _apply_bulk(self, ssn, enc: EncodedSnapshot, assign: np.ndarray) -> None:
        """Bulk writeback for rounds mode: same end state as the statement
        path (session + cache task/node/job status, binder calls, plugin
        shares) but with all resource accounting vectorized and the
        remaining per-task work reduced to attribute writes + dict moves.

        Bumps the session placement generation: these writes bypass the
        Session/Statement mutators, so any cached dense view must rebuild
        (preemptview.build's generation gate).

        The statement path costs ~40us/task in event handlers, epsilon
        asserts, and per-task Resource arithmetic; at 50k tasks that is the
        session bottleneck, not the device solve. Here each placement costs
        ~2us: status/node_name on the session + cache task, the index-bucket
        move on both JobInfos, one shared status-frozen clone into both node
        task-maps, and the batch binder/event entries."""
        from volcano_tpu_torch.api.resource import Resource
        from volcano_tpu_torch.api.types import TaskStatus
        from volcano_tpu_torch.api.unschedule_info import FitErrors
        from volcano_tpu_torch.scheduler.cache.interface import BindManyError

        ssn._placement_gen += 1
        prof_t0 = time.perf_counter()
        a = enc.arrays
        t_real = len(enc.task_infos)
        assign = assign[:t_real]
        capped = assign == -2
        if capped.any():
            # diminishing-returns leftovers (rounds.py capped exit) fold
            # into residue accounting: the serial pass retries exactly
            # these tasks, and the fit-error stamping below skips their
            # jobs — no stale '0/N nodes' error outlives the retry
            cap_counts = np.bincount(
                a["task_job"][:t_real][capped],
                minlength=len(enc.job_infos)).astype(np.int32)
            if enc.job_residue is None:
                enc.job_residue = cap_counts
            else:
                enc.job_residue = enc.job_residue + cap_counts
            enc.residue_count += int(capped.sum())
            self.profile["round_capped_tasks"] = int(capped.sum())
            assign = np.where(capped, np.int32(-1), assign)
        placed_mask = assign >= 0

        # --- vectorized per-node / per-job resource deltas ----------------
        node_ids = assign[placed_mask]
        reqs = a["task_req"][:t_real][placed_mask]
        n_count = len(enc.node_names)
        j_count = len(enc.job_infos)
        sums = np.zeros((n_count, reqs.shape[1]))
        np.add.at(sums, node_ids, reqs)
        counts = np.bincount(node_ids, minlength=n_count)
        job_ids = a["task_job"][:t_real][placed_mask]
        job_sums = np.zeros((j_count, reqs.shape[1]))
        np.add.at(job_sums, job_ids, reqs)
        job_placed_n = np.bincount(job_ids, minlength=j_count)

        # resource dim names recovered from the encoder's layout
        scalar_names = enc.resource_names[2:]

        def apply_delta(res: Resource, vec, sign: float) -> None:
            res.milli_cpu += sign * vec[0]
            res.memory += sign * vec[1]
            for si, name in enumerate(scalar_names):
                q = vec[2 + si]
                if q:
                    res.add_scalar(name, sign * q)

        BINDING = TaskStatus.BINDING
        PENDING = TaskStatus.PENDING
        task_infos = enc.task_infos
        job_infos = enc.job_infos
        node_names = enc.node_names
        cache = ssn.cache
        ssn_nodes = ssn.nodes
        cache_nodes = cache.nodes
        vb = cache.volume_binder
        # volume calls are skippable when the binder is a declared no-op
        # OR no pod in the cache references a PVC (counter maintained by
        # the cache's task handlers) — a real StoreVolumeBinder then costs
        # nothing on PVC-free sessions and the native loop stays eligible
        vols_noop = getattr(vb, "IS_NOOP", False) or (
            getattr(cache, "_pvc_pod_count", 1) == 0)
        alloc_vols = vb.allocate_volumes
        bind_vols = vb.bind_volumes

        placed_arr = np.nonzero(placed_mask)[0]
        job_nz_arr = np.nonzero(job_placed_n)[0]
        seg_ends_arr = np.cumsum(job_placed_n[job_nz_arr])
        job_nz = job_nz_arr.tolist()

        # tasks are contiguous per job on the flat axis, so placed visits
        # each job's placements as one contiguous run. The loop allocates
        # ~1 object + a few dict entries per task; suppress the cyclic GC so
        # gen-promotion scans of the (multi-million-object) session heap
        # don't fire mid-apply.
        import gc

        self.profile["apply_prep_s"] = time.perf_counter() - prof_t0
        prof_t1 = time.perf_counter()
        gc_was = gc.isenabled()
        gc.disable()
        bind_tasks: list = []
        bind_pods: list = []
        bind_hosts: list = []
        bind_keys: list = []
        # native batched loop (volcano_tpu_torch/_native/fastapply.c):
        # identical semantics to the Python body below, which remains the
        # fallback and oracle; volumes force the Python path (effector
        # calls). Non-blocking: a cold process compiles on a background
        # thread and THIS session runs the Python loop; never wait on cc here
        from volcano_tpu_torch._native import get_fastapply_nowait

        mod = get_fastapply_nowait()
        fast_all = getattr(mod, "apply_all_jobs", None) \
            if (mod is not None and vols_noop) else None
        # a keyed binder that declares it does not consume pod objects
        # (KEYED_NEEDS_PODS = False — the k8s Bind subresource needs only
        # name + target) lets the writeback skip the .pod extractions;
        # the BindManyError retry path still reads task.pod lazily
        binder0 = cache.binder
        want_pods = not (
            getattr(binder0, "bind_many_keyed", None) is not None
            and getattr(binder0, "KEYED_NEEDS_PODS", True) is False)
        # cache-mirror deferral: the reference's Bind is an async goroutine
        # and its scheduler cache learns pod statuses from LATER watch
        # events (cache.go:123-135,597-613) — only the SESSION state must be
        # current inside the cycle. The cache-side half of this writeback
        # (status flips, bucket moves, node maps, allocated sums on the
        # cache twins) is therefore queued on the cache and applied at
        # session close / before the next snapshot (cache.flush_mirror),
        # halving the per-task work on the measured path. Bulk-bound tasks
        # are disjoint from anything later actions touch through the cache
        # effectors (they bind/evict PENDING/RUNNING tasks, never this
        # session's BINDING set), and the deferred node deltas touch
        # idle/used while evictions touch releasing — commutative.
        defer_mirror = getattr(cache, "defer_mirror", None)
        do_cache_inline = defer_mirror is None
        try:
            if fast_all is not None:
                fast_all(
                    job_nz_arr, seg_ends_arr, placed_arr,
                    assign.astype(np.int64),
                    task_infos, node_names, ssn_nodes,
                    cache_nodes if do_cache_inline else None,
                    job_infos,
                    cache.jobs if do_cache_inline else None,
                    PENDING, BINDING,
                    np.ascontiguousarray(job_sums),
                    tuple(scalar_names),
                    bind_tasks, bind_pods, bind_hosts, bind_keys,
                    int(want_pods))
                loop_jobs = ()  # the batched call covered every job
            else:
                loop_jobs = job_nz
                assign_l = assign.tolist()
                placed_l = placed_arr.tolist()
                job_sums_l = job_sums.tolist()
            lo = 0
            for ji, hi in zip(loop_jobs, seg_ends_arr.tolist()):
                tis = placed_l[lo:hi]
                lo = hi
                job = job_infos[ji]
                cache_job = cache.jobs.get(job.uid) if do_cache_inline else None
                job._status_version += 1  # direct index surgery below
                idx = job.task_status_index
                s_pending = idx.get(PENDING)
                # wholesale bucket move when the whole PENDING set placed
                # (the common all-or-nothing gang case): O(1) instead of
                # per-task pop+insert
                if s_pending is not None and len(s_pending) == len(tis):
                    s_binding = idx.get(BINDING)
                    if s_binding is None:
                        idx[BINDING] = s_pending
                    else:
                        s_binding.update(s_pending)
                    del idx[PENDING]
                    s_pending = None
                    s_binding = idx[BINDING]
                else:
                    s_binding = idx.get(BINDING)
                    if s_binding is None:
                        s_binding = idx[BINDING] = {}
                if cache_job is not None:
                    c_tasks = cache_job.tasks
                    cache_job._status_version += 1  # direct index surgery
                    cidx = cache_job.task_status_index
                    c_pending = cidx.get(PENDING)
                    if c_pending is not None and len(c_pending) == len(tis):
                        c_binding = cidx.get(BINDING)
                        if c_binding is None:
                            cidx[BINDING] = c_pending
                        else:
                            c_binding.update(c_pending)
                        del cidx[PENDING]
                        c_pending = None
                        c_binding = cidx[BINDING]
                    else:
                        c_binding = cidx.get(BINDING)
                        if c_binding is None:
                            c_binding = cidx[BINDING] = {}
                else:
                    c_tasks = c_pending = c_binding = None

                for ti in tis:
                    task = task_infos[ti]
                    host = node_names[assign_l[ti]]
                    task.node_name = host
                    task.status = BINDING
                    uid = task.uid
                    if s_pending is not None:
                        s_pending.pop(uid, None)
                        s_binding[uid] = task
                    # the session task itself is shared into both node
                    # task-maps (the serial path stores clones so LATER
                    # status flips can't corrupt node accounting;
                    # nothing flips a BINDING task in place for the
                    # rest of this session, and cache watch events
                    # REPLACE node entries rather than mutate them, so
                    # the share is safe and saves one object per
                    # placement)
                    key = task.key
                    node = ssn_nodes[host]
                    node._acct_gen += 1  # invalidate snapshot node-axis
                    node.tasks[key] = task
                    if c_tasks is not None:
                        ctask = c_tasks.get(uid)
                        if ctask is not None:
                            ctask.node_name = host
                            ctask.status = BINDING
                            if c_pending is not None:
                                c_pending.pop(uid, None)
                                c_binding[uid] = ctask
                            cnode = cache_nodes.get(host)
                            if cnode is not None:
                                cnode._acct_gen += 1
                                cnode.tasks[key] = task
                    # effector contract matches session.dispatch ->
                    # cache.bind (cache.py:374-395): volumes, binder
                    if not vols_noop:
                        alloc_vols(task, host)
                        bind_vols(task)
                    bind_tasks.append(task)
                    if want_pods:
                        bind_pods.append(task.pod)
                    bind_hosts.append(host)
                    bind_keys.append(key)

                # PENDING -> BINDING leaves total_request unchanged;
                # allocated grows by the job's placed sum, pending_sum
                # shrinks by it (every placed task left the PENDING bucket)
                vec = job_sums_l[ji]
                apply_delta(job.allocated, vec, +1.0)
                apply_delta(job.pending_sum, vec, -1.0)
                if cache_job is not None:
                    apply_delta(cache_job.allocated, vec, +1.0)
                    apply_delta(cache_job.pending_sum, vec, -1.0)
        finally:
            if gc_was:
                gc.enable()

        self.profile["apply_loop_s"] = time.perf_counter() - prof_t1
        prof_t2 = time.perf_counter()

        # --- bulk node accounting (session tree; cache tree deferred) -----
        # runs BEFORE the mirror defer so the payload can capture the final
        # session-side node generations (the keeper's sync point)
        node_nz = np.nonzero(counts)[0]
        fast_nodes = getattr(mod, "apply_node_deltas", None) \
            if mod is not None else None
        if fast_nodes is not None:
            fast_nodes(node_nz, np.ascontiguousarray(sums),
                       node_names, ssn_nodes,
                       cache_nodes if do_cache_inline else None,
                       tuple(scalar_names))
        else:
            sums_l = sums.tolist()
            for ni in node_nz.tolist():
                vec = sums_l[ni]
                name = node_names[ni]
                nodes_pair = (ssn_nodes.get(name), cache_nodes.get(name)) \
                    if do_cache_inline else (ssn_nodes.get(name),)
                for node in nodes_pair:
                    if node is None:
                        continue
                    node._acct_gen += 1  # invalidate snapshot node-axis
                    apply_delta(node.idle, vec, -1.0)
                    apply_delta(node.used, vec, +1.0)

        if not do_cache_inline:
            # queued only after the session-side loop SUCCEEDED (a loop
            # failure must not leave the cache applying phantom
            # placements), and before any effector runs — a store-backed
            # binder can fire synchronous watch events whose handlers
            # flush_mirror(), and they must land on a synced mirror.
            # job_vers/node_gens are the session-side versions at this
            # point (all bulk mutations applied): after an exact flush the
            # cache twins equal these objects, so the snapshot keeper can
            # re-record them as in-sync and reuse them next open.
            # placed_req rows let the flush subtract any placement it had
            # to skip (pod deleted in the defer window) from the node sums.
            defer_mirror(dict(
                job_nz=job_nz_arr, seg_ends=seg_ends_arr, placed=placed_arr,
                assign=assign, task_infos=task_infos, node_names=node_names,
                job_infos=job_infos, job_sums=job_sums,
                scalar_names=tuple(scalar_names),
                node_nz=node_nz, node_sums=sums,
                placed_req=reqs,
                job_vers=[job_infos[ji]._status_version
                          for ji in job_nz],
                node_gens=[ssn_nodes[node_names[ni]]._acct_gen
                           for ni in node_nz.tolist()]))
            self.profile["mirror_deferred"] = 1

        # --- batch binder + events ----------------------------------------
        binder = cache.binder
        retry_from = None
        keyed_bind = getattr(binder, "bind_many_keyed", None)
        if keyed_bind is not None:
            # the apply loop already derived each placement's ns/name key;
            # a keyed binder skips 50k metadata re-derivations (pods is
            # None when the binder declared KEYED_NEEDS_PODS = False)
            try:
                keyed_bind(bind_keys, bind_pods if want_pods else None,
                           bind_hosts)
            except BindManyError as e:
                retry_from = e.done
            except Exception:
                retry_from = 0
        elif hasattr(binder, "bind_many"):
            try:
                # pods were extracted during the apply loop; zip streams the
                # pairs without materializing another 50k-tuple list
                binder.bind_many(zip(bind_pods, bind_hosts))
            except BindManyError as e:
                retry_from = e.done
            except Exception:
                # bind_many contract: partial progress => BindManyError; a
                # bare exception means nothing was bound
                retry_from = 0
        else:
            retry_from = 0
        failed_binds: set = set()
        if retry_from is not None:
            # per-task so one bad pod degrades to resync, not a lost
            # session (cache.go:597-599 semantics); failures are tracked
            # so the event record below stays bind-exact — a fenced
            # (deposed-leader) or otherwise failed bind must not leave a
            # phantom Scheduled event behind
            for k, (task, host) in enumerate(
                    zip(bind_tasks[retry_from:], bind_hosts[retry_from:]),
                    start=retry_from):
                try:
                    binder.bind(task.pod, host)
                except Exception:
                    cache.resync_task(task)
                    failed_binds.add(k)
        if cache.store is not None:
            event_keys, event_hosts, event_tasks = (
                bind_keys, bind_hosts, bind_tasks)
            if failed_binds:
                event_keys = [k for i, k in enumerate(bind_keys)
                              if i not in failed_binds]
                event_hosts = [h for i, h in enumerate(bind_hosts)
                               if i not in failed_binds]
                event_tasks = [t for i, t in enumerate(bind_tasks)
                               if i not in failed_binds]
            record_scheduled = getattr(cache.store, "record_scheduled", None)
            if record_scheduled is not None:
                # lazy batch record: the Scheduled message materializes on
                # read, not on the session's critical path (the reference
                # recorder is an async broadcaster — cache.go:601-611)
                record_scheduled(event_keys, event_hosts)
            else:
                cache.store.record_events(
                    (task.pod, "Normal", "Scheduled",
                     f"Successfully assigned "
                     f"{task.namespace}/{task.name} to {host}")
                    for task, host in zip(event_tasks, event_hosts))

        if enc.spec.use_exclusion:
            # device-placed exclusion-group pods carry required
            # anti-affinity: later serial phases (residue, backfill,
            # preempt) must see them in the predicates plugin's resident
            # index, which the bulk writeback's event bypass would miss
            pred = ssn.plugins.get("predicates")
            note = getattr(pred, "note_resident", None)
            if note is not None:
                from volcano_tpu_torch.api.pod_traits import has_pod_affinity

                for task in bind_tasks:
                    if task.pod is not None and has_pod_affinity(task.pod):
                        note(task)

        self.profile["apply_bind_s"] = time.perf_counter() - prof_t2
        prof_t3 = time.perf_counter()

        # --- bulk plugin share updates (drf / proportion) -----------------
        # per-job DRF shares must be exact per job; namespace/queue shares
        # aggregate across jobs, so accumulate the deltas in numpy and touch
        # each namespace/queue attr once
        drf = ssn.plugins.get("drf")
        prop = ssn.plugins.get("proportion")
        if drf is not None:
            fast_drf = getattr(mod, "update_drf_shares", None) \
                if mod is not None else None
            if fast_drf is not None:
                attrs = [drf.job_attrs.get(job_infos[ji].uid)
                         for ji in job_nz]
                tnames = tuple(drf.total_resource.resource_names())
                tvals = np.array([drf.total_resource.get(n) for n in tnames])
                fast_drf(np.asarray(job_nz, np.int64),
                         np.ascontiguousarray(job_sums),
                         attrs, tnames, tvals, tuple(scalar_names))
            else:
                job_sums_rows = job_sums_l if fast_all is None else \
                    job_sums.tolist()
                for ji in job_nz:
                    job = job_infos[ji]
                    attr = drf.job_attrs.get(job.uid)
                    if attr is not None:
                        apply_delta(attr.allocated, job_sums_rows[ji], +1.0)
                        drf._update_share(attr)
        if (drf is not None and drf.namespace_opts) or prop is not None:
            ns_count_enc = int(a["ns_active0"].shape[0])
            q_count_enc = int(a["queue_deserved"].shape[0])
            ns_sums = np.zeros((ns_count_enc, job_sums.shape[1]))
            q_sums = np.zeros((q_count_enc, job_sums.shape[1]))
            np.add.at(ns_sums, a["job_ns"][job_nz], job_sums[job_nz])
            np.add.at(q_sums, a["job_queue"][job_nz], job_sums[job_nz])
            ns_sums_l = ns_sums.tolist()
            q_sums_l = q_sums.tolist()
            if drf is not None and drf.namespace_opts:
                for nsi in np.nonzero(ns_sums.any(axis=1))[0].tolist():
                    ns_opt = drf.namespace_opts.get(enc.ns_names[nsi])
                    if ns_opt is not None:
                        apply_delta(ns_opt.allocated, ns_sums_l[nsi], +1.0)
                        drf._update_share(ns_opt)
            if prop is not None:
                for qi in np.nonzero(q_sums.any(axis=1))[0].tolist():
                    attr = prop.queue_opts.get(enc.queue_uids[qi])
                    if attr is not None:
                        apply_delta(attr.allocated, q_sums_l[qi], +1.0)
                        prop._update_share(attr)

        # --- fit errors for gangs the solve could not complete ------------
        start, count = a["job_task_start"], a["job_task_count"]
        job_residue = enc.job_residue
        for ji in np.nonzero(job_placed_n < count)[0].tolist():
            job = job_infos[ji]
            lo, hi = int(start[ji]), int(start[ji]) + int(count[ji])
            if lo == hi or job.ready():
                continue
            if (job_residue is not None and job_residue[ji]) or enc.has_releasing:
                # the serial pass retries this job (residue tasks, or
                # releasing capacity it may pipeline onto) with full
                # predicate fidelity; it records its own fit errors —
                # mirror allocate.py's retry condition so no stale
                # '0/N nodes' error outlives a successful retry
                continue
            first = lo + int(np.argmax(assign[lo:hi] < 0))
            fe = FitErrors()
            fe.set_error(
                "0/%d nodes are available in the batched "
                "feasibility/fit solve" % n_count)
            job.nodes_fit_errors[task_infos[first].uid] = fe
        self.profile["apply_post_s"] = time.perf_counter() - prof_t3


