"""Whole-session fused dispatch: one device chain per session, on PyTorch
and CUDA.

Port of volcano_tpu/ops/session_fuse.py. The cfg4 overcommit chain
(allocate, backfill, preempt, reclaim) pays, action by action, an encode,
an upload, a dispatch, a blocking fetch and a host apply, and each action
re-encodes session state the stage before it already knew on the device.
Here the chain runs as one:

- every stage is encoded up front from the pre-action snapshot and staged
  on the device before the first launch; stage N+1 takes stage N's carry
  (node used/cnt, job ready/wait/alloc, queue alloc, the consumed-candidate
  skip mask, the victim alive mask) as tensors that stay on the card;
- the parts of an action's encode that depend on earlier actions' results
  (which jobs still have pending tasks, the initial job and queue heaps
  under post-allocate drf/gang keys, post-preempt gang validity) are
  rebuilt on the device from the static iteration orders of the fused
  encode (ops/evict.py ``fused=True``): the live-task maps and carry
  bridges as torch ops, the heaps by K13 (csrc/fuse_heaps.cu), all in
  ops/evict_kernels.py. Fused == per-action holds bit for bit for
  integral milli-cpu/byte quantities: the bridges' scatter-adds are exact
  in any order only for exact sums;
- the host fetches each stage's packed result in stage order and replays
  it through the real Statement/session mutators, while the card still
  runs the later stages: each fetch starts right after its stage's launch
  (one stream runs copies in launch order), and only the waits block.

The allocate stage (the rounds solve, K7) is one graph replay on the
card (ops/rounds_graph.py) and its carry bridge reads the solve's assign
there, so ``_fuse_alloc`` returns without a readback; backfill, preempt
and reclaim are launched right behind it, and the allocate apply and the
backfill replay overlap K13, K9 and K10 on the card.

Fallback contract (the reference's): ``VOLCANO_TPU_FUSE=0`` forces the
per-action path; out-of-envelope sessions (residue, releasing capacity,
exclusion groups, scalar resource dims, job-valid plugins other than gang,
an evict encode that is unsupported or trivial, allocate not in packed
rounds mode) never fuse and record ``fuse_fallback``; a mid-chain
validation failure (the allocate residue retry, a stage's step/log budget)
applies every stage up to the failure and runs the remaining actions
per-action, so nothing of an invalidated stage is applied. A build or
launch failure raises.

Trimmed from the reference: the mesh staging (``_pack_staged``,
``_stage``; staging is ``solver.from_numpy_encoded``), the adoption of a
preempt-terminal chain's carry into the device replica (``_offer_carry``:
the reference's adopted carry holds preempt's pipelined requests and
skips node rows the chain placed on, so its next session diverges from
replica-off; the replica here scatters every changed row instead), and
the ``except Exception`` that turned a dispatch error into a per-action
run.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from volcano_tpu_torch.ops import evict_kernels as ek
from volcano_tpu_torch.ops import rounds as rounds_mod

# the fusable chain grammar: "allocate" then a subsequence of _EVICT_ORDER
# containing "preempt" (the evict encode anchors every bridge axis)
_EVICT_ORDER = ("backfill", "preempt", "reclaim")


# ---------------------------------------------------------------------------
# device stages
# ---------------------------------------------------------------------------


def _fuse_alloc(spec, enc, maps, sizes):
    """Stage 1: the allocate rounds (ops/rounds.py) plus the carry bridge,
    the per-evict-axis deltas of everything the allocate apply will change
    on the host. ``sizes`` is (nodes, jobs, queues, tasks) of the evict
    axes. Returns (packed result, carry)."""
    raw, packed = rounds_mod.solve(spec, enc)
    return packed, ek.alloc_bridge(enc, maps, raw[0], sizes)


def _fuse_backfill(spec, enc, maps, carry):
    """Stage 2: backfill's placements (K11) under the post-allocate pod
    counts, skipping the candidates allocate consumed. Zero-request
    placements move cnt, ready and skip only. Returns (assign, carry)."""
    tc = carry["skip"].shape[0]
    b2c = maps["b2cand"]
    taken = carry["skip"][torch.clamp(b2c, 0, tc - 1).long()] & (b2c >= 0)
    enc2 = dict(enc, node_cnt=enc["node_cnt"] + carry["cnt_add"],
                b_real=enc["b_real"] & ~taken)
    assign = ek.backfill(spec, enc2)
    return assign, ek.backfill_bridge(carry, maps, assign)


def _fuse_preempt(spec, enc, carry, sizes):
    """Stage 3: the preempt machine (K9) from the carry-bridged
    post-allocate state, its initial job heaps and under-request list
    rebuilt by K13 under the current drf/gang keys. ``sizes`` is (heap
    rows, heap width). Returns (packed op log, full-state carry)."""
    qp, jcap = sizes
    skip = carry["skip"]
    p_next = ek.live_next(~skip)
    zero = torch.zeros((), dtype=enc["job_alloc0"].dtype,
                       device=skip.device)
    ready = enc["job_ready0"] + carry["ready_add"]
    job_alloc = enc["job_alloc0"] + torch.where(
        enc["f_job_attr"][:, None], carry["alloc_add"], zero)
    queue_alloc = enc["queue_alloc0"] + torch.where(
        enc["queue_has_attr"][:, None], carry["qalloc_add"], zero)
    heaps = ek.fuse_heaps(
        "preempt", spec, enc,
        dict(live_job=ek.live_job_mask(enc, p_next), ready=ready,
             job_alloc=job_alloc), qp, jcap)
    enc2 = dict(
        enc, node_used=enc["node_used"] + carry["used_add"],
        node_cnt=enc["node_cnt"] + carry["cnt_add"], job_ready0=ready,
        job_alloc0=job_alloc, queue_alloc0=queue_alloc, p_next=p_next,
        heap0=heaps["heap"], hsize0=heaps["hsize"],
        under_jobs=heaps["under_jobs"], p_done0=skip)
    return ek.preempt_fused(spec, enc2)


def _fuse_reclaim(spec, enc, carry, sizes, use_gang_valid: bool):
    """Stage 4: the reclaim machine (K10) from the post-preempt carry. Job
    validity is re-derived on the device (valid_task_num falls only by
    evictions), and K13 rebuilds the queue and job heaps in the serial
    registration order under the carried proportion/drf keys. ``sizes`` is
    (queue rows, heap width, queue heap width). Returns the packed op
    log."""
    qb, jcap, qh = sizes
    skip = carry["skip"]
    p_next = ek.live_next(~skip)
    heaps = ek.fuse_heaps(
        "reclaim", spec, enc,
        dict(live_job=ek.live_job_mask(enc, p_next), ready=carry["ready"],
             job_alloc=carry["job_alloc"], queue_alloc=carry["queue_alloc"],
             alive=carry["alive"]), qb, jcap, qh, use_gang_valid)
    enc2 = dict(
        enc, node_used=carry["used"], node_cnt=carry["cnt"],
        vic_alive0=carry["alive"], job_ready0=carry["ready"],
        job_wait0=carry["wait"], job_alloc0=carry["job_alloc"],
        queue_alloc0=carry["queue_alloc"], p_next=p_next,
        heap0=heaps["heap"], hsize0=heaps["hsize"], qheap0=heaps["qheap"],
        qhsize0=heaps["qhsize"], p_done0=skip,
        rr0=torch.zeros((), dtype=torch.int32, device=skip.device))
    return ek.reclaim_fused(spec, enc2)


# ---------------------------------------------------------------------------
# host driver
# ---------------------------------------------------------------------------


def _split_chain(names: Tuple[str, ...]):
    """(prefix, chain) when names embed a fusable suffix, else None.

    chain = "allocate" + an order-respecting subsequence of
    backfill/preempt/reclaim that contains "preempt"."""
    if "allocate" not in names:
        return None
    i = names.index("allocate")
    prefix, chain = list(names[:i]), list(names[i:])
    rest = chain[1:]
    order = [a for a in _EVICT_ORDER if a in rest]
    if rest != order or "preempt" not in rest:
        return None
    return prefix, chain


def try_run(ssn, names) -> Optional[Dict[str, float]]:
    """Run the session's action chain through the fused dispatcher.

    Returns the per-action timing dict, or None when the quick gates say
    this session cannot fuse at all (the caller then runs the plain
    per-action loop)."""
    if os.environ.get("VOLCANO_TPU_FUSE", "1") == "0":
        return None
    if os.environ.get("VOLCANO_TPU_EVICT", "1") == "0":
        return None
    solver = getattr(ssn, "batch_allocator", None)
    if solver is None or solver.mode not in ("rounds", "auto"):
        return None
    split = _split_chain(tuple(names))
    if split is None:
        return None
    prefix, chain = split

    action_ms: Dict[str, float] = {}
    _per_action(ssn, prefix, action_ms)
    _fuse_or_fallback(ssn, chain, action_ms)
    return action_ms


def _per_action(ssn, names: List[str], action_ms: Dict[str, float]) -> None:
    from volcano_tpu_torch.scheduler.framework import get_action

    for name in names:
        t0 = time.perf_counter()
        get_action(name).execute(ssn)
        action_ms[name] = round((time.perf_counter() - t0) * 1e3, 3)


def _note_fuse_fallback(prof: dict, reason: str) -> None:
    """Profile record + process-wide fallback counter."""
    from volcano_tpu_torch.scheduler import metrics

    prof["fuse_fallback"] = reason
    metrics.register_fallback("fuse")


def _fuse_or_fallback(ssn, chain: List[str],
                      action_ms: Dict[str, float]) -> None:
    """Attempt the fused chain; any envelope miss records `fuse_fallback`
    and runs the (remaining) actions per-action."""
    from volcano_tpu_torch.ops import evict as evict_mod

    solver = ssn.batch_allocator
    prof = solver.profile

    t_chain = time.perf_counter()
    prep = solver._prepare(ssn)
    if prep is None:
        # sub-threshold / unknown-plugin / encoder-fallback sessions run
        # the per-action path (allocate's own fallback ladder applies);
        # _prepare already recorded the reason
        _note_fuse_fallback(prof, prof.get(
            "fallback", "allocate not in packed rounds mode"))
        _per_action(ssn, chain, action_ms)
        return
    enc = prep["enc"]
    reason = None
    if enc.residue_count:
        reason = f"{enc.residue_count} residue tasks (serial pass runs " \
                 f"between actions)"
    elif enc.has_releasing:
        reason = "releasing capacity (serial pipeline pass runs " \
                 "between actions)"
    elif enc.spec.use_exclusion:
        reason = "exclusion-group workloads (resident affinity would " \
                 "poison the post-allocate evict views)"
    elif len(enc.resource_names) != 2:
        reason = "scalar resource dimensions not modeled by evict stages"
    elif set(ssn.job_valid_fns) - {"gang"}:
        reason = f"unsupported job-valid plugins: " \
                 f"{sorted(set(ssn.job_valid_fns) - {'gang'})}"
    if reason is None:
        try:
            plan = evict_mod._EvictPlan(ssn, "preempt", fused=True)
            bf = evict_mod._BackfillPlan(ssn, view=plan.view) \
                if "backfill" in chain else None
        except evict_mod._Unsupported as e:
            reason = str(e)
        else:
            if plan.trivial:
                reason = "no pre-action preemptor candidates"
    if reason is not None:
        _note_fuse_fallback(prof, reason)
        _per_action(ssn, chain, action_ms)
        return
    _run_fused(ssn, chain, action_ms, prep, plan, bf, t_chain)


def _build_maps(prep, plan, bf):
    """Host-side index maps between the rounds axes and the evict/backfill
    axes (uid/name joins; every padded slot maps to -1)."""
    enc = prep["enc"]
    staged = prep["staged"]
    tb_r = int(staged["task_cls"].shape[0])
    jb_r = int(staged["job_task_start"].shape[0])
    nb_r = int(staged["node_alloc"].shape[0])

    cand_of = {t.uid: i for i, t in enumerate(plan.p_tasks)}
    r2e_task = np.full(tb_r, -1, np.int32)
    for i, t in enumerate(enc.task_infos):
        r2e_task[i] = cand_of.get(t.uid, -1)
    r2e_job = np.full(jb_r, -1, np.int32)
    for i, job in enumerate(enc.job_infos):
        r2e_job[i] = plan.jidx.get(job.uid, -1)
    node_of = {name: i for i, name in enumerate(plan.node_names)}
    r2e_node = np.full(nb_r, -1, np.int32)
    for i, name in enumerate(enc.node_names):
        r2e_node[i] = node_of.get(name, -1)
    maps = dict(r2e_task=r2e_task, r2e_job=r2e_job, r2e_node=r2e_node,
                e_job_queue=np.asarray(plan.arrays["job_queue"], np.int32))
    bmaps = None
    if bf is not None and not bf.trivial:
        tb_b = int(np.asarray(bf.arrays["b_sig"]).shape[0])
        b2cand = np.full(tb_b, -1, np.int32)
        b_ejob = np.full(tb_b, -1, np.int32)
        for i, t in enumerate(bf.tasks):
            b2cand[i] = cand_of.get(t.uid, -1)
            b_ejob[i] = plan.jidx.get(t.job, -1)
        bmaps = dict(b2cand=b2cand, b_ejob=b_ejob)
    return maps, bmaps


def _timed_wait(prof: dict, stage: str, wait) -> np.ndarray:
    """wait() for a stage's fetch, its blocking time kept per stage."""
    t0 = time.perf_counter()
    out = wait()
    prof.setdefault("fuse_wait_s", {})[stage] = time.perf_counter() - t0
    return out


def _run_fused(ssn, chain, action_ms, prep, plan, bf, t_chain) -> None:
    from volcano_tpu_torch.ops.solver import from_numpy_encoded
    from volcano_tpu_torch.scheduler.actions import allocate as allocate_mod
    from volcano_tpu_torch.scheduler.framework import get_action
    from volcano_tpu_torch.utils import devprof

    solver = ssn.batch_allocator
    prof = solver.profile
    prof["fuse"] = 1
    prof["fuse_stages"] = list(chain)

    # stage every encode before the first launch: a copy from pageable
    # host memory waits for the work already queued on the stream
    t_stage = time.perf_counter()
    dev, dt = solver.device, solver.dtype
    maps, bmaps = _build_maps(prep, plan, bf)
    mstaged = from_numpy_encoded(maps, device=dev, dtype=dt)
    estaged = from_numpy_encoded(plan.arrays, device=dev, dtype=dt)
    do_backfill = bf is not None and not bf.trivial
    if do_backfill:
        bstaged = from_numpy_encoded(bf.arrays, device=dev, dtype=dt)
        bmstaged = from_numpy_encoded(bmaps, device=dev, dtype=dt)
    prof["fuse_stage_s"] = time.perf_counter() - t_stage

    fs = plan.fuse_sizes
    use_gang_valid = "gang" in ssn.job_valid_fns
    with devprof.session(prof):
        # --- launch the whole chain (device-to-device carries); each
        # fetch starts right after its stage, ahead of the later stages
        t_disp = time.perf_counter()
        packed_a, carry = _fuse_alloc(
            prep["spec"], prep["staged"], mstaged,
            (fs["n"], fs["jb"], fs["qb"], fs["tb"]))
        wait_a = devprof.start_fetch(packed_a)
        if do_backfill:
            assign_bf, carry = _fuse_backfill(bf.spec, bstaged, bmstaged,
                                              carry)
            wait_bf = devprof.start_fetch(assign_bf)
        packed_p, carry = _fuse_preempt(plan.spec, estaged, carry,
                                        (fs["qp"], fs["jcap"]))
        wait_p = devprof.start_fetch(packed_p)
        if "reclaim" in chain:
            wait_r = devprof.start_fetch(_fuse_reclaim(
                plan.reclaim_spec, estaged, carry,
                (fs["qb"], fs["jcap"], fs["qh"]), use_gang_valid))
        prof["fuse_dispatch_s"] = time.perf_counter() - t_disp

        # --- stage 1: allocate apply (overlaps the evict stages) ---------
        out_a = _timed_wait(prof, "allocate", wait_a)
        prof["h2d_s"] = prep["h2d_s"]
        prof["dispatch_s"] = time.perf_counter() - t_disp
        assign, meta = solver.parse_packed(out_a)
        solver.apply_packed(ssn, prep, np.asarray(assign), meta)
        needs_residue = bool(prof.get("residue")) or (
            prof.get("has_releasing") and
            prof.get("tasks", 0) > prof.get("placed", 0))
        allocate_mod.finish_batched(ssn, solver)
        action_ms["allocate"] = round(
            (time.perf_counter() - t_chain) * 1e3, 3)
        if needs_residue:
            # the serial residue pass just mutated session state the
            # remaining device stages never saw: their results are invalid
            # — discard them and run the rest per-action (nothing else was
            # applied)
            _note_fuse_fallback(prof, "allocate residue retry invalidated "
                                      "the fused evict stages")
            _per_action(ssn, [n for n in chain if n != "allocate"],
                        action_ms)
            return

        # --- stage 2: backfill replay ------------------------------------
        if "backfill" in chain:
            t0 = time.perf_counter()
            if do_backfill:
                bf.consume(_timed_wait(prof, "backfill", wait_bf),
                           time.perf_counter() - t_disp)
            else:
                prof["evict_backfill"] = {"trivial": True}
            action_ms["backfill"] = round(
                (time.perf_counter() - t0) * 1e3, 3)

        # --- stage 3: preempt op-log replay ------------------------------
        t0 = time.perf_counter()
        out_p = _timed_wait(prof, "preempt", wait_p)
        ok = plan.consume(out_p, time.perf_counter() - t_disp,
                          kind="preempt")
        action_ms["preempt"] = round((time.perf_counter() - t0) * 1e3, 3)
        if not ok:
            # consume recorded the reason and applied nothing; the
            # per-action rerun owns preempt AND reclaim (the fused reclaim
            # took a carry whose preempt half never landed)
            _per_action(ssn, [n for n in chain
                              if n in ("preempt", "reclaim")], action_ms)
            return

        # --- stage 4: reclaim op-log replay ------------------------------
        if "reclaim" in chain:
            t0 = time.perf_counter()
            ok = plan.consume(_timed_wait(prof, "reclaim", wait_r),
                              time.perf_counter() - t_disp, kind="reclaim")
            if not ok:
                get_action("reclaim").execute(ssn)
            action_ms["reclaim"] = round(
                (time.perf_counter() - t0) * 1e3, 3)
