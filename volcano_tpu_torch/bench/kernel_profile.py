"""Where a kernel's time goes: K7b, K9, K10, K11, K13, K14 or K15, phase by phase,
on the card; and, with ``--kernel k7``, where a warm graph round of the
rounds solve spends it, node group by node group (bench/round_split.py).

Builds the kernel's source with its profile flag (``-DK7B_PROFILE``,
``-DK9_PROFILE``, ``-DK10_PROFILE``, ``-DK11_PROFILE``, ``-DK13_PROFILE``,
``-DK14_PROFILE`` or ``-DK15_PROFILE``), which turns the kernel's PROF(k)
marks into clock64() reads at the thread that runs its control machine
(CTA 0 thread 0; K7b's, K11's, K13's and K15's block thread 0; K14's walk
CTA 0 thread 0), takes the kernel's
inputs from a session on the card (float32), runs them through that build
and prints each phase's share of the kernel's time and microseconds a unit
of work:

- k7b: the tail pass of cfg6's capped solve (full scale, the host-driven
  machine's tail inputs, as chip_smoke.py's K7 phase records them); a
  step. Its lines add the kernel's device span (globaltimer marks), to
  which its phases are scaled; every call starts from the recorded state;
- k9: the preempt machine of a per-action cfg4 session; a walk;
- k11: the backfill placements of a per-action cfg4 session (the shared
  placement) and bench/backfill_cases.py's N = 40,000, S = 64 case (the
  global one); a task. Its lines add the kernel's device span
  (globaltimer marks), to which its phases are scaled;
- k10: the reclaim machine of a per-action reclaim-path session
  (``bench/reclaim_path.py``); a candidate fold (one walk iteration);
- k13: both heap rebuilds (preempt, reclaim) of a fused cfg4 session; a
  push; its lines add the wrapper's host time a call and the kernel's
  device span (globaltimer marks), to which its phases are scaled;
- k14: the express placement of a cfg5 lane's 1-task batch and of a full
  64-task batch; a valid task step. Its lines also split the call: the
  wrapper's host time a call (20 calls, no sync between), the window
  kernel's and the walk's device spans and the idle gap between them
  (globaltimer marks), the walk's phases scaled to its span;
- k15: the parity scan of a cfg5 (or ``--config 2``) parity session; a
  task step.

A phase ends at its mark, so a barrier's wait is the time the marking
thread spent in it. K10's, K13's, K14's and K15's builds also count their
units. A last line a case times the same calls on the kernel's own build
(``unmarked_ms``, CUDA events over 5 back-to-back calls).

On a machine with an NVIDIA GPU:

    python -m volcano_tpu_torch.bench.kernel_profile --kernel k10 [--scale 1.0]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from typing import NamedTuple, Tuple

import torch


class Kernel(NamedTuple):
    source: str        # csrc/<source>.cu
    flag: str          # the profile build's define
    read: str          # the C function that copies the counters out
    unit: str          # what a unit of the kernel's work is
    counts_units: bool  # the counters end with the units' count
    phases: Tuple[Tuple[str, str], ...]  # PROF(k)'s phase k, in order of k
    spans: int = 0      # globaltimer marks after the counters (ns)


KERNELS = {
    "k7b": Kernel("tail_pass", "K7B_PROFILE", "k7b_profile_read", "step", True, (
        ("setup", "the pass's start: staging and the per-job cursors"),
        ("gate", "step: the overused gate"),
        ("select", "step: the task select and its reduction"),
        ("sweep", "step: the node sweep and its reduction"),
        ("commit", "step: the commit and its barrier"),
    ), 2),
    "k9": Kernel("evict_preempt", "K9_PROFILE", "k9_profile_read", "walk", False, (
        ("loop", "the machine loop's own work"),
        ("window_scan", "window: eligibility and the block scan"),
        ("window_barrier1", "window: cluster barrier after the scan"),
        ("window_select", "window: offsets, counts, scores, list entries"),
        ("window_barrier2", "window: cluster barrier after the list"),
        ("fold", "iteration: CTA 0 thread 0's folds"),
        ("block_best", "iteration: CTA 0's best (waits for its slowest warp)"),
        ("barrier_best", "iteration: cluster barrier after the bests"),
        ("visited", "iteration: the cluster's best, visited sums"),
        ("barrier_visited", "iteration: cluster barrier after the sums"),
        ("control", "decide: control steps after the last heap operation"),
        ("barrier_cmd", "cluster barrier after CTA 0's order"),
        ("pipeline", "decide: the pipeline of a covered cut"),
        ("post_walk", "decide: the walk's end (commit mark, mode)"),
        ("control_heap_prep", "decide: control steps before a heap operation"),
        ("heap_pop", "decide: job heap pops"),
        ("heap_push", "decide: job heap pushes"),
        ("cut", "decide: the eviction cut"),
    )),
    "k10": Kernel("evict_reclaim", "K10_PROFILE", "k10_profile_read", "fold", True, (
        ("loop", "the machine loop's own work and its barriers"),
        ("heap", "the queue and job heap pops and the queue re-push"),
        ("elig", "a walk's eligibility pass"),
        ("fold", "the marking thread's own victim folds"),
        ("reduce", "the first qualifying node: reductions and their barriers"),
        ("visited", "the visited nodes' underflow"),
        ("cut", "the eviction cut and the pipeline"),
        ("barrier", "the iteration's closing barriers"),
    )),
    "k11": Kernel("evict_backfill", "K11_PROFILE", "k11_profile_read", "task", True, (
        ("setup", "the bitsets, headroom, room bits, first nodes and cursors"),
        ("read", "32 tasks: their columns and ballots, the assign store"),
        ("cursor", "a run's cursor word (a ballot past spent words), a single's node"),
        ("commit", "a run's scan, search and headroom; a single's headroom"),
    ), 2),
    "k13": Kernel("fuse_heaps", "K13_PROFILE", "k13_profile_read", "push", True, (
        ("zero", "the outputs zeroed, the evictions counted (reclaim)"),
        ("slots", "the slot pass: decisions, compaction, keys"),
        ("pushes", "the heap pushes"),
        ("out", "the heaps written out"),
    ), 2),
    "k14": Kernel("express_place", "K14_PROFILE", "k14_profile_read", "step", True, (
        ("copy", "the walk's start: state set up"),
        ("window", "step: the window columns rescored, coverage"),
        ("sweep", "step: a full-width sweep and its reduction"),
        ("apply", "step: the placement and the step's barrier"),
        ("strip", "the gang strip and the packed result"),
    ), 4),
    "k15": Kernel("parity_scan", "K15_PROFILE", "k15_profile_read", "step", True, (
        ("loop", "the visit loop's head (any namespace left)"),
        ("ns_argmin", "visit: the namespace argmin"),
        ("queue_argmin", "visit: the overused purge and the queue argmin"),
        ("job_argmin", "visit: the job argmin"),
        ("sweep", "step: the node sweep (feasibility, counts, scores)"),
        ("best", "step: the arg-max over the block"),
        ("place", "step: the placement and its barrier"),
        ("commit", "visit: the gang commit or the roll back"),
    )),
}


def build_command(kernel: str, out: str) -> list:
    """nvcc's command for the profiling build of ``kernel`` into ``out``:
    the kernels' own flags and source, with the kernel's flag defined."""
    from volcano_tpu_torch import _build

    k = KERNELS[kernel]
    return [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-D{k.flag}", "-o", out,
            os.path.join(_build.CSRC, k.source + ".cu")]


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    return out.splitlines()[0]


def _capture_evict(kind: str, build):
    """The ``kind`` machine's (spec, inputs) of a per-action session on the
    card, float32: ``build()`` gives (cache, tier names, actions)."""
    from volcano_tpu_torch.bench.clusters import make_tiers
    from volcano_tpu_torch.ops import evict_kernels as EK
    from volcano_tpu_torch.scheduler.framework import (
        close_session, open_session, run_actions)
    import volcano_tpu_torch.scheduler.actions  # noqa: F401
    import volcano_tpu_torch.scheduler.plugins  # noqa: F401

    seen = {}
    real = EK.solve_packed

    def keep(spec, enc):
        if spec.kind == kind and kind not in seen:
            seen[kind] = (spec, {k: v.clone() for k, v in enc.items()})
        return real(spec, enc)

    prev = os.environ.get("VOLCANO_TPU_FUSE")
    os.environ["VOLCANO_TPU_FUSE"] = "0"
    EK.solve_packed = keep
    try:
        cache, tiers, actions = build()
        ssn = open_session(cache, make_tiers(["tpuscore"], *tiers, arguments={
            "tpuscore": {"tpuscore.mode": "rounds", "tpuscore.device": "cuda",
                         "tpuscore.dtype": "float32"}}))
        try:
            run_actions(ssn, list(actions))
        finally:
            close_session(ssn)
    finally:
        EK.solve_packed = real
        if prev is None:
            os.environ.pop("VOLCANO_TPU_FUSE", None)
        else:
            os.environ["VOLCANO_TPU_FUSE"] = prev
    if kind not in seen:
        raise RuntimeError(f"kernel_profile: the session never ran the {kind} machine")
    return seen[kind]


def evict_inputs(kernel: str, scale: float):
    if kernel == "k9":
        from volcano_tpu_torch.bench.clusters import CONFIGS, build_config

        def build():
            cache, _, _, actions, _ = build_config(4, scale)
            return cache, CONFIGS[4].tiers, actions

        return _capture_evict("preempt", build)
    from volcano_tpu_torch.bench.reclaim_path import (
        EVICT_ACTIONS, RECLAIM_TIERS, reclaim_path_cluster)

    return _capture_evict("reclaim", lambda: (
        reclaim_path_cluster(scale)[0], RECLAIM_TIERS, EVICT_ACTIONS))


def backfill_cases_inputs(scale: float):
    """K11's [(label, spec, enc)]: a per-action cfg4 session's call and
    bench/backfill_cases.py's N = 40,000, S = 64 case, on the card."""
    from volcano_tpu_torch.bench import backfill_cases
    from volcano_tpu_torch.bench.clusters import CONFIGS, build_config

    def build():
        cache, _, _, actions, _ = build_config(4, scale)
        return cache, CONFIGS[4].tiers, actions

    spec, enc = _capture_evict("backfill", build)
    out = [("cfg4", spec, enc)]
    for name, check_pod, arrays in backfill_cases.cases():
        if name == "N=40000 S=64":
            out.append((name, backfill_cases.spec(check_pod),
                        {k: torch.from_numpy(v).cuda() for k, v in arrays.items()}))
    return out


def parity_inputs(cfg: int, scale: float):
    """K15's (spec, inputs, rr0, num_to_find) of a parity session of bench
    config ``cfg`` on the card, float32."""
    from volcano_tpu_torch.bench import parity_cases
    from volcano_tpu_torch.bench.clusters import CONFIGS, build_config

    cache, _, _, _, _ = build_config(cfg, scale)
    return parity_cases.parity_inputs(cache, CONFIGS[cfg].tiers)


def fused_heap_inputs(scale: float):
    """K13's calls of a fused cfg4 session on the card, float32:
    {kind: (kind, spec, enc, st, args, kwargs)} for preempt and reclaim."""
    from volcano_tpu_torch.bench.clusters import CONFIGS, build_config, make_tiers
    from volcano_tpu_torch.ops import evict_kernels as EK
    from volcano_tpu_torch.scheduler.framework import (
        close_session, open_session, run_actions)
    import volcano_tpu_torch.scheduler.actions  # noqa: F401
    import volcano_tpu_torch.scheduler.plugins  # noqa: F401

    seen = {}
    real = EK.fuse_heaps

    def clone(d):
        return {k: v.clone() for k, v in d.items()}

    def keep(kind, spec, enc, st, *args, **kw):
        seen.setdefault(kind, (kind, spec, clone(enc), clone(st), args, kw))
        return real(kind, spec, enc, st, *args, **kw)

    prev = os.environ.get("VOLCANO_TPU_FUSE")
    os.environ["VOLCANO_TPU_FUSE"] = "1"
    EK.fuse_heaps = keep
    try:
        cache, _, _, actions, _ = build_config(4, scale)
        ssn = open_session(cache, make_tiers(["tpuscore"], *CONFIGS[4].tiers, arguments={
            "tpuscore": {"tpuscore.mode": "rounds", "tpuscore.device": "cuda",
                         "tpuscore.dtype": "float32"}}))
        try:
            run_actions(ssn, list(actions))
        finally:
            close_session(ssn)
    finally:
        EK.fuse_heaps = real
        if prev is None:
            os.environ.pop("VOLCANO_TPU_FUSE", None)
        else:
            os.environ["VOLCANO_TPU_FUSE"] = prev
    if sorted(seen) != ["preempt", "reclaim"]:
        raise RuntimeError(f"kernel_profile: the fused session ran K13 for {sorted(seen)}")
    return seen


def express_inputs(scale: float):
    """K14's (spec, args) of a cfg5 express lane on the card, float32: the
    batch of one arrival (tb = 16) and a full batch of 64 (tb = 64)."""
    from volcano_tpu_torch.api import objects
    from volcano_tpu_torch.bench.clusters import CONFIGS, build_config, make_tiers
    from volcano_tpu_torch.express import ExpressLane
    from volcano_tpu_torch.express import place as place_mod
    from volcano_tpu_torch.scheduler.framework import (
        close_session, open_session, run_actions)
    from volcano_tpu_torch.scheduler.util.test_utils import build_pod, build_pod_group
    import volcano_tpu_torch.scheduler.actions  # noqa: F401
    import volcano_tpu_torch.scheduler.plugins  # noqa: F401

    cache, _, _, actions, _ = build_config(5, scale)
    ssn = open_session(cache, make_tiers(["tpuscore"], *CONFIGS[5].tiers, arguments={
        "tpuscore": {"tpuscore.mode": "rounds", "tpuscore.device": "cuda",
                     "tpuscore.dtype": "float32"}}))
    try:
        run_actions(ssn, list(actions))
    finally:
        close_session(ssn)
    lane = ExpressLane(cache, device="cuda", dtype="float32")
    lane.run_once()
    seen = {}
    real = place_mod.solve_express

    def keep(spec, *args):
        seen.setdefault(spec.tb, (spec, [a.clone() for a in args]))
        return real(spec, *args)

    place_mod.solve_express = keep
    try:
        for n in (1, place_mod.EXPRESS_MAX_BATCH):
            for i in range(n):
                pg = f"prof-{n}-{i:03d}"
                cache.add_pod_group(build_pod_group(pg, namespace="express", min_member=1))
                cache.add_pod(build_pod("express", f"{pg}-t0", "", objects.POD_PHASE_PENDING,
                                        {"cpu": "100m", "memory": "128Mi"}, pg))
            lane.run_once()
    finally:
        place_mod.solve_express = real
    if sorted(seen) != [16, 64]:
        raise RuntimeError(f"kernel_profile: the lane's batches had tb {sorted(seen)}")
    return seen[16], seen[64]


def tail_inputs(cfg: int = 6, scale: float = 1.0):
    """K7b's (spec, enc, state, ctl) as the host-driven machine hands them
    to the tail of bench config ``cfg``'s allocate solve on the card,
    float32 (cfg6 caps at full scale)."""
    from volcano_tpu_torch.bench.clusters import CONFIGS, build_config, make_tiers
    from volcano_tpu_torch.ops import rounds, rounds_kernels as RK
    from volcano_tpu_torch.scheduler.framework import close_session, open_session
    import volcano_tpu_torch.scheduler.actions  # noqa: F401
    import volcano_tpu_torch.scheduler.plugins  # noqa: F401

    cache, *_ = build_config(cfg, scale)
    ssn = open_session(cache, make_tiers(["tpuscore"], *CONFIGS[cfg].tiers, arguments={
        "tpuscore": {"tpuscore.mode": "rounds", "tpuscore.device": "cuda",
                     "tpuscore.dtype": "float32"}}))
    try:
        prep = ssn.batch_allocator._prepare(ssn)
    finally:
        close_session(ssn)
    seen = {}
    real = RK.tail_pass_plain

    def keep(spec, enc, st, ctl):
        seen.setdefault("tail", (spec, dict(enc), {k: v.clone() for k, v in st.items()},
                                 ctl.clone()))
        return real(spec, enc, st, ctl)

    RK.tail_pass_plain = keep
    try:
        rounds.solve(prep["spec"], prep["staged"], loop="host")
    finally:
        RK.tail_pass_plain = real
    if "tail" not in seen:
        raise RuntimeError(f"kernel_profile: cfg{cfg}'s solve never reached the tail")
    return seen["tail"]


def _cases(kernel: str, args):
    """[(label, shape dict, run, reset)] of ``kernel``: the calls to
    profile; ``reset`` (or None) restores the state a call updates in
    place, off the clock."""
    if kernel == "k7b":
        from volcano_tpu_torch.ops import rounds_kernels as RK

        spec, enc, st0, ctl0 = tail_inputs(6, args.scale)
        st = {k: v.clone() for k, v in st0.items()}
        ctl = ctl0.clone()

        def reset():
            for k, v in st0.items():
                st[k].copy_(v)
            ctl.copy_(ctl0)

        N, R = st0["idle"].shape
        shape = {"config": 6, "T": enc["task_cls"].shape[0], "N": N, "R": R,
                 "J": enc["job_tie_rank"].shape[0], "Q": enc["queue_deserved"].shape[0],
                 "active": int(st0["active"].sum()), "budget": RK.tail_budget(spec)}
        return [("tail", shape, lambda: RK.tail_pass(spec, enc, st, ctl), reset)]
    if kernel == "k11":
        from volcano_tpu_torch.ops import evict_kernels as EK

        cases = []
        for label, spec, enc in backfill_cases_inputs(args.scale):
            s_rows, n = enc["sig_mask"].shape
            t_total = enc["b_sig"].shape[0]
            shape = {"T": t_total, "S": s_rows, "N": n,
                     "placement": EK.backfill_placement(n, s_rows, t_total)}
            # no state to restore: the graph replay times the unmarked launch
            cases.append((label, shape, lambda spec=spec, enc=enc: EK.backfill(spec, enc),
                          lambda: None))
        return cases
    if kernel == "k15":
        from volcano_tpu_torch.ops import parity_kernels as PK

        spec, enc, rr0, ntf = parity_inputs(args.config, args.scale)
        shape = {"config": args.config, "T": enc["task_req"].shape[0],
                 "N": enc["node_idle"].shape[0], "J": enc["job_task_start"].shape[0],
                 "ntf": ntf}
        return [("parity", shape, lambda: PK._solve_cuda(spec, enc, rr0, ntf), None)]
    if kernel == "k13":
        from volcano_tpu_torch.ops import evict_kernels as EK

        cases = []
        for kind, (_, spec, enc, st, a, kw) in sorted(fused_heap_inputs(args.scale).items()):
            slots = enc["f_push_jobs" if kind == "preempt" else "f_ev_jobs"].shape[0]
            shape = {"J": enc["job_prio"].shape[0], "rows": a[0], "jcap": a[1],
                     "slots": slots}
            cases.append((kind, shape, lambda kind=kind, spec=spec, enc=enc, st=st, a=a, kw=kw:
                           EK.fuse_heaps(kind, spec, enc, st, *a, **kw), None))
        return cases
    if kernel == "k14":
        from volcano_tpu_torch.express import place as P

        cases = []
        for label, (spec, a) in zip(("1-task", "64-task"), express_inputs(args.scale)):
            shape = {"N": a[0].shape[0], "tb": spec.tb, "W": spec.window_k,
                     "valid": int(a[9].sum())}
            cases.append((label, shape, lambda spec=spec, a=a: P.solve_express(spec, *a), None))
        return cases
    from volcano_tpu_torch.ops import evict_kernels as EK

    spec, enc = evict_inputs(kernel, args.scale)
    n, v = enc["vic_job"].shape
    shape = {"N": n, "V": v}
    if kernel == "k9":
        cluster, smem, spill = EK.preempt_layout(n, v, enc["node_used"].dtype)
    else:
        cluster, smem, spill = EK.reclaim_layout(n, v, enc["node_used"].dtype)
    shape.update(cluster=cluster, smem=smem, spill=spill)
    return [(kernel, shape, lambda: EK.solve_packed(spec, enc), None)]


def replay_ms(run, reset, reps: int = 5) -> list:
    """Device ms of ``run`` (one call that updates state in place),
    captured once in a CUDA graph and replayed ``reps`` times, ``reset``
    putting the state back before each replay, CUDA events around the
    replay alone: the device's time without the wrapper's host work."""
    reset()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        with torch.cuda.graph(graph, stream=stream):
            run()
    torch.cuda.current_stream().wait_stream(stream)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        reset()
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def _host_ms(run, reps=20) -> float:
    """The wrapper's host time a call: ``reps`` calls with no sync between
    (the card runs behind), then one sync outside the clock."""
    import time

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS) + ["k7"], default="k9")
    ap.add_argument("--scale", type=float, default=1.0, help="the cluster's scale")
    ap.add_argument("--config", type=int, default=5, help="k15: the parity session's bench config")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_profile: no CUDA device is available", file=sys.stderr)
        return 2
    if args.kernel == "k7":
        from volcano_tpu_torch.bench import round_split

        return round_split.main(args.scale)
    from volcano_tpu_torch import _build

    k = KERNELS[args.kernel]
    cases = _cases(args.kernel, args)
    os.makedirs(_build.BUILD, exist_ok=True)
    so = os.path.join(_build.BUILD, f"lib{args.kernel}_profile.so")
    subprocess.run(build_command(args.kernel, so), check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    fn = getattr(lib, k.read)
    fn.argtypes = [ctypes.c_void_p]
    spans = k.spans
    slots = len(k.phases) + (1 if k.counts_units else 0)
    real = _build.library
    _build.library = lambda name: lib if name == k.source else real(name)
    try:
        for label, shape, run, reset in cases:
            run()                                        # warm-up
            host_ms = _host_ms(run) if spans and reset is None else None
            if reset is not None:
                reset()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = run()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
            cycles = (ctypes.c_longlong * (slots + spans))()
            if fn(cycles) != 0:
                raise RuntimeError("kernel_profile: reading the counters failed")
            phase_cycles = list(cycles)[:len(k.phases)]
            # K9: its walks are the tail's attempts (one a walk at cfg4)
            units = max(int(cycles[slots - 1]) if k.counts_units else int(out[-3]), 1)
            total = max(sum(phase_cycles), 1)
            extra = {}
            span_ms = ms
            marks = [int(x) for x in list(cycles)[slots:]]
            if spans == 4:     # K14: the window launch, then the walk
                w0, w1, k0, k1 = marks
                has_window = shape["W"] > 0
                span_ms = (k1 - k0) * 1e-6
                extra = {"host_ms_a_call": host_ms,
                         "window_ms": (w1 - w0) * 1e-6 if has_window else None,
                         "gap_ms": (k0 - w1) * 1e-6 if has_window else None,
                         "walk_ms": span_ms}
            elif spans == 2:   # the kernel's own start and end
                span_ms = (marks[1] - marks[0]) * 1e-6
                extra = {"host_ms_a_call": host_ms, "kernel_ms": span_ms}
            per = f"us_a_{k.unit}"
            rows = {name: {"share": c / total, per: span_ms * 1e3 * c / total / units}
                    for (name, _), c in zip(k.phases, phase_cycles)}
            print(json.dumps({"kernel_profile": args.kernel, "case": label,
                              "card": smi_line(), "scale": args.scale, **shape,
                              "ms": ms, f"{k.unit}s": units, per: span_ms * 1e3 / units,
                              **extra, "phases": rows}), flush=True)
            for name, what in k.phases:
                print(f"{name:18s} {rows[name][per]:8.3f} us a {k.unit}  {what}")
    finally:
        _build.library = real
    # the same calls on the kernels' own build (no marks): CUDA events over
    # back-to-back calls, as chip_smoke.py times them (one call replayed
    # in a graph where each starts from the recorded state)
    for label, _, run, reset in cases:
        run()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if reset is None:
            start.record()
            for _ in range(5):
                run()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / 5
        else:
            reps = replay_ms(run, reset)
            ms = sum(reps) / len(reps)
        print(json.dumps({"kernel_profile": args.kernel, "case": label, "unmarked_ms": ms}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
