"""The port's benchmark: scheduler-session latency, serial loop vs the GPU solve.

Port of the JAX package's ``bench.py`` (which stays as it is); run it as
``python -m volcano_tpu_torch.bench``. Same modes, flags, record keys and
JSON lines, so the two records can be diffed key by key (the device arm
keeps the reference's ``tpu_*`` names). It prints a headline JSON line
right after the cfg-5 run and, in the default all-configs mode, a final
combined line, then a compact ``{"summary": ...}`` tail line:

    {"metric": "...", "value": N, "unit": "ms", "vs_baseline": N}

- value: the device arm's END-TO-END session latency (open_session +
  actions + close_session), warm MEDIAN across samples, at the headline
  config (cfg 5: 50k tasks x 10k nodes). Kernel builds and graph captures
  are excluded (the cold session pays them); nothing else is.
- vs_baseline: speedup over the serial loop at the same config on
  matching spans (serial full-session e2e over the device arm's warm
  median e2e). Where the serial loop would take more than
  ``--serial-budget`` seconds, its actions window is measured at a
  reduced scale and extrapolated linearly in tasks x nodes (open/close
  linearly in scale), marked ``"serial_extrapolated": true``.

The record (every config, per-phase and per-action splits, every sample,
the card's name and power limit, which native engines loaded) goes to
``BENCH_torch_local.json`` at the repository root.

``--device`` (default ``cuda``) and ``--dtype`` (default ``float32``) place
the solve (the tpuscore plugin's ``tpuscore.device`` / ``tpuscore.dtype``)
and the express lane; ``--device cpu --dtype float64`` runs the kernels'
plain versions on the host.

``--fanout [N]`` runs the watch fan-out bench alone (N watchers over one
shared journal, host only: it exits before any device is resolved); the
all-configs summary carries it as its ``watch_fanout`` column unless
``--no-fanout``.

Left out, each refused with its ROADMAP.md item: the front-door and storm
columns (each runs the simulator's cluster, ``sim.harness``) and
``--scenario`` (the simulator, item 6), and the bare ``--mesh`` flag (the
mesh, item 7). The all-configs
summary's standing mesh curve runs in-process.

Usage:
    python -m volcano_tpu_torch.bench                # headline (cfg 5, full scale)
    python -m volcano_tpu_torch.bench --config 1 --scale 0.2 --backend both
    python -m volcano_tpu_torch.bench --all --scale 0.05
    python -m volcano_tpu_torch.bench --device cpu --dtype float64 --config 2 --scale 0.02
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RECORD = os.path.join(REPO, "BENCH_torch_local.json")

# flags of the reference bench the port does not run yet, with the
# ROADMAP.md item that owns each
REFUSED = {
    "no_front_door": "the front_door_storm column runs the simulator's "
                     "cluster (ROADMAP.md Queue 1 item 6)",
    "scenario": "scenario clusters come from the simulator "
                "(ROADMAP.md Queue 1 item 6)",
    "no_storm": "the cfg5_storm column needs the simulator "
                "(ROADMAP.md Queue 1 item 6)",
    "storm_scale": "the cfg5_storm column needs the simulator "
                   "(ROADMAP.md Queue 1 item 6)",
    "storm_duration": "the cfg5_storm column needs the simulator "
                      "(ROADMAP.md Queue 1 item 6)",
}
# summary columns of the reference's all-configs tail left out here
LEFT_OUT_COLUMNS = {
    "cfg5_storm": REFUSED["no_storm"],
    "front_door_storm": REFUSED["no_front_door"],
}

_GC_POLICY = None


def device_line(device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them, or ``cpu``."""
    import subprocess

    import torch

    if torch.device(device).type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=30).stdout
        return out.strip().splitlines()[0]
    except Exception:
        return f"{torch.cuda.get_device_name(0)}, power limit not read"


def _tpu_tiers(tier_names, device, dtype, mode=None):
    from volcano_tpu_torch.bench.clusters import make_tiers

    args = {"tpuscore.device": str(device), "tpuscore.dtype": str(dtype)}
    if mode is not None:
        args["tpuscore.mode"] = mode
    return make_tiers(["tpuscore"], *tier_names, arguments={"tpuscore": args})


def _session_once(cache, tiers, actions):
    """Open a session, run the actions, close; returns per-phase timings.

    The measured span is the full production cycle, open_session through
    close_session: what Scheduler.run_once times into its e2e metric. Work
    deferred to close (the cache-mirror flush) is inside the window, and
    the device is drained at both fences, so nothing queued hides outside
    it."""
    import volcano_tpu_torch.scheduler.actions  # noqa: F401 (register actions)
    from volcano_tpu_torch.scheduler.framework import (
        close_session, open_session, run_actions)
    from volcano_tpu_torch.utils import devprof
    from volcano_tpu_torch.utils.compilewatch import CompileWatcher

    if _GC_POLICY is not None:
        _GC_POLICY.maintain()  # between-cycle collection, as in the loop
    win = CompileWatcher.install().window()
    # fence: the timed window must not inherit queued device work from the
    # previous build/session
    devprof.drain()
    devc = {}
    t0 = time.perf_counter()
    ssn = open_session(cache, tiers)
    t_open = time.perf_counter()
    with devprof.session(devc):
        action_ms = run_actions(ssn, actions)
    t_act = time.perf_counter()
    profile = dict(ssn.plugins["tpuscore"].profile) if "tpuscore" in ssn.plugins else {}
    profile.update(devc)  # tpu_sync_points / tpu_d2h_fetches / tpu_overlap_ms
    close_session(ssn)
    devprof.drain()  # e2e ends only when the device is drained
    t_close = time.perf_counter()
    # a warm session with compiles > 0 built a kernel or captured a graph
    cs = win.delta()
    profile["compiles"] = cs.compiles
    profile["compile_s"] = round(cs.compile_s, 3)
    return {
        "open_s": t_open - t0,
        "actions_s": t_act - t_open,
        "close_s": t_close - t_act,
        "e2e_s": t_close - t0,
        "action_ms": action_ms,
        "binds": len(cache.binder.binds),
        "profile": profile,
    }


def native_engines() -> dict:
    """Build the native host engines (blocking) and say which loaded. Done
    BEFORE any timed window, including the serial baseline's, whose
    session transitions also reach for fasttrans: the non-blocking
    accessors fall back to Python while a background cc runs, which would
    bench the wrong implementation."""
    from volcano_tpu_torch import _native

    return {"fastapply": _native.get_fastapply() is not None,
            "fasttrans": _native.get_fasttrans() is not None}


def run_config(cfg: int, scale: float, backend: str,
               serial_budget: float = 30.0, verbose=True,
               warm_iters: int = 5, device="cuda", dtype="float32"):
    import gc

    from volcano_tpu_torch.bench.clusters import CONFIGS, build_config

    warm_iters = max(warm_iters, 1)
    bc = CONFIGS[cfg]
    tpu_tiers = _tpu_tiers(bc.tiers, device, dtype)

    def build(s):
        cache, serial_tiers, _, actions, n_tasks = build_config(cfg, s)
        return cache, serial_tiers, actions, n_tasks

    out = {"config": cfg, "name": bc.name, "scale": scale,
           "native_engines": native_engines(),
           "device": device_line(device)}

    if backend in ("serial", "both", "auto"):
        # estimate serial cost before committing to it: measured at small
        # scale, the serial loop is ~linear in placed-tasks x nodes
        serial_scale = scale
        if backend == "auto" or cfg >= 3:
            probe_scale = min(scale, 0.02)
            cache, st, actions, _ = build(probe_scale)
            t0 = time.perf_counter()
            _session_once(cache, st, actions)
            probe_s = time.perf_counter() - t0
            unit = probe_scale * probe_scale  # tasks*nodes both scale
            est = probe_s / unit * (scale * scale)
            if est > serial_budget:
                serial_scale = max((serial_budget / (probe_s / unit)) ** 0.5, probe_scale)
        cache, serial_tiers, actions, n_tasks = build(serial_scale)
        r = _session_once(cache, serial_tiers, actions)
        serial_s = r["actions_s"]
        open_close_s = r["open_s"] + r["close_s"]
        if serial_scale < scale:
            factor = (scale * scale) / (serial_scale * serial_scale)
            out["serial_measured_scale"] = serial_scale
            out["serial_measured_ms"] = serial_s * 1e3
            serial_s = serial_s * factor
            # open/close walk every object once -> ~linear in scale
            open_close_s = open_close_s * (scale / serial_scale)
            out["serial_extrapolated"] = True
        out["serial_ms"] = serial_s * 1e3
        # full-session serial span, matching tpu_e2e_*
        out["serial_e2e_ms"] = round((serial_s + open_close_s) * 1e3, 3)
        out["serial_binds"] = r["binds"]
        out["serial_open_ms"] = round(r["open_s"] * 1e3, 3)
        out["serial_close_ms"] = round(r["close_s"] * 1e3, 3)
        if verbose:
            print(f"[cfg{cfg}] serial: {out['serial_ms']:.1f} ms "
                  f"({'extrapolated' if out.get('serial_extrapolated') else 'measured'})",
                  file=sys.stderr)

    if backend in ("tpu", "both", "auto"):
        cache, _, actions, n_tasks = build(scale)
        cold = _session_once(cache, tpu_tiers, actions)
        out["tpu_cold_ms"] = cold["actions_s"] * 1e3
        out["tpu_cold_profile"] = cold["profile"]
        # warm: fresh identical clusters, built kernels and captured graphs
        # reused. A median-of-k no-op dispatch+fetch right before each
        # timed sample pins the round-trip floor that sample ran against,
        # with the probe spread recorded beside it
        samples = []        # actions window, ms
        e2e_samples = []    # open + actions + close, ms — the honest span
        floor_samples = []  # per-sample floor (median of k probes)
        floor_spreads = []  # max-min of each sample's floor probes
        floor_notes = []    # per-sample floor cause annotations
        warm = None
        warm_compiles = []
        # one extra warm session whose sample is DISCARDED: the first
        # session after the cold one still pays one-off warm-up (allocator
        # pools, first loads) the steady state never sees
        for it in range(warm_iters + 1):
            del cache
            gc.collect()
            cache, _, actions, n_tasks = build(scale)
            # collect the build's allocation debt BEFORE the timed window
            gc.collect()
            f_med, f_spread, f_note = _measure_floor_ms(device=device)
            w = _session_once(cache, tpu_tiers, actions)
            if it == 0:
                out["tpu_first_warm_ms"] = round(w["e2e_s"] * 1e3, 3)
                out["tpu_first_warm_compiles"] = w["profile"].get("compiles", 0)
                continue
            floor_samples.append(f_med)
            floor_spreads.append(f_spread)
            floor_notes.append(f_note)
            samples.append(w["actions_s"] * 1e3)
            e2e_samples.append(w["e2e_s"] * 1e3)
            warm_compiles.append(w["profile"].get("compiles", 0))
            if warm is None or w["e2e_s"] * 1e3 <= min(e2e_samples):
                warm = w
        out["tpu_ms"] = min(samples)
        out["tpu_warm_median_ms"] = round(statistics.median(samples), 3)
        out["tpu_warm_max_ms"] = round(max(samples), 3)
        out["tpu_warm_samples_ms"] = [round(s, 3) for s in samples]
        out["tpu_e2e_ms"] = round(min(e2e_samples), 3)
        out["tpu_e2e_median_ms"] = round(statistics.median(e2e_samples), 3)
        out["tpu_e2e_samples_ms"] = [round(s, 3) for s in e2e_samples]
        out["tpu_floor_samples_ms"] = floor_samples
        out["tpu_floor_spread_ms"] = floor_spreads
        out["tpu_floor_probe_notes"] = floor_notes
        # phase split of the best-e2e sample
        out["tpu_open_ms"] = round(warm["open_s"] * 1e3, 3)
        out["tpu_close_ms"] = round(warm["close_s"] * 1e3, 3)
        out["tpu_action_ms"] = warm["action_ms"]
        out["tpu_warm_compiles"] = warm_compiles
        out["tpu_binds"] = warm["binds"]
        # round profile: the solve is one graph replay, so per-round
        # splits are not observable; the record carries the placed-per-
        # round histogram, the full-sweep round count and the average ms a
        # round over the dispatch window
        wp = warm["profile"]
        if wp.get("rounds"):
            out["tpu_round_profile"] = {
                "rounds": wp["rounds"],
                "placed": wp.get("round_placed", []),
                "full_sweep_rounds": wp.get("full_sweep_rounds"),
                "window_k": wp.get("window_k"),
                "dirty_k": wp.get("dirty_k"),
                "tail_placed": wp.get("tail_placed", 0),
                "avg_round_ms": round(
                    wp.get("dispatch_s", 0.0) * 1e3 / max(wp["rounds"], 1), 3),
            }
        out["tpu_residue_ms"] = wp.get("residue_pass_ms", 0.0)
        out["tpu_residue_tasks"] = wp.get("residue_pass_tasks", 0)
        # encode split: snapshot is the session->arrays encode, host_pack
        # the grouped buffer build, h2d the device staging
        out["tpu_encode_split_ms"] = {
            "snapshot": round(wp.get("encode_s", 0.0) * 1e3, 3),
            "host_pack": round(wp.get("pack_s", 0.0) * 1e3, 3),
            "h2d": round(wp.get("h2d_s", 0.0) * 1e3, 3),
        }
        # steady-state incremental sessions on the last warm cache: the
        # first reconciles the placements the mirror flush synced, the
        # rest are the no-churn steady state riding the standing replica
        incr_open, incr_close = [], []
        steady_encode, steady_replica = [], {}
        for _ in range(3):
            w2 = _session_once(cache, tpu_tiers, actions)
            incr_open.append(round(w2["open_s"] * 1e3, 3))
            incr_close.append(round(w2["close_s"] * 1e3, 3))
            p2 = w2["profile"]
            steady_encode.append(round(p2.get("encode_s", 0.0) * 1e3, 3))
            steady_replica.update({
                k: p2[k] for k in ("encode_reused", "h2d_puts",
                                   "replica_rebuilds",
                                   "replica_scatter_rows",
                                   "tpu_replica_scatter_ms",
                                   "replica_epoch") if k in p2})
        out["tpu_incr_open_ms"] = incr_open
        out["tpu_incr_close_ms"] = incr_close
        out["tpu_incr_open_close_ms"] = round(statistics.median(
            o + c for o, c in zip(incr_open, incr_close)), 3)
        out["tpu_steady_encode_ms"] = steady_encode
        out["tpu_steady_state"] = dict(
            steady_replica,
            encode_ms=round(statistics.median(steady_encode[1:]
                                              or steady_encode), 3))
        out["snap_keeper_stats"] = dict(cache.snap_keeper.stats)
        out["tpu_profile"] = {
            k: (round(v, 4) if isinstance(v, float) else v)
            for k, v in warm["profile"].items()}
        out["tasks"] = n_tasks
        if verbose:
            p = warm["profile"]
            print(f"[cfg{cfg}] device warm e2e: {out['tpu_e2e_ms']:.1f} ms "
                  f"(open {out['tpu_open_ms']:.1f} actions {warm['actions_s']*1e3:.1f} "
                  f"close {out['tpu_close_ms']:.1f}) "
                  f"(encode {p.get('encode_s', 0)*1e3:.1f} solve {p.get('solve_s', 0)*1e3:.1f} "
                  f"apply {p.get('apply_s', 0)*1e3:.1f}) binds={warm['binds']} "
                  f"actions={out['tpu_action_ms']} "
                  f"e2e_samples={[round(s) for s in e2e_samples]} compiles={warm_compiles}",
                  file=sys.stderr)

    if "serial_ms" in out and "tpu_ms" in out and out["tpu_ms"] > 0:
        out["speedup_actions_min"] = out["serial_ms"] / out["tpu_ms"]
        # the published speedup binds on MATCHING spans at matching
        # percentiles: serial full-session e2e over the warm MEDIAN e2e
        if out.get("tpu_e2e_median_ms", 0) > 0:
            out["speedup"] = out["serial_e2e_ms"] / out["tpu_e2e_median_ms"]
    return out


def run_mesh_curve(scale: float, counts, warm_iters: int = 2, cfg: int = 7,
                   device="cuda", dtype="float32"):
    """The mesh-scaling curve: cfg7 (paper-2x, 100k tasks x 50k nodes at
    scale 1.0) encoded once in rounds mode, then warm sessions at each
    device count in ``counts`` the host can run. The port has no mesh yet
    (ROADMAP.md Queue 1 item 7), so it runs one device: ``counts`` is
    filtered to ``[1]``, as the reference filters it on a one-device host.

    ``per_device_stage_ms`` is the measured wall of one shard's slice of
    the sharded stages (K16a's refresh and K16b's victim fold,
    ops/shard.probe_per_device_stage_ms) at per-shard width N/d over the
    config's real encoded arrays."""
    from volcano_tpu_torch.bench.clusters import CONFIGS, make_cache
    from volcano_tpu_torch.ops import shard as shard_mod
    from volcano_tpu_torch.ops.solver import _NODE_AXIS
    from volcano_tpu_torch.scheduler.framework import close_session, open_session

    devices = 1  # no mesh in the port yet
    counts = [d for d in counts if d <= devices] or [1]
    bc = CONFIGS[cfg]
    # rounds mode forced: the curve's job is the sharded stages, and at
    # reduced scales auto mode would hand the session to the serial loop
    tiers = _tpu_tiers(bc.tiers, device, dtype, mode="rounds")

    def build():
        cache = make_cache()
        n_tasks = bc.populate(cache, scale)
        return cache, n_tasks

    # one encode of the real config feeds the per-shard stage probes
    cache, n_tasks = build()
    ssn = open_session(cache, tiers)
    prep = ssn.batch_allocator._prepare(ssn)
    probe_arrays = dict(prep["arrays"]) if prep is not None else None
    probe_spec = prep["spec"] if prep is not None else None
    close_session(ssn)

    curve = []
    for d in counts:
        shard_mod.clear_cache()
        cache, _ = build()
        _session_once(cache, tiers, bc.actions)
        e2e = []
        for _ in range(max(warm_iters, 1)):
            cache, _ = build()
            w = _session_once(cache, tiers, bc.actions)
            e2e.append(w["e2e_s"] * 1e3)
        p = w["profile"]
        entry = {
            "devices": d,
            "warm_e2e_ms": round(statistics.median(e2e), 3),
            "solve_ms": round(p.get("solve_s", 0.0) * 1e3, 3),
            "encode_ms": round(p.get("encode_s", 0.0) * 1e3, 3),
            "host_pack_ms": round(p.get("pack_s", 0.0) * 1e3, 3),
            "h2d_ms": round(p.get("h2d_s", 0.0) * 1e3, 3),
            "h2d_puts": p.get("h2d_puts", 0),
            "h2d_shard_puts": p.get("h2d_shard_puts", 0),
            "h2d_shard_cached": p.get("h2d_shard_cached", 0),
            "warm_compiles": p.get("compiles", 0),
            "binds": w["binds"],
        }
        if probe_arrays is not None:
            entry["per_device_stage_ms"] = shard_mod.probe_per_device_stage_ms(
                probe_spec, probe_arrays, _NODE_AXIS, d, device=device,
                dtype=dtype)
        curve.append(entry)
    out = {"config": cfg, "name": bc.name, "scale": scale,
           "tasks": n_tasks, "devices": counts, "curve": curve}
    first, last = curve[0], curve[-1]
    if "per_device_stage_ms" in first and last["devices"] > 1 \
            and last.get("per_device_stage_ms"):
        out["sharded_stage_speedup"] = round(
            first["per_device_stage_ms"] / last["per_device_stage_ms"], 3)
        out["sharded_stage_speedup_devices"] = [first["devices"], last["devices"]]
    if first.get("warm_e2e_ms") and last.get("warm_e2e_ms") \
            and last["devices"] > 1:
        out["warm_e2e_speedup"] = round(first["warm_e2e_ms"] / last["warm_e2e_ms"], 3)
    return out


def run_express(scale: float, arrivals: int = 96, rate_per_s: float = 50.0,
                warm: int = 16, seed: int = 7, device="cuda", dtype="float32"):
    """--express: Poisson interactive arrivals against a warm cfg5-scale
    snapshot, through the express lane (volcano_tpu_torch/express).

    One full session settles the backlog first, then each iteration
    submits the arrivals one ~20 ms service period accrued (Poisson at
    ``rate_per_s``) and services the lane once. The first ``warm``
    iterations are excluded from the latency percentiles; the measured
    ones must build no kernel (``express_warm_compiles``). After the
    arrivals a full session reconciles, and the confirm/revert counts land
    in the record."""
    import random

    from volcano_tpu_torch.api import objects
    from volcano_tpu_torch.bench.clusters import CONFIGS, build_config
    from volcano_tpu_torch.express import ExpressLane
    from volcano_tpu_torch.scheduler.util.test_utils import (
        build_pod, build_pod_group)
    from volcano_tpu_torch.utils.compilewatch import CompileWatcher

    cache, _, _, actions, n_tasks = build_config(5, scale)
    tpu_tiers = _tpu_tiers(CONFIGS[5].tiers, device, dtype)
    lane = ExpressLane(cache, device=device, dtype=dtype)
    settle = _session_once(cache, tpu_tiers, actions)
    lane.run_once()  # drain the backlog notifications (all ineligible/bound)

    rng = random.Random(seed)
    period_s = 0.02
    counter = [0]

    def submit_burst():
        """Arrivals accrued over one service period of the Poisson
        process (>= 1 so every iteration measures a real batch)."""
        n = 0
        budget = period_s
        while True:
            gap = rng.expovariate(rate_per_s)
            if gap > budget and n > 0:
                break
            budget -= gap
            n += 1
        for _ in range(max(n, 1)):
            counter[0] += 1
            pg = f"xpr-{counter[0]:05d}"
            cache.add_pod_group(build_pod_group(
                pg, namespace="express", min_member=1))
            cache.add_pod(build_pod(
                "express", f"{pg}-t0", "", objects.POD_PHASE_PENDING,
                {"cpu": f"{rng.choice([100, 250])}m",
                 "memory": rng.choice(["128Mi", "256Mi"])}, pg))
        return max(n, 1)

    watcher = CompileWatcher.install()
    lat_ms = []
    warm_lat_ms = []
    sync_points = 0
    batch_sizes = []
    win = None
    for it in range(arrivals + warm):
        if it == warm:
            win = watcher.window()
        batch_sizes.append(submit_burst())
        rep = lane.run_once()
        (lat_ms if it >= warm else warm_lat_ms).append(rep["ms"])
        if it >= warm:
            sync_points += rep["profile"].get("tpu_sync_points", 0)
    compiles = win.delta().compiles if win is not None else None

    # the reconciling full session: every optimistic bind gets a verdict
    _session_once(cache, tpu_tiers, actions)

    ordered = sorted(lat_ms)

    def pick(q):
        return round(ordered[min(int(q * len(ordered)), len(ordered) - 1)], 3)

    return {
        "scale": scale,
        "snapshot_tasks": n_tasks,
        "settle_session_ms": round(settle["e2e_s"] * 1e3, 3),
        "arrivals": counter[0],
        "batches": len(lat_ms),
        "mean_batch": round(statistics.mean(batch_sizes), 2),
        "tpu_express_p50_ms": pick(0.50),
        "tpu_express_p99_ms": pick(0.99),
        "tpu_express_max_ms": round(ordered[-1], 3),
        "tpu_express_warm_max_ms": round(max(warm_lat_ms), 3)
        if warm_lat_ms else 0.0,
        "express_placed": lane.counters["placed"],
        "express_deferred": lane.counters["deferred"],
        "express_deferral_rate": round(
            lane.counters["deferred"]
            / max(lane.counters["arrivals"], 1), 4),
        "express_reconciled": lane.counters["reconciled"],
        "express_reverted": lane.counters["reverted"],
        "express_warm_compiles": compiles,
        "express_sync_points_per_batch": round(
            sync_points / max(len(lat_ms), 1), 3),
        "express_state": dict(lane.state.stats),
    }


def _arrival_pod(name, t, cpu):
    from volcano_tpu_torch.api import objects
    from volcano_tpu_torch.scheduler.util.test_utils import build_pod

    return build_pod("arr", f"{name}-t{t}", "", objects.POD_PHASE_PENDING,
                     {"cpu": f"{cpu}m", "memory": "256Mi"}, name)


def run_pipeline(scale: float, cycles: int = 24, warm: int = 4,
                 rate_per_cycle: float = 3.0, seed: int = 7,
                 device="cuda", dtype="float32"):
    """--pipeline: back-to-back sessions under Poisson arrivals through the
    serial loop and the continuous pipeline (volcano_tpu_torch/pipeline),
    on identical pregenerated arrival schedules: sustained sessions/sec,
    p99 submit->bind task wait, and the speculation ledger.

    Arrivals go in through the pipeline's intake hook, so each batch lands
    before the next snapshot seals; the serial arm injects the same batch
    right before each cycle: both arms' session k sees arrival batches
    0..k. An express lane is attached but PARKED and the device drained
    before the floor probes and the measured window."""
    import gc
    import random

    import volcano_tpu_torch.scheduler.actions  # noqa: F401 (register actions)
    from volcano_tpu_torch.bench.clusters import DEFAULT_TIERS, build_config
    from volcano_tpu_torch.scheduler.util.test_utils import build_pod_group
    from volcano_tpu_torch.utils import devprof
    from volcano_tpu_torch.utils.compilewatch import CompileWatcher

    total = cycles + warm
    rng = random.Random(seed)
    batches = []
    for k in range(total):
        n, budget = 0, 1.0
        while True:
            gap = rng.expovariate(rate_per_cycle)
            if gap > budget:
                break
            budget -= gap
            n += 1
        batches.append([
            (f"arr-{k:03d}-{j:02d}", rng.choice([1, 2, 4]),
             rng.choice([250, 500, 1000])) for j in range(n)])

    actions = ["allocate", "backfill"]

    def _arm(pipelined: bool):
        from volcano_tpu_torch.express import ExpressLane
        from volcano_tpu_torch.scheduler.framework import (
            close_session, open_session, run_actions)

        cache, _, _, _, n_tasks = build_config(5, scale)
        tiers = _tpu_tiers(DEFAULT_TIERS, device, dtype, mode="rounds")
        lane = ExpressLane(cache, device=device, dtype=dtype)
        submit_t = {}
        waits = []

        orig_bind = cache.binder.bind
        orig_many = cache.binder.bind_many
        orig_keyed = getattr(cache.binder, "bind_many_keyed", None)

        def _record(keys, now):
            for key in keys:
                t = submit_t.get(key)
                if t is not None:
                    waits.append(now - t)

        def bind(pod, hostname):
            orig_bind(pod, hostname)
            _record([f"{pod.metadata.namespace}/{pod.metadata.name}"],
                    time.perf_counter())

        def bind_many(pairs):
            pairs = list(pairs)
            orig_many(pairs)
            _record([f"{p.metadata.namespace}/{p.metadata.name}"
                     for p, _h in pairs], time.perf_counter())

        cache.binder.bind, cache.binder.bind_many = bind, bind_many
        if orig_keyed is not None:
            # the bulk writeback prefers the keyed batch entrypoint
            def bind_many_keyed(keys, pods, hosts):
                orig_keyed(keys, pods, hosts)
                _record(list(keys), time.perf_counter())

            cache.binder.bind_many_keyed = bind_many_keyed

        def inject(batch):
            now = time.perf_counter()
            for name, tasks, cpu in batch:
                cache.add_pod_group(build_pod_group(
                    name, namespace="arr", min_member=tasks))
                for t in range(tasks):
                    cache.add_pod(_arrival_pod(name, t, cpu))
                    submit_t[f"arr/{name}-t{t}"] = now

        pending = list(batches)
        drv = None
        if pipelined:
            from volcano_tpu_torch.pipeline import PipelineDriver

            def intake():
                if pending:
                    inject(pending.pop(0))

            drv = PipelineDriver(
                cache, lambda: (actions, tiers), intake=intake)
            inject(pending.pop(0))  # batch 0, visible to cycle 0

        def cycle():
            if drv is not None:
                drv.run_cycle()
                return
            inject(pending.pop(0))
            ssn = open_session(cache, tiers)
            try:
                run_actions(ssn, actions)
            finally:
                close_session(ssn)

        watcher = CompileWatcher.install()
        win = None
        t_start = None
        floor = (None, None, None)
        for k in range(total):
            if k == warm:
                # measurement fence: background lane parked, device
                # drained, per-arm floor pinned with its notes
                lane.park("bench_measurement")
                gc.collect()
                devprof.drain()
                floor = _measure_floor_ms(device=device)
                win = watcher.window()
                t_start = time.perf_counter()
                # waits bind only to POST-fence submissions
                submit_t.clear()
                waits.clear()
            cycle()
        devprof.drain()
        wall = time.perf_counter() - t_start
        if drv is not None:
            drv.abandon()
        compiles = win.delta().compiles if win is not None else None
        ordered = sorted(waits)

        def pick(q):
            if not ordered:
                return 0.0
            return round(
                ordered[min(int(q * len(ordered)), len(ordered) - 1)] * 1e3, 3)

        out = {
            "sessions_per_sec": round(cycles / wall, 3) if wall > 0 else 0.0,
            "measured_cycles": cycles,
            "wall_s": round(wall, 3),
            "mean_cycle_ms": round(wall / cycles * 1e3, 3),
            "p50_task_wait_ms": pick(0.50),
            "p99_task_wait_ms": pick(0.99),
            "binds": len(cache.binder.binds),
            "snapshot_tasks": n_tasks,
            "warm_compiles": compiles,
            "express_parked": bool(lane.parked),
            "tpu_floor_probe_notes": floor[2],
            "tpu_floor_ms": floor[0],
            "tpu_floor_spread_ms": floor[1],
        }
        if drv is not None:
            out["driver"] = {k: (dict(v) if isinstance(v, dict) else v)
                             for k, v in drv.stats.items()}
        return out

    # discarded prewarm arm: replays the identical schedule once so every
    # bucket's kernels and graphs exist BEFORE either measured arm —
    # otherwise whichever arm runs first pays them inside its window
    _arm(pipelined=False)
    serial = _arm(pipelined=False)
    pipelined = _arm(pipelined=True)
    speedup = (pipelined["sessions_per_sec"] / serial["sessions_per_sec"]
               if serial["sessions_per_sec"] else 0.0)
    churn = _pipeline_churn(scale, batches, actions, seed, warm=warm,
                            device=device, dtype=dtype)
    return {
        "scale": scale,
        "arrival_rate_per_cycle": rate_per_cycle,
        "serial": serial,
        "pipeline": pipelined,
        "pipeline_sessions_per_sec": pipelined["sessions_per_sec"],
        "p99_submit_bind_ms": pipelined["p99_task_wait_ms"],
        "speedup_sessions_per_sec": round(speedup, 3),
        "churn": churn,
        "pipeline_spec_commit_rate": churn["commit_rate_readset"],
    }


def _pipeline_churn(scale, batches, actions, seed,
                    queue_rate_per_cycle: float = 3.0,
                    node_rate_per_cycle: float = 0.35, warm: int = 4,
                    device="cuda", dtype="float32"):
    """The --pipeline churn arm: replay run_pipeline's arrival schedule
    with a pregenerated Poisson mix of value-neutral deltas injected
    BETWEEN each speculation's seal and its apply (spec echoes on
    bystander queues no sealed solve consumed, salted with node status
    echoes). Three arms on identical inputs:

      serial    — the byte-for-byte oracle (echoes are placement no-ops);
      whole_fp  — pipelined with VOLCANO_TPU_READSET=0: every echoed
                  window moves the coarse fingerprint, so the sealed
                  solve is discarded on ANY movement;
      readset   — pipelined with the read-set seal: bystander-queue noise
                  is disjoint from the sealed read set, so those windows
                  commit; a node echo discards where the solve's touched
                  mask is full-width.

    Binds must be identical across the three arms, and the readset arm's
    measured window must build nothing."""
    import copy
    import random

    import volcano_tpu_torch.scheduler.actions  # noqa: F401 (register actions)
    from volcano_tpu_torch.bench.clusters import DEFAULT_TIERS, build_config
    from volcano_tpu_torch.scheduler.util.test_utils import (
        build_pod_group, build_queue)
    from volcano_tpu_torch.utils import devprof
    from volcano_tpu_torch.utils.compilewatch import CompileWatcher

    total = len(batches)
    n_bystanders = 8
    rng = random.Random(seed * 7919)

    def _poisson_burst(rate):
        n, budget = 0, 1.0
        while True:
            gap = rng.expovariate(rate)
            if gap > budget:
                return n
            budget -= gap
            n += 1

    echoes = []
    for _ in range(total):
        burst = [("queue", rng.random())
                 for _ in range(max(_poisson_burst(queue_rate_per_cycle), 1))]
        burst += [("node", rng.random())
                  for _ in range(_poisson_burst(node_rate_per_cycle))]
        # at least one echo per window: every speculation faces a delta
        echoes.append(burst)

    def _inject_jobs(cache, batch):
        for name, tasks, cpu in batch:
            cache.add_pod_group(build_pod_group(
                name, namespace="arr", min_member=tasks))
            for t in range(tasks):
                cache.add_pod(_arrival_pod(name, t, cpu))

    def _arm(mode):
        from volcano_tpu_torch.scheduler.framework import (
            close_session, open_session, run_actions)

        prev = os.environ.get("VOLCANO_TPU_READSET")
        if mode == "whole_fp":
            os.environ["VOLCANO_TPU_READSET"] = "0"
        try:
            cache, _, _, _, _ = build_config(5, scale)
            tiers = _tpu_tiers(DEFAULT_TIERS, device, dtype, mode="rounds")
            node_names = sorted(cache.nodes)
            # bystander queues exist BEFORE the first session: later
            # re-adds are spec echoes on an existing queue (the scoped
            # mark), never a queue-set change
            bystanders = [build_queue(f"bystander-{i}", weight=1)
                          for i in range(n_bystanders)]
            for q in bystanders:
                cache.add_queue(q)
            pending = list(batches)
            drv = None
            if mode != "serial":
                from volcano_tpu_torch.pipeline import PipelineDriver

                def intake():
                    if pending:
                        _inject_jobs(cache, pending.pop(0))

                drv = PipelineDriver(
                    cache, lambda: (actions, tiers), intake=intake)
                _inject_jobs(cache, pending.pop(0))
            watcher = CompileWatcher.install()
            win = None
            for k in range(total):
                if k == warm:
                    devprof.drain()
                    win = watcher.window()
                if drv is not None:
                    drv.run_cycle()
                else:
                    _inject_jobs(cache, pending.pop(0))
                    ssn = open_session(cache, tiers)
                    try:
                        run_actions(ssn, actions)
                    finally:
                        close_session(ssn)
                # the echo stream lands AFTER this cycle sealed the next
                # solve-ahead — between seal and apply
                for fam, frac in echoes[k]:
                    if fam == "queue":
                        cache.add_queue(copy.deepcopy(
                            bystanders[int(frac * n_bystanders) % n_bystanders]))
                    else:
                        name = node_names[int(frac * len(node_names))
                                          % len(node_names)]
                        cache.add_node(copy.deepcopy(cache.nodes[name].node))
            devprof.drain()
            if drv is not None:
                drv.abandon()
            out = {
                "binds": dict(cache.binder.binds),
                "warm_compiles":
                    win.delta().compiles if win is not None else None,
            }
            if drv is not None:
                st = drv.stats
                out["spec_dispatched"] = st["spec_dispatched"]
                out["spec_applied"] = st["spec_applied"]
                out["spec_commits"] = dict(st["spec_commits"])
                out["spec_discards"] = dict(st["spec_discards"])
                out["commit_rate"] = round(
                    st["spec_applied"] / max(st["spec_dispatched"], 1), 4)
            return out
        finally:
            if prev is None:
                os.environ.pop("VOLCANO_TPU_READSET", None)
            else:
                os.environ["VOLCANO_TPU_READSET"] = prev

    serial = _arm("serial")
    whole = _arm("whole_fp")
    scoped = _arm("readset")
    return {
        "queue_echo_rate_per_cycle": queue_rate_per_cycle,
        "node_echo_rate_per_cycle": node_rate_per_cycle,
        "echo_deltas_total": sum(len(e) for e in echoes),
        "commit_rate_readset": scoped["commit_rate"],
        "commit_rate_whole_fingerprint": whole["commit_rate"],
        "spec_commits": scoped["spec_commits"],
        "spec_discards": scoped["spec_discards"],
        "whole_fp_discards": whole["spec_discards"],
        "binds_match_serial": scoped["binds"] == serial["binds"],
        "whole_fp_binds_match_serial": whole["binds"] == serial["binds"],
        "binds": len(serial["binds"]),
        "warm_compiles_readset": scoped["warm_compiles"],
    }


_FLOOR_PROBE = {}  # device -> the no-op's one-element operand


def run_fanout_bench(watchers: int = 10000, batches: int = 40,
                     churn: int = 96, cap: int = 4096,
                     slow_every: int = 500, slow_stride: int = 8,
                     sample: int = 64, pods: int = 512):
    """Watch fan-out at 10k+ concurrent watchers over ONE shared journal.

    Synchronous (no threads — the shared-slice fast path is what's under
    test): each batch mutates ``churn`` pods, then every watcher polls
    once through the flow-control layer. Every ``slow_every``-th watcher
    only polls every ``slow_stride`` batches — the laggard tail that must
    ride bounded retention and demotion-to-resync instead of pinning the
    ring. Reports per-event delivery latency percentiles (append-stamp to
    delivery, sampled over the first ``sample`` watchers), throughput,
    and the per-watcher memory footprint — cursor + counters only, which
    is the O(events + watchers) proof."""
    import copy

    from volcano_tpu_torch.api import objects
    from volcano_tpu_torch.scheduler.util.test_utils import build_pod
    from volcano_tpu_torch.store.flowcontrol import WatchFanout, WatcherState
    from volcano_tpu_torch.store.gateway import _WatchJournal
    from volcano_tpu_torch.store.store import Store

    store = Store()
    journal = _WatchJournal(store, "Pod", cap=cap)
    fanout = WatchFanout(journal, demote_lag=2 * cap, pin_factor=4)

    def make(i):
        pod = build_pod("bench", f"pod-{i:06d}", "",
                        objects.POD_PHASE_PENDING,
                        {"cpu": "100m", "memory": "64Mi"}, "")
        pod.metadata.ensure_identity()
        return pod

    live = []
    for i in range(pods):
        pod = make(i)
        store.create(pod)
        live.append(pod)
    cursors = [0] * watchers
    classes = ["interactive" if i % 3 == 0 else "batch"
               for i in range(watchers)]
    latencies = []
    delivered = resyncs = 0
    next_pod = pods
    wall0 = time.perf_counter()
    for batch in range(batches):
        for k in range(churn):
            idx = (batch * churn + k) % len(live)
            if k % 7 == 0:
                pod = make(next_pod)
                next_pod += 1
                store.create(pod)
                live.append(pod)
            else:
                cur = store.try_get("Pod", "bench",
                                    live[idx].metadata.name)
                if cur is None:
                    continue
                upd = copy.deepcopy(cur)
                upd.metadata.annotations["b"] = str(batch)
                store.update(upd)
        poll_t = time.monotonic()
        for i in range(watchers):
            if slow_every and i % slow_every == slow_every - 1 \
                    and batch % slow_stride != 0:
                continue  # the deliberately slow tail
            events, nxt, reset = fanout.poll_for(
                f"w{i:05d}", cursors[i], 0.0, cls=classes[i])
            cursors[i] = nxt
            if reset:
                resyncs += 1
                continue
            delivered += len(events)
            if i < sample:
                latencies.extend(poll_t - e["ts"] for e in events
                                 if "ts" in e)
    wall = time.perf_counter() - wall0
    latencies.sort()

    def pct(q):
        if not latencies:
            return 0.0
        return round(
            latencies[min(int(q * len(latencies)), len(latencies) - 1)]
            * 1e3, 3)

    ws_bytes = sys.getsizeof(WatcherState("x", "batch", 0)) \
        + sum(sys.getsizeof(getattr(WatcherState("x", "batch", 0), s))
              for s in WatcherState.__slots__)
    stats = fanout.watch_stats()
    return {
        "watchers": watchers,
        "batches": batches,
        "events_appended": stats["journal"]["appended"],
        "deliveries": delivered,
        "fanout_p50_ms": pct(0.50),
        "fanout_p99_ms": pct(0.99),
        "polls_per_sec": round(watchers * batches / wall, 1),
        "deliveries_per_sec": round(delivered / wall, 1),
        "coalesced": stats["counters"]["coalesced"],
        "demotions": stats["counters"]["demotions"],
        "resyncs": resyncs,
        "journal_peak_occupancy": stats["journal"]["peak_occupancy"],
        "journal_hard_cap": stats["journal"]["hard_cap"],
        "per_watcher_state_bytes": ws_bytes,
        "wall_s": round(wall, 3),
        "pid_rss_mb": _rss_mb(),
    }


def _rss_mb():
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return round(int(line.split()[1]) / 1024.0, 1)
    except OSError:
        pass
    return None


def _probe_once_ms(device):
    """One timed no-op round trip: ``x + 1`` on a one-element int32 tensor
    on the device, fetched through devprof (so its sync/fetch budget lands
    in the floor annotations). Fenced: nothing queued may overlap it."""
    import torch

    from volcano_tpu_torch.utils import devprof

    x = _FLOOR_PROBE.get(str(device))
    if x is None:
        x = torch.zeros((1,), dtype=torch.int32, device=device)
        devprof.start_fetch(x + 1)()  # first launch outside any timed window
        _FLOOR_PROBE[str(device)] = x
    devprof.drain()
    t0 = time.perf_counter()
    devprof.start_fetch(x + 1)()
    return round((time.perf_counter() - t0) * 1e3, 3)


def _measure_floor_ms(probes: int = 5, device="cuda"):
    """Median-of-k floor: (median_ms, spread_ms, annotation).

    The annotation carries every probe's wall plus the counted sync-point
    and fetch budget. The first probe after the drain fence is kept apart
    as first_probe_ms; the median and spread come from the rest."""
    from volcano_tpu_torch.utils import devprof

    counters = {}
    with devprof.session(counters):
        raw = [_probe_once_ms(device) for _ in range(probes + 1)]
    first, samples = raw[0], (raw[1:] or raw)
    note = {"probes_ms": samples,
            "first_probe_ms": first,
            "sync_points": counters.get("tpu_sync_points"),
            "d2h_fetches": counters.get("tpu_d2h_fetches")}
    return (round(statistics.median(samples), 3),
            round(max(samples) - min(samples), 3), note)


def _parser():
    ap = argparse.ArgumentParser(
        prog="python -m volcano_tpu_torch.bench",
        description="scheduler-session latency: serial loop vs the GPU solve")
    ap.add_argument("--config", type=int, default=None,
                    choices=[1, 2, 3, 4, 5, 6, 7],
                    help="run ONE config (default: all six, headline = cfg 5; "
                         "cfg7 = paper-2x 100k tasks x 50k nodes, the "
                         "mesh-curve config)")
    ap.add_argument("--all", action="store_true",
                    help="run all six configs (the default when --config is absent)")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--backend", choices=["serial", "tpu", "both", "auto"],
                    default="auto",
                    help="tpu = the device arm (the reference's name)")
    ap.add_argument("--serial-budget", type=float, default=30.0,
                    help="max seconds to spend measuring the serial loop per config")
    ap.add_argument("--warm-iters", type=int, default=5,
                    help="warm device sessions per config (>=1); the headline "
                         "binds on the MEDIAN e2e")
    ap.add_argument("--device", default="cuda",
                    help="where the solve and the express lane run (cuda/cpu)")
    ap.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    ap.add_argument("--mesh", nargs="?", const="all", default=None,
                    help="with a device-count list (--mesh 1,2,4,8): run the "
                         "cfg7 mesh-scaling sweep, emitting tpu_mesh_curve "
                         "in the summary tail, then exit")
    ap.add_argument("--mesh-curve-scale", type=float, default=0.02,
                    help="cfg7 scale for the standing mesh curve recorded "
                         "in every all-configs run")
    ap.add_argument("--no-mesh-curve", action="store_true",
                    help="skip the standing cfg7 mesh curve in the "
                         "all-configs summary tail")
    ap.add_argument("--express", action="store_true",
                    help="express-lane mode: Poisson interactive arrivals "
                         "against a warm cfg5-scale snapshot, then exit")
    ap.add_argument("--express-arrivals", type=int, default=96,
                    help="measured express batches (after 16 warmup)")
    ap.add_argument("--express-rate", type=float, default=50.0,
                    help="Poisson arrival rate for --express, jobs/sec")
    ap.add_argument("--pipeline", action="store_true",
                    help="continuous-pipeline mode: back-to-back sessions "
                         "under Poisson arrivals through the serial loop AND "
                         "the pipeline, then exit")
    ap.add_argument("--pipeline-cycles", type=int, default=24,
                    help="measured back-to-back cycles per arm (after 4 warmup cycles)")
    ap.add_argument("--pipeline-rate", type=float, default=3.0,
                    help="Poisson arrival rate for --pipeline, jobs/cycle")
    ap.add_argument("--fanout", nargs="?", const=10000, default=None,
                    type=int,
                    help="run the watch fan-out bench alone at N watchers "
                         "(default 10000) and print its summary tail")
    ap.add_argument("--no-fanout", action="store_true",
                    help="skip the standing 10k-watcher fan-out column in "
                         "the all-configs summary tail")
    # the reference's flags whose modes are not ported: refused below
    ap.add_argument("--scenario", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--no-front-door", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--no-storm", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--storm-scale", type=float, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--storm-duration", type=float, default=None,
                    help=argparse.SUPPRESS)
    return ap


def _refusal(args):
    for dest, why in REFUSED.items():
        if getattr(args, dest) not in (None, False):
            return f"--{dest.replace('_', '-')}: not in the port yet: {why}"
    if args.mesh == "all":
        return ("--mesh (shard the config runs across every local device): "
                "not in the port yet: the mesh is ROADMAP.md Queue 1 item 7")
    return None


def main(argv=None) -> int:
    global _GC_POLICY
    from volcano_tpu_torch import device as devmod
    from volcano_tpu_torch.utils.gcpolicy import LowLatencyGC

    args = _parser().parse_args(argv)
    why = _refusal(args)
    if why is not None:
        print(f"[bench] {why}", file=sys.stderr)
        return 2
    if args.fanout is not None:
        # device-free path: the fan-out bench exercises only the store/
        # journal/flow-control layer, so it runs (and exits) before any
        # device machinery loads
        result = run_fanout_bench(watchers=args.fanout)
        print(json.dumps({
            "metric": "watch fan-out p99 delivery latency @ %d watchers"
                      % args.fanout,
            "value": result["fanout_p99_ms"],
            "unit": "ms",
        }), flush=True)
        print(json.dumps({"summary": {"watch_fanout": result}},
                         separators=(",", ":")), flush=True)
        return 0
    device = str(devmod.resolve_device(args.device))
    dtype = args.dtype
    # the production loop runs under this policy (Scheduler._loop);
    # run_config calls maintain() between sessions, as the loop does
    _GC_POLICY = LowLatencyGC.install()
    try:
        return _main(args, device, dtype,
                     sys.argv[1:] if argv is None else list(argv))
    finally:
        _GC_POLICY.uninstall()
        _GC_POLICY = None


def _main(args, device, dtype, argv) -> int:
    card = device_line(device)
    print(f"[bench] device: {card}", file=sys.stderr)

    if args.mesh is not None:
        mesh_counts = sorted({max(int(x), 1)
                              for x in args.mesh.split(",") if x.strip()})
        result = run_mesh_curve(args.scale, mesh_counts,
                                warm_iters=max(args.warm_iters // 2, 1),
                                device=device, dtype=dtype)
        print(json.dumps({
            "metric": "cfg7 (paper-2x) per-device sharded-stage wall at "
                      "%d devices, x %s scale"
                      % (result["devices"][-1], args.scale),
            "value": result["curve"][-1].get("per_device_stage_ms", 0.0),
            "unit": "ms",
            "vs_baseline": result.get("sharded_stage_speedup", 0.0),
        }), flush=True)
        print(json.dumps({"summary": {"tpu_mesh_curve": result}},
                         separators=(",", ":")), flush=True)
        return 0

    if args.pipeline:
        result = run_pipeline(args.scale, cycles=args.pipeline_cycles,
                              rate_per_cycle=args.pipeline_rate,
                              device=device, dtype=dtype)
        drv = result["pipeline"].get("driver", {})
        print(json.dumps({
            "metric": "pipelined sustained sessions/sec @ cfg5 x %s "
                      "under Poisson arrivals" % args.scale,
            "value": result["pipeline_sessions_per_sec"],
            "unit": "sessions/s",
            "vs_baseline": result["speedup_sessions_per_sec"],
        }), flush=True)
        print(json.dumps({"summary": {
            "cfg5_pipeline": {
                "pipeline_sessions_per_sec": result["pipeline_sessions_per_sec"],
                "serial_sessions_per_sec": result["serial"]["sessions_per_sec"],
                "speedup_sessions_per_sec": result["speedup_sessions_per_sec"],
                "p99_submit_bind_ms": result["p99_submit_bind_ms"],
                "serial_p99_submit_bind_ms": result["serial"]["p99_task_wait_ms"],
                "pipeline_warm_compiles": result["pipeline"]["warm_compiles"],
                "spec": drv,
                "pipeline_spec_discard_rate": round(
                    drv.get("spec_discarded", 0)
                    / max(drv.get("spec_dispatched", 0), 1), 4),
                "pipeline_spec_commit_rate": result["pipeline_spec_commit_rate"],
                "churn": result["churn"],
            },
            "pipeline_full": result,
        }}, separators=(",", ":"), default=str), flush=True)
        return 0

    if args.express:
        result = run_express(args.scale, arrivals=args.express_arrivals,
                             rate_per_s=args.express_rate,
                             device=device, dtype=dtype)
        print(json.dumps({
            "metric": "express placement latency p99 (ms) @ cfg5 x %s"
                      % args.scale,
            "value": result["tpu_express_p99_ms"],
            "unit": "ms",
        }), flush=True)
        print(json.dumps({"summary": {"express": result}},
                         separators=(",", ":")), flush=True)
        return 0

    # the device round-trip floor: one no-op dispatch + 4-byte fetch, the
    # lower bound of any session's solve phase, recorded beside the numbers
    rtt_floor_ms = None
    if args.backend in ("tpu", "both", "auto"):
        rtt_floor_ms, rtt_spread, _ = _measure_floor_ms(probes=7, device=device)
        print(f"[link] device round-trip floor: {rtt_floor_ms} ms "
              f"(median of 7, spread {rtt_spread} ms)", file=sys.stderr)

    def headline_json(headline):
        value = headline.get(
            "tpu_e2e_median_ms",
            headline.get("serial_e2e_ms",     # --backend serial: same span
                         headline.get("tpu_ms", headline.get("serial_ms", 0.0))))
        final = {
            "metric": "scheduler e2e session latency, warm median (ms) @ %dk tasks x %dk nodes"
                      % (int(50 * args.scale), int(10 * args.scale))
                      if headline["config"] == 5 else
                      f"scheduler e2e session latency, warm median (ms), cfg {headline['config']} ({headline['name']})",
            "value": round(value, 3),
            "unit": "ms",
            "vs_baseline": round(headline.get("speedup", 0.0), 3),
        }
        for src, dst in (("tpu_open_ms", "open_ms"),
                         ("tpu_close_ms", "close_ms"),
                         ("tpu_incr_open_close_ms", "incr_open_close_ms")):
            if src in headline:
                final[dst] = headline[src]
        # the baseline may be a reduced-scale serial run extrapolated
        # linearly in tasks x nodes: say so next to the number it shaped
        if headline.get("serial_extrapolated"):
            final["serial_extrapolated"] = True
            final["serial_measured_scale"] = headline.get("serial_measured_scale")
        return final

    def write_record(results, final=None):
        # the COMPLETE record, re-written after EVERY config, so a run cut
        # mid-sweep leaves what it measured
        try:
            import subprocess

            sha = subprocess.run(
                ["git", "rev-parse", "--short", "HEAD"],
                capture_output=True, text=True, timeout=10, cwd=REPO
            ).stdout.strip() or None
        except Exception:
            sha = None
        record = {"rtt_floor_ms": rtt_floor_ms, "git_sha": sha,
                  "argv": argv,
                  "device": card,
                  "complete": final is not None,
                  "results": [
                      {k: v for k, v in r.items() if k != "tpu_cold_profile"}
                      for r in results]}
        if final is not None:
            record["headline"] = {k: v for k, v in final.items()
                                  if k != "all_configs"}
        try:
            with open(RECORD, "w") as fh:
                json.dump(record, fh, indent=1)
                fh.write("\n")
        except Exception as e:
            print(f"[bench] could not write {RECORD}: {e}", file=sys.stderr)

    results = []
    # headline (cfg 5) runs FIRST and prints its JSON line immediately; the
    # combined line prints last and supersedes it
    cfgs = [args.config] if args.config is not None else [5, 1, 2, 3, 4, 6]
    for cfg in cfgs:
        results.append(run_config(cfg, args.scale, args.backend,
                                  args.serial_budget,
                                  warm_iters=args.warm_iters,
                                  device=device, dtype=dtype))
        write_record(results)
        if cfg == 5 and len(cfgs) > 1:
            print(json.dumps(headline_json(results[0])), flush=True)

    headline = results[0] if cfgs[0] == 5 else results[-1]
    final = headline_json(headline)
    if rtt_floor_ms is not None:
        final["rtt_floor_ms"] = rtt_floor_ms
    if len(results) > 1:
        final["all_configs"] = [
            {k: v for k, v in r.items() if k != "tpu_cold_profile"}
            for r in results]
    write_record(results, final=final)
    print(json.dumps(final))
    # compact trajectory line, printed LAST
    summary = {}
    for r in results:
        entry = {
            "e2e_ms": r.get("tpu_e2e_median_ms", r.get("serial_e2e_ms")),
            "speedup": round(r.get("speedup", 0.0), 3),
        }
        st = r.get("tpu_steady_state")
        if st is not None:
            entry["steady_encode_ms"] = st.get("encode_ms")
        if r["config"] == 4 and "tpu_action_ms" in r:
            entry["action_ms"] = {
                k: v for k, v in r["tpu_action_ms"].items()
                if k in ("preempt", "reclaim", "backfill")}
        summary[f"cfg{r['config']}"] = entry
    if len(cfgs) > 1:
        for column, why in LEFT_OUT_COLUMNS.items():
            print(f"[bench] summary column {column} left out: {why}",
                  file=sys.stderr)
    # the standing fan-out column: 10k-watcher fan-out p50/p99 delivery
    # latency + bounded per-watcher memory
    if not args.no_fanout and len(cfgs) > 1:
        try:
            summary["watch_fanout"] = run_fanout_bench()
        except Exception as e:
            print(f"[bench] fan-out bench failed: {e}", file=sys.stderr)
    # the standing mesh-scaling curve: cfg7 in every all-configs run,
    # in-process (no virtual devices to set up)
    if (not args.no_mesh_curve and args.backend in ("tpu", "both", "auto")
            and len(cfgs) > 1):
        try:
            summary["tpu_mesh_curve"] = run_mesh_curve(
                args.mesh_curve_scale, [1, 2, 4, 8], warm_iters=2,
                device=device, dtype=dtype)
        except Exception as e:
            print(f"[bench] mesh curve failed: {e}", file=sys.stderr)
    print(json.dumps({"summary": summary}, separators=(",", ":")), flush=True)
    return 0
