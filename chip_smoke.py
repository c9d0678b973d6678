"""Chip smoke test of the PyTorch/CUDA port (volcano_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py            # full scale: cfg2, cfg3, cfg5
    python3 chip_smoke.py --scale 0.05   # a quick, smaller rehearsal

Phases, each failing the run on any error:

1. the card's name and power limit (nvidia-smi), then the build of every
   CUDA kernel under volcano_tpu_torch/csrc, one nvcc per source, in
   parallel;
2. kernel phase: one cfg5 allocate session on the card records the first
   input each kernel wrapper sees on that path (K1 score_block full and
   dirty-column, K2 window_topk, K4 resolve_prefix, K5 queue_budget); each
   kernel is then held against its plain PyTorch version on those inputs
   with torch.equal (exact), and both are timed with CUDA events;
3. reference check: a small cfg5 session in float64 on the card gives the
   same binds as the same session on the CPU (plain versions);
4. session phase: cfg2 (5k x 1k), cfg3 (20k x 5k) and cfg5 (50k x 10k)
   through build_config -> open_session -> run_actions(["allocate"]) ->
   close_session with tpuscore on cuda, twice each on fresh caches. Launch
   counters are zeroed just before each run and read just after; every
   kernel must have launched. Every bind must be feasible, no node over
   capacity, every gang whole, and both runs must give the same binds.

The last two lines of standard output are a {"kernels": [...]} JSON object
and {"ok": true, "device": {...}}. Without a usable GPU, or without the
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

MEM_BPS = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_OPS = {torch.float32: 67e12, torch.float64: 34e12}  # non-tensor-core


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, reps=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*ts) -> int:
    return int(sum(t.numel() * t.element_size() for t in ts if t is not None))


def run_session(cfg, scale, device, dtype):
    """One allocate session of a bench config through the port's normal
    entry; returns (cache, profile, launches, n_tasks, wall_s)."""
    from volcano_tpu_torch import device as devmod
    from volcano_tpu_torch.bench.clusters import CONFIGS, build_config, make_tiers
    from volcano_tpu_torch.scheduler.framework import (
        close_session, open_session, run_actions)

    cache, _, _, _, n_tasks = build_config(cfg, scale)
    tiers = make_tiers(["tpuscore"], *CONFIGS[cfg].tiers, arguments={
        "tpuscore": {"tpuscore.mode": "rounds", "tpuscore.device": device,
                     "tpuscore.dtype": dtype}})
    if device == "cuda":
        torch.cuda.synchronize()
    devmod.reset_launches()
    t0 = time.perf_counter()
    ssn = open_session(cache, tiers)
    run_actions(ssn, ["allocate"])
    prof = dict(ssn.plugins["tpuscore"].profile)
    close_session(ssn)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return cache, prof, devmod.launches(), n_tasks, wall


def check_binds(cache, cfg):
    """Feasibility, capacity and gang atomicity of the FakeBinder result."""
    from volcano_tpu_torch.api.resource import Resource

    binds = cache.binder.binds
    tasks = {}
    for job in cache.jobs.values():
        for t in job.tasks.values():
            tasks[f"{t.namespace}/{t.name}"] = (job, t)
    per_node = {}
    per_job = {}
    for key, node_name in binds.items():
        job, t = tasks[key]
        per_node.setdefault(node_name, []).append(t)
        per_job[job.uid] = per_job.get(job.uid, 0) + 1
    for node_name, ts in per_node.items():
        node = cache.nodes[node_name]
        total = Resource.empty()
        for t in ts:
            total.add(t.resreq)
        if not total.less_equal(node.allocatable):
            raise AssertionError(f"cfg{cfg}: node {node_name} over capacity")
        if len(ts) > node.allocatable.max_task_num:
            raise AssertionError(f"cfg{cfg}: node {node_name} over its pod count")
    for uid, n in per_job.items():
        if n < cache.jobs[uid].min_available:
            raise AssertionError(f"cfg{cfg}: gang {uid} bound {n} < min")


def capture_inputs():
    """Wrap the rounds solver's kernel wrappers so the first call of each
    (and the first dirty-column K1 call) keeps a copy of its inputs."""
    from volcano_tpu_torch.ops import rounds

    seen = {}
    real = {n: getattr(rounds, n) for n in
            ("score_block", "window_topk", "resolve_prefix", "queue_budget")}

    def cl(x):
        return x.clone() if isinstance(x, torch.Tensor) else x

    def wrap(name):
        def fn(*args, **kw):
            key = name
            if name == "score_block":
                key = "score_block_cols" if kw.get("cols") is not None else name
            if key not in seen:
                seen[key] = ([cl(a) for a in args], {k: cl(v) for k, v in kw.items()})
            return real[name](*args, **kw)
        return fn

    for name in real:
        setattr(rounds, name, wrap(name))

    def restore():
        for name, f in real.items():
            setattr(rounds, name, f)
    return seen, restore


def kernel_phase(scale):
    """Hold every kernel against its plain version on cfg5 main-path
    inputs; time both. Returns the kernel records (launches filled later)."""
    from volcano_tpu_torch.ops import kernels as K
    from volcano_tpu_torch.ops import rounds_kernels as RK

    seen, restore = capture_inputs()
    try:
        run_session(5, scale, "cuda", "float32")
        src = {k: "cfg5" for k in seen}
        if "score_block_cols" not in seen:
            # cfg5 placed everything before any dirty-column rescore: take
            # that variant's inputs from cfg2's path, which rescores
            run_session(2, scale, "cuda", "float32")
    finally:
        restore()
    missing = {"score_block", "window_topk", "resolve_prefix",
               "queue_budget"} - set(seen)
    if missing:
        raise AssertionError(f"cfg5 path never called {sorted(missing)}")
    records = []

    # K1, full and (when the path reached it) dirty-column
    for key in ("score_block", "score_block_cols"):
        if key not in seen:
            log(f"kernel phase: {key} not reached on the cfg5 path")
            continue
        (spec, enc, idle, used, cnt, occ, out), kw = seen[key]
        cols = kw.get("cols")
        k_rows, n = enc["cls_req"].shape[0], idle.shape[0]
        base = torch.full((k_rows, n), 7.0, dtype=idle.dtype, device=idle.device)
        got = base.clone()
        K.score_block(spec, enc, idle, used, cnt, occ, got, cols=cols)
        block = K.score_block_plain(spec, enc, idle, used, cnt, occ, cols)
        want = base.clone()
        if cols is None:
            want.copy_(block)
        else:
            want[:, cols.long()] = block
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = (got != want).sum().item()
            raise AssertionError(f"{key}: kernel != plain at {bad} cells")
        m = n if cols is None else cols.shape[0]
        dt = idle.dtype
        r = idle.shape[1]
        col_bytes = m * (3 * r * idle.element_size() + 8
                         + enc["sig_mask"].shape[0] * (1 + idle.element_size()))
        byts = nbytes(*(enc[x] for x in ("cls_req", "cls_initreq", "cls_sig",
                                         "cls_nz_cpu", "cls_nz_mem",
                                         "cls_has_pod"))) \
            + col_bytes + k_rows * m * idle.element_size() \
            + (0 if cols is None else nbytes(cols))
        ops = k_rows * m * (30 + 12 * r)
        scratch = base.clone()
        ms = time_ms(lambda: K.score_block(spec, enc, idle, used, cnt, occ,
                                           scratch, cols=cols))
        plain_ms = time_ms(lambda: K.score_block_plain(spec, enc, idle, used,
                                                       cnt, occ, cols))
        records.append(dict(
            name=key, kernel="score_block", route="cuda",
            source="volcano_tpu_torch/csrc/score_block.cu",
            replaces="volcano_tpu/ops/rounds.py:108" if cols is None
            else "volcano_tpu/ops/rounds.py:168",
            max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
            bytes=byts, ops=ops, dtype=dt, library_ms=None,
            shape=f"K={k_rows} cols={m} N={n} R={r} ({src.get(key, 'cfg2')})"))

    # K2
    (scores, k), _ = seen["window_topk"]
    s1, i1 = RK.window_topk(scores, k)
    s2, i2 = RK.window_topk_plain(scores, k)
    torch.cuda.synchronize()
    if not (torch.equal(i1, i2) and torch.equal(s1, s2)):
        raise AssertionError("window_topk: kernel != plain")
    records.append(dict(
        name="window_topk", kernel="window_topk", route="cuda",
        source="volcano_tpu_torch/csrc/window_topk.cu",
        replaces="volcano_tpu/ops/rounds.py:754", max_abs_err=0.0,
        ms=time_ms(lambda: RK.window_topk(scores, k)),
        plain_ms=time_ms(lambda: RK.window_topk_plain(scores, k)),
        library_ms=time_ms(lambda: torch.topk(scores, k, dim=1)),
        bytes=nbytes(scores) + scores.shape[0] * k * (scores.element_size() + 4),
        ops=scores.numel(), dtype=scores.dtype,
        shape=f"K={scores.shape[0]} N={scores.shape[1]} k={k}"))

    # K4
    args, _ = seen["resolve_prefix"]
    a1 = RK.resolve_prefix(*args)
    a2 = RK.resolve_prefix_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(a1, a2):
        raise AssertionError(f"resolve_prefix: kernel != plain at "
                             f"{(a1 != a2).sum().item()} rows")
    key_s, req_s, pod_s, bound, is_scalar, cnt, nmax, _ = args
    records.append(dict(
        name="resolve_prefix", kernel="resolve_prefix", route="cuda",
        source="volcano_tpu_torch/csrc/resolve_prefix.cu",
        replaces="volcano_tpu/ops/rounds.py:442", max_abs_err=0.0,
        ms=time_ms(lambda: RK.resolve_prefix(*args)),
        plain_ms=time_ms(lambda: RK.resolve_prefix_plain(*args)),
        library_ms=None,
        bytes=nbytes(key_s, req_s, pod_s, bound, is_scalar, cnt, nmax) + key_s.shape[0],
        ops=req_s.numel() * 3, dtype=torch.int64,
        shape=f"T={key_s.shape[0]} R={req_s.shape[1]} N={bound.shape[0]}"))

    # K5
    args, _ = seen["queue_budget"]
    b1 = RK.queue_budget(*args)
    b2 = RK.queue_budget_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(b1, b2):
        raise AssertionError(f"queue_budget: kernel != plain at "
                             f"{(b1 != b2).sum().item()} rows")
    q_s = args[0]
    records.append(dict(
        name="queue_budget", kernel="queue_budget", route="cuda",
        source="volcano_tpu_torch/csrc/queue_budget.cu",
        replaces="volcano_tpu/ops/rounds.py:495", max_abs_err=0.0,
        ms=time_ms(lambda: RK.queue_budget(*args)),
        plain_ms=time_ms(lambda: RK.queue_budget_plain(*args)),
        library_ms=None,
        bytes=nbytes(*args) + q_s.shape[0],
        ops=args[2].numel() * 4, dtype=torch.int64,
        shape=f"T={q_s.shape[0]} R={args[2].shape[1]} Q={args[4].shape[0]}"))
    for rec in records:
        peak = PEAK_OPS.get(rec["dtype"], PEAK_OPS[torch.float32])
        t_bytes = rec["bytes"] / MEM_BPS * 1e3
        t_ops = rec["ops"] / peak * 1e3
        rec["bound_ms"] = max(t_bytes, t_ops)
        rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        log(f"kernel {rec['name']} [{rec['shape']}]: equal to plain; "
            f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
            f"bound {rec['bound_ms']:.5f} ms ({rec['bound_by']})")
        print(json.dumps({"kernel": rec["name"], "shape": rec["shape"],
                          "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                          "library_ms": rec["library_ms"]}), flush=True)
    return records


def reference_check():
    """A small cfg5 session in float64: the card's binds equal the CPU's."""

    gpu, prof_g, _, _, _ = run_session(5, 0.02, "cuda", "float64")
    cpu, prof_c, _, _, _ = run_session(5, 0.02, "cpu", "float64")
    if prof_g.get("mode") != "rounds" or prof_c.get("mode") != "rounds":
        raise AssertionError("reference check: rounds mode did not run")
    if gpu.binder.binds != cpu.binder.binds or not gpu.binder.binds:
        raise AssertionError("reference check: card and CPU binds differ")
    print(json.dumps({"reference_check": "cfg5@0.02 float64 cuda == cpu",
                      "binds": len(gpu.binder.binds)}), flush=True)


def session_phase(scale):
    from volcano_tpu_torch import device as devmod

    launches = {}
    for cfg in (2, 3, 5):
        runs = []
        for _ in range(2):
            cache, prof, counts, n_tasks, wall = run_session(
                cfg, scale, "cuda", "float32")
            if prof.get("mode") != "rounds":
                raise AssertionError(f"cfg{cfg}: mode {prof.get('mode')}: {prof}")
            idle = [k for k, v in counts.items() if v == 0]
            if idle:
                raise AssertionError(f"cfg{cfg}: kernels never launched: {idle}")
            check_binds(cache, cfg)
            runs.append((cache.binder.binds, prof, counts, n_tasks, wall))
        if runs[0][0] != runs[1][0]:
            raise AssertionError(f"cfg{cfg}: two runs gave different binds")
        binds, prof, counts, n_tasks, wall = runs[1]
        launches[cfg] = runs[0][2]
        print(json.dumps({
            "cfg": cfg, "tasks": n_tasks, "nodes": prof.get("nodes"),
            "placed": prof.get("placed"), "binds": len(binds),
            "rounds": prof.get("rounds"),
            "sync_points": prof.get("tpu_sync_points"),
            "window_k": prof.get("window_k"), "dirty_k": prof.get("dirty_k"),
            "full_sweep_rounds": prof.get("full_sweep_rounds"),
            "encode_ms": prof["encode_s"] * 1e3,
            "solve_ms": prof["solve_s"] * 1e3,
            "apply_ms": prof["apply_s"] * 1e3,
            "session_ms": wall * 1e3,
            "launches": counts, "deterministic": True}), flush=True)
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="cluster scale of the cfg sessions (1.0 = full)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device is available")
        return 2
    import volcano_tpu_torch  # noqa: F401  (fails outside the repository)
    from volcano_tpu_torch import _build
    import volcano_tpu_torch.scheduler.actions  # noqa: F401
    import volcano_tpu_torch.scheduler.plugins  # noqa: F401

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    print(f"device: {smi}", flush=True)
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name in libs:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    records = kernel_phase(args.scale)
    reference_check()
    launches = session_phase(args.scale)
    out = []
    for rec in records:
        out.append({
            "name": rec["name"], "route": rec["route"], "source": rec["source"],
            "replaces": rec["replaces"],
            "launches": launches[5][rec["kernel"]],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
    print(f"power: {smi}", flush=True)
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
