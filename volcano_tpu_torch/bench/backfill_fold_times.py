"""K11 (evict_backfill), K16b (probe_evict_fold) and K16a (probe_refresh)
timed on the card, for the package of a given checkout, so that a parent
commit and its change are timed by the same code in one call (in turns:
parent, change, change, parent).

``--tree DIR`` puts DIR first on the import path (default: the checkout
holding this file); the script uses only what both trees have: the
wrappers' Python signatures (``evict_kernels.backfill``,
``shard.probe_evict_fold``, ``shard.probe_refresh``), their plain
versions, the launch counters and ``_build.library``.

- K11 on the backfill inputs of a per-action cfg4 session (full scale,
  float32; the session runs allocate and backfill);
- K16b on one shard's seeded victim slice at cfg7 x 0.65's width (W =
  32,500 at d = 1, 4,063 at d = 8; V = 8, R = 2, float32);
- K16a on that encode's class and node arrays (d = 1 and d = 8).

Each is held equal to its plain version (torch.equal) with one launch a
call (K16a: 16), then timed three ways: ``ms``, CUDA events over 20
back-to-back wrapper calls after 3 warm-ups (chip_smoke.py's
``time_ms``); ``graph_ms``, 20 calls captured in one CUDA graph and
replayed 5 times (K11 through its wrapper; K16b through its C entry with
the factors built once, which the parent's wrapper would copy from the
host inside the capture; ``memset_graph_ms`` the same with W = 0, where
the entry only zeroes the count); ``host_ms``, the wrapper's host time a
call (20 calls, no sync between). One JSON line a measurement, with the card's
name and power limit.

On a machine with an NVIDIA GPU:

    python volcano_tpu_torch/bench/backfill_fold_times.py [--tree DIR] [--label A1]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    return out.splitlines()[0]


def time_ms(torch, fn, reps=20, warmup=3) -> float:
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


def graph_ms(torch, fn, reps=20, replays=5) -> float:
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(reps):
                fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def host_ms(torch, fn, reps=20) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


def backfill_inputs():
    """(spec, enc) of K11's call in a per-action cfg4 session on the card."""
    from volcano_tpu_torch.bench.clusters import CONFIGS, build_config, make_tiers
    from volcano_tpu_torch.ops import evict_kernels as EK
    from volcano_tpu_torch.scheduler.framework import (
        close_session, open_session, run_actions)
    import volcano_tpu_torch.scheduler.actions  # noqa: F401
    import volcano_tpu_torch.scheduler.plugins  # noqa: F401

    seen = {}
    real = EK.solve_packed

    def keep(spec, enc):
        if spec.kind == "backfill" and not seen:
            seen["backfill"] = (spec, {k: v.clone() for k, v in enc.items()})
        return real(spec, enc)

    os.environ["VOLCANO_TPU_FUSE"] = "0"
    EK.solve_packed = keep
    try:
        cache, *_ = build_config(4, 1.0)
        ssn = open_session(cache, make_tiers(["tpuscore"], *CONFIGS[4].tiers, arguments={
            "tpuscore": {"tpuscore.mode": "rounds", "tpuscore.device": "cuda",
                         "tpuscore.dtype": "float32"}}))
        try:
            run_actions(ssn, ["allocate", "backfill"])
        finally:
            close_session(ssn)
    finally:
        EK.solve_packed = real
        os.environ.pop("VOLCANO_TPU_FUSE", None)
    if not seen:
        raise RuntimeError("cfg4's session never called the backfill machine")
    return seen["backfill"]


def cfg7_prepare(scale):
    """(spec, host arrays) of one rounds-mode cfg7 encode on the card."""
    from volcano_tpu_torch.bench.clusters import CONFIGS, make_cache
    from volcano_tpu_torch.bench.run import _tpu_tiers
    from volcano_tpu_torch.scheduler.framework import close_session, open_session

    cache = make_cache()
    CONFIGS[7].populate(cache, scale)
    ssn = open_session(cache, _tpu_tiers(CONFIGS[7].tiers, "cuda", "float32", mode="rounds"))
    prep = ssn.batch_allocator._prepare(ssn)
    close_session(ssn)
    return prep["spec"], prep["arrays"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(HERE)),
                    help="the checkout whose package is timed")
    ap.add_argument("--label", default="", help="printed with every line")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("backfill_fold_times: no CUDA device is available", file=sys.stderr)
        return 2
    import volcano_tpu_torch
    from volcano_tpu_torch import _build, device as devmod
    from volcano_tpu_torch.ops import evict_kernels as EK, shard
    from volcano_tpu_torch.ops.solver import _NODE_AXIS

    if not os.path.abspath(volcano_tpu_torch.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {volcano_tpu_torch.__file__}, not from {tree}")
    card = smi_line()
    _build.build_all(("evict_backfill", "probe_evict_fold", "score_block"))
    head = {"label": args.label, "tree": tree, "card": card}

    def emit(**kw):
        print(json.dumps({**head, **kw}), flush=True)

    spec, enc = backfill_inputs()
    devmod.reset_launches()
    got = EK.backfill(spec, enc)
    torch.cuda.synchronize()
    if devmod.launches()["evict_backfill"] != 1:
        raise AssertionError(f"evict_backfill: {devmod.launches()['evict_backfill']} launches")
    if not torch.equal(got, EK.backfill_plain(spec, enc)):
        raise AssertionError("evict_backfill != backfill_plain at cfg4")
    s_rows, n = enc["sig_mask"].shape

    def k11():
        return EK.backfill(spec, enc)

    emit(kernel="evict_backfill", shape=f"cfg4 T={enc['b_sig'].shape[0]} S={s_rows} N={n}",
         placed=int((got >= 0).sum()), ms=time_ms(torch, k11),
         graph_ms=graph_ms(torch, k11), host_ms=host_ms(torch, k11))

    p_spec, arrays = cfg7_prepare(0.65)
    lib = _build.library("probe_evict_fold")
    for d in (1, 8):
        width, p_enc, fold = shard.stage_probe(arrays, _NODE_AXIS, d, device="cuda",
                                               dtype="float32")
        devmod.reset_launches()
        count = shard.probe_evict_fold(*fold)
        torch.cuda.synchronize()
        if devmod.launches()["probe_evict_fold"] != 1:
            raise AssertionError("probe_evict_fold: not one launch")
        if not torch.equal(count, shard.probe_evict_fold_plain(*fold)):
            raise AssertionError(f"probe_evict_fold != plain at d={d}")
        w, v, r = fold[0].shape
        factors = shard._factor_tensor(shard._PROBE_REPS, fold[0].dtype, fold[0].device)
        out = torch.empty((), dtype=torch.int32, device="cuda")
        entry = lib.probe_evict_fold_f32
        entry.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 9
        entry.restype = ctypes.c_int
        ptrs = [t.data_ptr() for t in (*fold, factors, out)]

        def c_entry(rows=w):
            rc = entry(rows, v, r, shard._PROBE_REPS, *ptrs,
                       torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"probe_evict_fold: CUDA error {rc}")

        c_entry()
        torch.cuda.synchronize()
        if int(out) != int(count):
            raise AssertionError("probe_evict_fold's C entry != its wrapper")

        def k16b():
            return shard.probe_evict_fold(*fold)

        emit(kernel="probe_evict_fold", shape=f"cfg7 d={d}: W={w} V={v} R={r}",
             count=int(count), ms=time_ms(torch, k16b), graph_ms=graph_ms(torch, c_entry),
             memset_graph_ms=graph_ms(torch, lambda: c_entry(0)), host_ms=host_ms(torch, k16b))
        want = shard.probe_refresh_plain(p_spec, p_enc)
        devmod.reset_launches()
        if not torch.equal(shard.probe_refresh(p_spec, p_enc), want):
            raise AssertionError(f"probe_refresh != plain at d={d}")
        if devmod.launches()["score_block"] != shard._PROBE_REPS:
            raise AssertionError("probe_refresh: not one K1 launch a rep")

        def k16a():
            return shard.probe_refresh(p_spec, p_enc)

        emit(kernel="probe_refresh", shape=f"cfg7 d={d}: N/d={width}",
             ms=time_ms(torch, k16a, reps=5, warmup=1), host_ms=host_ms(torch, k16a, reps=5))
    return 0


if __name__ == "__main__":
    sys.exit(main())
