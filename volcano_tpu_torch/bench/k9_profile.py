"""Where K9's time goes: the preempt machine's phases on the card.

Builds volcano_tpu_torch/csrc/evict_preempt.cu with ``-DK9_PROFILE``, which
turns the kernel's PROF(k) marks into clock64() reads at CTA 0 thread 0
(the control machine's thread, which takes part in every phase), runs the
per-action preempt machine of a cfg4 session (float32) through that build,
and prints each phase's share of the kernel's time and microseconds a
walk. A phase ends at its mark, so a barrier's wait is the time CTA 0
spent in it.

On a machine with an NVIDIA GPU:

    python -m volcano_tpu_torch.bench.k9_profile [--scale 1.0]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

# PROF(k)'s phase k, in the kernel's order of k
PHASES = [
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
]


def build_command(out: str) -> list:
    """nvcc's command for the profiling build of K9 into ``out``: the
    kernels' own flags and source, with K9_PROFILE defined."""
    from volcano_tpu_torch import _build

    return [_build.nvcc_path(), *_build.NVCC_FLAGS, "-DK9_PROFILE", "-o", out,
            os.path.join(_build.CSRC, "evict_preempt.cu")]


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    return out.splitlines()[0]


def cfg4_preempt_inputs(scale: float):
    """The preempt machine's (spec, inputs) of a per-action cfg4 session on
    the card, float32."""
    from volcano_tpu_torch.bench.clusters import CONFIGS, build_config, make_tiers
    from volcano_tpu_torch.ops import evict_kernels as EK
    from volcano_tpu_torch.scheduler.framework import (
        close_session, open_session, run_actions)
    import volcano_tpu_torch.scheduler.actions  # noqa: F401
    import volcano_tpu_torch.scheduler.plugins  # noqa: F401

    seen = {}
    real = EK.solve_packed

    def keep(spec, enc):
        if spec.kind == "preempt" and "preempt" not in seen:
            seen["preempt"] = (spec, {k: v.clone() for k, v in enc.items()})
        return real(spec, enc)

    prev = os.environ.get("VOLCANO_TPU_FUSE")
    os.environ["VOLCANO_TPU_FUSE"] = "0"
    EK.solve_packed = keep
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
        EK.solve_packed = real
        if prev is None:
            os.environ.pop("VOLCANO_TPU_FUSE", None)
        else:
            os.environ["VOLCANO_TPU_FUSE"] = prev
    if "preempt" not in seen:
        raise RuntimeError("k9_profile: the session never ran the preempt machine")
    return seen["preempt"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=1.0, help="cfg4's cluster scale")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k9_profile: no CUDA device is available", file=sys.stderr)
        return 2
    from volcano_tpu_torch import _build
    from volcano_tpu_torch.ops import evict_kernels as EK

    spec, enc = cfg4_preempt_inputs(args.scale)
    os.makedirs(_build.BUILD, exist_ok=True)
    so = os.path.join(_build.BUILD, "libk9_profile.so")
    subprocess.run(build_command(so), check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    real = _build.library
    _build.library = lambda name: lib if name == "evict_preempt" else real(name)
    try:
        EK.solve_packed(spec, enc)                   # warm-up
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = EK.solve_packed(spec, enc)
        end.record()
        torch.cuda.synchronize()
    finally:
        _build.library = real
    ms = start.elapsed_time(end)
    cycles = (ctypes.c_longlong * len(PHASES))()
    lib.k9_profile_read.argtypes = [ctypes.c_void_p]
    if lib.k9_profile_read(cycles) != 0:
        raise RuntimeError("k9_profile: reading the counters failed")
    total = max(sum(cycles), 1)
    walks = max(int(out[-3]), 1)                     # attempts: one a walk at cfg4
    rows = {name: {"share": c / total, "us_a_walk": ms * 1e3 * c / total / walks}
            for (name, _), c in zip(PHASES, cycles)}
    n, v = enc["vic_job"].shape
    cluster, smem, spill = EK.preempt_layout(n, v, enc["node_used"].dtype)
    print(json.dumps({"k9_profile": smi_line(), "scale": args.scale, "N": n, "V": v,
                      "cluster": cluster, "smem": smem, "spill": spill, "ms": ms,
                      "walks": walks, "us_a_walk": ms * 1e3 / walks, "phases": rows}),
          flush=True)
    for name, what in PHASES:
        print(f"{name:18s} {rows[name]['us_a_walk']:8.3f} us a walk  {what}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
