"""K1's grid on the card: csrc/score_block.cu built at several targets of
CTAs an SM (``kCtasPerSm``; 0 gives every CTA 16 class rows, whatever
the shape), each timed on the rounds a solve gives K1.

A cell's work is a chain of dependent loads and divisions, so the number
of threads in flight decides K1's time more than loading a node's state
once for many rows does; the committed target is the one this measures
best. Each build is held equal to the plain version (round_cases
``hold_score_round``: scores by their bits, the counts, the scratch left
zero; the full entry's scores by their bits) and timed as 20 calls in a
CUDA graph (chip_smoke.graph_ms's method): the round entry on the first
full and the first dirty round of host-driven cfg5, cfg2 and cfg6 solves
at full scale (float32), and the full-refresh entry on the full rounds.
One JSON line a build.

On a machine with an NVIDIA GPU:

    python -m volcano_tpu_torch.bench.score_round_designs
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import re
import subprocess

import torch

TARGETS = (0, 1, 2, 4, 8, 16)


def _build_target(target: int) -> ctypes.CDLL:
    """csrc/score_block.cu with kCtasPerSm = ``target``, built beside the
    kernels (csrc/build/) and loaded."""
    from volcano_tpu_torch import _build

    with open(os.path.join(_build.CSRC, "score_block.cu")) as fh:
        text = fh.read()
    text, n = re.subn(r"constexpr int kCtasPerSm = \d+;",
                      f"constexpr int kCtasPerSm = {target};", text)
    if n != 1:
        raise RuntimeError("score_block.cu: no kCtasPerSm constant to set")
    os.makedirs(_build.BUILD, exist_ok=True)
    src = os.path.join(_build.BUILD, f"score_block_ctas{target}.cu")
    out = os.path.join(_build.BUILD, f"libscore_block_ctas{target}.so")
    with open(src, "w") as fh:
        fh.write(text)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC,
                    "-o", out, src], check=True, capture_output=True)
    return ctypes.CDLL(out)


@contextlib.contextmanager
def using(lib):
    """K1's wrappers (ops/kernels.py) launch ``lib``'s entries while open."""
    from volcano_tpu_torch.ops import kernels as K

    saved = dict(K._SCORE_FNS)
    for entry in ("score_round", "score_block"):
        for dt, suffix in ((torch.float32, "_f32"), (torch.float64, "_f64")):
            fn = getattr(lib, entry + suffix)
            fn.argtypes = [ctypes.POINTER(K._ScoreArgs), ctypes.c_void_p]
            fn.restype = ctypes.c_int
            K._SCORE_FNS[(entry, dt)] = fn
    try:
        yield
    finally:
        K._SCORE_FNS.clear()
        K._SCORE_FNS.update(saved)


def rounds():
    """(label, args) of the first full and the first dirty round K1 gets
    in host-driven cfg5, cfg2 and cfg6 solves (full scale, float32)."""
    from volcano_tpu_torch.bench import round_cases as RC
    from volcano_tpu_torch.bench.round_split import solve_inputs
    from volcano_tpu_torch.ops import kernels as K

    out = []
    for cfg in (5, 2, 6):
        spec, enc = solve_inputs(cfg, 1.0)
        seen = [a for a, _ in RC.record_solve(spec, enc, limit=24, kinds=("score",))["score"]]
        for kind, full in (("full", True), ("dirty", False)):
            args = next((a for a in seen if K.round_is_full(a[0], int(a[8])) == full), None)
            if args is not None:
                n = int(args[6].shape[1]) if full else int(args[7].sum())
                out.append((f"cfg{cfg} {kind} (K={args[6].shape[0]}, {n} columns)", args))
    return out


def main() -> int:
    from volcano_tpu_torch.bench.job_rank_designs import graph_ms
    from volcano_tpu_torch.bench.round_cases import bit_equal, hold_score_round
    from volcano_tpu_torch.ops import kernels as K

    if not torch.cuda.is_available():
        raise SystemExit("score_round_designs: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    cases = rounds()
    for target in TARGETS:
        lib = _build_target(target)
        row = {}
        with using(lib):
            for label, args in cases:
                hold_score_round(args, f"kCtasPerSm {target}, {label}")
                spec, enc, idle, used, cnt, occ, scores, dirty, n_dirty, n_feas = args[:10]
                s_t, f_t = scores.clone(), n_feas.clone()
                acc = torch.zeros(n_feas.shape[0] + 1, dtype=torch.int32, device="cuda")
                w = K.score_weights(enc)
                row[label] = graph_ms(lambda: K.score_round(
                    spec, enc, idle, used, cnt, occ, s_t, dirty, n_dirty, f_t, w, acc))
                if K.round_is_full(spec, int(n_dirty)):
                    K.score_block(spec, enc, idle, used, cnt, occ, s_t, w)
                    if not bit_equal(s_t, K.score_block_plain(spec, enc, idle, used, cnt, occ)):
                        raise AssertionError(f"score_block != plain: {label}")
                    row[label + ", full entry"] = graph_ms(lambda: K.score_block(
                        spec, enc, idle, used, cnt, occ, s_t, w))
        print(json.dumps({"kernel": "score_round", "kCtasPerSm": target, "card": card,
                          "ms": row}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
