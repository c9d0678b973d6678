"""Device and dtype policy, and the kernels' launch counters.

Every entry point of the port takes an explicit ``device`` and ``dtype``.
The device defaults to ``cuda``; asking for it on a host without a usable
GPU raises instead of carrying on on the CPU. The CPU is used only when the
caller names it (the tests do, and then every kernel wrapper takes its
plain PyTorch version because its tensors lie on the CPU).

float32 is the default on the card, float64 is accepted (it is the parity
dtype the CPU tests use), and bf16/fp16 are refused: the memory epsilon is
10 MiB on byte-valued quantities near 1e11, which needs more than 8 (or
11) mantissa bits (scheduler/plugins/tpuscore.py in the JAX package).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Union

import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64}

# launches of each hand-written kernel, bumped by its wrapper right where
# the kernel is launched (never on the plain-version path); chip_smoke.py
# zeroes them before it drives the main path and reads them after. A launch
# recorded into a CUDA graph is no launch: while a graph body is captured
# its wrapper's count goes to the body's sink (capture_sink), and the
# graph's owner adds sink x the times the body ran once it knows them
# (ops/rounds_graph.py, at the solve's fetch)
LAUNCHES: Dict[str, int] = {
    "score_block": 0,
    "window_topk": 0,
    "resolve_prefix": 0,
    "queue_budget": 0,
    "queue_budget_mask": 0,
    "evict_preempt": 0,
    "evict_reclaim": 0,
    "evict_backfill": 0,
    "evict_preempt_fused": 0,
    "evict_reclaim_fused": 0,
    "fuse_heaps_preempt": 0,
    "fuse_heaps_reclaim": 0,
    "scatter_rows": 0,
    "express_place": 0,
    "parity_scan": 0,
    "rounds_ctl": 0,
    "tail_pass": 0,
    "probe_evict_fold": 0,
    "round_select": 0,
    "round_commit": 0,
    "cap_walk": 0,
    "job_rank": 0,
    "job_rank_count": 0,
}

_SINKS: List[Dict[str, int]] = []


def count_launch(name: str) -> None:
    if _SINKS:
        _SINKS[-1][name] = _SINKS[-1].get(name, 0) + 1
        return
    LAUNCHES[name] += 1


@contextlib.contextmanager
def capture_sink():
    """Collect the launches recorded while a graph body is captured."""
    sink: Dict[str, int] = {}
    _SINKS.append(sink)
    try:
        yield sink
    finally:
        _SINKS.pop()


def add_launches(counts: Dict[str, int], times: int = 1) -> None:
    """Count launches a graph replay made: ``counts`` x ``times``."""
    for name, n in counts.items():
        LAUNCHES[name] += n * times


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launches() -> Dict[str, int]:
    return dict(LAUNCHES)


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for ``cpu``. Raises when CUDA is asked for (or defaulted to) and no GPU
    is usable."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "volcano_tpu_torch: no CUDA device is available; pass "
            "device='cpu' (tpuscore.device: cpu) to run on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def resolve_dtype(dtype: Union[str, torch.dtype, None],
                  device: torch.device) -> torch.dtype:
    """float32 on the card and float64 on the CPU unless named; float32
    and float64 are the only accepted score/state dtypes."""
    if dtype is None or dtype == "":
        return torch.float32 if device.type == "cuda" else torch.float64
    if isinstance(dtype, str):
        if dtype not in DTYPES:
            raise ValueError(
                f"dtype {dtype!r} not supported ({'/'.join(DTYPES)}); "
                "bf16/fp16 lack the mantissa bits the memory epsilon needs")
        return DTYPES[dtype]
    if dtype not in DTYPES.values():
        raise ValueError(f"dtype {dtype} not supported (float32/float64)")
    return dtype


def raw_stream(device: torch.device) -> int:
    """The handle of ``device``'s current CUDA stream, as an int: what
    ``torch.cuda.current_stream(device).cuda_stream`` gives, without building
    a Stream object (0.1 against 7.4 us a call on the host of an NVIDIA
    H100 80GB HBM3 at 700.00 W, where a kernel wrapper's host time can
    decide a short kernel's time)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def on_cuda(*tensors: Optional[torch.Tensor]) -> bool:
    """True when the (non-None) tensors lie on a CUDA device. Mixed
    placement is a caller error."""
    kinds = {t.device.type for t in tensors if t is not None}
    if len(kinds) > 1:
        raise ValueError(f"tensors on mixed devices: {sorted(kinds)}")
    return kinds == {"cuda"}
