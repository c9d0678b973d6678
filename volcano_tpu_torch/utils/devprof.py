"""Device-interaction counters: sync points, device-to-host fetches, and
the host work that overlaps the device.

Port of volcano_tpu/utils/devprof.py for PyTorch. Every place where the
port waits for the device routes through here so it can be counted:

- ``fetch(x)`` copies a result tensor to the host (one D2H fetch and one
  sync point);
- ``start_fetch(x)`` starts that copy without waiting (into pinned host
  memory, behind a recorded CUDA event) and returns ``wait()``; the host
  work between the two calls overlaps the device and is summed into
  ``overlap_s``, the time ``wait()`` blocks into ``fence_wait_s``;
- ``readback(x)`` reads loop-control scalars (one sync point): the rounds
  solver's host-driven loop makes one per loop test.

``session(profile)`` scopes the counters to one scheduler session; on exit
``tpu_sync_points``, ``tpu_d2h_fetches``, ``tpu_overlap_ms`` and
``tpu_fence_wait_ms`` land in the session profile (the key names the JAX
package's profile uses). A scope opened inside another adds its counts to
the enclosing one when it closes. Single-threaded, like the session loop
that owns it.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

_active: Optional[dict] = None


class _Collector(object):
    """Context manager installing a per-session counter dict."""

    def __init__(self, profile: dict):
        self.profile = profile
        self._prev: Optional[dict] = None

    def __enter__(self) -> dict:
        global _active
        self._prev = _active
        _active = {"sync_points": 0, "d2h_fetches": 0, "overlap_s": 0.0,
                   "fence_wait_s": 0.0}
        return _active

    def __exit__(self, *exc) -> None:
        global _active
        counters, _active = _active, self._prev
        if counters is None:
            return
        if _active is not None:
            for key, val in counters.items():
                _active[key] += val
        if self.profile is not None:
            self.profile["tpu_sync_points"] = counters["sync_points"]
            self.profile["tpu_d2h_fetches"] = counters["d2h_fetches"]
            self.profile["tpu_overlap_ms"] = round(
                counters["overlap_s"] * 1e3, 3)
            self.profile["tpu_fence_wait_ms"] = round(
                counters["fence_wait_s"] * 1e3, 3)


def session(profile: dict) -> _Collector:
    """Scope the counters to one session; results land in ``profile``."""
    return _Collector(profile)


def counters() -> Optional[dict]:
    """The live counter dict, or None outside any session scope."""
    return _active


def fetch(x) -> np.ndarray:
    """Copy tensor ``x`` to the host: a counted fetch and sync point."""
    if _active is not None:
        _active["d2h_fetches"] += 1
        _active["sync_points"] += 1
    return x.cpu().numpy()


def start_fetch(x: torch.Tensor) -> Callable[[], np.ndarray]:
    """Start copying tensor ``x`` to the host; returns wait() -> ndarray.

    On the card the copy is enqueued now on the current stream, behind the
    work that produces ``x`` and ahead of anything launched later, into
    pinned host memory, and a CUDA event marks its end; wait() blocks on
    that event only (the counted sync point), so host work between the two
    calls overlaps the device. On the CPU wait() is ``x.numpy()``.
    """
    t0 = time.perf_counter()
    if _active is not None:
        _active["d2h_fetches"] += 1
    if x.device.type == "cuda":
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(x.device))
    else:
        host, done = x, None

    def wait() -> np.ndarray:
        t1 = time.perf_counter()
        if done is not None:
            done.synchronize()
        out = host.numpy()
        if _active is not None:
            _active["sync_points"] += 1
            _active["overlap_s"] += t1 - t0
            _active["fence_wait_s"] += time.perf_counter() - t1
        return out

    return wait


def readback(x):
    """Read a small tensor of loop-control scalars to the host (a Python
    number, or a list for a vector): a counted sync point."""
    if _active is not None:
        _active["sync_points"] += 1
    return x.tolist()
