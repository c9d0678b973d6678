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
  solver's host-driven step machine (``loop="host"``) makes one per step
  and per windowed round; the graph-replayed solve makes none;
- ``note_overlappable(rows)`` counts a launch nobody waits for (the
  device replica's row scatters);
- ``register(x)`` tracks a launched result consumed on the device,
  ``discard(x)`` forgets one without fetching it (the pipeline's
  invalidated speculative stages), and ``fence(x)`` / ``drain()`` wait for
  one or for everything tracked: on a CUDA event recorded behind the
  result's producer (a counted sync point).

``session(profile)`` scopes the counters to one scheduler session; on exit
``tpu_sync_points``, ``tpu_d2h_fetches``, ``tpu_overlap_ms`` and
``tpu_fence_wait_ms`` land in the session profile (the key names the JAX
package's profile uses). A scope opened inside another adds its counts to
the enclosing one when it closes. Single-threaded, like the session loop
that owns it.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

_active: Optional[dict] = None

# launched results with a pending fetch or fence, as (tensor, CUDA event
# recorded behind its producer, or None on the CPU); dropped once waited on
_inflight: List[Tuple[torch.Tensor, Optional[torch.cuda.Event]]] = []


def _forget(x) -> None:
    """Drop ``x`` from the in-flight list by IDENTITY: list.remove would
    compare tensors with ``==``, which broadcasts (and raises outright for
    mismatched shapes, as soon as two solves of different buckets are in
    flight)."""
    for i, (t, _) in enumerate(_inflight):
        if t is x:
            del _inflight[i]
            return


def _behind(x: torch.Tensor) -> Optional[torch.cuda.Event]:
    """A CUDA event recorded now on the current stream (behind the work
    that produces ``x``), or None for a CPU tensor."""
    if x.device.type != "cuda":
        return None
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(x.device))
    return done


class _Collector(object):
    """Context manager installing a per-session counter dict."""

    def __init__(self, profile: dict):
        self.profile = profile
        self._prev: Optional[dict] = None

    def __enter__(self) -> dict:
        global _active
        self._prev = _active
        _active = {"sync_points": 0, "d2h_fetches": 0, "overlap_s": 0.0,
                   "fence_wait_s": 0.0, "overlappable_dispatches": 0,
                   "overlappable_rows": 0}
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
            self.profile["tpu_overlappable_dispatches"] = \
                counters["overlappable_dispatches"]
            self.profile["tpu_overlappable_rows"] = \
                counters["overlappable_rows"]


def session(profile: dict) -> _Collector:
    """Scope the counters to one session; results land in ``profile``."""
    return _Collector(profile)


def counters() -> Optional[dict]:
    """The live counter dict, or None outside any session scope."""
    return _active


def fetch(x) -> np.ndarray:
    """Copy tensor ``x`` to the host: a counted fetch and sync point."""
    if getattr(x, "devprof_fetch", None) is not None:
        return start_fetch(x)()
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
    calls overlaps the device. On the CPU wait() is ``x.numpy()``. A
    solve by the rounds graph (ops/rounds_graph.py) started its copy
    itself: ``x`` then carries ``devprof_fetch`` (the event behind the
    copy, the read of it), and may be the graph's handle of the copy
    rather than a tensor.
    """
    t0 = time.perf_counter()
    if _active is not None:
        _active["d2h_fetches"] += 1
    started = getattr(x, "devprof_fetch", None)
    if started is not None:
        done, read = started
    else:
        if x.device.type == "cuda":
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x, non_blocking=True)
        else:
            host = x
        done, read = _behind(x), host.numpy
    _inflight.append((x, done))

    def wait() -> np.ndarray:
        t1 = time.perf_counter()
        if done is not None:
            done.synchronize()
        out = read()
        if _active is not None:
            _active["sync_points"] += 1
            _active["overlap_s"] += t1 - t0
            _active["fence_wait_s"] += time.perf_counter() - t1
        _forget(x)
        return out

    return wait


def note_overlappable(rows: int = 0) -> None:
    """Count an asynchronous device launch whose result is never fetched
    or fenced by its issuer — the replica's row scatters (ops/replica.py):
    the scatter enqueues, the session's host work continues, and the
    tensors are consumed on the card by the next solve. These are the
    opposite of sync points."""
    if _active is not None:
        _active["overlappable_dispatches"] += 1
        _active["overlappable_rows"] += int(rows)


def register(x: torch.Tensor) -> None:
    """Track a launched result that is consumed on the device, so that a
    later fence() waits for it."""
    _inflight.append((x, _behind(x)))


def discard(x) -> None:
    """Forget a launched result WITHOUT fetching it: the pipeline's
    invalidated speculative stages. The value is never read, and later
    fence() calls no longer wait on it."""
    _forget(x)


def fence(x: Optional[torch.Tensor] = None) -> None:
    """Wait until ``x`` (or, with no argument, every tracked result) is
    computed: on the CUDA event recorded behind its producer, or by
    synchronising its stream when it was never tracked. A counted sync
    point. With no argument the waited results are forgotten."""
    t0 = time.perf_counter()
    if x is None:
        targets = list(_inflight)
    else:
        targets = [e for e in _inflight if e[0] is x] or [(x, None)]
    blocked = False
    for t, done in targets:
        if done is not None:
            done.synchronize()
        elif t.device.type == "cuda":
            torch.cuda.current_stream(t.device).synchronize()
        blocked = True
        if x is None:
            _forget(t)
    if _active is not None and blocked:
        _active["sync_points"] += 1
        _active["fence_wait_s"] += time.perf_counter() - t0


def drain() -> None:
    """fence() of everything in flight."""
    fence(None)


def readback(x):
    """Read a small tensor of loop-control scalars to the host (a Python
    number, or a list for a vector): a counted sync point."""
    if _active is not None:
        _active["sync_points"] += 1
    return x.tolist()
