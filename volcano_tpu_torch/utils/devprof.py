"""Device-interaction counters: sync points and device-to-host fetches.

Port of volcano_tpu/utils/devprof.py for PyTorch. Every place where the
port waits for the device routes through here so it can be counted:

- ``fetch(x)`` copies a result tensor to the host (one D2H fetch and one
  sync point);
- ``readback(x)`` reads loop-control scalars (one sync point): the rounds
  solver's host-driven loop makes one per loop test.

``session(profile)`` scopes the counters to one scheduler session; on exit
``tpu_sync_points`` and ``tpu_d2h_fetches`` land in the session profile
(the key names the JAX package's profile uses). Single-threaded, like the
session loop that owns it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

_active: Optional[dict] = None


class _Collector(object):
    """Context manager installing a per-session counter dict."""

    def __init__(self, profile: dict):
        self.profile = profile
        self._prev: Optional[dict] = None

    def __enter__(self) -> dict:
        global _active
        self._prev = _active
        _active = {"sync_points": 0, "d2h_fetches": 0}
        return _active

    def __exit__(self, *exc) -> None:
        global _active
        counters, _active = _active, self._prev
        if counters is not None and self.profile is not None:
            self.profile["tpu_sync_points"] = counters["sync_points"]
            self.profile["tpu_d2h_fetches"] = counters["d2h_fetches"]


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


def readback(x):
    """Read a small tensor of loop-control scalars to the host (a Python
    number, or a list for a vector): a counted sync point."""
    if _active is not None:
        _active["sync_points"] += 1
    return x.tolist()
