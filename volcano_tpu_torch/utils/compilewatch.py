"""Compile-event accounting for steady-state guarantees.

Port of volcano_tpu/utils/jaxcompile.py. The module drops "jax" from its
name on purpose: the port has no XLA compiles to watch. What stands in
for a compile on a warm session's path is:

- a kernel library built by ``_build.py`` (one nvcc run; ``_build.BUILDS``
  counts them and their seconds);
- a solve graph captured by ``ops/rounds_graph.py`` (one a padded bucket;
  ``rounds_graph.STATS["captures"]`` and ``["capture_s"]``).

Either turns a warm cycle into a stall, so a warm session must read 0.
The bench records the per-session delta as ``compiles`` / ``compile_s``
(``tpu_warm_compiles``), and ``assert_no_compiles`` fails a block that
builds or captures. On the CPU neither happens: the kernels' plain
versions run and the rounds machine is driven from the host.

The counters are plain module state, read under one lock; builds and
captures happen on the thread that launches the work.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass


@dataclass
class CompileStats:
    compiles: int = 0
    compile_s: float = 0.0


def _now() -> CompileStats:
    from volcano_tpu_torch import _build
    from volcano_tpu_torch.ops import rounds_graph

    return CompileStats(
        compiles=_build.BUILDS["count"] + rounds_graph.STATS["captures"],
        compile_s=_build.BUILDS["seconds"] + rounds_graph.STATS["capture_s"])


class CompileWatcher:
    """Process-global view of kernel builds + graph captures.

    install() is idempotent; ``window()`` returns an object whose
    ``delta()`` yields the stats accumulated since the window was opened."""

    _instance: "CompileWatcher | None" = None
    _lock = threading.Lock()

    def __init__(self) -> None:
        self._mu = threading.Lock()

    @classmethod
    def install(cls) -> "CompileWatcher":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def snapshot(self) -> CompileStats:
        with self._mu:
            return _now()

    def window(self) -> "_Window":
        return _Window(self)

    @contextlib.contextmanager
    def assert_no_compiles(self, what: str = "warm path"):
        """Fail loudly if a kernel build or a graph capture lands inside
        the block (the enforcement twin of the bench's per-session
        ``tpu_warm_compiles``). Yields the window."""
        win = self.window()
        yield win
        d = win.delta()
        if d.compiles:
            raise AssertionError(
                f"{what}: {d.compiles} kernel build(s) or graph capture(s) "
                f"({d.compile_s:.3f}s) inside a no-compile window — a warm "
                f"session must reuse its built kernels and its bucket's "
                f"captured graph (bench tpu_warm_compiles)")


class _Window:
    def __init__(self, watcher: CompileWatcher):
        self._w = watcher
        self._base = watcher.snapshot()

    def delta(self) -> CompileStats:
        now = self._w.snapshot()
        b = self._base
        return CompileStats(compiles=now.compiles - b.compiles,
                            compile_s=now.compile_s - b.compile_s)
