"""Native host engines, compiled lazily at first use.

Port of volcano_tpu/_native/__init__.py. The control plane is Python with
the solve on the GPU; the few remaining interpreted hot loops (the
bulk-apply writeback and its deferred cache-mirror flush, the
per-operation preempt/reclaim transitions, the preempt candidate-head
pick) have C equivalents here (``fastapply.c``, ``fasttrans.c``),
compiled on demand with the system's C compiler (``cc``, not nvcc: this
is host code) into this package directory and imported as
``volcano_tpu_torch._native._fastapply`` / ``._fasttrans``. Every native
path has a pure-Python fallback, the oracle: a missing compiler, a failed
build or import, or ``VOLCANO_TPU_NO_NATIVE`` set degrades to it, never
to an error.
"""

from __future__ import annotations

import importlib
import logging
import os
import subprocess
import sysconfig

logger = logging.getLogger(__name__)

_DIR = os.path.dirname(os.path.abspath(__file__))
# per-module load state: name -> {"mod": module|None, "tried": bool,
# "done": bool, "thread": Thread|None}. "tried" gates re-attempts;
# "done" means the attempt fully finished (build+import) — the two differ
# while a build is in flight.
_STATE: dict = {}
# per-module build locks, deliberately OUTSIDE _STATE: _reset() must not
# clear them, or a reset mid-compile would let a second cc race the first
# on the shared .so.tmp output
_LOCKS: dict = {}


def _lock(modname: str):
    import threading

    lk = _LOCKS.get(modname)
    if lk is None:
        lk = _LOCKS.setdefault(modname, threading.Lock())
    return lk


def _paths(src: str, modname: str):
    ext = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return os.path.join(_DIR, src), os.path.join(_DIR, modname + ext)


def _is_fresh(src_path: str, out: str) -> bool:
    return (os.path.exists(out)
            and os.path.getmtime(out) >= os.path.getmtime(src_path))


def _build(src: str, modname: str) -> bool:
    src_path, out = _paths(src, modname)
    if _is_fresh(src_path, out):
        return True
    cc = sysconfig.get_config_var("CC") or "cc"
    include = sysconfig.get_paths()["include"]
    cmd = [*cc.split(), "-O2", "-fPIC", "-shared",
           f"-I{include}", src_path, "-o", out + ".tmp"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except Exception as e:  # toolchain absent or not runnable
        logger.info("native build unavailable (%s); using Python fallback", e)
        return False
    if proc.returncode != 0:
        logger.warning("native build failed; using Python fallback:\n%s",
                       proc.stderr[-2000:])
        return False
    os.replace(out + ".tmp", out)
    return True


def _get(src: str, modname: str):
    """The compiled module, or None (callers keep the Python loop).
    Build+import attempted once per process per module. BLOCKS on the
    compiler the first time — latency-critical callers use _get_nowait.
    The per-module lock serializes a blocking call racing the background
    thread (only one cc ever writes the .so.tmp)."""
    with _lock(modname):
        st = _STATE.setdefault(
            modname, {"mod": None, "tried": False, "done": False, "thread": None})
        if st["tried"]:
            return st["mod"]
        st["tried"] = True
        try:
            if os.environ.get("VOLCANO_TPU_NO_NATIVE"):
                return None
            try:
                if _build(src, modname):
                    st["mod"] = importlib.import_module(
                        f"{__name__}.{modname}")
            except Exception:
                logger.exception(
                    "native %s unavailable; using Python fallback", modname)
                st["mod"] = None
        finally:
            st["done"] = True
        return st["mod"]


def _get_nowait(src: str, modname: str):
    """Non-blocking variant for critical paths: returns the module if it is
    already available (cached .so imports in milliseconds), else kicks the
    compile off on a background thread ONCE and returns None — the first
    session runs the Python fallback instead of waiting on cc."""
    st = _STATE.setdefault(
        modname, {"mod": None, "tried": False, "done": False, "thread": None})
    if st["done"]:
        return st["mod"]
    if os.environ.get("VOLCANO_TPU_NO_NATIVE"):
        return None
    src_path, out = _paths(src, modname)
    if _is_fresh(src_path, out):
        return _get(src, modname)  # import only — no compiler run
    if st["thread"] is None:
        import threading

        st["thread"] = threading.Thread(
            target=_get, args=(src, modname), daemon=True)
        st["thread"].start()
    return None


def _reset() -> None:
    """Forget load state so the next get_* re-evaluates the env gate and
    build (tests poke this; the .so cache on disk is untouched). The build
    locks survive, so a reset cannot let two compiles race."""
    _STATE.clear()


def settled(modname: str) -> bool:
    """True once a load attempt for `modname` fully finished (module built,
    failed, or env-disabled); False while a build is still in flight."""
    if os.environ.get("VOLCANO_TPU_NO_NATIVE"):
        return True
    st = _STATE.get(modname)
    return bool(st and st["done"])


def get_fastapply():
    return _get("fastapply.c", "_fastapply")


def get_fastapply_nowait():
    return _get_nowait("fastapply.c", "_fastapply")


def get_fasttrans():
    return _get("fasttrans.c", "_fasttrans")


def get_fasttrans_nowait():
    return _get_nowait("fasttrans.c", "_fasttrans")
