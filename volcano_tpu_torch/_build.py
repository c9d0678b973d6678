"""Builds the hand-written CUDA kernels under ``csrc/`` and loads them.

Each ``csrc/<name>.cu`` compiles on first use, with the CUDA toolkit's
``nvcc`` and nothing else, into ``csrc/build/lib<name>-<hash>.so``: a
shared library with a plain C interface, loaded with ctypes (no PyTorch
headers, so a build takes seconds). The hash covers the source, the
shared headers and the flags, so an edited source never loads a stale
library. ``build_all`` starts one ``nvcc`` per source, all together.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``--fmad=false``: the scores
decide placements through ties, so a kernel must round exactly as its
plain PyTorch version does; where the JAX reference fuses a multiply-add
the kernel asks for ``fma()`` by name. Never ``--use_fast_math``.

``BUILDS`` counts the libraries built in this process and the seconds
their nvcc runs took (utils/compilewatch.py reads it: a warm session
builds nothing).

Nothing here runs at import time; on a host without ``nvcc`` only a
build attempt fails. A failed build raises ``KernelBuildError``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict, List

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD = os.path.join(CSRC, "build")
KERNELS = ("score_block", "window_topk", "resolve_prefix", "queue_budget",
           "evict_preempt", "evict_reclaim", "evict_backfill", "fuse_heaps",
           "scatter_rows", "express_place", "parity_scan", "rounds_ctl",
           "tail_pass", "probe_evict_fold", "round_select", "round_commit",
           "cap_walk", "job_rank")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LOADED: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


BUILDS = {"count": 0, "seconds": 0.0}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand:
            p = os.path.join(cand, "bin", "nvcc")
            if os.path.exists(p):
                return p
    p = shutil.which("nvcc")
    if p is None:
        raise KernelBuildError("nvcc not found: the CUDA kernels build only on "
                           "a host with the CUDA toolkit")
    return p


def _headers() -> List[str]:
    return sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))


def _target(name: str) -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for f in [name + ".cu"] + _headers():
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(f.encode() + b"\0" + fh.read())
    return os.path.join(BUILD, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start one nvcc (or return None when the library is built)."""
    out = _target(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    log = open(os.path.join(BUILD, name + ".log"), "w")
    proc = subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")],
        stdout=log, stderr=subprocess.STDOUT)
    return proc, tmp, out, log, time.perf_counter()


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out, log, t0 = job
    rc = proc.wait()
    BUILDS["count"] += 1
    BUILDS["seconds"] += time.perf_counter() - t0
    log.close()
    with open(log.name) as fh:
        text = fh.read()
    if rc != 0:
        os.unlink(tmp)
        raise KernelBuildError(f"nvcc failed for {name}.cu (rc {rc}):\n{text}")
    os.replace(tmp, out)


def build_all(names=KERNELS) -> Dict[str, str]:
    """Build every kernel library, one nvcc per source, all in parallel.
    Returns {name: path of the shared library}."""
    jobs = {name: _start(name) for name in names}
    errors = []
    for name, job in jobs.items():
        try:
            _finish(name, job)
        except KernelBuildError as e:
            errors.append(str(e))
    if errors:
        raise KernelBuildError("\n".join(errors))
    return {name: _target(name) for name in names}


def build_log(name: str) -> str:
    """The compiler's output of the last build of ``name`` (ptxas -v
    register and shared-memory lines), or '' when it was not built here."""
    p = os.path.join(BUILD, name + ".log")
    if not os.path.exists(p):
        return ""
    with open(p) as fh:
        return fh.read()


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = _LOADED[name] = ctypes.CDLL(_target(name))
    return lib
