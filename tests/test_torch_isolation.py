"""The port stands alone: it imports neither jax nor anything of
volcano_tpu, and it never carries on on the CPU unless asked to."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "volcano_tpu_torch")


def _port_files():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top == "jax" or top.startswith("jax") or top == "volcano_tpu"


def test_no_port_file_imports_jax_or_the_jax_package():
    offenders = []
    files = list(_port_files())
    assert len(files) > 40
    for path in files:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{os.path.relpath(path, REPO)}: {n}"
                          for n in names if _forbidden(n)]
    assert not offenders, offenders


_SESSION = r"""
import sys
import torch
torch.set_num_threads(1)
from volcano_tpu_torch.bench.clusters import CONFIGS, build_config, make_tiers
from volcano_tpu_torch.scheduler.framework import close_session, open_session, run_actions
import volcano_tpu_torch.scheduler.actions, volcano_tpu_torch.scheduler.plugins
cache, _, _, _, n = build_config(5, 0.01)
tiers = make_tiers(["tpuscore"], *CONFIGS[5].tiers, arguments={"tpuscore": {
    "tpuscore.mode": "rounds", "tpuscore.device": "cpu", "tpuscore.dtype": "float64"}})
ssn = open_session(cache, tiers)
run_actions(ssn, ["allocate"])
mode = ssn.plugins["tpuscore"].profile.get("mode")
close_session(ssn)
assert mode == "rounds", mode
assert len(cache.binder.binds) > 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0].startswith("jax") or m.split(".")[0] == "volcano_tpu")
print("LOADED", bad)
"""


def test_port_session_loads_no_jax_module():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _SESSION], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout, out.stdout


_FUSED_SESSION = r"""
import sys
import torch
torch.set_num_threads(1)
from volcano_tpu_torch.bench.clusters import CONFIGS, build_config, make_tiers
from volcano_tpu_torch.scheduler.framework import close_session, open_session, run_actions
import volcano_tpu_torch.scheduler.actions, volcano_tpu_torch.scheduler.plugins
cache, _, _, actions, n = build_config(4, 0.02)
tiers = make_tiers(["tpuscore"], *CONFIGS[4].tiers, arguments={"tpuscore": {
    "tpuscore.mode": "rounds", "tpuscore.device": "cpu", "tpuscore.dtype": "float64"}})
ssn = open_session(cache, tiers)
run_actions(ssn, list(actions))
prof = dict(ssn.plugins["tpuscore"].profile)
close_session(ssn)
assert prof.get("fuse") == 1 and "fuse_fallback" not in prof, prof
assert prof["fuse_stages"] == ["allocate", "backfill", "preempt", "reclaim"]
assert len(cache.evictor.evicts) > 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0].startswith("jax") or m.split(".")[0] == "volcano_tpu")
print("LOADED", bad)
"""


def test_fused_session_loads_no_jax_module():
    """cfg4's chain through run_actions takes the fused dispatch
    (ops/session_fuse.py and its kernels' plain versions) without loading
    jax or the JAX package."""
    assert os.path.join(PORT, "ops", "session_fuse.py") in set(_port_files())
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _FUSED_SESSION], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout, out.stdout


def test_every_kernel_source_is_built():
    """Every csrc/*.cu (K13's fuse_heaps.cu among them) is a kernel the
    builder compiles, and a CUDA source includes only the toolkit's
    headers and the port's own."""
    from volcano_tpu_torch import _build

    csrc = os.path.join(PORT, "csrc")
    sources = sorted(f[:-3] for f in os.listdir(csrc) if f.endswith(".cu"))
    assert "fuse_heaps" in sources
    assert sources == sorted(_build.KERNELS)
    for f in os.listdir(csrc):
        if not f.endswith((".cu", ".cuh")):
            continue
        with open(os.path.join(csrc, f)) as fh:
            for line in fh:
                if line.startswith("#include \""):
                    local = line.split('"')[1]
                    assert os.path.exists(os.path.join(csrc, local)), (f, line)


def test_entry_points_raise_without_a_gpu():
    """Without device='cpu' the port asks for CUDA, and on a host without a
    GPU that raises — at the allocator, at staging, and in a session."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the no-GPU refusal cannot be shown here")
    from volcano_tpu_torch.bench.clusters import CONFIGS, make_cache, make_tiers
    from volcano_tpu_torch.ops.solver import BatchAllocator, from_numpy_encoded
    from volcano_tpu_torch.scheduler.framework import open_session
    import volcano_tpu_torch.scheduler.plugins  # noqa: F401

    with pytest.raises(RuntimeError, match="CUDA"):
        BatchAllocator(mode="rounds")
    with pytest.raises(RuntimeError, match="CUDA"):
        from_numpy_encoded({"eps": np.ones(2)}, device=None, dtype=None)
    cache = make_cache()
    CONFIGS[5].populate(cache, 0.01)
    tiers = make_tiers(["tpuscore"], *CONFIGS[5].tiers,
                       arguments={"tpuscore": {"tpuscore.mode": "rounds"}})
    with pytest.raises(RuntimeError, match="CUDA"):
        open_session(cache, tiers)


def test_kernel_wrappers_use_plain_versions_only_for_cpu_tensors():
    """A CPU tensor runs the plain version and counts no launch."""
    from volcano_tpu_torch import device as devmod
    from volcano_tpu_torch.ops import rounds_kernels as rk

    devmod.reset_launches()
    scores = torch.tensor([[1.0, 3.0, 3.0, float("-inf")]], dtype=torch.float64)
    s, i = rk.window_topk(scores, 2)
    assert i.tolist() == [[1, 2]] and s.tolist() == [[3.0, 3.0]]
    assert devmod.launches() == {k: 0 for k in devmod.LAUNCHES}
