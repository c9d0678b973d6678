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


def test_no_port_file_imports_yaml():
    """The machine with the card has no PyYAML: the port reads YAML with
    its own reader (volcano_tpu_torch/utils/yaml_subset.py)."""
    offenders = []
    for path in _port_files():
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
                          for n in names if n.split(".")[0] == "yaml"]
    assert not offenders, offenders


_ENTRY = r"""
import runpy, sys
sys.argv = [sys.argv[1]] + sys.argv[2:]
try:
    runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
except SystemExit as e:
    assert not e.code, e.code
bad = sorted(m for m in sys.modules
             if m.split(".")[0].startswith("jax")
             or m.split(".")[0] in ("volcano_tpu", "yaml"))
print("LOADED", bad)
"""


@pytest.mark.parametrize("argv", [
    ["volcano_tpu_torch.scheduler", "--scheduler-conf",
     os.path.join(REPO, "tests", "cpu_tpuscore_conf.yaml"), "--run-for",
     "0.3", "--listen-address", ":0", "--healthz-address", "127.0.0.1:0"],
    ["volcano_tpu_torch.cli.vcctl", "version"],
], ids=["daemon", "vcctl"])
def test_entry_binaries_load_no_jax_and_no_yaml(argv):
    """``python -m volcano_tpu_torch.scheduler --run-for 0.3`` (an
    in-process cluster, its loop and its endpoints) and ``python -m
    volcano_tpu_torch.cli.vcctl version`` load no jax module, nothing of
    the JAX package and no PyYAML."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _ENTRY, *argv], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout, out.stdout


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


_EXPRESS_AND_REPLICA = r"""
import sys
import torch
torch.set_num_threads(1)
from volcano_tpu_torch.api import objects
from volcano_tpu_torch.bench.clusters import CONFIGS, DEFAULT_TIERS, build_config, make_tiers
from volcano_tpu_torch.express import ExpressLane
from volcano_tpu_torch.scheduler.framework import close_session, open_session, run_actions
from volcano_tpu_torch.scheduler.util.test_utils import build_pod, build_pod_group
import volcano_tpu_torch.scheduler.actions, volcano_tpu_torch.scheduler.plugins
cache, _, _, _, n = build_config(5, 0.01)
tiers = make_tiers(["tpuscore"], *CONFIGS[5].tiers, arguments={"tpuscore": {
    "tpuscore.mode": "rounds", "tpuscore.device": "cpu", "tpuscore.dtype": "float64"}})
profs = []
for k in range(2):
    if k:  # a new arrival between the sessions: the second serves a delta
        cache.add_pod_group(build_pod_group("late", namespace="xp", min_member=1,
                                            phase=objects.PodGroupPhase.INQUEUE))
        cache.add_pod(build_pod("xp", "late-t0", "", objects.POD_PHASE_PENDING,
                                {"cpu": "100m", "memory": "128Mi"}, "late"))
    ssn = open_session(cache, tiers)
    run_actions(ssn, ["allocate"])
    profs.append(dict(ssn.plugins["tpuscore"].profile))
    close_session(ssn)
assert profs[0]["replica_rebuilds"] == {"cold": 1}, profs[0]
assert profs[1]["replica_rebuilds"]["cold"] == 1, profs[1]
lane = ExpressLane(cache, device="cpu", dtype=torch.float64)
cache.add_pod_group(build_pod_group("svc", namespace="xp", min_member=1,
                                    phase=objects.PodGroupPhase.INQUEUE))
cache.add_pod(build_pod("xp", "svc-t0", "", objects.POD_PHASE_PENDING,
                        {"cpu": "100m", "memory": "128Mi"}, "svc"))
rep = lane.run_once()
assert rep["batches"] == 1 and rep["placed"] == 1, rep
bad = sorted(m for m in sys.modules
             if m.split(".")[0].startswith("jax") or m.split(".")[0] == "volcano_tpu")
print("LOADED", bad)
"""


def test_express_batch_and_replica_sessions_load_no_jax_module():
    """Two replica-fed allocate sessions (a cold serve, then the standing
    replica) and one express batch run without loading jax or the JAX
    package."""
    for f in ("ops/replica.py", "express/place.py", "express/trigger.py",
              "scheduler/degrade.py", "analysis/witness.py"):
        assert os.path.join(PORT, f) in set(_port_files()), f
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _EXPRESS_AND_REPLICA],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout, out.stdout


_LOOP_AND_PARITY = r"""
import sys
import torch
torch.set_num_threads(1)
from volcano_tpu_torch.bench.clusters import CONFIGS, build_config, make_tiers
from volcano_tpu_torch.scheduler.framework import close_session, open_session, run_actions
from volcano_tpu_torch.scheduler.scheduler import TPU_SCHEDULER_CONF, Scheduler
import volcano_tpu_torch.scheduler.actions, volcano_tpu_torch.scheduler.plugins
conf = TPU_SCHEDULER_CONF.replace(
    "  - name: tpuscore\n",
    "  - name: tpuscore\n    arguments:\n      tpuscore.mode: rounds\n"
    "      tpuscore.device: cpu\n      tpuscore.dtype: float64\n")
from volcano_tpu_torch.api import objects
from volcano_tpu_torch.scheduler.util.test_utils import build_pod, build_pod_group
cache, _, _, _, n = build_config(5, 0.01)
# a backlog no node holds: the next cycle's session still has a solve
cache.add_pod_group(build_pod_group("huge", namespace="backlog", min_member=1))
cache.add_pod(build_pod("backlog", "huge-t0", "", objects.POD_PHASE_PENDING,
                        {"cpu": "640", "memory": "1Gi"}, "huge"))
s = Scheduler(cache, conf, pipeline=True)
s.run()
s.stop()
info = s.run_once_pipelined()
assert info["mode"] == "pipelined" and info["spec"] == "dispatched", info
assert s.pipeline_driver._inflight is not None
s.pipeline_driver.abandon()
assert len(cache.binder.binds) > 0
cache, _, _, _, n = build_config(2, 0.02)
tiers = make_tiers(["tpuscore"], *CONFIGS[2].tiers, arguments={"tpuscore": {
    "tpuscore.mode": "parity", "tpuscore.device": "cpu", "tpuscore.dtype": "float64"}})
ssn = open_session(cache, tiers)
run_actions(ssn, ["allocate"])
mode = ssn.plugins["tpuscore"].profile.get("mode")
close_session(ssn)
assert mode == "parity", mode
assert len(cache.binder.binds) > 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0].startswith("jax") or m.split(".")[0] == "volcano_tpu")
print("LOADED", bad)
"""


def test_scheduler_cycle_and_parity_session_load_no_jax_module():
    """One pipelined Scheduler cycle (the driver, its solve-ahead, the
    conf reader, the GC policy) and one parity-mode session (K15's plain
    version) run without loading jax or the JAX package."""
    for f in ("scheduler/scheduler.py", "pipeline/driver.py",
              "ops/parity_kernels.py", "utils/gcpolicy.py"):
        assert os.path.join(PORT, f) in set(_port_files()), f
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _LOOP_AND_PARITY],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout, out.stdout


_ROUNDS_LOOP = r"""
import sys
import torch
torch.set_num_threads(1)
from volcano_tpu_torch.bench.clusters import CONFIGS, build_config, make_tiers
from volcano_tpu_torch.ops import rounds, rounds_graph, rounds_kernels
from volcano_tpu_torch.scheduler.framework import close_session, open_session
import volcano_tpu_torch.scheduler.actions, volcano_tpu_torch.scheduler.plugins
cache, _, _, _, n = build_config(6, 0.06)
tiers = make_tiers(["tpuscore"], *CONFIGS[6].tiers, arguments={"tpuscore": {
    "tpuscore.mode": "rounds", "tpuscore.device": "cpu", "tpuscore.dtype": "float64"}})
ssn = open_session(cache, tiers)
prep = ssn.batch_allocator._prepare(ssn)
close_session(ssn)
spec = prep["spec"]._replace(round_min_progress=40, straggler_rounds=2)
raw, packed = rounds.solve(spec, prep["staged"])
assert bool(raw[4]) and int(raw[2]) > 0, raw[1:5]
try:
    rounds.solve(spec, prep["staged"], loop="graph")
    raise SystemExit("a graph solve of CPU tensors must raise")
except ValueError:
    pass
bad = sorted(m for m in sys.modules
             if m.split(".")[0].startswith("jax") or m.split(".")[0] == "volcano_tpu")
print("LOADED", bad)
"""


def test_rounds_loop_modules_load_no_jax_module():
    """The rounds loop's modules (the step machine, K7a/K7b's wrappers and
    plain versions, the graph cache) run a capped solve through its tail
    pass without loading jax or the JAX package; asking for the graph on
    CPU tensors raises instead of falling back."""
    for f in ("ops/rounds.py", "ops/rounds_kernels.py", "ops/rounds_graph.py"):
        assert os.path.join(PORT, f) in set(_port_files()), f
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _ROUNDS_LOOP],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout, out.stdout


_BENCH = r"""
import io, os, sys
from contextlib import redirect_stdout
import torch
torch.set_num_threads(1)
from volcano_tpu_torch.bench import run
from volcano_tpu_torch import _native
from volcano_tpu_torch.ops import shard
buf = io.StringIO()
with redirect_stdout(buf):
    assert run.main(["--device", "cpu", "--dtype", "float64", "--config", "5",
                     "--scale", "0.05", "--backend", "tpu", "--warm-iters", "1"]) == 0
    assert run.main(["--device", "cpu", "--dtype", "float64", "--mesh", "1",
                     "--scale", "0.005"]) == 0
assert '"summary"' in buf.getvalue().splitlines()[-1]
mods = [_native.get_fastapply(), _native.get_fasttrans()]
assert all(m is not None for m in mods), mods
here = os.path.dirname(os.path.abspath(_native.__file__))
assert all(os.path.dirname(m.__file__) == here for m in mods), mods
bad = sorted(m for m in sys.modules
             if m.split(".")[0].startswith("jax") or m.split(".")[0] == "volcano_tpu")
print("LOADED", bad)
"""


def test_bench_entry_loads_no_jax_module():
    """The bench entry (a rounds-mode cfg5 run and the cfg7 mesh curve with
    its K16 probes), the compile watcher, the shard probes and the native
    engines run without loading jax or the JAX package; the engines load
    from the port's own _native directory."""
    for f in ("bench/run.py", "bench/__main__.py", "ops/shard.py",
              "ops/fasttrans.py", "utils/compilewatch.py", "_native/__init__.py"):
        assert os.path.join(PORT, f) in set(_port_files()), f
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _BENCH], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout, out.stdout


def test_every_kernel_source_is_built():
    """Every csrc/*.cu (K13's fuse_heaps.cu among them) is a kernel the
    builder compiles, and a CUDA source includes only the toolkit's
    headers and the port's own."""
    from volcano_tpu_torch import _build

    csrc = os.path.join(PORT, "csrc")
    sources = sorted(f[:-3] for f in os.listdir(csrc) if f.endswith(".cu"))
    assert {"fuse_heaps", "express_place", "scatter_rows", "parity_scan",
            "rounds_ctl", "tail_pass", "probe_evict_fold"} <= set(sources)
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
