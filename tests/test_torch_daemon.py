"""The port's daemon, ``python -m volcano_tpu_torch.scheduler``, as separate
processes.

Twins of tests/test_remote_scheduler.py: the reference module's tests
and fixtures run unchanged on ``volcano_tpu_torch`` (tests/_port_twin.py),
so every process they start is the port's daemon (an ``--api-server-only``
process and a ``--server`` scheduler). tests/test_torch_daemon_ha.py
holds the remote vcctl, remote watch and leader-election twins.

The twins' daemon processes read tests/cpu_tpuscore_conf.yaml (the
batch-solve conf with ``tpuscore.device: cpu``): without a conf the
port's daemon schedules on the card, and on a host without one it exits
with ``DeviceUnavailable``, in-process and remote alike, while an
``--api-server-only`` process, which schedules nothing, runs.

Then a check the reference has no twin of: a remote scheduler under a
tpuscore conf (``tpuscore.device: cpu``, ``tpuscore.dtype: float64``,
``tpuscore.mode: rounds``) binds the example job, and its rounds solve
ran in its own process: the process is the daemon's ``main()`` with
``BatchAllocator.__call__`` wrapped to print each session's solver
profile.

Every process is started on ``127.0.0.1:0`` ports and killed in a
``finally``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest

from tests._port_twin import load
from volcano_tpu_torch.scheduler import degrade as port_degrade
from volcano_tpu_torch.scheduler.scheduler import TPU_SCHEDULER_CONF
from volcano_tpu_torch.store.remote import RemoteStore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the batch-solve conf on the CPU: without a conf the port's daemon
# schedules on the card
CPU_CONF = os.path.join(REPO, "tests", "cpu_tpuscore_conf.yaml")

load(globals(), "test_remote_scheduler", daemon_conf=CPU_CONF)

CPU_ROUNDS_CONF = TPU_SCHEDULER_CONF.replace(
    "  - name: tpuscore\n",
    "  - name: tpuscore\n    arguments:\n      tpuscore.device: cpu\n"
    "      tpuscore.dtype: float64\n      tpuscore.mode: rounds\n")

# the daemon's own main(), with each allocate session's solver profile
# printed as one "SOLVE {...}" line
_PROBE = """
import json, sys
from volcano_tpu_torch.ops import solver
call = solver.BatchAllocator.__call__
def traced(self, ssn):
    ok = call(self, ssn)
    print("SOLVE " + json.dumps({"ok": bool(ok),
          "mode": self.profile.get("mode"),
          "fallback": self.profile.get("fallback"),
          "placed": self.profile.get("placed")}), flush=True)
    return ok
solver.BatchAllocator.__call__ = traced
from volcano_tpu_torch.scheduler.__main__ import main
sys.exit(main(sys.argv[1:]))
"""


@pytest.fixture(autouse=True)
def _fresh_port_ladder():
    port_degrade.reset()
    yield
    port_degrade.reset()


def _env():
    env = dict(os.environ)
    env.pop("VOLCANO_TPU_PANIC", None)
    return env


def _stop(proc):
    if proc.poll() is None:
        proc.kill()
    try:
        return proc.communicate(timeout=15)[0] or ""
    except subprocess.TimeoutExpired:
        return ""


def _until(predicate, timeout, what, procs=()):
    deadline = time.time() + timeout
    while time.time() < deadline:
        for p in procs:
            assert p.poll() is None, f"{what}: a process exited early"
        out = predicate()
        if out:
            return out
        time.sleep(0.1)
    pytest.fail(f"{what}: not within {timeout} s")


def _submit(remote, name):
    from volcano_tpu_torch.cli import job as job_cli

    with open(os.path.join(REPO, "example", "job.yaml")) as f:
        job = job_cli.run_job(remote, f.read().replace("name: test-job",
                                                       f"name: {name}"))
    return sum(t.replicas for t in job.spec.tasks)


def _bound(remote, name, replicas):
    from volcano_tpu_torch.api import objects

    pods = [p for p in remote.list("Pod", namespace="default")
            if p.metadata.annotations.get(objects.JOB_NAME_KEY) == name]
    return pods if len(pods) == replicas \
        and all(p.spec.node_name for p in pods) else None


def test_remote_scheduler_runs_the_rounds_solve_in_its_process(
        api_server_proc, tmp_path):
    _, port = api_server_proc
    conf = tmp_path / "rounds.yaml"
    conf.write_text(CPU_ROUNDS_CONF)
    sched = subprocess.Popen(
        [sys.executable, "-c", _PROBE, "--server", f"127.0.0.1:{port}",
         "--scheduler-conf", str(conf), "--listen-address", ":0",
         "--healthz-address", "127.0.0.1:0", "--schedule-period", "0.2",
         "--run-for", "60"],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    remote = RemoteStore(f"127.0.0.1:{port}")
    try:
        replicas = _submit(remote, "rounds-job")
        _until(lambda: _bound(remote, "rounds-job", replicas), 45,
               "the rounds scheduler binding the job", [sched])
    finally:
        out = _stop(sched)
    solves = [json.loads(line[6:]) for line in out.splitlines()
              if line.startswith("SOLVE ")]
    placed = [s for s in solves if s["ok"] and s["placed"]]
    assert placed, solves
    assert all(s["mode"] == "rounds" and s["fallback"] is None
               for s in placed), placed
    assert sum(s["placed"] for s in placed) == replicas


@pytest.mark.parametrize("argv", [[], ["--server", "127.0.0.1:1"]],
                         ids=["in-process", "remote"])
def test_the_daemon_without_a_conf_asks_for_the_card(argv):
    """With no ``--scheduler-conf`` the daemon schedules with
    TPU_SCHEDULER_CONF on cuda: on a host without a card it raises before
    its loop starts (and before it reaches a gateway)."""
    import torch

    from volcano_tpu_torch.device import DeviceUnavailable
    from volcano_tpu_torch.scheduler.__main__ import main

    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the no-GPU refusal cannot be shown here")
    with pytest.raises(DeviceUnavailable, match="CUDA"):
        main([*argv, "--run-for", "0.3", "--listen-address", ":0",
              "--healthz-address", "127.0.0.1:0"])
    assert main(["--api-server-only", "--api-address", "127.0.0.1:0",
                 "--run-for", "0.3", "--listen-address", ":0",
                 "--healthz-address", "127.0.0.1:0"]) == 0
