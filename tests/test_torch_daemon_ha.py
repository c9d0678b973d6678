"""The port's daemon as leader-elected processes, and vcctl against it.

Twins of tests/test_remote_vcctl.py, and of tests/test_remote_watch.py's
``test_leader_election_over_remote_store`` and
``test_remote_controller_observes_phase_flip``: the reference module's
tests and fixtures run unchanged on ``volcano_tpu_torch``
(tests/_port_twin.py), so the cluster process they drive is ``python -m
volcano_tpu_torch.scheduler --api-address``. The two remote-watch tests
run against the remote-vcctl twin's cluster process (the reference starts
the same daemon with ``--api-token watch-tok``; a gateway without a token
ignores the one the clients send). Every daemon process reads
tests/cpu_tpuscore_conf.yaml (the batch-solve conf on the CPU).

Then a check the reference has no twin of: two ``--server
--leader-elect`` schedulers share one lock through an ``--api-server-only``
process's gateway. One leads and binds; when it is killed (SIGKILL) the
other takes the lease with more transitions (the store's fence epoch is
the lease's transitions + 1) and binds the next job, each pod once.

Every process is started on ``127.0.0.1:0`` ports and killed in a
``finally``.
"""

from __future__ import annotations

import signal
import subprocess
import sys

import pytest

from tests._port_twin import load
from tests.test_torch_daemon import (
    CPU_CONF, REPO, _bound, _env, _stop, _submit, _until,
    api_server_proc)  # noqa: F401
from volcano_tpu_torch.scheduler import degrade as port_degrade
from volcano_tpu_torch.store.remote import RemoteStore

load(globals(), "test_remote_vcctl", daemon_conf=CPU_CONF)
load(globals(), "test_remote_watch",
     only=["test_leader_election_over_remote_store",
           "test_remote_controller_observes_phase_flip"],
     daemon_conf=CPU_CONF)


@pytest.fixture(autouse=True)
def _fresh_port_ladder():
    port_degrade.reset()
    yield
    port_degrade.reset()


def _lease(remote):
    from volcano_tpu_torch.scheduler.leaderelection import ResourceLock

    got = ResourceLock(remote, "volcano-system", "volcano", "probe").get()
    return None if got is None else got[0]


def test_leader_elected_schedulers_fail_over(api_server_proc):  # noqa: F811
    _, port = api_server_proc
    scheds = {
        name: subprocess.Popen(
            [sys.executable, "-m", "volcano_tpu_torch.scheduler",
             "--server", f"127.0.0.1:{port}", "--scheduler-conf", CPU_CONF,
             "--leader-elect",
             "--leader-elect-identity", name, "--listen-address", ":0",
             "--healthz-address", "127.0.0.1:0", "--schedule-period", "0.2",
             "--run-for", "90"],
            cwd=REPO, env=_env(), stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL)
        for name in ("sched-a", "sched-b")}
    remote = RemoteStore(f"127.0.0.1:{port}")
    try:
        first = _until(lambda: (_lease(remote) or None)
                       and _lease(remote).holder_identity, 30,
                       "a first leader", scheds.values())
        replicas = _submit(remote, "before-kill")
        _until(lambda: _bound(remote, "before-kill", replicas), 30,
               "the leader binding", scheds.values())
        before = _lease(remote)
        scheds[first].send_signal(signal.SIGKILL)
        scheds[first].wait(timeout=10)
        standby = next(n for n in scheds if n != first)
        after = _until(lambda: (lambda r: r if r and r.holder_identity
                                == standby else None)(_lease(remote)),
                       40, "the standby's takeover", [scheds[standby]])
        assert after.leader_transitions > before.leader_transitions
        _submit(remote, "after-kill")
        _until(lambda: _bound(remote, "after-kill", replicas), 30,
               "the standby binding", [scheds[standby]])
        # the new term's fence is in force: every bind of both jobs went
        # through, once each
        pods = remote.list("Pod", namespace="default")
        names = [p.metadata.name for p in pods]
        assert len(names) == len(set(names))
    finally:
        for proc in scheds.values():
            _stop(proc)
