"""vcctl on the port (volcano_tpu_torch/cli) against the JAX package's.

Twins of tests/test_cli.py, and of tests/test_codec.py's
``test_roundtrip_object_zoo`` with its ``DEMO_JOB_YAML`` Job: the
reference module's tests run unchanged on ``volcano_tpu_torch``
(tests/_port_twin.py). Then both packages' vcctl are compared: each
package's cluster, served by its own gateway, is driven through ``vcctl
--server`` (job run, list, view, suspend, resume, delete; queue create,
get, list; version) with its draws and clocks pinned as in
tests/test_torch_controllers.py, and ``time.time`` of the CLI's job
module pinned (ages and command names). The printed output of every
command, and both stores afterwards, must be equal; each gateway is also
read by the other package's vcctl, with the same output.

Tolerance: none; every comparison is exact.
"""

from __future__ import annotations

import importlib
import io
from contextlib import redirect_stdout
from types import SimpleNamespace

import pytest

from tests._port_twin import load
from tests.test_torch_controllers import pinned, twin  # noqa: F401

load(globals(), "test_cli")
load(globals(), "test_codec", only=["test_roundtrip_object_zoo"])


def _pkg(name):
    mods = {
        "objects": "api.objects", "codec": "api.codec", "clock": "utils.clock",
        "helper": "scheduler.util.scheduler_helper", "cluster": "cluster",
        "gateway": "store.gateway", "job": "cli.job", "vcctl": "cli.vcctl",
        "degrade": "scheduler.degrade", "utils": "scheduler.util.test_utils",
    }
    return SimpleNamespace(name=name, **{
        k: importlib.import_module(f"{name}.{v}") for k, v in mods.items()})


REF = _pkg("volcano_tpu")
PORT = _pkg("volcano_tpu_torch")


@pytest.fixture(autouse=True)
def _fresh_port_ladder():
    PORT.degrade.reset()
    yield
    PORT.degrade.reset()


def _vcctl(P, port, *argv) -> str:
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = P.vcctl.main(["--server", f"127.0.0.1:{port}", *argv])
    assert rc == 0, (P.name, argv, buf.getvalue())
    return buf.getvalue()


def test_vcctl_output_equals_the_reference(pinned, monkeypatch, tmp_path):  # noqa: F811
    job_file = tmp_path / "job.yaml"
    job_file.write_text(REF.vcctl.DEMO_JOB_YAML)
    for P in (REF, PORT):
        monkeypatch.setattr(P.job, "time", SimpleNamespace(time=lambda: 1e6))

    def scenario(P):
        other = PORT if P is REF else REF
        cluster = P.cluster.Cluster()
        for n in range(3):
            cluster.store.create(P.utils.build_node(
                f"node-{n}", P.utils.build_resource_list_with_pods("8", "16Gi")))
        gateway = P.gateway.ApiGateway(cluster.store).start()
        out = []
        try:
            def run(*argv, steps=0):
                out.append(_vcctl(P, gateway.port, *argv))
                cluster.settle(steps) if steps else None

            run("job", "run", "-f", str(job_file), steps=4)
            for argv in (("job", "list"), ("job", "view", "-N", "test-job"),
                         ("queue", "list"), ("queue", "get", "-N", "default")):
                run(*argv)
                assert _vcctl(other, gateway.port, *argv) == out[-1], argv
            run("queue", "create", "-N", "gold", "-w", "5")
            run("queue", "list")
            run("job", "suspend", "-N", "test-job", steps=4)
            run("job", "list")
            run("job", "resume", "-N", "test-job", steps=6)
            run("job", "list")
            run("job", "delete", "-N", "test-job")
            run("job", "list")
        finally:
            gateway.stop()
        return cluster.store, out

    out = twin(pinned, scenario, pkgs=(REF, PORT))
    assert "test-job" in out[1] and "Running" in out[1], out[1]
    assert "Aborted" in out[8] and "test-job" not in out[-1], out


def test_vcctl_demo_equals_the_reference(pinned, monkeypatch):  # noqa: F811
    for P in (REF, PORT):
        monkeypatch.setattr(P.job, "time", SimpleNamespace(time=lambda: 1e6))
    seen = {}
    for P in (REF, PORT):
        pinned(P)
        buf = io.StringIO()
        try:
            with redirect_stdout(buf):
                assert P.vcctl.main(["demo"]) == 0
        finally:
            pinned(None)
        seen[P.name] = buf.getvalue()
    assert seen["volcano_tpu_torch"] == seen["volcano_tpu"]
    assert "# vcctl job resume" in seen["volcano_tpu_torch"]

