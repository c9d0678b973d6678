"""Leader election, /metrics and /healthz, and the daemon's ``main()``, on
the port.

Twins of tests/test_ha_observability.py: the reference module's tests
(the store's compare-and-swap, leader election, the observability
endpoints, ``TestDriverMain`` on ``volcano_tpu_torch.scheduler.__main__``,
the example corpus, the version banner, concurrent scrapes) run unchanged
on ``volcano_tpu_torch`` (tests/_port_twin.py). The daemon's ``main()``
schedules with ``TPU_SCHEDULER_CONF`` when given no conf, on the card;
here that conf's solve is put on the CPU for each test.
"""

from __future__ import annotations

import pytest

from tests._port_twin import load
from tests.test_torch_daemon import CPU_CONF
from volcano_tpu_torch.scheduler import degrade as port_degrade
from volcano_tpu_torch.scheduler import scheduler as port_scheduler

load(globals(), "test_ha_observability")


@pytest.fixture(autouse=True)
def _fresh_port_ladder():
    port_degrade.reset()
    yield
    port_degrade.reset()


@pytest.fixture(autouse=True)
def _daemon_solves_on_the_cpu(monkeypatch):
    with open(CPU_CONF) as f:
        monkeypatch.setattr(port_scheduler, "TPU_SCHEDULER_CONF", f.read())
