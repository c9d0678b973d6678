"""Fenced active/standby failover and the degradation ladder, on the port.

Twins of every class of tests/test_failover.py (store fencing, gateway
fencing, the two-elector race, warm standby and FailoverScheduler,
backoff, the circuit breaker, the ladder, the scheduler's session skip
and the remote watch backoff): the reference module's tests run
unchanged on ``volcano_tpu_torch`` (tests/_port_twin.py). The breaker's
sequence is held to the JAX package's in
tests/test_torch_degrade_fallback.py.
"""

from __future__ import annotations

import pytest

from tests._port_twin import load
from volcano_tpu_torch.scheduler import degrade as port_degrade

load(globals(), "test_failover")


@pytest.fixture(autouse=True)
def _fresh_port_ladder():
    port_degrade.reset()
    yield
    port_degrade.reset()

