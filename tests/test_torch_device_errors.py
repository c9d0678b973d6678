"""A device error in the port raises; it never moves the work to the host.

The reference turns a failed launch, solve or fetch into its serial path
at four sites (the solver, the per-action evict actions, the fused chain,
the pipeline). The port leaves those fallbacks out: nothing moves to the
host after a device error. The failure is injected at run time (a monkeypatch;
no package file changes) at each site:

- the solver: the port's rounds dispatch (``rounds.dispatch_packed``);
- the per-action evict actions: ``evict._solve``;
- the fused chain: ``session_fuse._fuse_preempt`` (its dispatch);
- the pipeline: ``_InFlight.fetch`` (the speculative stage's fetch) and
  the rounds dispatch under the pipelined loop.

Three errors are injected: a launch failure (a RuntimeError), a kernel
that does not build (``_build.KernelBuildError``) and the absence of the
card (``device.DeviceUnavailable``). Each propagates out of the session
as it was raised; nothing is counted as a fallback and the kernel breaker
stays closed. The reference's serial fallback on the same injected launch
failure is pinned beside it, as the divergence. And the express lane's
and the pipeline driver's build still raise on a host without a card (the
port keeps the trim of the reference's ``except Exception`` around them).

The port runs on the CPU in float64.
"""

from __future__ import annotations

import pytest
import torch

from tests.test_torch_evict import TIER_SETS, overcommit_cluster
from tests.test_torch_evict_session import ACTIONS
from tests.test_torch_session_fuse import run
from volcano_tpu.ops import rounds as jrounds
from volcano_tpu.scheduler import degrade as jdegrade

from volcano_tpu_torch import device as devmod
from volcano_tpu_torch._build import KernelBuildError
from volcano_tpu_torch.ops import evict as tevict
from volcano_tpu_torch.ops import rounds as trounds
from volcano_tpu_torch.ops import session_fuse as tfuse
from volcano_tpu_torch.pipeline import driver as tdriver
from volcano_tpu_torch.scheduler import degrade as tdegrade
from volcano_tpu_torch.scheduler import metrics as tmetrics

MESSAGE = "injected launch failure"
FALLBACK_KINDS = ("evict_backfill", "evict_preempt", "evict_reclaim", "fuse")
SITES = {
    "dispatch": (trounds, "dispatch_packed"),
    "evict": (tevict, "_solve"),
    "fuse": (tfuse, "_fuse_preempt"),
    "fetch": (tdriver._InFlight, "fetch"),
}
ERRORS = [RuntimeError(MESSAGE),
          KernelBuildError("nvcc failed for score_block.cu (rc 1)"),
          devmod.DeviceUnavailable("volcano_tpu_torch: no CUDA device")]
ERROR_IDS = ["launch", "build", "no-device"]
CFG4 = TIER_SETS[0]


@pytest.fixture(autouse=True)
def _fresh_state():
    for degrade in (jdegrade, tdegrade):
        degrade.reset()
    tmetrics.reset()
    yield
    for degrade in (jdegrade, tdegrade):
        degrade.reset()


def inject(monkeypatch, site, error):
    """Make the port's ``site`` raise ``error``; returns its calls."""
    owner, name = SITES[site]
    calls = []

    def fail(*args, **kwargs):
        calls.append(site)
        raise error
    monkeypatch.setattr(owner, name, fail)
    return calls


def nothing_counted():
    """No fallback was counted: the ladder's per_action_fallbacks, the
    kernel breaker and metrics' device_fallbacks by kind."""
    ladder = tdegrade.default_ladder()
    reg = tmetrics.registry()
    assert ladder.counters["per_action_fallbacks"] == 0
    assert ladder.kernel.state == "closed"
    assert {k: reg.device_fallbacks.get((k,)) for k in FALLBACK_KINDS} == {
        k: 0.0 for k in FALLBACK_KINDS}


def _cluster(seed):
    return lambda c: overcommit_cluster(c, seed)


@pytest.mark.parametrize("error", ERRORS, ids=ERROR_IDS)
@pytest.mark.parametrize("site,fuse", [("dispatch", False), ("evict", False),
                                       ("fuse", True)])
def test_a_device_error_raises_out_of_the_session(site, fuse, error,
                                                  monkeypatch):
    with monkeypatch.context() as m:
        calls = inject(m, site, error)
        with pytest.raises(type(error), match=str(error)[:12]):
            run("torch", _cluster(11), CFG4, m, fuse=fuse, actions=ACTIONS)
    assert calls == [site]
    nothing_counted()


@pytest.mark.parametrize("error", ERRORS, ids=ERROR_IDS)
@pytest.mark.parametrize("site", ["fetch", "dispatch"])
def test_a_device_error_raises_out_of_the_pipeline(site, error, monkeypatch):
    from tests import test_torch_pipeline as tp

    with monkeypatch.context() as m:
        calls = inject(m, site, error)
        with pytest.raises(type(error)):
            tp._drive(3, 8, pipeline=True, spec=True)
    assert calls
    assert tdegrade.default_ladder().counters["per_action_fallbacks"] == 0
    assert tdegrade.default_ladder().kernel.state == "closed"


def test_the_reference_falls_back_where_the_port_raises(monkeypatch):
    """The divergence, pinned: the same injected launch failure in the
    rounds dispatch takes the JAX package's serial loop ("solve error:
    ..." in the profile, one kernel failure on its ladder) and raises out
    of the port's session."""
    with monkeypatch.context() as m:
        def fail(*args, **kwargs):
            raise RuntimeError(MESSAGE)
        m.setattr(jrounds, "solve_rounds_packed", fail)
        _sig, binds, _evicts, profs = run("jax", _cluster(11), CFG4, m,
                                          fuse=False, actions=("allocate",))
    assert profs[0]["fallback"] == f"solve error: {MESSAGE}"
    assert binds, "the reference's serial loop binds"
    assert jdegrade.default_ladder().counters["per_action_fallbacks"] == 1
    with monkeypatch.context() as m:
        inject(m, "dispatch", RuntimeError(MESSAGE))
        with pytest.raises(RuntimeError, match=MESSAGE):
            run("torch", _cluster(11), CFG4, m, fuse=False,
                actions=("allocate",))
    nothing_counted()


def test_a_solve_notes_its_success_on_the_ladder(monkeypatch):
    """A rounds solve that returns notes ``degrade.note_kernel_ok`` as the
    reference's does: with the kernel breaker half-open (its cooldown
    passed), the session's solve closes it."""
    from volcano_tpu_torch.utils import clock

    now = [1000.0]
    clock.set_source(lambda: now[0])
    try:
        breaker = tdegrade.default_ladder().kernel
        for _ in range(breaker.threshold):
            tdegrade.note_kernel_failure()
        assert breaker.state == "open"
        now[0] += breaker.cooldown_s
        assert breaker.allow(), "half-open after the cooldown"
        _sig, binds, _evicts, profs = run("torch", _cluster(11), CFG4,
                                          monkeypatch, fuse=False,
                                          actions=("allocate",))
    finally:
        clock.set_source(None)
    assert profs[0].get("mode") == "rounds" and binds
    assert breaker.state == "closed"


def test_lane_and_driver_builds_raise_without_a_card():
    """The kept trim: the reference wraps building the express lane and
    the pipeline driver in ``except Exception`` (a host without its
    accelerator stack); in the port the only such failure is a host
    without the card, and it raises."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the no-GPU refusal cannot be shown here")
    from tests.test_torch_scheduler import _populate
    from volcano_tpu_torch.bench.clusters import make_cache
    from volcano_tpu_torch.pipeline import PipelineDriver
    from volcano_tpu_torch.scheduler.scheduler import (
        TPU_SCHEDULER_CONF, Scheduler, load_scheduler_conf)

    cache = make_cache()
    _populate(cache)
    s = Scheduler(cache, express=True)
    with pytest.raises(devmod.DeviceUnavailable, match="CUDA"):
        s.run()
    s.stop()
    actions, tiers = load_scheduler_conf(TPU_SCHEDULER_CONF)
    drv = PipelineDriver(cache, lambda: (
        [a.name() for a in actions], tiers))
    with pytest.raises(devmod.DeviceUnavailable, match="CUDA"):
        drv.run_cycle()
