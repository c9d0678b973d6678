"""The port's front door (volcano_tpu_torch/admission/intake.py, the
gateway's 429 and RemoteStore's typed re-raise, the degrade ladder's
overload rungs, the front-door metrics) against the JAX package's.

Twins of every test in tests/test_front_door.py but the fan-out bench's
(``TestFanoutBenchCli``, whose twin is
tests/test_torch_bench.py::test_fanout_cli_runs_without_a_device). Each
runs the same steps on both packages under the same injected clock and
asserts the reference test's checks on both; what each package admitted
and shed (names, reasons, retry-after hints, the gate's stats, the
store's Jobs) must be equal.

Tolerance: none; every comparison is exact (the HTTP hop's backoff is
wall time, so its twin compares the counts it keeps, not the seconds).
"""

from __future__ import annotations

import importlib
import json
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest
import torch

from tests.test_torch_controllers import decode


def _pkg(name):
    mods = {
        "objects": "api.objects", "codec": "api.codec", "store": "store.store",
        "clock": "utils.clock", "intake": "admission.intake",
        "metrics": "scheduler.metrics", "degrade": "scheduler.degrade",
        "gateway": "store.gateway", "remote": "store.remote",
    }
    return SimpleNamespace(name=name, **{
        k: importlib.import_module(f"{name}.{v}") for k, v in mods.items()})


REF = _pkg("volcano_tpu")
PORT = _pkg("volcano_tpu_torch")
BOTH = (REF, PORT)


def job_manifest(name: str, replicas: int = 2, min_available: int = 1,
                 queue: str = "") -> dict:
    """tests/test_front_door.py's ``_job`` as a manifest dict."""
    return {"kind": "Job", "object": {
        "metadata": {"name": name, "namespace": "fd"},
        "spec": {"min_available": min_available, "queue": queue, "tasks": [{
            "name": "w", "replicas": replicas, "template": {"spec": {
                "containers": [{"name": "c", "image": "t", "requests": {
                    "cpu": "100m", "memory": "64Mi"}}]}}}]}}}


def job(P, name, **kw):
    return decode(P, job_manifest(name, **kw))


class _FakeClock:
    def __init__(self, t0: float = 1000.0):
        self.t = t0

    def __call__(self) -> float:
        return self.t


@pytest.fixture
def clocks():
    """One fake clock a package, each installed as its utils/clock source."""
    fcs = {}
    for P in BOTH:
        fcs[P.name] = _FakeClock()
        P.clock.set_source(fcs[P.name])
    yield fcs
    for P in BOTH:
        P.clock.set_source(None)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _fresh_port_ladder():
    PORT.degrade.reset()
    yield
    PORT.degrade.reset()


def each(fn, clocks=None):
    """``fn(P, clock)`` on both packages; the two results must be equal."""
    got = [fn(P, clocks[P.name] if clocks else None) for P in BOTH]
    assert got[1] == got[0]
    return got[1]


def _shed(e):
    return (type(e).__name__, e.reason, e.retry_after)


# -- TestIntakeGate ---------------------------------------------------------

def test_bucket_deterministic_and_typed_retry_after(clocks):
    def run(P, fc):
        gate = P.intake.IntakeGate(rate_per_s=2.0, burst=4.0,
                                   interactive_reserve=0.0)
        for _ in range(4):
            gate.admit("batch")
        with pytest.raises(P.store.OverloadedError) as exc:
            gate.admit("batch")
        assert exc.value.reason == "rate"
        # empty bucket, rate 2/s: one token is 0.5s away — exactly
        assert exc.value.retry_after == pytest.approx(0.5)
        # refill admits again, deterministically
        fc.t += 0.5
        gate.admit("batch")
        with pytest.raises(P.store.OverloadedError) as again:
            gate.admit("batch")
        return _shed(exc.value), _shed(again.value), gate.stats()

    each(run, clocks)


def test_priority_shedding_batch_first_on_rate(clocks):
    def run(P, fc):
        gate = P.intake.IntakeGate(rate_per_s=1.0, burst=4.0,
                                   interactive_reserve=0.5)
        sheds = []
        # batch may not spend the reserved half: 2 tokens usable
        gate.admit("batch")
        gate.admit("batch")
        with pytest.raises(P.store.OverloadedError) as e:
            gate.admit("batch")
        sheds.append(_shed(e.value))
        # interactive rides the reserve to the bottom
        gate.admit("interactive")
        gate.admit("interactive")
        with pytest.raises(P.store.OverloadedError) as e:
            gate.admit("interactive")
        sheds.append(_shed(e.value))
        st = gate.stats()
        assert st["admitted_batch"] == 2
        assert st["admitted_interactive"] == 2
        assert st["shed_batch"] == 1 and st["shed_interactive"] == 1
        return sheds, st

    each(run, clocks)


def test_priority_shedding_batch_first_on_backlog(clocks):
    def run(P, fc):
        gate = P.intake.IntakeGate(rate_per_s=100.0, burst=100.0,
                                   max_backlog=100, interactive_reserve=0.25,
                                   backlog_retry_s=3.0)
        gate.set_backlog(80)  # >= 75 = batch bound, < 100 = interactive
        with pytest.raises(P.store.OverloadedError) as exc:
            gate.admit("batch")
        assert exc.value.reason == "backlog"
        assert exc.value.retry_after == pytest.approx(3.0)
        gate.admit("interactive")  # interactive still admitted
        gate.set_backlog(100)
        with pytest.raises(P.store.OverloadedError) as again:
            gate.admit("interactive")
        return _shed(exc.value), _shed(again.value), gate.stats()

    each(run, clocks)


def test_classify_job_express_envelope():
    def run(P, _):
        got = (P.intake.classify_job(job(P, "tiny", replicas=1, min_available=1)),
               P.intake.classify_job(job(P, "gang", replicas=24, min_available=16)))
        assert got == ("interactive", "batch")
        return got

    each(run)


# -- TestAdmissionStorm -----------------------------------------------------

def test_storm_bounded_typed_and_priority_ordered(clocks):
    """A 60-submission burst against burst=8: admission stays bounded at
    the bucket depth, every rejection is the typed rejected-with-retry
    contract, the interactive class is shed strictly less than batch, and
    both packages admit and shed the same submissions."""
    def run(P, fc):
        store = P.store.Store()
        gate = P.intake.IntakeGate(rate_per_s=2.0, burst=8.0,
                                   interactive_reserve=0.25)
        P.intake.install_intake(store, gate)
        admitted, shed = [], []
        for i in range(60):
            interactive = i % 2 == 0
            j = job(P, f"j{i:03d}", replicas=1 if interactive else 24,
                    min_available=1 if interactive else 16)
            try:
                store.create(j)
                admitted.append(j.metadata.name)
            except P.store.OverloadedError as e:
                shed.append((j.metadata.name,) + _shed(e))
        assert len(admitted) <= 8
        assert len(shed) == 60 - len(admitted)
        assert all(s[3] > 0 for s in shed)
        assert all(s[2] == "rate" for s in shed)
        st = gate.stats()
        assert st["admitted_interactive"] > st["admitted_batch"]
        assert st["shed_batch"] / 30 > st["shed_interactive"] / 30
        assert st["shed_total"] == len(shed)
        assert st["attempts"] == 60
        return admitted, shed, st, sorted(x.metadata.name for x in store.list("Job"))

    admitted, _, _, landed = each(run, clocks)
    assert landed == sorted(admitted)


def test_admitted_jobs_actually_landed(clocks):
    def run(P, fc):
        store = P.store.Store()
        gate = P.intake.IntakeGate(rate_per_s=1.0, burst=2.0,
                                   interactive_reserve=0.0)
        P.intake.install_intake(store, gate)
        store.create(job(P, "a"))
        store.create(job(P, "b"))
        with pytest.raises(P.store.OverloadedError) as e:
            store.create(job(P, "c"))
        names = sorted(j.metadata.name for j in store.list("Job"))
        assert names == ["a", "b"], "shed submission must not land"
        return names, _shed(e.value), gate.stats()

    each(run, clocks)


# -- TestHttpHop ------------------------------------------------------------

def test_gateway_429_and_remote_typed():
    """Each package's gateway maps the gate's OverloadedError to 429 +
    Retry-After, and its RemoteStore re-raises it typed; a raw POST of the
    same manifest reads 429 with the header from both."""
    def run(P, _):
        store = P.store.Store()
        gate = P.intake.IntakeGate(rate_per_s=0.5, burst=1.0,
                                   interactive_reserve=0.0)
        P.intake.install_intake(store, gate)
        gateway = P.gateway.ApiGateway(store).start()
        try:
            remote = P.remote.RemoteStore(f"127.0.0.1:{gateway.port}",
                                          overload_retries=0)
            remote.create(job(P, "ok"))
            with pytest.raises(P.store.OverloadedError) as exc:
                remote.create(job(P, "nope"))
            assert exc.value.retry_after > 0
            assert exc.value.reason == "rate"
            req = urllib.request.Request(
                f"http://127.0.0.1:{gateway.port}/apis/Job",
                data=json.dumps(job_manifest("raw")).encode(),
                method="POST", headers={"Content-Type": "application/json"})
            with pytest.raises(urllib.error.HTTPError) as raw:
                urllib.request.urlopen(req, timeout=5)
            assert raw.value.code == 429
            assert float(raw.value.headers["Retry-After"]) > 0
        finally:
            gateway.stop()
        st = gate.stats()
        return (type(exc.value).__name__, exc.value.reason, raw.value.code,
                sorted(j.metadata.name for j in store.list("Job")),
                st["attempts"], st["shed_total"])

    each(run)


def test_remote_honors_retry_after_with_backoff():
    """overload_retries: the client pauses >= the server hint (via
    degrade.Backoff) and the re-submission succeeds, in both packages."""
    def run(P, _):
        store = P.store.Store()
        gate = P.intake.IntakeGate(rate_per_s=20.0, burst=1.0,
                                   interactive_reserve=0.0)
        P.intake.install_intake(store, gate)
        gateway = P.gateway.ApiGateway(store).start()
        try:
            remote = P.remote.RemoteStore(f"127.0.0.1:{gateway.port}",
                                          overload_retries=3)
            remote.create(job(P, "first"))
            created = remote.create(job(P, "second"))
            assert created.metadata.name == "second"
            st = remote.intake_stats()
            assert st["overloaded"] >= 1
            assert st["retries"] >= 1
            assert st["backoff_s"] > 0
        finally:
            gateway.stop()
        return sorted(j.metadata.name for j in store.list("Job"))

    assert each(run) == ["first", "second"]


# -- TestOverloadRungs ------------------------------------------------------

def test_admission_shed_rung_arms_and_clears(clocks):
    def run(P, fc):
        ladder = P.degrade.DegradeLadder(shed_hold_s=5.0)
        rungs = [ladder.rung()]
        ladder.note_admission_shed()
        rungs.append(ladder.rung())
        fc.t += 6.0
        rungs.append(ladder.rung())
        assert rungs == ["", "admission_shed", ""]
        return rungs

    each(run, clocks)


def test_coalesce_rung_arms_on_lag_signal(clocks):
    def run(P, fc):
        ladder = P.degrade.DegradeLadder(coalesce_hold_s=10.0)
        seen = []
        ladder.note_watch_lag(10, 100)  # under half the budget: quiet
        seen.append((ladder.rung(), ladder.watch_coalesce_aggressive()))
        ladder.note_watch_lag(60, 100)  # over half: armed
        seen.append((ladder.rung(), ladder.watch_coalesce_aggressive()))
        fc.t += 11.0
        seen.append(ladder.watch_coalesce_aggressive())
        assert seen == [("", False), ("watch_coalesce_aggressive", True), False]
        return seen

    each(run, clocks)


def test_resync_only_breaker_demotion_storm(clocks):
    def run(P, fc):
        ladder = P.degrade.DegradeLadder(frontdoor_threshold=3,
                                         frontdoor_cooldown_s=10.0)
        assert not ladder.watch_resync_only()
        for _ in range(3):
            ladder.note_watch_demotion()
        assert ladder.rung() == "snapshot_resync_only"
        assert ladder.watch_resync_only()
        # open implies coalesce-hard too
        assert ladder.watch_coalesce_aggressive()
        # cooldown passes: one probe allowed, and a completed resync
        # closes the breaker
        fc.t += 11.0
        assert not ladder.watch_resync_only()  # the half-open probe
        ladder.note_watch_promoted()
        assert ladder.rung() == ""
        assert not ladder.watch_resync_only()
        return ladder.stats()

    each(run, clocks)


def test_session_skip_still_most_severe(clocks):
    def run(P, fc):
        ladder = P.degrade.DegradeLadder(frontdoor_threshold=1)
        ladder.note_watch_demotion()
        for _ in range(3):
            ladder.note_store_error()
        assert ladder.rung() == "session_skip"
        return ladder.stats()

    each(run, clocks)


# -- TestFrontDoorMetrics ---------------------------------------------------

def test_new_series_render_with_inf_bucket():
    def run(P, _):
        m = P.metrics
        m.reset()
        try:
            m.set_watch_queue_depth("interactive", 7)
            m.set_watch_queue_depth("batch", 123)
            m.register_watch_coalesced(41)
            m.register_admission_shed("rate", 3)
            m.register_admission_shed("backlog")
            m.observe_admission_retry_after(0.3)
            m.observe_admission_retry_after(42.0)  # beyond buckets
            body = m.render()
        finally:
            m.reset()
        assert ('volcano_watch_queue_depth{watcher_class='
                '"interactive"} 7' in body)
        assert 'volcano_watch_queue_depth{watcher_class="batch"} 123' in body
        assert "volcano_watch_events_coalesced_total 41" in body
        assert 'volcano_admission_shed_total{reason="rate"} 3' in body
        assert 'volcano_admission_shed_total{reason="backlog"} 1' in body
        # +Inf bucket is mandatory and equals _count (2 observations, one
        # past the last finite bucket)
        assert ('volcano_admission_retry_after_seconds_bucket'
                '{le="+Inf"} 2' in body)
        assert "volcano_admission_retry_after_seconds_count 2" in body
        return body

    each(run)
