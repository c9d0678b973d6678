"""The gateway's watch journal and the fan-out flow control in the port
(volcano_tpu_torch/store/gateway.py ``_WatchJournal``,
volcano_tpu_torch/store/flowcontrol.py) against the JAX package's.

Twins of the tests in tests/test_watch_overflow_fuzz.py that do not use
``sim.mirror.JournalMirror`` (the simulator, not ported yet): the poll
protocol's resets, the squash gate, the event compactor's fuzz, the
shared fan-out batch and the remote fuzz over a real gateway, with the
reference's seeds. Each scenario runs on both packages with the clock
pinned to one counter, and the two observations (events without their
wall-clock append stamp, cursors, counters, final states) must be equal.
The append-time demotion of a stalled watcher is held the same way,
driven by ``WatchFanout.poll_for`` alone.

Every wait has its own deadline; every gateway is stopped in a
``finally``. Tolerance: none; comparisons exact.
"""

from __future__ import annotations

import copy
import importlib
import itertools
import random
import threading
import time
from types import SimpleNamespace

import pytest


def _pkg(name):
    mods = {"objects": "api.objects", "codec": "api.codec",
            "store": "store.store", "gateway": "store.gateway",
            "remote": "store.remote", "flow": "store.flowcontrol",
            "clock": "utils.clock", "tu": "scheduler.util.test_utils",
            "degrade": "scheduler.degrade"}
    return SimpleNamespace(name=name, **{
        k: importlib.import_module(f"{name}.{v}") for k, v in mods.items()})


REF = _pkg("volcano_tpu")
PORT = _pkg("volcano_tpu_torch")


def _both(scenario):
    seen = []
    for P in (REF, PORT):
        ticks = itertools.count(1)
        P.clock.set_source(lambda: float(next(ticks)))
        P.degrade.reset()
        try:
            seen.append(scenario(P))
        finally:
            P.clock.set_source(None)
            P.degrade.reset()
    assert seen[1] == seen[0]
    return seen[1]


def _plain(events):
    """Journal entries without the wall-clock append stamp."""
    return [{k: v for k, v in e.items() if k != "ts"} for e in events]


def _make_pod(P, i):
    pod = P.tu.build_pod("fuzz", f"pod-{i:05d}", "", P.objects.POD_PHASE_PENDING,
                         {"cpu": "100m", "memory": "64Mi"}, "")
    pod.metadata.ensure_identity()
    return pod


def _churn(P, store, rng, live, i):
    """One random store mutation; returns the next pod index."""
    roll = rng.random()
    if not live or roll < 0.45:
        pod = _make_pod(P, i)
        store.create(pod)
        live[P.store.object_key(pod)] = pod
        return i + 1
    key = rng.choice(sorted(live))
    if roll < 0.75:
        pod = copy.deepcopy(live[key])
        pod.metadata.annotations["fuzz"] = str(i)
        live[key] = store.update(pod)
    else:
        ns, name = key.split("/", 1)
        store.delete("Pod", ns, name)
        del live[key]
    return i + 1


# -- TestJournalPollProtocol ---------------------------------------------------

def test_future_cursor_signals_reset():
    def scenario(P):
        store = P.store.Store()
        journal = P.gateway._WatchJournal(store, "Pod", cap=8)
        store.create(_make_pod(P, 0))
        events, nxt, reset = journal.poll(0, 0.0)
        # a cursor beyond the head (stale client after a journal rebuild)
        events2, nxt2, reset2 = journal.poll(nxt + 100, 0.0)
        return _plain(events), nxt, reset, list(events2), nxt2, reset2

    events, nxt, reset, events2, nxt2, reset2 = _both(scenario)
    assert not reset and len(events) == 1
    assert reset2 and events2 == [] and nxt2 == nxt


def test_fallen_off_ring_signals_reset():
    def scenario(P):
        store = P.store.Store()
        journal = P.gateway._WatchJournal(store, "Pod", cap=4)
        for idx in range(10):
            store.create(_make_pod(P, idx))
        events, nxt, reset = journal.poll(0, 0.0)
        events2, _, reset2 = journal.poll(nxt, 0.0)
        return list(events), nxt, reset, list(events2), reset2, journal.stats()

    events, nxt, reset, events2, reset2, stats = _both(scenario)
    assert reset and events == [] and nxt == 10
    assert not reset2 and events2 == []
    assert stats["trimmed"] == 6


# -- TestJournalSquash (no mirror) ----------------------------------------------

def test_served_entries_are_immutable():
    def scenario(P):
        store = P.store.Store()
        journal = P.gateway._WatchJournal(store, "Pod", cap=32)
        pod = _make_pod(P, 0)
        store.create(pod)
        pod = copy.deepcopy(pod)
        pod.metadata.annotations["v"] = "1"
        pod = store.update(pod)
        events, nxt, reset = journal.poll(0, 0.0)
        v1 = P.codec.from_envelope(events[1]["object"]).metadata.resource_version
        pod = copy.deepcopy(pod)
        pod.metadata.annotations["v"] = "2"
        pod = store.update(pod)
        events2, _, reset2 = journal.poll(nxt, 0.0)
        return (reset, len(events), v1,
                P.codec.from_envelope(events[1]["object"]).metadata.resource_version,
                reset2, _plain(events2), pod.metadata.resource_version,
                journal.squashed)

    (reset, n, v1, v1_after, reset2, events2, rv, squashed) = _both(scenario)
    assert not reset and n == 2 and v1_after == v1
    assert not reset2 and len(events2) == 1 and squashed == 0
    assert events2[0]["object"]["object"]["metadata"]["resource_version"] == rv


def test_unserved_modified_chain_squashes():
    """The squash half of the gate: MODIFIEDs no poll has served yet
    coalesce into one entry that keeps the chain's first ``old``."""
    def scenario(P):
        store = P.store.Store()
        journal = P.gateway._WatchJournal(store, "Pod", cap=32)
        pod = store.create(_make_pod(P, 0))
        for v in range(5):
            pod = copy.deepcopy(pod)
            pod.metadata.annotations["v"] = str(v)
            pod = store.update(pod)
        events, _, _ = journal.poll(0, 0.0)
        return _plain(events), journal.squashed, journal.stats()

    events, squashed, stats = _both(scenario)
    assert [e["type"] for e in events] == ["ADDED", "MODIFIED"]
    assert squashed == 4 and stats["appended"] == 2
    assert events[1]["old"]["object"]["metadata"]["annotations"] == {}
    assert events[1]["object"]["object"]["metadata"]["annotations"] == {"v": "4"}


# -- TestEventCompactor ----------------------------------------------------------

def _replay(P, events, state):
    for entry in events:
        etype = entry.get("type")
        if etype in ("ADDED", "MODIFIED"):
            obj = P.codec.from_envelope(entry["object"])
            state[P.store.object_key(obj)] = obj.metadata.resource_version
        elif etype == "DELETED":
            obj = P.codec.from_envelope(entry["old"])
            state.pop(P.store.object_key(obj), None)


@pytest.mark.parametrize("seed", [21, 22, 23, 24])
def test_compacted_replay_matches_raw_replay(seed):
    def scenario(P):
        rng = random.Random(seed)
        store = P.store.Store()
        journal = P.gateway._WatchJournal(store, "Pod", cap=100000)
        live: dict = {}
        idx = 0
        for _ in range(400):
            idx = _churn(P, store, rng, live, idx)
        events, _, reset = journal.poll(0, 0.0)
        compacted, coalesced = P.flow.compact_events(events)
        raw_state: dict = {}
        compact_state: dict = {}
        _replay(P, events, raw_state)
        _replay(P, compacted, compact_state)
        truth = {P.store.object_key(p): p.metadata.resource_version
                 for p in store.list("Pod")}
        return (reset, len(events), _plain(compacted), coalesced,
                raw_state, compact_state, truth)

    reset, n, compacted, coalesced, raw, compact, truth = _both(scenario)
    assert not reset
    assert coalesced > 0, "fuzz never exercised compaction"
    assert len(compacted) == n - coalesced
    assert compact == raw == truth


def test_delete_recreate_never_merges():
    def scenario(P):
        store = P.store.Store()
        journal = P.gateway._WatchJournal(store, "Pod", cap=100000)
        pod = _make_pod(P, 0)
        store.create(pod)
        store.delete("Pod", "fuzz", pod.metadata.name)
        pod2 = _make_pod(P, 0)
        store.create(pod2)
        events, _, _ = journal.poll(0, 0.0)
        compacted, _ = P.flow.compact_events(events)
        return ([e["type"] for e in compacted],
                P.codec.from_envelope(compacted[0]["object"]).metadata.uid
                == pod2.metadata.uid)

    assert _both(scenario) == (["ADDED"], True)


# -- TestFanoutDemotion (no mirror) ------------------------------------------------

def test_shared_batch_is_one_object():
    def scenario(P):
        store = P.store.Store()
        journal = P.gateway._WatchJournal(store, "Pod", cap=64)
        fanout = P.flow.WatchFanout(journal, demote_lag=24, pin_factor=4)
        for i in range(10):
            store.create(_make_pod(P, i))
        a, na, _ = fanout.poll_for("wa", 0, 0.0)
        b, nb, _ = fanout.poll_for("wb", 0, 0.0)
        return a is b, len(a), na, nb

    assert _both(scenario) == (True, 10, 10, 10)


def test_stalled_watcher_is_demoted_at_append_time():
    """A registered watcher that stops polling holds retention past the
    soft cap only up to ``min(demote_lag, hard_cap)``; it is demoted at
    append time (reason ``append_lag``), the ring falls back to its cap,
    and its next poll is the reset."""
    def scenario(P):
        store = P.store.Store()
        journal = P.gateway._WatchJournal(store, "Pod", cap=16)
        fanout = P.flow.WatchFanout(journal, demote_lag=24, pin_factor=4)
        for i in range(8):
            store.create(_make_pod(P, i))
        events, cursor, _ = fanout.poll_for("stalled", 0, 0.0, cls="batch")
        peak = 0
        for i in range(8, 80):
            store.create(_make_pod(P, i))
            peak = max(peak, len(journal.events))
        after = len(journal.events)
        _, nxt, reset = fanout.poll_for("stalled", cursor, 0.0, cls="batch")
        stats = fanout.watch_stats()
        return (len(events), peak, after, nxt, reset,
                dict(fanout.demotions_by_reason), stats["counters"],
                fanout.hard_cap)

    n, peak, after, nxt, reset, reasons, counters, hard_cap = _both(scenario)
    assert n == 8 and peak > 16 and peak <= min(24, hard_cap)
    assert after <= 16 and reset and nxt == 80
    assert reasons.get("append_lag", 0) >= 1 and counters["demotions"] >= 1


# -- TestRemoteWatchFuzz ----------------------------------------------------------

def _remote_fuzz(P, seed, bursts, burst, gw_kw, watch_kw):
    store = P.store.Store()
    gateway = P.gateway.ApiGateway(store, **gw_kw).start()
    remote = P.remote.RemoteStore(f"127.0.0.1:{gateway.port}")
    try:
        known: dict = {}
        lock = threading.Lock()
        key = P.store.object_key

        def on_added(obj):
            with lock:
                known[key(obj)] = obj.metadata.resource_version

        def on_updated(old, new):
            with lock:
                known[key(new)] = new.metadata.resource_version

        def on_deleted(obj):
            with lock:
                known.pop(key(obj), None)

        remote.watch("Pod", P.store.WatchHandler(
            added=on_added, updated=on_updated, deleted=on_deleted),
            poll_timeout=0.2, **watch_kw)
        rng = random.Random(seed)
        live: dict = {}
        idx = 0
        for _ in range(bursts):
            # bursts far past the ring while the long-poll sleeps
            for _ in range(burst):
                idx = _churn(P, store, rng, live, idx)
            time.sleep(0.05)
        truth = {key(p): p.metadata.resource_version for p in store.list("Pod")}
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            with lock:
                snapshot = dict(known)
            if snapshot == truth:
                break
            time.sleep(0.1)
        assert snapshot == truth, (
            f"remote mirror did not converge: "
            f"{len(set(snapshot) - set(truth))} phantom, "
            f"{len(set(truth) - set(snapshot))} missing")
        return truth, remote.watch_stats(), gateway.watch_stats()
    finally:
        remote.stop_watches()
        gateway.stop()


def test_remote_consumer_lags_past_tiny_ring():
    truth = _both(lambda P: _remote_fuzz(
        P, 99, 6, 60, dict(journal_cap=16), {})[0])
    assert truth


def test_remote_watcher_demoted_to_resync_converges():
    def scenario(P):
        truth, client, server = _remote_fuzz(
            P, 7, 5, 80, dict(journal_cap=16, watch_demote_lag=24),
            dict(watcher_id="remote-consumer", watcher_class="batch"))
        assert server["Pod"]["counters"]["registered"] >= 1, server
        assert client["resets"] >= 1
        return truth

    assert _both(scenario)
