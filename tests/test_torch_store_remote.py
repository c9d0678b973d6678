"""The port's HTTP gateway and remote client (volcano_tpu_torch/store/
gateway.py, remote.py) against the JAX package's.

- Twins of tests/test_remote_watch.py's ``TestGatewayWatch``,
  ``TestWatchResetSynthesis``, ``TestGatewayAuth`` and the TLS round
  trip: each scenario runs once with the JAX package's gateway and client
  and once with the port's, and what the client observes (watch callbacks
  in order, errors, listed names) must be equal, and equal to what the
  reference test asserts.
- A cross-package wire test: the port's ``RemoteStore`` watching a JAX
  ``ApiGateway``, and the JAX ``RemoteStore`` watching a port
  ``ApiGateway``, each see the same ADDED/MODIFIED/DELETED sequence as a
  client of its own package, and writes made through either client land
  in the other package's store.

Every wait has its own deadline (``_wait``); every gateway is stopped and
every watch joined in a ``finally``. Tolerance: none; comparisons exact.
"""

from __future__ import annotations

import copy
import importlib
import shutil
import subprocess
import threading
import time
from types import SimpleNamespace

import pytest


def _pkg(name):
    mods = {"objects": "api.objects", "codec": "api.codec", "store": "store",
            "gateway": "store.gateway", "remote": "store.remote"}
    return SimpleNamespace(name=name, **{
        k: importlib.import_module(f"{name}.{v}") for k, v in mods.items()})


REF = _pkg("volcano_tpu")
PORT = _pkg("volcano_tpu_torch")
PAIRS = {"ref": (REF, REF), "port": (PORT, PORT)}


def _queue(P, name, weight=1):
    return P.objects.Queue(
        metadata=P.objects.ObjectMeta(name=name),
        spec=P.objects.QueueSpec(weight=weight))


def _wait(predicate, timeout=20.0, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        out = predicate()
        if out:
            return out
        time.sleep(interval)
    return None


def _twice(scenario):
    """``scenario(server_pkg, client_pkg)`` with the JAX package on both
    ends, then the port on both ends; the observations must be equal."""
    ref = scenario(*PAIRS["ref"])
    port = scenario(*PAIRS["port"])
    assert port == ref
    return port


class _Served:
    """A store behind a started gateway and a client of it; ``close()``
    stops the client's watches and the gateway."""

    def __init__(self, S, C, **gw_kw):
        self.store = S.store.Store()
        self.gw = S.gateway.ApiGateway(self.store, ":0", **gw_kw).start()
        self.remote = C.remote.RemoteStore(f"127.0.0.1:{self.gw.port}")

    def close(self):
        try:
            self.remote.stop_watches()
        finally:
            self.gw.stop()


# -- TestGatewayWatch twins ----------------------------------------------------

def _watch_sequence(S, C):
    """Pre-existing object, then a create, an update and a delete on the
    server; the client's callbacks in order."""
    srv = _Served(S, C)
    try:
        srv.store.create(_queue(S, "pre-existing", 2))
        events = []
        lock = threading.Lock()

        def record(kind):
            def cb(*args):
                with lock:
                    events.append((kind, tuple(
                        (a.metadata.name, a.spec.weight) for a in args)))
            return cb

        srv.remote.watch("Queue", C.store.WatchHandler(
            added=record("added"), updated=record("updated"),
            deleted=record("deleted")))
        assert _wait(lambda: len(events) >= 1), "initial sync never arrived"
        q2 = srv.store.create(_queue(S, "flip", 1))
        assert _wait(lambda: len(events) >= 2), events
        q2b = copy.deepcopy(q2)  # the store holds q2 live; don't alias it
        q2b.spec.weight = 7
        srv.store.update(q2b)
        assert _wait(lambda: len(events) >= 3), events
        srv.store.delete("Queue", "", "flip")
        assert _wait(lambda: len(events) >= 4), events
        return events
    finally:
        srv.close()


def test_watch_added_modified_deleted():
    assert _twice(_watch_sequence) == [
        ("added", (("pre-existing", 2),)),
        ("added", (("flip", 1),)),
        ("updated", (("flip", 1), ("flip", 7))),
        ("deleted", (("flip", 7),)),
    ]


def test_watch_reset_relists():
    def scenario(S, C):
        srv = _Served(S, C)
        try:
            srv.store.create(_queue(S, "q0"))
            j = S.gateway._WatchJournal(srv.store, "Queue", cap=2)
            with srv.gw._journals_lock:
                srv.gw._journals["Queue"] = j
            for i in range(1, 6):
                srv.store.create(_queue(S, f"q{i}"))
            events, nxt, reset = j.poll(0, 0)
            seen = []
            srv.remote.watch("Queue", C.store.WatchHandler(added=seen.append))
            assert _wait(lambda: len(seen) >= 6)
            return (list(events), nxt, reset,
                    sorted({q.metadata.name for q in seen}))
        finally:
            srv.close()

    events, nxt, reset, names = _twice(scenario)
    assert reset and nxt == 6 and events == []  # the ring holds the last 2
    assert names == [f"q{i}" for i in range(6)]


def test_event_flusher_respawns_after_stop_timeout():
    def scenario(S, C):
        srv = _Served(S, C)
        try:
            q = srv.store.create(_queue(S, "evq"))
            srv.remote._event_stop = True  # simulate the timed-out stop
            srv.remote.record_event(q, "Normal", "First", "m1")
            srv.remote.flush_events()
            srv.remote.record_event(q, "Normal", "Second", "m2")
            srv.remote.flush_events()
            return sorted(e.reason for e in srv.store.events_for(q))
        finally:
            srv.close()

    assert _twice(scenario) == ["First", "Second"]


def _client_error(S, C, call):
    srv = _Served(S, C)
    try:
        with pytest.raises(ValueError) as e:
            call(S, srv)
        return type(e.value).__name__, str(e.value)
    finally:
        srv.close()


def test_malformed_selector_is_400():
    _twice(lambda S, C: _client_error(
        S, C, lambda S, srv: srv.remote._request(
            "GET", "/apis/Queue", query={"selector": "no-equals-sign"})))


def test_put_path_body_mismatch_is_400():
    def call(S, srv):
        q = srv.store.create(_queue(S, "real"))
        srv.remote._request("PUT", "/apis/Queue/-/other", S.codec.envelope(q))

    _, msg = _twice(lambda S, C: _client_error(S, C, call))
    assert "path/body mismatch" in msg


def test_watch_bad_since_is_400():
    _twice(lambda S, C: _client_error(
        S, C, lambda S, srv: srv.remote._request(
            "GET", "/watch/Queue", query={"since": "nan-o-second"})))


# -- TestWatchResetSynthesis twin ---------------------------------------------

def test_reset_diffs_known_set_and_retries_failed_relist():
    """The poller's reset handling against a scripted transport: two
    failed re-lists are retried without moving the cursor, then the
    objects missing from the re-list get a synthesized DELETED, the
    listed set is re-ADDed, and the cursor resumes from the reset's
    ``next``."""
    def scenario(P, _):
        remote = P.remote.RemoteStore("127.0.0.1:1")  # transport stubbed
        calls = {"list": 0, "polls": []}
        stopper = threading.Event()

        def fake_request(method, path, payload=None, query=None,
                         timeout=None):
            if path == "/apis/Queue":
                calls["list"] += 1
                if calls["list"] <= 2:
                    raise P.remote.RemoteStoreError("re-list unavailable")
                return {"items": [P.codec.envelope(_queue(P, "q0")),
                                  P.codec.envelope(_queue(P, "q5"))]}
            assert path == "/watch/Queue"
            since = int(query["since"])
            calls["polls"].append(since)
            if since == 0:
                return {"events": [
                    {"type": "ADDED", "object": P.codec.envelope(_queue(P, n))}
                    for n in ("q0", "q1", "q2")], "next": 3}
            if since == 3:
                return {"reset": True, "next": 9}
            stopper.wait(0.2)  # post-reset steady state
            return {"events": [], "next": since}

        remote._request = fake_request
        adds, dels = [], []
        remote.watch("Queue", P.store.WatchHandler(
            added=lambda o: adds.append(o.metadata.name),
            deleted=lambda o: dels.append(o.metadata.name)))
        try:
            assert _wait(lambda: set(dels) == {"q1", "q2"}, timeout=30.0), \
                (adds, dels, calls)
            assert _wait(lambda: 9 in calls["polls"])
            stats = remote.watch_stats()
            return (adds[:3], sorted(adds[3:]), sorted(dels), calls["list"],
                    [s for s in calls["polls"] if s == 3][:3],
                    stats["resets"], stats["relist_retries"])
        finally:
            stopper.set()
            remote.stop_watches()

    first, readded, dels, lists, polls3, resets, retries = \
        _twice(scenario)
    assert first == ["q0", "q1", "q2"] and readded == ["q0", "q5"]
    assert dels == ["q1", "q2"] and lists == 3 and polls3 == [3, 3, 3]
    assert resets == 3 and retries == 2


# -- TestGatewayAuth twins and TLS ----------------------------------------------

def test_anonymous_write_rejected():
    def scenario(S, C):
        store = S.store.Store()
        gw = S.gateway.ApiGateway(store, ":0", token="sekrit").start()
        try:
            out = []
            anon = C.remote.RemoteStore(f"127.0.0.1:{gw.port}")
            for call in (lambda: anon.create(_queue(C, "nope")),
                         lambda: anon.list("Queue")):  # reads are gated too
                with pytest.raises(C.remote.RemoteStoreError, match="401"):
                    call()
            # healthz stays open (liveness probes carry no credentials)
            out.append(anon.healthy())
            authed = C.remote.RemoteStore(f"127.0.0.1:{gw.port}",
                                          token="sekrit")
            out.append(authed.create(_queue(C, "yes")).metadata.name)
            out.append([q.metadata.name for q in authed.list("Queue")])
            return out
        finally:
            gw.stop()

    assert _twice(scenario) == [True, "yes", ["yes"]]


def test_non_loopback_bind_requires_token():
    def scenario(S, _):
        gw = S.gateway.ApiGateway(S.store.Store(), "0.0.0.0:0")
        with pytest.raises(ValueError, match="requires --api-token") as e:
            gw.start()
        # and the same bind WITH a token is accepted
        gw2 = S.gateway.ApiGateway(S.store.Store(), "0.0.0.0:0",
                                   token="t").start()
        gw2.stop()
        return str(e.value)

    _twice(scenario)


@pytest.mark.skipif(shutil.which("openssl") is None,
                    reason="openssl binary unavailable")
def test_gateway_tls_roundtrip(tmp_path):
    cert = tmp_path / "gw.crt"
    key = tmp_path / "gw.key"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", str(key), "-out", str(cert), "-days", "1",
         "-subj", "/CN=127.0.0.1"],
        check=True, capture_output=True, timeout=120)

    def scenario(S, C):
        gw = S.gateway.ApiGateway(S.store.Store(), ":0", token="tls-tok",
                                  tls_cert=str(cert), tls_key=str(key)).start()
        try:
            remote = C.remote.RemoteStore(f"https://127.0.0.1:{gw.port}",
                                          token="tls-tok", tls_verify=False)
            created = remote.create(_queue(C, "over-tls", 5))
            # plaintext client against the TLS port fails at the transport
            with pytest.raises(C.remote.RemoteStoreError):
                C.remote.RemoteStore(f"127.0.0.1:{gw.port}", token="tls-tok",
                                     timeout=3).list("Queue")
            return created.spec.weight
        finally:
            gw.stop()

    assert _twice(scenario) == 5


# -- the cross-package wire test -------------------------------------------------

@pytest.mark.parametrize("server,client", [(REF, PORT), (PORT, REF)],
                         ids=["port-client-jax-gateway",
                              "jax-client-port-gateway"])
def test_cross_package_watch_sequence(server, client):
    """One package's client against the other's gateway sees the same
    callbacks as a client of its own package."""
    own = _watch_sequence(server, server)
    assert _watch_sequence(server, client) == own
    assert [e[0] for e in own] == ["added", "added", "updated", "deleted"]


@pytest.mark.parametrize("server,client", [(REF, PORT), (PORT, REF)],
                         ids=["port-client-jax-gateway",
                              "jax-client-port-gateway"])
def test_cross_package_writes_land_in_the_other_store(server, client):
    srv = _Served(server, client)
    try:
        tu = importlib.import_module(f"{client.name}.scheduler.util.test_utils")
        pod = tu.build_pod("ns", "p1", "", "Pending", {"cpu": "1"}, "pg")
        created = srv.remote.create(pod)
        assert type(created) is client.objects.Pod
        created.spec.node_name = "n7"
        srv.remote.update(created)
        held = srv.store.get("Pod", "ns", "p1")
        assert type(held) is server.objects.Pod
        assert held.spec.node_name == "n7"
        assert server.codec.to_wire(held) == client.codec.to_wire(
            srv.remote.get("Pod", "ns", "p1"))
        srv.remote.record_scheduled(["ns/p1"], ["n7"])
        srv.remote.flush_events()
        assert [(e.reason, e.message) for e in srv.store.events_for(held)] == [
            ("Scheduled", "Successfully assigned ns/p1 to n7")]
        # a fenced write keeps its type across the hop
        srv.store.advance_fence(3)
        with pytest.raises(client.store.FencedError):
            srv.remote.update(created, epoch=2)
        assert srv.store.fence_stats["rejected"] == 1
    finally:
        srv.close()
