"""HTTP/JSON gateway over the store — the API-server seam for remote
clients.

The reference's vcctl is a network client of the Kubernetes API server
(cmd/cli/vcctl.go:34; pkg/cli/job/run.go:55-80 creates Jobs over HTTP).
This gateway gives the in-process store the same served surface so
``vcctl --server host:port`` (store/remote.py RemoteStore) drives a live
cluster process from outside:

    POST   /apis/{Kind}                      create   (envelope body)
    GET    /apis/{Kind}?namespace=&selector= list     ({"items": [...]})
    GET    /apis/{Kind}/{ns}/{name}          get      ("-" = cluster scope)
    PUT    /apis/{Kind}/{ns}/{name}?expect=  update   (CAS via expect)
    DELETE /apis/{Kind}/{ns}/{name}          delete
    GET    /events/{Kind}/{ns}/{name}        recorded events
    GET    /watch/{Kind}?since=&timeout=     long-poll watch stream
    GET    /healthz

Admission runs server-side exactly as for in-process writes (store.create
applies mutators/validators); AdmissionError maps to 422, ConflictError
to 409, NotFoundError to 404, and OverloadedError — the intake gate's
admission backpressure (admission/intake.py) — to 429 with a Retry-After
header and a ``retry_after`` body field, so a shed submission is always
rejected-with-retry, never dropped. Objects travel as api/codec.py
envelopes.

Watch streams make remote informer clients possible — the reference's
controllers/scheduler are informer clients of the API server
(pkg/scheduler/cache/cache.go:322-425); RemoteStore.watch (store/remote.py)
long-polls this endpoint and dispatches the same WatchHandler callbacks as
the in-process Store.watch. Protocol: each kind gets a server-side journal
(created on first watch, seeded with ADDED for existing objects); clients
poll `since=<seq>` and receive `{"events": [...], "next": seq}`; a client
that fell behind a trimmed journal receives `{"reset": true, "next": seq}`
and must re-list before resuming. A poll naming `watcher=<id>` (and
optionally `class=interactive|batch|default`) opts into the fan-out
flow-control layer (store/flowcontrol.py): per-watcher lag accounting,
batched delivery-side coalescing, and slow-watcher demotion — a deep
laggard receives the SAME reset contract instead of an unbounded
catch-up stream, and resumes via re-list with its resumable cursor.

Auth/TLS: pass ``token=`` to require `Authorization: Bearer <token>` on
every request except /healthz (the reference's API surface is an
authenticated TLS server — pkg/admission/server.go:33-62); pass
``tls_cert=/tls_key=`` to serve HTTPS. A non-loopback bind without a token
is refused at start() — exposing an unauthenticated read-write API beyond
the host must be impossible by accident.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import parse_qs, urlsplit

from volcano_tpu_torch.api import codec
from volcano_tpu_torch.scheduler.httpserver import _parse_address
from volcano_tpu_torch.store.store import (
    AdmissionError, ConflictError, NotFoundError, OverloadedError, Store,
    WatchHandler)

logger = logging.getLogger(__name__)


class _WatchJournal:
    """Per-kind ring buffer of watch events, fed by a store WatchHandler.

    Seeded with ADDED entries for existing objects at creation (the
    list+watch initial sync), so a client polling from since=0 sees the
    full state. Trimmed at ``cap``; a reader whose cursor predates the
    ring start gets reset=True and must re-list.

    Backpressure coalescing: while every watcher is behind a MODIFIED for
    key K (no poll has served K's latest MODIFIED yet), a newer MODIFIED
    for K squashes into it in place — the entry keeps its original "old"
    and takes the newest "object", so a catching-up client observes one
    old->newest transition instead of the whole chain. Under fan-out with
    slow watchers this is what keeps a MODIFIED storm (no-op update
    bursts, status churn) from rolling the ring past every cursor and
    forcing spurious 410-style reset/re-list cycles. Squashing is gated
    on ``_served_to`` (the highest sequence any poll has handed out):
    an entry some client may already have consumed is immutable, so no
    client can ever miss a final state."""

    def __init__(self, store: Store, kind: str, cap: int = 4096):
        self.cond = threading.Condition()
        self.events: list = []
        self.start = 0  # sequence number of events[0]
        self.cap = cap
        self.squashed = 0  # MODIFIED events coalesced away
        self.appended = 0  # entries ever appended (post-squash)
        self.trimmed = 0   # entries dropped off the ring start
        self.peak_occupancy = 0
        self._served_to = 0  # highest seq ever returned by a poll
        # key -> (seq, type) of that key's latest ring entry, the squash
        # candidate index; pruned lazily against the ring start
        self._latest: dict = {}
        # optional flow-control layer (store/flowcontrol.WatchFanout):
        # consulted at trim time so live laggards extend retention up to
        # its hard cap, and demoted/stalled watchers cannot pin the ring
        self.fanout = None
        # shared-slice cache: watchers at the same cursor receive the
        # SAME immutable tuple, so N watchers cost O(events + N), not
        # O(events x N) copies; invalidated whenever the ring moves.
        # Safe to share: poll marks entries served (immutable) before
        # caching, so no later squash can rewrite a cached entry.
        self._slice_cache: dict = {}
        self._slice_gen = (-1, -1)
        store.watch(kind, WatchHandler(
            added=lambda new: self._append("ADDED", None, new),
            updated=lambda old, new: self._append("MODIFIED", old, new),
            deleted=lambda old: self._append("DELETED", old, None),
        ), replay=True)

    def _append(self, etype: str, old, new) -> None:
        from volcano_tpu_torch.store.store import object_key

        import time as _time

        key = object_key(new if new is not None else old)
        # append-time stamp (wall monotonic, observability only — never a
        # scheduling input): the fan-out bench derives per-watcher
        # delivery latency from it
        entry = {"type": etype, "key": key, "ts": _time.monotonic()}
        if new is not None:
            entry["object"] = codec.envelope(new)
        if old is not None:
            entry["old"] = codec.envelope(old)
        with self.cond:
            if etype == "MODIFIED":
                prior = self._latest.get(key)
                if prior is not None:
                    seq, ptype = prior
                    if ptype == "MODIFIED" and seq >= self.start \
                            and seq >= self._served_to:
                        # unserved chain tail for this key: squash in
                        # place (keep the chain's original "old")
                        merged = self.events[seq - self.start]
                        merged["object"] = entry["object"]
                        self.squashed += 1
                        self.cond.notify_all()
                        return
            self.events.append(entry)
            self.appended += 1
            self._slice_cache.clear()
            self._latest[key] = (self.start + len(self.events) - 1, etype)
            if len(self.events) > self.cap:
                # soft-cap trim. With a fanout attached, a LIVE laggard
                # may lower the floor (bounded retention up to the
                # fanout's hard cap) — and the fanout demotes any watcher
                # lagging past demote_lag right here, so a stalled
                # watcher can never pin entries past the cap.
                floor = self.start + len(self.events) - self.cap
                if self.fanout is not None:
                    floor = self.fanout.retain_floor(floor)
                drop = floor - self.start
                if drop > 0:
                    del self.events[:drop]
                    self.start = floor
                    self.trimmed += drop
            if len(self.events) > self.peak_occupancy:
                self.peak_occupancy = len(self.events)
            if len(self._latest) > 4 * self.cap:
                self._latest = {k: v for k, v in self._latest.items()
                                if v[0] >= self.start}
            self.cond.notify_all()

    def attach_fanout(self, fanout) -> None:
        """Install the flow-control layer (store/flowcontrol.WatchFanout);
        its retain_floor() hook runs inside every over-cap trim."""
        with self.cond:
            self.fanout = fanout

    def force_reset(self) -> int:
        """Freeze squash eligibility through the current head and return
        it — the demote-to-resync twin of poll()'s reset path (a watcher
        told to re-list must never lose a final state to a squash below
        its new cursor)."""
        with self.cond:
            end = self.start + len(self.events)
            self._served_to = max(self._served_to, end)
            return end

    def stats(self) -> dict:
        """Occupancy + lifetime accounting (the journal half of
        ``watch_stats()``)."""
        with self.cond:
            return {
                "occupancy": len(self.events),
                "cap": self.cap,
                "hard_cap": (self.fanout.hard_cap
                             if self.fanout is not None else self.cap),
                "peak_occupancy": self.peak_occupancy,
                "start": self.start,
                "end": self.start + len(self.events),
                "appended": self.appended,
                "squashed": self.squashed,
                "trimmed": self.trimmed,
            }

    def poll(self, since: int, timeout: float):
        """Events with seq >= since, blocking up to ``timeout`` when none
        are pending. Returns (events, next_seq, reset)."""
        deadline = None
        with self.cond:
            while True:
                end = self.start + len(self.events)
                if since < self.start:
                    # fell behind the ring: re-list. The reset ALSO ends
                    # squash eligibility through `end`: the client resumes
                    # from `end`, so a post-reset MODIFIED squashed into an
                    # entry below it would vanish into the gap between this
                    # reset and the client's re-list — a lost final state.
                    self._served_to = max(self._served_to, end)
                    return [], end, True
                if since > end:
                    # cursor from a FUTURE sequence this journal never
                    # assigned (a client that outlived a gateway restart,
                    # or a corrupted cursor). Waiting for the journal to
                    # catch up would silently skip every event in the gap
                    # — the same phantom-object hazard as falling behind —
                    # so signal the HTTP-410-style reset and make the
                    # client re-list (and freeze squashes, as above).
                    self._served_to = max(self._served_to, end)
                    return [], end, True
                if since < end:
                    # entries handed out become immutable (the squash gate)
                    self._served_to = max(self._served_to, end)
                    # shared-slice fast path: every watcher at this cursor
                    # gets the SAME tuple until the ring moves again
                    if self._slice_gen != (self.start, end):
                        self._slice_cache.clear()
                        self._slice_gen = (self.start, end)
                    batch = self._slice_cache.get(since)
                    if batch is None:
                        batch = tuple(self.events[since - self.start:])
                        self._slice_cache[since] = batch
                    return batch, end, False
                if deadline is None:
                    import time as _time

                    deadline = _time.monotonic() + timeout
                    remaining = timeout
                else:
                    import time as _time

                    remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    return [], end, False
                self.cond.wait(remaining)


class ApiGateway:
    """Serves the store over HTTP; port 0 picks a free port (``.port``).

    Binds loopback by default (':0' -> 127.0.0.1): this is an
    UNAUTHENTICATED read-write API — exposing it beyond the host must be
    an explicit operator choice (--api-address 0.0.0.0:PORT)."""

    def __init__(self, store: Store, address: str = ":0",
                 token: Optional[str] = None,
                 tls_cert: Optional[str] = None,
                 tls_key: Optional[str] = None,
                 journal_cap: int = 4096,
                 watch_demote_lag: Optional[int] = None,
                 watch_pin_factor: int = 4):
        self.store = store
        self._journal_cap = journal_cap
        self._watch_demote_lag = watch_demote_lag
        self._watch_pin_factor = watch_pin_factor
        self._address = _parse_address(address, default_host="127.0.0.1")
        self._token = token
        self._tls_cert = tls_cert
        self._tls_key = tls_key
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._journals: Dict[str, _WatchJournal] = {}
        self._fanouts: Dict[str, object] = {}
        self._journals_lock = threading.Lock()

    @property
    def port(self) -> int:
        if self._httpd is None:
            raise RuntimeError("gateway not started")
        return self._httpd.server_address[1]

    def _journal(self, kind: str) -> _WatchJournal:
        with self._journals_lock:
            j = self._journals.get(kind)
            if j is None:
                j = self._journals[kind] = _WatchJournal(
                    self.store, kind, cap=self._journal_cap)
            return j

    def _fanout(self, kind: str):
        """Per-kind flow-control layer, created on the first poll that
        names a watcher id (clients that never do keep the bare journal
        protocol — fully backward compatible)."""
        journal = self._journal(kind)
        with self._journals_lock:
            f = self._fanouts.get(kind)
            if f is None:
                from volcano_tpu_torch.store.flowcontrol import WatchFanout

                f = self._fanouts[kind] = WatchFanout(
                    journal, demote_lag=self._watch_demote_lag,
                    pin_factor=self._watch_pin_factor)
            return f

    def watch_stats(self) -> Dict[str, dict]:
        """Per-kind journal + fan-out accounting (the front-door twin of
        the store's fence_stats): occupancy, squash/coalesce tallies,
        per-class watcher lag and demotions."""
        with self._journals_lock:
            journals = dict(self._journals)
            fanouts = dict(self._fanouts)
        out: Dict[str, dict] = {}
        for kind in sorted(journals):
            f = fanouts.get(kind)
            out[kind] = (f.watch_stats() if f is not None
                         else {"journal": journals[kind].stats()})
        return out

    def start(self) -> "ApiGateway":
        store = self.store
        gw = self
        token = self._token
        host = self._address[0]
        if token is None and host not in ("127.0.0.1", "localhost", "::1", ""):
            raise ValueError(
                f"refusing to bind unauthenticated gateway on {host!r}: "
                "a non-loopback --api-address requires --api-token")

        class Handler(BaseHTTPRequestHandler):
            def _reply(self, code: int, payload,
                       headers: Optional[dict] = None) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for key, value in (headers or {}).items():
                    self.send_header(key, value)
                self.end_headers()
                self.wfile.write(body)

            def _error(self, code: int, exc: Exception) -> None:
                self._reply(code, {"error": str(exc),
                                   "type": type(exc).__name__})

            def _body(self) -> dict:
                n = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(n) or b"{}")

            def _route(self):
                """(verb-agnostic) path -> (segments, query dict). Blank
                values are KEPT: list?namespace= means namespace "" (the
                Store.list semantic), not namespace-absent."""
                parts = urlsplit(self.path)
                segs = [s for s in parts.path.split("/") if s]
                q = {k: v[0] for k, v in parse_qs(
                    parts.query, keep_blank_values=True).items()}
                return segs, q

            def _authorized(self, segs) -> bool:
                """Bearer-token gate on every route except /healthz."""
                if token is None or segs == ["healthz"]:
                    return True
                import hmac

                supplied = self.headers.get("Authorization", "")
                if hmac.compare_digest(supplied, f"Bearer {token}"):
                    return True
                self._reply(401, {"error": "missing or invalid bearer token",
                                  "type": "Unauthorized"})
                return False

            def do_GET(self):  # noqa: N802 (http.server API)
                segs, q = self._route()
                if not self._authorized(segs):
                    return
                try:
                    if segs == ["healthz"]:
                        self._reply(200, {"ok": True})
                    elif len(segs) == 2 and segs[0] == "apis":
                        ns = q.get("namespace")
                        selector = None
                        if q.get("selector"):
                            try:
                                selector = dict(
                                    kv.split("=", 1)
                                    for kv in q["selector"].split(","))
                            except ValueError:
                                self._reply(400, {
                                    "error": "malformed selector: expected "
                                             "k=v[,k=v...]",
                                    "type": "ValueError"})
                                return
                        items = store.list(segs[1], namespace=ns,
                                           selector=selector)
                        self._reply(200, {"items": [
                            codec.envelope(o) for o in items]})
                    elif len(segs) == 2 and segs[0] == "watch":
                        try:
                            since = int(q.get("since", "0"))
                            timeout = min(float(q.get("timeout", "30")), 60.0)
                        except ValueError:
                            self._reply(400, {
                                "error": "since/timeout must be numeric",
                                "type": "ValueError"})
                            return
                        watcher = q.get("watcher")
                        if watcher:
                            # flow-controlled path: per-watcher cursor
                            # accounting, batched coalescing, slow-watcher
                            # demotion to snapshot-resync (the reset below
                            # carries the same re-list contract)
                            events, nxt, reset = gw._fanout(segs[1]).poll_for(
                                watcher, since, timeout,
                                cls=q.get("class", "default"))
                            events = list(events)
                        else:
                            events, nxt, reset = gw._journal(segs[1]).poll(
                                since, timeout)
                            events = list(events)
                        payload = {"events": events, "next": nxt}
                        if reset:
                            payload["reset"] = True
                        self._reply(200, payload)
                    elif len(segs) == 4 and segs[0] == "apis":
                        ns = "" if segs[2] == "-" else segs[2]
                        obj = store.get(segs[1], ns, segs[3])
                        self._reply(200, codec.envelope(obj))
                    elif len(segs) == 4 and segs[0] == "events":
                        ns = "" if segs[2] == "-" else segs[2]
                        obj = store.get(segs[1], ns, segs[3])
                        self._reply(200, {"items": [
                            {"event_type": e.event_type, "reason": e.reason,
                             "message": e.message}
                            for e in store.events_for(obj)]})
                    else:
                        self._reply(404, {"error": "not found"})
                except NotFoundError as e:
                    self._error(404, e)
                except Exception as e:  # noqa: BLE001 — served boundary
                    logger.exception("gateway GET %s failed", self.path)
                    self._error(500, e)

            def _epoch(self, q):
                """Optional lease-epoch stamp on a mutating verb (the
                fencing-token hop for remote leaders; store/store.py)."""
                if "epoch" not in q:
                    return None
                return int(q["epoch"])

            def do_POST(self):  # noqa: N802
                segs, q = self._route()
                if not self._authorized(segs):
                    return
                try:
                    if segs == ["events"]:
                        # batched event ingestion from remote components
                        # (a remote scheduler cache records Scheduled /
                        # Unschedulable events here; the reference's
                        # recorder is an async broadcaster to the API
                        # server the same way)
                        from volcano_tpu_torch.store.store import RecordedEvent

                        items = [
                            RecordedEvent(
                                object_kind=str(i["object_kind"]),
                                object_key=str(i["object_key"]),
                                event_type=str(i["event_type"]),
                                reason=str(i["reason"]),
                                message=str(i["message"]))
                            for i in self._body().get("items", [])]
                        store.record_events_raw(items)
                        self._reply(200, {"recorded": len(items)})
                    elif len(segs) == 2 and segs[0] == "apis":
                        obj = codec.from_envelope(self._body())
                        if type(obj).KIND != segs[1]:
                            self._reply(400, {
                                "error": f"kind mismatch: {type(obj).KIND}"
                                         f" != {segs[1]}",
                                "type": "ValueError"})
                            return
                        created = store.create(obj, epoch=self._epoch(q))
                        self._reply(201, codec.envelope(created))
                    else:
                        self._reply(404, {"error": "not found"})
                except OverloadedError as e:
                    # admission backpressure (admission/intake.py): 429 +
                    # retry-after, the rejected-with-retry contract — a
                    # shed submission is never silently dropped
                    self._reply(429, {
                        "error": str(e), "type": "OverloadedError",
                        "reason": e.reason,
                        "retry_after": e.retry_after,
                    }, headers={"Retry-After":
                                f"{max(e.retry_after, 0.0):.3f}"})
                except AdmissionError as e:
                    self._error(422, e)
                except ConflictError as e:
                    self._error(409, e)
                except (ValueError, KeyError, TypeError,
                        json.JSONDecodeError) as e:
                    self._error(400, e)  # malformed envelope: client error
                except Exception as e:  # noqa: BLE001
                    logger.exception("gateway POST %s failed", self.path)
                    self._error(500, e)

            def do_PUT(self):  # noqa: N802
                segs, q = self._route()
                if not self._authorized(segs):
                    return
                try:
                    if len(segs) == 4 and segs[0] == "apis":
                        obj = codec.from_envelope(self._body())
                        # the path names the update target; a body whose
                        # metadata disagrees would silently update a
                        # DIFFERENT object — reject instead
                        ns = "" if segs[2] == "-" else segs[2]
                        body_ns = getattr(obj.metadata, "namespace", "") or ""
                        if type(obj).KIND != segs[1] \
                                or obj.metadata.name != segs[3] \
                                or (body_ns != ns and segs[2] != "-"):
                            self._reply(400, {
                                "error": "path/body mismatch: path names "
                                         f"{segs[1]}/{segs[2]}/{segs[3]}, body "
                                         f"names {type(obj).KIND}/"
                                         f"{body_ns or '-'}/{obj.metadata.name}",
                                "type": "ValueError"})
                            return
                        expect = (int(q["expect"])
                                  if "expect" in q else None)
                        updated = store.update(obj, expect_version=expect,
                                               epoch=self._epoch(q))
                        self._reply(200, codec.envelope(updated))
                    else:
                        self._reply(404, {"error": "not found"})
                except NotFoundError as e:
                    self._error(404, e)
                except ConflictError as e:
                    self._error(409, e)
                except (ValueError, KeyError, json.JSONDecodeError) as e:
                    self._error(400, e)  # bad expect=/envelope: client error
                except Exception as e:  # noqa: BLE001
                    logger.exception("gateway PUT %s failed", self.path)
                    self._error(500, e)

            def do_DELETE(self):  # noqa: N802
                segs, q = self._route()
                if not self._authorized(segs):
                    return
                try:
                    if len(segs) == 4 and segs[0] == "apis":
                        ns = "" if segs[2] == "-" else segs[2]
                        obj = store.delete(segs[1], ns, segs[3],
                                           epoch=self._epoch(q))
                        self._reply(200, codec.envelope(obj))
                    else:
                        self._reply(404, {"error": "not found"})
                except NotFoundError as e:
                    self._error(404, e)
                except ConflictError as e:
                    self._error(409, e)  # fenced delete (stale lease epoch)
                except ValueError as e:
                    self._error(400, e)  # malformed epoch=
                except Exception as e:  # noqa: BLE001
                    logger.exception("gateway DELETE %s failed", self.path)
                    self._error(500, e)

            def log_message(self, fmt, *args):
                logger.debug("gateway: " + fmt, *args)

        self._httpd = ThreadingHTTPServer(self._address, Handler)
        if self._tls_cert:
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(self._tls_cert, self._tls_key)
            self._httpd.socket = ctx.wrap_socket(
                self._httpd.socket, server_side=True)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="volcano-api-gateway")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
