"""RemoteStore — HTTP client twin of the in-process Store.

Implements the read/write verbs the CLI layers use (create / update /
delete / get / list / events_for) against a store gateway
(store/gateway.py), so ``cli/job.py`` and ``cli/queue.py`` drive a LIVE
cluster process unchanged — the networked counterpart of the reference's
vcctl-to-API-server client (cmd/cli/vcctl.go:34; pkg/cli/job/run.go:55-80).

Also implements ``watch``: a background long-poll thread per watched kind
dispatches the same informer-style WatchHandler callbacks as the
in-process Store.watch, which makes CONTROLLERS network-capable — a
controller process can run outside the cluster process exactly like the
reference's informer clients of the API server
(pkg/scheduler/cache/cache.go:322-425).

Errors map back to the store's exception types (NotFoundError /
ConflictError / AdmissionError), so callers cannot tell the difference.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, List, Optional

from volcano_tpu_torch.api import codec
from volcano_tpu_torch.store.store import (
    CLUSTER_SCOPED, AdmissionError, ConflictError, FencedError,
    NotFoundError, OverloadedError, WatchHandler)

logger = logging.getLogger(__name__)

CLUSTER_SCOPED_PLACEHOLDER = "-"


class RemoteStoreError(RuntimeError):
    pass


class RemoteEvent:
    """Duck-typed event entry (store.RecordedEvent contract subset)."""

    __slots__ = ("event_type", "reason", "message")

    def __init__(self, event_type: str, reason: str, message: str):
        self.event_type = event_type
        self.reason = reason
        self.message = message


class RemoteStore:
    def __init__(self, server: str, timeout: float = 10.0,
                 token: Optional[str] = None,
                 tls_verify: bool = True,
                 overload_retries: int = 2):
        if "://" not in server:
            server = "http://" + server
        self.base = server.rstrip("/")
        self.timeout = timeout
        self.token = token
        self._ssl_ctx = None
        if not tls_verify:
            import ssl

            # self-signed test deployments: the operator opts out of
            # verification explicitly (mirrors kubeconfig insecure-skip)
            self._ssl_ctx = ssl.create_default_context()
            self._ssl_ctx.check_hostname = False
            self._ssl_ctx.verify_mode = ssl.CERT_NONE
        self._watch_stop = threading.Event()
        self._watch_threads: List[threading.Thread] = []
        # watch-path retry diagnostics (snap_keeper_stats-style): polls /
        # resets / retry counts and the total seconds spent backing off,
        # shared across the per-kind poll threads under _watch_stats_lock
        self._watch_stats_lock = threading.Lock()
        self._watch_stats: Dict[str, float] = {
            "polls": 0, "poll_errors": 0, "resets": 0,
            "relist_retries": 0, "backoff_s": 0.0, "max_backoff_s": 0.0}
        # 429 handling: how many times create() re-tries a shed
        # submission before surfacing the typed OverloadedError; each
        # pause honors max(server retry_after, jittered Backoff delay)
        self.overload_retries = int(overload_retries)
        self._overload_backoff = None  # lazy (degrade import)
        self._overload_lock = threading.Lock()
        self._overload_stats: Dict[str, float] = {
            "overloaded": 0, "retries": 0, "backoff_s": 0.0}
        self._event_buf: List[dict] = []
        self._event_lock = threading.Lock()
        self._event_wake = threading.Event()
        self._event_thread: Optional[threading.Thread] = None
        self._event_stop = False
        self._event_inflight = False

    # -- transport ---------------------------------------------------------

    def _request(self, method: str, path: str, payload: Optional[dict] = None,
                 query: Optional[Dict[str, str]] = None,
                 timeout: Optional[float] = None) -> dict:
        url = self.base + path
        if query:
            url += "?" + urllib.parse.urlencode(query)
        data = json.dumps(payload).encode() if payload is not None else None
        headers = {"Content-Type": "application/json"}
        if self.token is not None:
            headers["Authorization"] = f"Bearer {self.token}"
        req = urllib.request.Request(
            url, data=data, method=method, headers=headers)
        try:
            with urllib.request.urlopen(
                    req, timeout=timeout if timeout is not None
                    else self.timeout,
                    context=self._ssl_ctx) as resp:
                return json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            try:
                detail = json.loads(e.read() or b"{}")
            except Exception:
                detail = {}
            msg = detail.get("error", str(e))
            if e.code == 400:
                raise ValueError(msg) from None
            if e.code == 404:
                raise NotFoundError(msg) from None
            if e.code == 409:
                # the fenced-write subtype survives the HTTP hop: a remote
                # deposed leader must see the same exception the in-process
                # effectors do, or its rewind paths would misclassify
                if detail.get("type") == "FencedError":
                    raise FencedError(msg) from None
                raise ConflictError(msg) from None
            if e.code == 422:
                raise AdmissionError(msg) from None
            if e.code == 429:
                # the intake gate's backpressure survives the HTTP hop
                # typed: the caller sees the same rejected-with-retry
                # contract as an in-process submitter
                raise OverloadedError(
                    msg,
                    retry_after=float(detail.get("retry_after", 1.0)),
                    reason=str(detail.get("reason", "overloaded"))) \
                    from None
            raise RemoteStoreError(f"{method} {url}: {e.code} {msg}") from None
        except urllib.error.URLError as e:
            raise RemoteStoreError(f"{method} {url}: {e.reason}") from None
        except OSError as e:
            # transport-level failures below urllib's mapping (e.g. a
            # plaintext client hitting a TLS port gets a raw reset)
            raise RemoteStoreError(f"{method} {url}: {e}") from None

    @staticmethod
    def _ns_seg(namespace: str) -> str:
        return namespace or CLUSTER_SCOPED_PLACEHOLDER

    # -- verbs (Store surface subset) ---------------------------------------

    def _overload_pause(self, exc: OverloadedError) -> None:
        """Honor a 429's retry-after hint through the standing jittered
        Backoff (scheduler/degrade.py) — a storm of shed clients must
        retry de-correlated AND no earlier than the server asked."""
        with self._overload_lock:
            if self._overload_backoff is None:
                from volcano_tpu_torch.scheduler.degrade import Backoff

                self._overload_backoff = Backoff(
                    f"intake-retry:{self.base}", base=0.05, cap=15.0)
            delay = max(exc.retry_after,
                        self._overload_backoff.next_delay())
            self._overload_stats["retries"] += 1
            self._overload_stats["backoff_s"] += delay
        time.sleep(delay)

    def intake_stats(self) -> Dict[str, float]:
        """429/backpressure client-side tallies (watch_stats() twin)."""
        with self._overload_lock:
            out = dict(self._overload_stats)
        out["backoff_s"] = round(out["backoff_s"], 3)
        return out

    def create(self, obj, epoch: Optional[int] = None) -> object:
        kind = type(obj).KIND
        q = {"epoch": str(epoch)} if epoch is not None else None
        attempt = 0
        while True:
            try:
                out = self._request("POST", f"/apis/{kind}",
                                    codec.envelope(obj), q)
                with self._overload_lock:
                    if self._overload_backoff is not None:
                        self._overload_backoff.reset()
                return codec.from_envelope(out)
            except OverloadedError as e:
                with self._overload_lock:
                    self._overload_stats["overloaded"] += 1
                if attempt >= self.overload_retries:
                    raise
                attempt += 1
                self._overload_pause(e)

    def update(self, obj, expect_version: Optional[int] = None,
               epoch: Optional[int] = None) -> object:
        kind = type(obj).KIND
        ns = self._ns_seg(
            "" if kind in CLUSTER_SCOPED else obj.metadata.namespace)
        q: Dict[str, str] = {}
        if expect_version is not None:
            q["expect"] = str(expect_version)
        if epoch is not None:
            q["epoch"] = str(epoch)
        out = self._request(
            "PUT", f"/apis/{kind}/{ns}/{obj.metadata.name}",
            codec.envelope(obj), q or None)
        return codec.from_envelope(out)

    def update_status(self, obj, epoch: Optional[int] = None) -> object:
        return self.update(obj, epoch=epoch)

    def delete(self, kind: str, namespace: str, name: str,
               epoch: Optional[int] = None) -> object:
        q = {"epoch": str(epoch)} if epoch is not None else None
        out = self._request(
            "DELETE", f"/apis/{kind}/{self._ns_seg(namespace)}/{name}",
            query=q)
        return codec.from_envelope(out)

    def try_delete(self, kind: str, namespace: str, name: str):
        try:
            return self.delete(kind, namespace, name)
        except NotFoundError:
            return None

    def get(self, kind: str, namespace: str, name: str) -> object:
        out = self._request(
            "GET", f"/apis/{kind}/{self._ns_seg(namespace)}/{name}")
        return codec.from_envelope(out)

    def try_get(self, kind: str, namespace: str, name: str):
        try:
            return self.get(kind, namespace, name)
        except NotFoundError:
            return None

    def list(self, kind: str, namespace: Optional[str] = None,
             selector: Optional[Dict[str, str]] = None) -> List[object]:
        q: Dict[str, str] = {}
        if namespace is not None:
            q["namespace"] = namespace
        if selector:
            q["selector"] = ",".join(f"{k}={v}" for k, v in selector.items())
        out = self._request("GET", f"/apis/{kind}", query=q or None)
        return [codec.from_envelope(item) for item in out.get("items", [])]

    def events_for(self, obj) -> list:
        kind = type(obj).KIND
        ns = self._ns_seg(
            "" if kind in CLUSTER_SCOPED else obj.metadata.namespace)
        out = self._request(
            "GET", f"/events/{kind}/{ns}/{obj.metadata.name}")
        return [RemoteEvent(i["event_type"], i["reason"], i["message"])
                for i in out.get("items", [])]

    def watch_stats(self) -> Dict[str, float]:
        """Watch-path retry/backoff counters (diagnostics surface)."""
        with self._watch_stats_lock:
            out = dict(self._watch_stats)
        out["backoff_s"] = round(out["backoff_s"], 3)
        out["max_backoff_s"] = round(out["max_backoff_s"], 3)
        return out

    def _bump_watch_stat(self, key: str, value: float = 1) -> None:
        with self._watch_stats_lock:
            self._watch_stats[key] += value
            if key == "backoff_s":
                self._watch_stats["max_backoff_s"] = max(
                    self._watch_stats["max_backoff_s"], value)

    def healthy(self, timeout: Optional[float] = None) -> bool:
        """Gateway liveness. ``timeout`` overrides the store default —
        health probes should fail fast, not inherit a 10s RPC budget."""
        try:
            return bool(self._request("GET", "/healthz",
                                      timeout=timeout).get("ok"))
        except Exception:
            return False

    # -- events (async batched recorder) -------------------------------------

    def _event_flusher(self) -> None:
        while True:
            self._event_wake.wait(0.5)
            self._event_wake.clear()
            with self._event_lock:
                batch, self._event_buf = self._event_buf, []
                stopping = self._event_stop
                # in-flight marker: flush_events must not report drained
                # while this batch is still crossing the wire
                self._event_inflight = bool(batch)
            if batch:
                for i in batch:
                    # deferred Scheduled-message formatting (the lazy-
                    # message twin of the in-process ScheduledEvent):
                    # the scheduler's bulk-apply path queued (key, host)
                    # only, off its critical path
                    host = i.pop("_host", None)
                    if host is not None:
                        i["message"] = (f"Successfully assigned "
                                        f"{i['object_key']} to {host}")
                try:
                    self._request("POST", "/events", {"items": batch})
                except Exception as e:
                    logger.warning("event flush dropped %d items: %s",
                                   len(batch), e)
                finally:
                    with self._event_lock:
                        self._event_inflight = False
            if stopping:
                with self._event_lock:
                    drained = not self._event_buf
                    if drained:
                        # drop the self-reference so a later record_event
                        # can spawn a fresh flusher (is_alive() in
                        # _queue_events is the belt to this suspender)
                        if self._event_thread is threading.current_thread():
                            self._event_thread = None
                        return

    def _queue_events(self, items) -> None:
        with self._event_lock:
            self._event_buf.extend(items)
            t = self._event_thread
            if t is None or not t.is_alive():
                # a dead thread reference (a flusher that exited after a
                # timed-out stop_events) must not block respawning, or
                # every later event would buffer forever
                t = threading.Thread(
                    target=self._event_flusher, daemon=True,
                    name="remote-event-flush")
                self._event_thread = t
                t.start()
            if len(self._event_buf) >= 512:
                self._event_wake.set()

    def record_event(self, obj, event_type: str, reason: str,
                     message: str) -> None:
        """Fire-and-forget event recording, batched onto a background
        flusher — events are observability, and the reference's recorder
        is an async broadcaster the same way; a per-event HTTP round trip
        on the scheduler's critical path would be pathological."""
        from volcano_tpu_torch.store.store import object_key

        self._queue_events([{
            "object_kind": type(obj).KIND, "object_key": object_key(obj),
            "event_type": event_type, "reason": reason, "message": message}])

    def record_scheduled(self, keys, hosts) -> None:
        """Bulk Pod-Scheduled events from pre-derived ns/name keys (the
        bulk-apply writeback's batch seam)."""
        self._queue_events([
            {"object_kind": "Pod", "object_key": key,
             "event_type": "Normal", "reason": "Scheduled", "_host": host}
            for key, host in zip(keys, hosts)])

    def flush_events(self, timeout: float = 5.0) -> None:
        """Block until queued events have been POSTED (tests/shutdown) —
        both the buffer and any in-flight batch must drain."""
        deadline = time.monotonic() + timeout
        self._event_wake.set()
        while time.monotonic() < deadline:
            with self._event_lock:
                if not self._event_buf and not self._event_inflight:
                    return
            self._event_wake.set()
            time.sleep(0.05)

    def stop_events(self, timeout: float = 5.0) -> None:
        """Final-drain and stop the event flusher thread."""
        with self._event_lock:
            t = self._event_thread
            self._event_stop = True
            self._event_thread = None
        if t is not None:
            self._event_wake.set()
            t.join(timeout=timeout)
            if t.is_alive():
                # join timed out (gateway hung mid-POST): leave
                # _event_stop set so the zombie exits as soon as it
                # drains, instead of running concurrently with a future
                # flusher and clobbering the shared in-flight flag; a
                # later record_event still flushes (its fresh thread
                # posts the batch and exits on the drained check)
                logger.warning("event flusher did not stop within %.1fs",
                               timeout)
                return
        with self._event_lock:
            self._event_stop = False

    # -- watch (informer twin) ----------------------------------------------

    def watch(self, kind: str, handler: WatchHandler,
              replay: bool = True, poll_timeout: float = 20.0,
              watcher_id: Optional[str] = None,
              watcher_class: str = "default") -> None:
        """Long-poll the gateway's /watch/{kind} journal on a background
        thread, dispatching the in-process WatchHandler callbacks.

        The journal's initial sync already delivers existing objects as
        ADDED (gateway _WatchJournal seeds on creation), so ``replay``
        is honored by starting from seq 0; ``replay=False`` starts from
        the journal's current head. On a journal reset (client fell
        behind the ring buffer) the poller re-lists the kind, synthesizes
        DELETED for every previously-delivered object missing from the
        re-list (the reflector's DeltaFIFO Replace semantic — without it
        a burst of deletes larger than the journal ring would leave
        phantom objects in a remote cache forever), then re-delivers the
        current objects as ADDED — at-least-once; handlers must be
        idempotent on re-ADDs, which the store-backed caches/controllers
        are. A FAILED re-list retries without advancing the cursor (the
        next poll resets again), so the gap is never silently skipped —
        and both poll and re-list retries run under capped jittered
        exponential backoff (scheduler/degrade.Backoff), never
        fixed-interval hammering: a gateway restarting under thousands of
        watchers must see de-correlated retries, not a synchronized herd.
        Retry/backoff tallies surface through ``watch_stats()``.

        With ``watcher_id`` the poller opts into the gateway's fan-out
        flow control (store/flowcontrol.py): the server tracks this
        watcher's lag per ``watcher_class``, coalesces its catch-up
        batches, and may demote it to snapshot-resync — which arrives
        as the SAME reset this loop already handles, so nothing extra
        is needed client-side.

        Callbacks run on the poll thread — the same "handler runs on a
        foreign thread" contract as the in-process store, whose handlers
        run on the writer's thread."""
        from volcano_tpu_torch.scheduler.degrade import Backoff
        from volcano_tpu_torch.store.store import object_key

        extra_q = {}
        if watcher_id:
            extra_q = {"watcher": str(watcher_id),
                       "class": str(watcher_class)}
        since = 0
        if not replay:
            out = self._request("GET", f"/watch/{kind}",
                                query={"since": "0", "timeout": "0",
                                       **extra_q})
            since = int(out.get("next", 0))

        # capture THIS registration's stop event: stop_watches replaces
        # the attribute, so a still-draining old poller must keep seeing
        # its own (set) event rather than resurrecting on the fresh one
        stop = self._watch_stop
        poll_backoff = Backoff(f"watch-poll:{kind}", base=0.25, cap=15.0)
        relist_backoff = Backoff(f"watch-relist:{kind}", base=0.25, cap=15.0)

        def _pause(backoff: Backoff) -> None:
            delay = backoff.next_delay()
            self._bump_watch_stat("backoff_s", delay)
            stop.wait(delay)

        def _loop(since=since):
            # last-delivered object per key — the reset path's diff base
            known: Dict[str, object] = {}
            while not stop.is_set():
                try:
                    out = self._request(
                        "GET", f"/watch/{kind}",
                        query={"since": str(since),
                               "timeout": str(poll_timeout), **extra_q},
                        timeout=poll_timeout + self.timeout)
                    self._bump_watch_stat("polls")
                    poll_backoff.reset()
                except Exception as e:
                    if stop.is_set():
                        return
                    self._bump_watch_stat("poll_errors")
                    logger.warning("watch %s poll failed (%s); retrying "
                                   "in ~%.2fs", kind, e, poll_backoff.peek())
                    _pause(poll_backoff)
                    continue
                if out.get("reset"):
                    self._bump_watch_stat("resets")
                    try:
                        listed = {object_key(o): o for o in self.list(kind)}
                        relist_backoff.reset()
                    except Exception as e:
                        # do NOT advance `since`: the next poll returns
                        # reset again and the re-list is retried, instead
                        # of permanently skipping the journal gap
                        self._bump_watch_stat("relist_retries")
                        logger.warning(
                            "watch %s re-list failed (%s); retrying "
                            "in ~%.2fs", kind, e, relist_backoff.peek())
                        _pause(relist_backoff)
                        continue
                    since = int(out.get("next", 0))
                    for key in [k for k in known if k not in listed]:
                        old = known.pop(key)
                        try:
                            if handler.deleted is not None:
                                handler.deleted(old)
                        except Exception:
                            logger.exception(
                                "watch %s reset-delete handler failed", kind)
                    for key, obj in listed.items():
                        known[key] = obj
                        try:
                            if handler.added is not None:
                                handler.added(obj)
                        except Exception:
                            logger.exception(
                                "watch %s re-list handler failed", kind)
                    continue
                for entry in out.get("events", []):
                    try:
                        etype = entry.get("type")
                        new = (codec.from_envelope(entry["object"])
                               if "object" in entry else None)
                        old = (codec.from_envelope(entry["old"])
                               if "old" in entry else None)
                        if etype == "ADDED" and new is not None:
                            known[object_key(new)] = new
                        elif etype == "MODIFIED" and new is not None:
                            known[object_key(new)] = new
                        elif etype == "DELETED" and old is not None:
                            known.pop(object_key(old), None)
                        if etype == "ADDED" and handler.added is not None:
                            handler.added(new)
                        elif etype == "MODIFIED" and handler.updated is not None:
                            handler.updated(old, new)
                        elif etype == "DELETED" and handler.deleted is not None:
                            handler.deleted(old)
                    except Exception:
                        logger.exception("watch %s handler failed", kind)
                since = int(out.get("next", since))

        t = threading.Thread(target=_loop, daemon=True,
                             name=f"remote-watch-{kind}")
        t.start()
        self._watch_threads.append(t)

    def stop_watches(self) -> None:
        """Signal and join the watch poll threads (in-flight long-polls
        finish their server-side timeout or error out). A later watch()
        starts fresh — the stop event is replaced, not left set."""
        self._watch_stop.set()
        for t in self._watch_threads:
            t.join(timeout=2)
        self._watch_threads = []
        self._watch_stop = threading.Event()
        # the de-facto shutdown call: drain and stop the event flusher too
        self.stop_events()
