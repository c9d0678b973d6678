"""The state store: typed buckets + watch streams + admission middleware.

Replaces the reference's distributed state store and message bus (the k8s API
server, SURVEY L0). Volcano coordinates everything through watch/list/update
on CRDs (installer/volcano-development.yaml; pkg/client generated informers);
here the same contract is an in-process store:

- ``create``/``update``/``update_status``/``delete`` mutate canonical objects
  and bump a global resource version;
- ``watch(kind, handler)`` delivers ADDED/MODIFIED/DELETED callbacks
  synchronously under the store lock (informer-style: handlers must be fast
  and must not call back into the store — they mirror state into their own
  caches, exactly like volcano's scheduler cache event handlers);
- admission middleware (mutators, then validators) runs on create, the seam
  where volcano's webhooks sit (pkg/admission);
- an event recorder stands in for k8s Events.

Objects handed out by ``get``/``list`` are the canonical instances — callers
must treat them as read-only and go through ``update`` (shared-informer
convention). The scheduler cache clones what it needs into its snapshot.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field
from itertools import repeat
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from volcano_tpu_torch.api import objects
from volcano_tpu_torch.utils import clock


class NotFoundError(KeyError):
    pass


class ConflictError(RuntimeError):
    pass


class FencedError(ConflictError):
    """A write stamped with a lease epoch older than the store's fence.

    The fencing-token half of leader election (scheduler/leaderelection.py):
    every mutating write a leader performs carries its lease epoch, and the
    store rejects epochs older than the newest lease it has seen — so a
    deposed leader finishing an in-flight fused chain or express commit
    cannot double-bind against the new leader's placements. Subclassing
    ConflictError keeps every existing 409/conflict handler correct."""


class AdmissionError(ValueError):
    """An admission validator rejected the request."""


class OverloadedError(RuntimeError):
    """The front door is shedding load: the request was rejected WITH a
    retry hint, never dropped silently.

    Raised by the intake gate (admission/intake.py) when the token-bucket
    rate or the backlog bound is exhausted; carries ``retry_after``
    (seconds — the earliest retry that can succeed under the current
    refill rate) and ``reason`` ("rate" | "backlog"). The gateway maps it
    to HTTP 429 + Retry-After; RemoteStore re-raises it typed and can
    honor the hint through degrade.Backoff."""

    def __init__(self, message: str, retry_after: float = 1.0,
                 reason: str = "overloaded"):
        super().__init__(message)
        self.retry_after = float(retry_after)
        self.reason = str(reason)


# Kinds without a namespace (keyed by bare name).
CLUSTER_SCOPED = {"Node", "Queue", "PriorityClass", "PersistentVolume"}

# The resource-lock record annotation (scheduler/leaderelection.py). The
# store recognizes lease writes by this key and advances its fence epoch
# from the record's transition count — fencing authority lives SERVER-side,
# so a remote elector CASing the lock through the gateway revokes the old
# leader's write authority in the same atomic step that grants its own.
LEADER_RECORD_ANNOTATION = "control-plane.alpha.volcano/leader"


def object_key(obj) -> str:
    meta = obj.metadata
    if type(obj).KIND in CLUSTER_SCOPED:
        return meta.name
    return f"{meta.namespace}/{meta.name}"


@dataclass
class WatchHandler:
    """Informer-style callbacks. ``updated`` receives (old, new)."""

    added: Optional[Callable] = None
    updated: Optional[Callable] = None
    deleted: Optional[Callable] = None


@dataclass
class RecordedEvent:
    """Analog of a k8s Event object."""

    object_kind: str
    object_key: str
    event_type: str  # Normal | Warning
    reason: str
    message: str
    timestamp: float = field(default_factory=lambda: clock.now())


class ScheduledEvent:
    """A Pod Scheduled event whose message materializes on read.

    The bulk-apply writeback records one event per placement; at 50k
    placements/session, formatting 50k messages eagerly would sit on the
    session's critical path for work nobody may ever read — the reference
    recorder is an async broadcaster with the same effect (the event text
    exists only when an observer consumes it)."""

    __slots__ = ("object_key", "host", "timestamp")
    object_kind = "Pod"
    event_type = "Normal"
    reason = "Scheduled"

    def __init__(self, key: str, host: str, ts: float):
        self.object_key = key
        self.host = host
        self.timestamp = ts

    @property
    def message(self) -> str:
        return f"Successfully assigned {self.object_key} to {self.host}"


class Store:
    """Thread-safe typed object store with watches and admission."""

    def __init__(self):
        self._lock = threading.RLock()
        self._buckets: Dict[str, Dict[str, object]] = {}
        self._watchers: Dict[str, List[WatchHandler]] = {}
        self._mutators: Dict[str, List[Callable]] = {}
        self._validators: Dict[str, List[Callable]] = {}
        self._resource_version = 0
        # lease-epoch fence: the newest leadership epoch this store has
        # seen (0 = no lease ever written — fencing disarmed until a
        # leader exists). Writes stamped with an older epoch are rejected
        # with FencedError and accounted here, per kind and per stale
        # epoch, so the failover auditor can balance every rejection
        # against the component that observed it.
        self._fence_epoch = 0
        self.fence_stats: Dict[str, object] = {
            "epoch": 0, "advances": 0, "rejected": 0,
            "rejected_by_kind": {}, "rejected_by_epoch": {}}
        # RecordedEvent | ScheduledEvent (duck-typed event contract)
        self.events: list = []

    # -- lease-epoch fencing -----------------------------------------------

    @property
    def fence_epoch(self) -> int:
        with self._lock:
            return self._fence_epoch

    def advance_fence(self, epoch: int) -> None:
        """Raise the fence to ``epoch`` (never lowers). Normally implicit —
        lease ConfigMap writes advance it — but exposed for tests and for
        embedders with out-of-band election."""
        with self._lock:
            if epoch > self._fence_epoch:
                self._fence_epoch = int(epoch)
                self.fence_stats["epoch"] = self._fence_epoch
                self.fence_stats["advances"] += 1

    def _check_fence(self, kind: str, key: str,
                     epoch: Optional[int]) -> None:
        """Reject a write whose stamp predates the current fence (caller
        holds the lock). Unstamped writes (epoch None) pass — controllers,
        kubelets, and tests carry their own authority."""
        if epoch is None or epoch >= self._fence_epoch:
            return
        self.fence_stats["rejected"] += 1
        by_kind = self.fence_stats["rejected_by_kind"]
        by_kind[kind] = by_kind.get(kind, 0) + 1
        by_epoch = self.fence_stats["rejected_by_epoch"]
        by_epoch[int(epoch)] = by_epoch.get(int(epoch), 0) + 1
        # observability import stays lazy: the store is the substrate and
        # must not pull the scheduler package in at import time
        from volcano_tpu_torch.scheduler import metrics as _metrics

        _metrics.register_fenced_write()
        raise FencedError(
            f"{kind} {key}: write fenced: lease epoch {epoch} < "
            f"current epoch {self._fence_epoch}")

    def _maybe_advance_fence(self, obj, kind: str) -> None:
        """A lease-record ConfigMap write with a non-empty holder carries
        the new leadership epoch (leader_transitions + 1); advance the
        fence so older-epoch writers are rejected from this instant
        (caller holds the lock — revoke and grant are one atomic step)."""
        if kind != "ConfigMap":
            return
        raw = (obj.metadata.annotations or {}).get(LEADER_RECORD_ANNOTATION)
        if not raw:
            return
        try:
            record = json.loads(raw)
        except (ValueError, TypeError):
            return
        if not record.get("holder_identity"):
            return  # a clean release keeps the current epoch in force
        try:
            epoch = int(record.get("leader_transitions", 0)) + 1
        except (ValueError, TypeError):
            return
        if epoch > self._fence_epoch:
            self._fence_epoch = epoch
            self.fence_stats["epoch"] = epoch
            self.fence_stats["advances"] += 1

    # -- admission ---------------------------------------------------------

    def register_admission(
        self,
        kind: str,
        mutator: Optional[Callable] = None,
        validator: Optional[Callable] = None,
    ) -> None:
        """Install admission middleware for a kind. Mutators run first and
        may modify the object in place; validators raise AdmissionError to
        reject (the webhook seam, pkg/admission/admission_controller.go:40-44)."""
        with self._lock:
            if mutator is not None:
                self._mutators.setdefault(kind, []).append(mutator)
            if validator is not None:
                self._validators.setdefault(kind, []).append(validator)

    # -- writes ------------------------------------------------------------

    def create(self, obj, epoch: Optional[int] = None) -> object:
        kind = type(obj).KIND
        with self._lock:
            for mutate in self._mutators.get(kind, []):
                mutate(obj)
            for validate in self._validators.get(kind, []):
                validate(obj)

            obj.metadata.ensure_identity()
            key = object_key(obj)
            self._check_fence(kind, key, epoch)
            bucket = self._buckets.setdefault(kind, {})
            if key in bucket:
                raise ConflictError(f"{kind} {key} already exists")
            self._resource_version += 1
            obj.metadata.resource_version = self._resource_version
            bucket[key] = obj
            self._maybe_advance_fence(obj, kind)
            self._dispatch(kind, "ADDED", None, obj)
            return obj

    def update(self, obj, expect_version: Optional[int] = None,
               epoch: Optional[int] = None) -> object:
        """Replace an object. With ``expect_version`` the write is a
        compare-and-swap: it fails with ConflictError unless the stored
        object's resource_version still matches — the optimistic-concurrency
        primitive the k8s API server provides and the reference's
        resource-lock leader election depends on. With ``epoch`` the write
        is additionally fenced: a stamp older than the store's current
        lease epoch raises FencedError (split-brain protection for a
        deposed leader's in-flight writes)."""
        kind = type(obj).KIND
        with self._lock:
            key = object_key(obj)
            self._check_fence(kind, key, epoch)
            bucket = self._buckets.setdefault(kind, {})
            old = bucket.get(key)
            if old is None:
                raise NotFoundError(f"{kind} {key} not found")
            if (expect_version is not None
                    and old.metadata.resource_version != expect_version):
                raise ConflictError(
                    f"{kind} {key}: version {old.metadata.resource_version} "
                    f"!= expected {expect_version}")
            self._resource_version += 1
            obj.metadata.resource_version = self._resource_version
            bucket[key] = obj
            self._maybe_advance_fence(obj, kind)
            self._dispatch(kind, "MODIFIED", old, obj)
            return obj

    def update_status(self, obj, epoch: Optional[int] = None) -> object:
        """Alias of update — status subresource writes share the path."""
        return self.update(obj, epoch=epoch)

    def delete(self, kind: str, namespace: str, name: str,
               epoch: Optional[int] = None) -> object:
        with self._lock:
            key = name if kind in CLUSTER_SCOPED else f"{namespace}/{name}"
            self._check_fence(kind, key, epoch)
            bucket = self._buckets.get(kind, {})
            obj = bucket.pop(key, None)
            if obj is None:
                raise NotFoundError(f"{kind} {key} not found")
            self._resource_version += 1
            self._dispatch(kind, "DELETED", obj, None)
            return obj

    def try_delete(self, kind: str, namespace: str, name: str) -> Optional[object]:
        try:
            return self.delete(kind, namespace, name)
        except NotFoundError:
            return None

    # -- reads -------------------------------------------------------------

    def get(self, kind: str, namespace: str, name: str) -> object:
        with self._lock:
            key = name if kind in CLUSTER_SCOPED else f"{namespace}/{name}"
            obj = self._buckets.get(kind, {}).get(key)
            if obj is None:
                raise NotFoundError(f"{kind} {key} not found")
            return obj

    def try_get(self, kind: str, namespace: str, name: str) -> Optional[object]:
        try:
            return self.get(kind, namespace, name)
        except NotFoundError:
            return None

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        selector: Optional[Dict[str, str]] = None,
    ) -> List[object]:
        with self._lock:
            items = list(self._buckets.get(kind, {}).values())
        if namespace is not None and kind not in CLUSTER_SCOPED:
            items = [o for o in items if o.metadata.namespace == namespace]
        if selector:
            items = [
                o
                for o in items
                if all(o.metadata.labels.get(k) == v for k, v in selector.items())
            ]
        return items

    @property
    def resource_version(self) -> int:
        with self._lock:
            return self._resource_version

    # -- watches -----------------------------------------------------------

    def watch(self, kind: str, handler: WatchHandler, replay: bool = True) -> None:
        """Register an informer-style handler. With ``replay``, existing
        objects are delivered as ADDED first (initial list+watch sync)."""
        with self._lock:
            self._watchers.setdefault(kind, []).append(handler)
            if replay and handler.added is not None:
                for obj in self._buckets.get(kind, {}).values():
                    handler.added(obj)

    def unwatch(self, kind: str, handler: WatchHandler) -> None:
        """Remove a registered handler (identity match; unknown handlers
        are a no-op). A component being torn down — a restarted scheduler
        cache or controller — detaches so a replacement can watch the same
        kinds without the zombie's callbacks still firing on every write."""
        with self._lock:
            handlers = self._watchers.get(kind)
            if handlers is not None:
                self._watchers[kind] = [h for h in handlers
                                        if h is not handler]

    def _dispatch(self, kind: str, event_type: str, old, new) -> None:
        for handler in self._watchers.get(kind, []):
            if event_type == "ADDED" and handler.added is not None:
                handler.added(new)
            elif event_type == "MODIFIED" and handler.updated is not None:
                handler.updated(old, new)
            elif event_type == "DELETED" and handler.deleted is not None:
                handler.deleted(old)

    # -- events (k8s Events analog) ---------------------------------------

    def record_event(self, obj, event_type: str, reason: str, message: str) -> None:
        with self._lock:
            self.events.append(
                RecordedEvent(
                    object_kind=type(obj).KIND,
                    object_key=object_key(obj),
                    event_type=event_type,
                    reason=reason,
                    message=message,
                )
            )

    def record_events(self, items) -> None:
        """Bulk event record: one lock acquisition for an iterable of
        (obj, event_type, reason, message) — the bulk-apply path records
        one Scheduled event per placement (cache.go:601-611)."""
        with self._lock:
            self.events.extend(
                RecordedEvent(
                    object_kind=type(obj).KIND,
                    object_key=object_key(obj),
                    event_type=event_type,
                    reason=reason,
                    message=message,
                )
                for obj, event_type, reason, message in items
            )

    def record_events_raw(self, items) -> None:
        """Bulk append of pre-built event records (RecordedEvent /
        ScheduledEvent duck-types) — the gateway's event-ingestion seam."""
        with self._lock:
            self.events.extend(items)

    def record_scheduled(self, keys, hosts) -> None:
        """Bulk Pod-Scheduled events from pre-derived ns/name keys; the
        message is lazy (ScheduledEvent), so the cost per placement is one
        small object, not a string format."""
        ts = clock.now()
        with self._lock:
            self.events.extend(map(ScheduledEvent, keys, hosts, repeat(ts)))

    def events_for(self, obj) -> list:
        """Events recorded against ``obj``. Entries are RecordedEvent or
        ScheduledEvent — both expose object_kind / object_key / event_type /
        reason / message / timestamp (duck-typed event contract)."""
        key = object_key(obj)
        kind = type(obj).KIND
        with self._lock:
            return [e for e in self.events if e.object_kind == kind and e.object_key == key]


class FencedStoreView:
    """A Store (or RemoteStore) facade whose mutating verbs carry a lease
    epoch read at call time.

    Components with many write sites (the controller manager, a kubelet)
    get failover fencing by construction instead of threading ``epoch=``
    through every call: build them over a FencedStoreView whose
    ``epoch_source`` is the elector's current epoch. Reads, watches, and
    event recording pass through unchanged (events are observability, and
    watches carry no authority)."""

    _STAMPED = {"create", "update", "update_status", "delete"}

    def __init__(self, store, epoch_source: Callable[[], Optional[int]]):
        self._store = store
        self._epoch_source = epoch_source

    def __getattr__(self, name):
        return getattr(self._store, name)

    def create(self, obj) -> object:
        return self._store.create(obj, epoch=self._epoch_source())

    def update(self, obj, expect_version: Optional[int] = None) -> object:
        return self._store.update(obj, expect_version=expect_version,
                                  epoch=self._epoch_source())

    def update_status(self, obj) -> object:
        return self._store.update_status(obj, epoch=self._epoch_source())

    def delete(self, kind: str, namespace: str, name: str) -> object:
        return self._store.delete(kind, namespace, name,
                                  epoch=self._epoch_source())

    def try_delete(self, kind: str, namespace: str, name: str):
        try:
            return self.delete(kind, namespace, name)
        except NotFoundError:
            return None
