"""Leader election over a store resource lock.

The reference runs the scheduler and the controller manager as active/passive
HA pairs coordinated through a ConfigMap resource lock
(volcano cmd/scheduler/app/server.go:131-160,
cmd/controllers/app/server.go:110-140, using client-go leaderelection with
lease 15s / renew 10s / retry 5s, server.go:52-54). This module is the
in-process analog: the lock record lives in a ConfigMap in the store, writes
go through the store's compare-and-swap (`Store.update(expect_version=...)`),
and candidates race exactly as the client-go implementation does — read the
record, and either (a) find it expired and try to take it, or (b) find
themselves the holder and renew. Exactly one candidate holds the lease at any
moment; the holder runs its workload callback, and a holder that fails to
renew inside the renew deadline stops leading so the standby can take over.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from volcano_tpu_torch.api import objects
from volcano_tpu_torch.store.store import ConflictError, Store

logger = logging.getLogger(__name__)

# client-go defaults used by the reference (cmd/scheduler/app/server.go:52-54)
DEFAULT_LEASE_DURATION = 15.0
DEFAULT_RENEW_DEADLINE = 10.0
DEFAULT_RETRY_PERIOD = 5.0

_RECORD_KEY = "control-plane.alpha.volcano/leader"


@dataclass
class LeaderElectionRecord:
    holder_identity: str
    lease_duration: float
    acquire_time: float
    renew_time: float
    leader_transitions: int = 0

    def to_json(self) -> str:
        return json.dumps(self.__dict__)

    @classmethod
    def from_json(cls, text: str) -> "LeaderElectionRecord":
        return cls(**json.loads(text))


class ResourceLock:
    """ConfigMap-annotation resource lock (client-go resourcelock semantics:
    the record is serialized into an annotation; create/update are guarded by
    the store's optimistic concurrency)."""

    def __init__(self, store: Store, namespace: str, name: str, identity: str):
        self.store = store
        self.namespace = namespace
        self.name = name
        self.identity = identity

    def get(self) -> Optional[tuple]:
        """(record_or_None, resource_version) when the lock ConfigMap
        exists — record None means the annotation is missing/unparseable
        and the caller must take the CAS-update path, NOT create (create
        would conflict forever and deadlock the election). Returns None
        only when the ConfigMap itself doesn't exist."""
        cm = self.store.try_get("ConfigMap", self.namespace, self.name)
        if cm is None:
            return None
        raw = (cm.metadata.annotations or {}).get(_RECORD_KEY)
        if not raw:
            return (None, cm.metadata.resource_version)
        try:
            return (LeaderElectionRecord.from_json(raw),
                    cm.metadata.resource_version)
        except (ValueError, TypeError):
            return (None, cm.metadata.resource_version)

    def create(self, record: LeaderElectionRecord) -> bool:
        cm = objects.ConfigMap(
            metadata=objects.ObjectMeta(
                name=self.name, namespace=self.namespace,
                annotations={_RECORD_KEY: record.to_json()}))
        try:
            self.store.create(cm)
            return True
        except ConflictError:
            return False

    def update(self, record: LeaderElectionRecord, expect_version: int) -> bool:
        cm = self.store.try_get("ConfigMap", self.namespace, self.name)
        if cm is None:
            return False
        annotations = dict(cm.metadata.annotations or {})
        annotations[_RECORD_KEY] = record.to_json()
        new = objects.ConfigMap(
            metadata=objects.ObjectMeta(
                name=self.name, namespace=self.namespace,
                annotations=annotations))
        new.metadata.uid = cm.metadata.uid
        new.metadata.creation_timestamp = cm.metadata.creation_timestamp
        try:
            self.store.update(new, expect_version=expect_version)
            return True
        except (ConflictError, KeyError):
            return False


class LeaderElector:
    """Run-loop elector: acquire -> on_started_leading, renew until lost ->
    on_stopped_leading. `run()` blocks until `stop()`; callbacks fire on the
    elector thread. `is_leader()` is safe from any thread."""

    def __init__(
        self,
        lock: ResourceLock,
        on_started_leading: Callable[[], None],
        on_stopped_leading: Callable[[], None],
        on_new_leader: Optional[Callable[[str], None]] = None,
        lease_duration: float = DEFAULT_LEASE_DURATION,
        renew_deadline: float = DEFAULT_RENEW_DEADLINE,
        retry_period: float = DEFAULT_RETRY_PERIOD,
        clock: Callable[[], float] = time.monotonic,
    ):
        if renew_deadline >= lease_duration:
            raise ValueError("renew_deadline must be < lease_duration")
        if retry_period >= renew_deadline:
            raise ValueError("retry_period must be < renew_deadline")
        self.lock = lock
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self.on_new_leader = on_new_leader
        self.lease_duration = lease_duration
        self.renew_deadline = renew_deadline
        self.retry_period = retry_period
        self._clock = clock
        self._stop = threading.Event()
        self._leading = False
        self._observed_holder = ""
        self._observed_record_key = None
        self._observed_time = 0.0
        self._thread: Optional[threading.Thread] = None
        # the lease epoch of the most recent acquisition: the record's
        # leader_transitions + 1, the fencing token every mutating write
        # of this leadership term carries (store/store.py FencedError).
        # DELIBERATELY never reset on lost leadership — a deposed
        # workload's in-flight writes must keep their stale stamp so the
        # store rejects them, rather than fall back to unfenced.
        self._epoch = 0

    # -- public ------------------------------------------------------------

    def is_leader(self) -> bool:
        return self._leading

    def epoch(self) -> int:
        """The fencing epoch of the most recent acquisition (0 = never
        led). Valid for writes only while ``is_leader()``; a deposed term
        keeps its stale epoch by design."""
        return self._epoch

    def start(self) -> None:
        """Run the elector loop on a daemon thread."""
        self._thread = threading.Thread(target=self.run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.renew_deadline + 1.0)

    def run(self) -> None:
        last_renew = self._clock()
        try:
            while not self._stop.is_set():
                try:
                    acquired = self._try_acquire_or_renew()
                except Exception:
                    # store hiccups must not kill the elector thread — a
                    # dead elector is a silently dead leader (healthz keeps
                    # answering while nothing schedules). While leading and
                    # still inside the renew deadline, a transient error is
                    # tolerated exactly like client-go tolerates failed
                    # renews: keep leading, retry next period. Only past
                    # the deadline does it count as a lost lease.
                    logger.exception("leader election cycle failed for %s",
                                     self.lock.identity)
                    if (self._leading
                            and self._clock() - last_renew < self.renew_deadline):
                        self._stop.wait(self.retry_period)
                        continue
                    acquired = False
                if acquired:
                    last_renew = self._clock()
                    if not self._leading:
                        logger.info("%s became leader (epoch %d)",
                                    self.lock.identity, self._epoch)
                        try:
                            from volcano_tpu_torch.scheduler import metrics

                            metrics.register_leader_transition()
                        except Exception:  # pragma: no cover
                            pass
                        # callback BEFORE publishing is_leader(): an observer
                        # that polls is_leader() must find the workload
                        # already started
                        try:
                            self.on_started_leading()
                        except Exception:
                            # workload failed to start: tear down whatever
                            # partially started, release the lease, and step
                            # down explicitly (never a silently dead leader
                            # holding the lock), then retry — the standby or
                            # this candidate re-acquires and restarts the
                            # workload. Teardown/release are themselves
                            # guarded: the elector thread survives store
                            # errors raised while cleaning up.
                            logger.exception(
                                "workload start failed for %s; stepping down",
                                self.lock.identity)
                            try:
                                self.on_stopped_leading()
                            except Exception:
                                logger.exception(
                                    "workload teardown failed for %s",
                                    self.lock.identity)
                            try:
                                self._release()
                            except Exception:
                                logger.exception(
                                    "lease release failed for %s",
                                    self.lock.identity)
                            self._stop.wait(self.retry_period)
                            continue
                        self._leading = True
                    self._stop.wait(self.retry_period)
                else:
                    if self._leading:
                        self._leading = False
                        logger.info("%s lost leadership", self.lock.identity)
                        try:
                            self.on_stopped_leading()
                        except Exception:
                            # teardown raising (e.g. during the same store
                            # outage that cost the lease) must not kill the
                            # elector: this node keeps contending
                            logger.exception(
                                "workload teardown failed for %s",
                                self.lock.identity)
                    self._stop.wait(self.retry_period)
        finally:
            if self._leading:
                self._leading = False
                self._release()
                self.on_stopped_leading()

    def healthy(self) -> bool:
        """Elector liveness for healthz: the loop thread (when started) is
        still running. A crashed elector must flip readiness, not keep
        serving 200 with no scheduler behind it."""
        return self._thread is None or self._thread.is_alive()

    # -- internals ---------------------------------------------------------

    def _observe(self, holder: str) -> None:
        if holder != self._observed_holder:
            self._observed_holder = holder
            if self.on_new_leader is not None:
                self.on_new_leader(holder)

    def _observe_record(self, record) -> None:
        """Track WHEN this elector locally observed the record last change
        (client-go leaderelection.go observedTime): lease expiry is judged
        as 'unchanged for a full lease_duration on MY clock', never by
        comparing the record's timestamps against the local clock — the
        holder's clock (time.monotonic has a per-host epoch) and ours need
        not be related when the lock lives in a remote store."""
        key = (record.holder_identity, record.acquire_time,
               record.renew_time)
        if key != self._observed_record_key:
            self._observed_record_key = key
            self._observed_time = self._clock()
        self._observe(record.holder_identity)

    def _try_acquire_or_renew(self) -> bool:
        now = self._clock()
        identity = self.lock.identity
        got = self.lock.get()

        if got is None:
            record = LeaderElectionRecord(
                holder_identity=identity,
                lease_duration=self.lease_duration,
                acquire_time=now, renew_time=now)
            if self.lock.create(record):
                self._epoch = record.leader_transitions + 1
                self._observe_record(record)
                return True
            return False  # raced; retry next period

        record, version = got
        if record is None:
            # lock object exists but carries no readable record (corrupt or
            # version-skewed annotation): claim it through the CAS update
            new = LeaderElectionRecord(
                holder_identity=identity,
                lease_duration=self.lease_duration,
                acquire_time=now, renew_time=now)
            if self.lock.update(new, version):
                self._epoch = new.leader_transitions + 1
                self._observe_record(new)
                return True
            return False

        self._observe_record(record)
        if record.holder_identity != identity:
            # expiry by LOCAL observation age, not by the record's
            # timestamps: cross-host monotonic clocks share no epoch
            # (client-go leaderelection.go:281-290 does the same). An
            # EMPTY holder is a clean release — no lease to wait out
            if record.holder_identity and \
                    now < self._observed_time + self.lease_duration:
                return False  # current leader still within its lease
            # lease expired: try to take over (CAS rejects racing standbys)
            new = LeaderElectionRecord(
                holder_identity=identity,
                lease_duration=self.lease_duration,
                acquire_time=now, renew_time=now,
                leader_transitions=record.leader_transitions + 1)
            if self.lock.update(new, version):
                self._epoch = new.leader_transitions + 1
                return True
            return False

        # we are the holder: renew
        record.renew_time = now
        record.lease_duration = self.lease_duration
        if self.lock.update(record, version):
            self._epoch = record.leader_transitions + 1
            return True
        # CAS failure while holding means someone stole an expired lease
        return False

    def _release(self) -> None:
        """Drop the lease on clean shutdown so the standby takes over in one
        retry period instead of a full lease duration."""
        got = self.lock.get()
        if got is None:
            return
        record, version = got
        if record is None or record.holder_identity != self.lock.identity:
            return
        # client-go's release: EMPTY the holder (observation-based expiry
        # deliberately ignores timestamps, so a zeroed renew_time alone
        # would read as just another record change and make the standby
        # wait a full lease; an empty holder bypasses the lease wait)
        record.holder_identity = ""
        record.renew_time = 0.0
        self.lock.update(record, version)
