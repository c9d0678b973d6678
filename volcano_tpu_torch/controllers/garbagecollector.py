"""TTL garbage collector: delete finished jobs after
ttl_seconds_after_finished (volcano pkg/controllers/garbagecollector/
garbagecollector.go:168-283)."""

from __future__ import annotations

import heapq
import logging
import time
from typing import List, Optional, Tuple

from volcano_tpu_torch.api import objects
from volcano_tpu_torch.api.objects import JobPhase
from volcano_tpu_torch.store.store import WatchHandler

logger = logging.getLogger(__name__)

FINISHED_PHASES = {JobPhase.COMPLETED, JobPhase.FAILED, JobPhase.TERMINATED}


def needs_cleanup(job: objects.Job) -> bool:
    """TTL set and job finished (garbagecollector.go:241-249)."""
    return (job.spec.ttl_seconds_after_finished is not None
            and job.status.state.phase in FINISHED_PHASES)


class GarbageCollector:
    def __init__(self, store, clock=time.time):
        self.store = store
        self.clock = clock
        # (fire_at, ns/name) min-heap standing in for the delaying queue
        self._heap: List[Tuple[float, str, str]] = []
        self._watch_regs = [("Job", WatchHandler(
            added=self._on_job,
            updated=lambda old, new: self._on_job(new)))]
        for kind, handler in self._watch_regs:
            store.watch(kind, handler)

    def detach(self) -> None:
        """Unregister store watches (sim restart-injection / teardown)."""
        for kind, handler in self._watch_regs:
            self.store.unwatch(kind, handler)
        self._watch_regs = []

    def _on_job(self, job: objects.Job) -> None:
        if not needs_cleanup(job):
            return
        expiry = self._expiry(job)
        if expiry is None:
            return
        heapq.heappush(
            self._heap, (expiry, job.metadata.namespace, job.metadata.name))

    def _expiry(self, job: objects.Job) -> Optional[float]:
        finish_at = job.status.state.last_transition_time
        if not finish_at:
            return None
        return finish_at + float(job.spec.ttl_seconds_after_finished)

    def process_expired(self) -> int:
        """Delete every job whose TTL has passed (processJob/processTTL).
        Re-checks freshness against the store before deleting."""
        n = 0
        now = self.clock()
        while self._heap and self._heap[0][0] <= now:
            _, namespace, name = heapq.heappop(self._heap)
            job = self.store.try_get("Job", namespace, name)
            if job is None or not needs_cleanup(job):
                continue
            expiry = self._expiry(job)
            if expiry is None:
                continue
            if expiry > now:  # status changed since enqueue; requeue
                heapq.heappush(self._heap, (expiry, namespace, name))
                continue
            logger.info("cleaning up job %s/%s (TTL expired)", namespace, name)
            self.store.try_delete("Job", namespace, name)
            n += 1
        return n

    def next_fire_time(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None
