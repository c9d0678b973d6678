"""Queue controller: aggregate PodGroup phases per queue into QueueStatus
(volcano pkg/controllers/queue/queue_controller.go:38-291)."""

from __future__ import annotations

import copy
import logging
import threading
from collections import deque
from typing import Dict, Set

from volcano_tpu_torch.api import objects
from volcano_tpu_torch.store.store import NotFoundError, WatchHandler

logger = logging.getLogger(__name__)


class QueueController:
    def __init__(self, store):
        self.store = store
        self._lock = threading.RLock()
        # queue name -> set of podgroup keys (the reverse index,
        # queue_controller.go:38-48)
        self._pod_groups: Dict[str, Set[str]] = {}
        self._queue: deque = deque()
        self._watch_regs = [
            ("Queue", WatchHandler(added=self._add_queue,
                                   deleted=self._delete_queue)),
            ("PodGroup", WatchHandler(
                added=self._add_pg, updated=self._update_pg,
                deleted=self._delete_pg)),
        ]
        for kind, handler in self._watch_regs:
            store.watch(kind, handler)

    def detach(self) -> None:
        """Unregister store watches (sim restart-injection / teardown)."""
        for kind, handler in self._watch_regs:
            self.store.unwatch(kind, handler)
        self._watch_regs = []

    # -- handlers ----------------------------------------------------------

    def _add_queue(self, queue: objects.Queue) -> None:
        self._queue.append(queue.metadata.name)

    def _delete_queue(self, queue: objects.Queue) -> None:
        with self._lock:
            self._pod_groups.pop(queue.metadata.name, None)

    def _pg_key(self, pg: objects.PodGroup) -> str:
        return f"{pg.metadata.namespace}/{pg.metadata.name}"

    def _add_pg(self, pg: objects.PodGroup) -> None:
        with self._lock:
            self._pod_groups.setdefault(pg.spec.queue, set()).add(self._pg_key(pg))
        self._queue.append(pg.spec.queue)

    def _update_pg(self, old: objects.PodGroup, new: objects.PodGroup) -> None:
        self._add_pg(new)

    def _delete_pg(self, pg: objects.PodGroup) -> None:
        with self._lock:
            groups = self._pod_groups.get(pg.spec.queue)
            if groups is not None:
                groups.discard(self._pg_key(pg))
        self._queue.append(pg.spec.queue)

    # -- sync --------------------------------------------------------------

    def process_all(self) -> int:
        n = 0
        seen = set()
        while self._queue:
            name = self._queue.popleft()
            if name in seen:
                continue
            seen.add(name)
            self.sync_queue(name)
            n += 1
        return n

    def sync_queue(self, name: str) -> None:
        """(queue_controller.go:158-213)"""
        queue = self.store.try_get("Queue", "", name)
        if queue is None:
            return
        with self._lock:
            # sorted: the reverse index is a set; status counts are order-
            # free but the store reads below must replay identically on
            # every replica
            keys = sorted(self._pod_groups.get(name, ()))

        status = objects.QueueStatus(state=queue.status.state)
        for key in keys:
            namespace, pg_name = key.split("/", 1)
            pg = self.store.try_get("PodGroup", namespace, pg_name)
            if pg is None:
                continue
            phase = pg.status.phase
            if phase == objects.PodGroupPhase.PENDING:
                status.pending += 1
            elif phase == objects.PodGroupPhase.RUNNING:
                status.running += 1
            elif phase == objects.PodGroupPhase.INQUEUE:
                status.inqueue += 1
            else:
                status.unknown += 1

        if status == queue.status:
            return
        updated = copy.deepcopy(queue)
        updated.status = status
        try:
            self.store.update_status(updated)
        except NotFoundError:  # pragma: no cover
            pass
