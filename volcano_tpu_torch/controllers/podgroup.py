"""PodGroup controller: auto-create a PodGroup (minMember=1) for *plain*
pods that use the volcano scheduler but carry no group annotation
(volcano pkg/controllers/podgroup/pg_controller.go:41-130).
"""

from __future__ import annotations

import copy
import logging
from collections import deque
from typing import Optional

from volcano_tpu_torch.api import objects
from volcano_tpu_torch.store.store import ConflictError, WatchHandler

logger = logging.getLogger(__name__)


class PodGroupController:
    def __init__(self, store, scheduler_name: str = "volcano"):
        self.store = store
        self.scheduler_name = scheduler_name
        self._queue: deque = deque()
        self._watch_regs = [("Pod", WatchHandler(added=self._add_pod))]
        for kind, handler in self._watch_regs:
            store.watch(kind, handler)

    def detach(self) -> None:
        """Unregister store watches (sim restart-injection / teardown)."""
        for kind, handler in self._watch_regs:
            self.store.unwatch(kind, handler)
        self._watch_regs = []

    def _add_pod(self, pod: objects.Pod) -> None:
        if pod.spec.scheduler_name != self.scheduler_name:
            return
        if pod.metadata.annotations.get(objects.GROUP_NAME_ANNOTATION_KEY):
            return
        self._queue.append((pod.metadata.namespace, pod.metadata.name))

    def process_all(self) -> int:
        n = 0
        while self._queue:
            namespace, name = self._queue.popleft()
            pod = self.store.try_get("Pod", namespace, name)
            if pod is None:
                continue
            self._create_normal_pod_pg_if_not_exist(pod)
            n += 1
        return n

    def _pg_name(self, pod: objects.Pod) -> str:
        return f"podgroup-{pod.metadata.uid}"

    def _create_normal_pod_pg_if_not_exist(self, pod: objects.Pod) -> None:
        """(pg_controller_handler.go:72-130)"""
        pg_name = self._pg_name(pod)
        if self.store.try_get("PodGroup", pod.metadata.namespace, pg_name) is None:
            pg = objects.PodGroup(
                metadata=objects.ObjectMeta(
                    name=pg_name,
                    namespace=pod.metadata.namespace,
                    owner_references=[objects.OwnerReference(
                        kind=objects.Pod.KIND, name=pod.metadata.name,
                        uid=pod.metadata.uid, controller=True)],
                ),
                spec=objects.PodGroupSpec(
                    min_member=1,
                    priority_class_name=pod.spec.priority_class_name,
                ),
            )
            try:
                self.store.create(pg)
            except ConflictError:
                pass
        # annotate the pod with its group
        updated = copy.deepcopy(pod)
        updated.metadata.annotations[objects.GROUP_NAME_ANNOTATION_KEY] = pg_name
        self.store.update(updated)
