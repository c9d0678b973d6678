"""QueueInfo (volcano pkg/scheduler/api/queue_info.go)."""

from __future__ import annotations

from volcano_tpu_torch.api import objects


class QueueInfo:
    __slots__ = ("uid", "name", "weight", "queue")

    def __init__(self, queue: objects.Queue):
        self.uid = queue.metadata.name  # QueueID is the queue name
        self.name = queue.metadata.name
        self.weight = queue.spec.weight
        self.queue = queue

    def clone(self) -> "QueueInfo":
        return QueueInfo(self.queue)

    def reclaimable(self) -> bool:
        return self.queue.spec.reclaimable

    def __repr__(self) -> str:
        return f"Queue ({self.name}): weight {self.weight}"
