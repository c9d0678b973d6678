"""vcctl queue commands: create/get/list (volcano pkg/cli/queue/)."""

from __future__ import annotations

import io
from typing import Optional

from volcano_tpu_torch.api import objects
from volcano_tpu_torch.store.store import Store

COLUMNS = ("Name", "Weight", "State", "Inqueue", "Pending", "Running", "Unknown")


def create_queue(store: Store, name: str, weight: int = 1,
                 capability: Optional[dict] = None) -> objects.Queue:
    q = objects.Queue(
        metadata=objects.ObjectMeta(name=name),
        spec=objects.QueueSpec(weight=weight, capability=capability),
    )
    return store.create(q)


def _row(q: objects.Queue) -> list:
    return [q.metadata.name, q.spec.weight, q.status.state, q.status.inqueue,
            q.status.pending, q.status.running, q.status.unknown]


def get_queue(store: Store, name: str) -> str:
    q = store.get("Queue", "", name)
    out = io.StringIO()
    out.write("".join(f"{h:<10}" for h in COLUMNS).rstrip() + "\n")
    out.write("".join(f"{str(v):<10}" for v in _row(q)).rstrip() + "\n")
    return out.getvalue()


def list_queues(store: Store) -> str:
    out = io.StringIO()
    out.write("".join(f"{h:<10}" for h in COLUMNS).rstrip() + "\n")
    for q in sorted(store.list("Queue"), key=lambda q: q.metadata.name):
        out.write("".join(f"{str(v):<10}" for v in _row(q)).rstrip() + "\n")
    return out.getvalue()
