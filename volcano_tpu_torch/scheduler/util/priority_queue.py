"""Heap-based priority queue over an arbitrary less-fn
(volcano pkg/scheduler/util/priority_queue.go)."""

from __future__ import annotations

import heapq
import itertools
from typing import Callable, Optional


class _Item:
    __slots__ = ("value", "less_fn", "seq")

    def __init__(self, value, less_fn, seq):
        self.value = value
        self.less_fn = less_fn
        self.seq = seq

    def __lt__(self, other: "_Item") -> bool:
        if self.less_fn is None:
            return self.seq < other.seq
        if self.less_fn(self.value, other.value):
            return True
        if self.less_fn(other.value, self.value):
            return False
        return self.seq < other.seq  # stable among equals


class _CmpItem:
    """Heap item over a 3-way comparator: one dispatch per comparison
    instead of the boolean protocol's two (the equality probe) — the
    job/queue order chains cost microseconds per call, and heap pops at
    preempt scale pay ~log(n) comparisons each."""

    __slots__ = ("value", "cmp_fn", "seq")

    def __init__(self, value, cmp_fn, seq):
        self.value = value
        self.cmp_fn = cmp_fn
        self.seq = seq

    def __lt__(self, other: "_CmpItem") -> bool:
        j = self.cmp_fn(self.value, other.value)
        if j != 0:
            return j < 0
        return self.seq < other.seq  # stable among equals


class PriorityQueue:
    """Pop returns the item for which less_fn says it orders before all
    others ("highest priority first" by convention of the less fns).
    ``cmp_fn`` (3-way, -1/0/1) is the cheaper protocol when the caller
    has one — identical ordering to the equivalent less_fn."""

    def __init__(self, less_fn: Optional[Callable] = None,
                 cmp_fn: Optional[Callable] = None):
        self._heap: list = []
        self._less_fn = less_fn
        self._cmp_fn = cmp_fn
        self._seq = itertools.count()

    def push(self, value) -> None:
        if self._cmp_fn is not None:
            heapq.heappush(
                self._heap, _CmpItem(value, self._cmp_fn, next(self._seq)))
        else:
            heapq.heappush(
                self._heap, _Item(value, self._less_fn, next(self._seq)))

    def pop(self):
        if not self._heap:
            return None
        return heapq.heappop(self._heap).value

    def empty(self) -> bool:
        return not self._heap

    def __len__(self) -> int:
        return len(self._heap)


def make_task_queue(ssn, items, reverse: bool = False):
    """Build-then-drain task queue ordered by the session's task order:
    a SortedTaskQueue when the session exposes an equivalent sort key
    (Session.stock_task_order_key), else a comparator PriorityQueue.
    ``reverse`` inverts the order (the preempt victim cut)."""
    key = ssn.stock_task_order_key()
    if key is not None:
        return SortedTaskQueue(items, key, reverse=reverse)
    if reverse:
        q = PriorityQueue(lambda l, r: not ssn.task_order_fn(l, r))
    else:
        q = PriorityQueue(ssn.task_order_fn)
    for item in items:
        q.push(item)
    return q


class SortedTaskQueue:
    """PriorityQueue-compatible pop/empty over a batch of items sorted ONCE
    by a key function (no comparator dispatch per pair). Valid only for the
    build-then-drain pattern — push after the first pop is a bug, and the
    caller must have verified the key matches the session's comparator
    (Session.stock_task_order_key)."""

    __slots__ = ("_items", "_pos")

    def __init__(self, items, key, reverse: bool = False):
        self._items = sorted(items, key=key, reverse=reverse)
        self._pos = 0

    def pop(self):
        if self._pos >= len(self._items):
            return None
        v = self._items[self._pos]
        self._pos += 1
        return v

    def empty(self) -> bool:
        return self._pos >= len(self._items)

    def __len__(self) -> int:
        return len(self._items) - self._pos
