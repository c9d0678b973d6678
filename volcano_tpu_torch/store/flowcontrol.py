"""Watch fan-out flow control — bounded per-watcher delivery over ONE
shared journal.

The gateway's `_WatchJournal` (store/gateway.py) is already a shared ring:
every watcher is just a cursor, so the per-event cost of N watchers is
O(events + watchers), never O(events x watchers). What was missing for
10k-watcher fan-out is the POLICY around those cursors — this module adds
it without adding any per-watcher buffering:

- ``compact_events`` — the general event-compactor. The journal's MODIFIED-squash
  coalesces write-side while nothing was served; this operator coalesces
  DELIVERY-side, collapsing a slow watcher's catch-up batch to one
  old->newest transition per key (ADDED+MODIFIED* -> ADDED, MODIFIED* ->
  one MODIFIED, ADDED+...+DELETED -> nothing, MODIFIED+...+DELETED ->
  DELETED). Level-triggered consumers (the informer contract: handlers
  idempotent, keyed by final state) converge identically, for a fraction
  of the decode/dispatch work.
- ``WatchFanout`` — per-watcher accounting (cursor, class, lag) over a
  shared journal, with three flow-control behaviors:
  * shared-batch fast path: watchers at the same cursor receive the SAME
    immutable tuple (the journal's slice cache) and the same compacted
    batch (the fanout's compaction cache) — zero per-watcher copies;
  * bounded retention: a live laggard may hold the ring past its soft
    ``cap`` (up to ``min(demote_lag, pin_factor*cap)``) to avoid a
    spurious reset, but NEVER further — and a watcher whose lag passes
    ``demote_lag`` is demoted at append time, so a stalled/demoted
    watcher can never pin old entries past the cap (the journal's
    accounting);
  * slow-watcher demotion to snapshot-resync: instead of feeding a deep
    laggard an unbounded catch-up stream, the fanout answers the same
    410-style reset the ring-overflow path uses — the watcher re-lists
    (snapshot resync) and resumes from the head with its resumable
    cursor. The overload ladder (scheduler/degrade.py) can force this
    for every deep laggard (``snapshot_resync_only``) and can force
    aggressive compaction (``watch_coalesce_aggressive``).

Locking: the fanout shares the journal's condition variable (one lock for
ring + cursor map — the append-side retention hook runs under it, and
``threading.Condition`` wraps an RLock, so re-entry from ``poll_for`` into
``journal.poll`` is safe). Nothing under the lock blocks: no socket sends,
no HTTP, no device work (VT008 checks this interprocedurally).

``watch_stats()`` aggregates per-class watcher state and is memoized on
``stats_gen`` — every mutation of the watcher map bumps it, so a stale
stats snapshot is a lint finding (VT007), not a debugging session.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

WATCHER_CLASSES = ("interactive", "batch", "default")


def compact_events(entries) -> Tuple[list, int]:
    """Collapse an event batch to one transition per key.

    Returns (compacted, coalesced) where ``coalesced`` is the number of
    entries the consumer no longer has to decode. Rules, per key run
    (a run never crosses a DELETED boundary — a delete+recreate must stay
    two events, the objects carry different identities):

    - MODIFIED chain          -> one MODIFIED (first old, newest object)
    - ADDED + MODIFIED chain  -> one ADDED carrying the newest object
    - ADDED ... DELETED       -> dropped entirely (the watcher never knew
                                 the key; delivering nothing is exact)
    - MODIFIED ... DELETED    -> the DELETED alone (its ``old`` is the
                                 last pre-delete state)

    Relative order of the surviving entries is preserved; a merged run
    keeps its FIRST entry's position except a trailing DELETED, which
    keeps its own (later) position — final states are unaffected either
    way, and level-triggered consumers converge identically.
    """
    out: list = []
    run: Dict[str, int] = {}  # key -> index in out of the mergeable entry
    coalesced = 0
    for entry in entries:
        key = entry.get("key")
        etype = entry.get("type")
        if key is None:
            out.append(entry)
            continue
        idx = run.get(key)
        if idx is None:
            if etype != "DELETED":
                run[key] = len(out)
            out.append(entry)
            continue
        prev = out[idx]
        ptype = prev["type"]
        if etype == "MODIFIED":
            # keep the run's original "old"; take the newest object
            merged = dict(prev)
            merged["object"] = entry.get("object")
            out[idx] = merged
            coalesced += 1
        elif etype == "DELETED":
            if ptype == "ADDED":
                out[idx] = None  # add+delete annihilate
                coalesced += 2
            else:
                out[idx] = None
                out.append(entry)
                coalesced += 1
            run.pop(key, None)
        else:  # a re-ADDED without an observed DELETED (journal reseed);
            # never merge across it — start a fresh run
            run[key] = len(out)
            out.append(entry)
    if coalesced:
        out = [e for e in out if e is not None]
    return out, coalesced


class WatcherState:
    """Cursor + accounting for one registered watcher — the ENTIRE
    per-watcher memory footprint of the fan-out layer (no queues, no
    copies), which is what keeps 10k watchers O(watchers)."""

    __slots__ = ("id", "cls", "cursor", "demoted", "polls", "delivered",
                 "coalesced", "demotions", "resyncs", "max_lag")

    def __init__(self, watcher_id: str, cls: str, cursor: int):
        self.id = watcher_id
        self.cls = cls if cls in WATCHER_CLASSES else "default"
        self.cursor = int(cursor)
        self.demoted = False
        self.polls = 0
        self.delivered = 0
        self.coalesced = 0
        self.demotions = 0
        self.resyncs = 0
        self.max_lag = 0


class WatchFanout:
    """Flow-controlled fan-out over one `_WatchJournal`."""

    def __init__(self, journal, demote_lag: Optional[int] = None,
                 pin_factor: int = 4, coalesce_min: int = 8,
                 max_watchers: int = 20000, ladder=None):
        self.journal = journal
        self.cap = int(journal.cap)
        self.demote_lag = int(demote_lag) if demote_lag else 2 * self.cap
        self.hard_cap = max(self.cap, int(pin_factor) * self.cap)
        self.coalesce_min = int(coalesce_min)
        self.max_watchers = int(max_watchers)
        self._explicit_ladder = ladder
        # ONE lock for ring + watcher map: the journal's condition (an
        # RLock underneath — poll_for re-enters journal.poll safely)
        self._lock = journal.cond
        self.watchers: Dict[str, WatcherState] = {}
        self.stats_gen = 0  # bumped by every watcher-map mutation
        self.counters: Dict[str, int] = {
            "registered": 0, "demotions": 0, "promotions": 0,
            "delivered": 0, "coalesced": 0, "unregistered_polls": 0,
            "forced_resyncs": 0}
        self.demotions_by_reason: Dict[str, int] = {}
        self._stats_cache: Optional[Dict] = None
        self._stats_cache_gen = -1
        # shared compaction cache: one compaction per distinct catch-up
        # window per journal generation, shared by every watcher at that
        # cursor (the fan-out fast path's second half)
        self._compact_cache: Dict[Tuple[int, int], Tuple[tuple, int]] = {}
        self._compact_gen: Tuple[int, int] = (-1, -1)
        journal.attach_fanout(self)

    # -- ladder hookup (lazy: the store layer must not import the
    # scheduler package at module import time) ----------------------------

    def _ladder(self):
        if self._explicit_ladder is not None:
            return self._explicit_ladder
        from volcano_tpu_torch.scheduler import degrade

        return degrade.default_ladder()

    # -- registration -------------------------------------------------------

    def _register(self, watcher_id: str, cls: str,
                  cursor: int) -> Optional[WatcherState]:
        if len(self.watchers) >= self.max_watchers:
            self.counters["unregistered_polls"] += 1
            return None
        ws = WatcherState(watcher_id, cls, cursor)
        self.watchers[watcher_id] = ws
        self.counters["registered"] += 1
        self.stats_gen += 1
        return ws

    def unregister(self, watcher_id: str) -> None:
        with self._lock:
            self.watchers.pop(watcher_id, None)
            self.stats_gen += 1

    # -- demotion / promotion ----------------------------------------------

    def _demote(self, ws: WatcherState, reason: str) -> None:
        if not ws.demoted:
            ws.demoted = True
            ws.demotions += 1
            self.counters["demotions"] += 1
            self.demotions_by_reason[reason] = \
                self.demotions_by_reason.get(reason, 0) + 1
            self.stats_gen += 1
            try:
                self._ladder().note_watch_demotion()
            except Exception:
                pass  # policy layer absent (bare-store embedders)

    def _promote(self, ws: WatcherState) -> None:
        ws.demoted = False
        ws.resyncs += 1
        self.counters["promotions"] += 1
        self.stats_gen += 1
        try:
            self._ladder().note_watch_promoted()
        except Exception:
            pass

    # -- append-side retention (called by _WatchJournal._append) -----------

    def retain_floor(self, target: int) -> int:
        """The lowest sequence the trim may keep, given live watchers.

        Called under the journal lock when the ring is over its soft cap.
        A LIVE laggard lowers the floor (we retain what it still needs);
        a watcher past ``demote_lag`` is demoted HERE, at append time —
        so a stalled watcher stops pinning the moment it falls too far
        behind, whether or not it ever polls again — and the floor never
        drops below ``end - hard_cap`` regardless."""
        with self._lock:
            end = self.journal.start + len(self.journal.events)
            floor = target
            for wid in sorted(self.watchers):
                ws = self.watchers[wid]
                if ws.demoted:
                    continue
                if end - ws.cursor > self.demote_lag:
                    self._demote(ws, "append_lag")
                    continue
                if ws.cursor < floor:
                    floor = ws.cursor
            return max(floor, end - self.hard_cap)

    # -- the poll path ------------------------------------------------------

    def poll_for(self, watcher_id: str, since: int, timeout: float = 0.0,
                 cls: str = "default"):
        """Flow-controlled twin of ``journal.poll``: same (events, next,
        reset) contract, same resumable-cursor reset semantics, plus
        per-watcher accounting, demotion, and shared compaction. Events
        may be returned as a shared immutable tuple — callers must not
        mutate entries."""
        since = int(since)
        with self._lock:
            journal = self.journal
            ws = self.watchers.get(watcher_id)
            if ws is None:
                ws = self._register(watcher_id, cls, since)
            end = journal.start + len(journal.events)
            lag = max(end - since, 0)
            ladder = None
            try:
                ladder = self._ladder()
            except Exception:
                pass
            if ws is not None:
                ws.polls += 1
                if lag > ws.max_lag:
                    ws.max_lag = lag
            if ladder is not None and lag:
                ladder.note_watch_lag(lag, self.demote_lag)
            resync_only = False
            if ladder is not None and lag > max(self.cap // 2, 1):
                # consult only for deep laggards: allow() doubles as the
                # breaker's half-open probe, so healthy traffic must not
                # burn probe slots
                resync_only = ladder.watch_resync_only()
            if since >= journal.start and lag > 0 \
                    and (lag > self.demote_lag or resync_only):
                # evict the laggard with a resumable cursor instead of
                # streaming an unbounded catch-up: force the 410-style
                # reset (freezing squash eligibility exactly as the
                # overflow reset does) and let the client re-list
                nxt = journal.force_reset()
                if ws is not None:
                    self._demote(ws, "resync_only" if resync_only
                                 else "poll_lag")
                    ws.cursor = nxt
                self.counters["forced_resyncs"] += 1
                return [], nxt, True
            events, nxt, reset = journal.poll(since, timeout)
            if reset:
                if ws is not None:
                    self._demote(ws, "overflow")
                    ws.cursor = nxt
                return events, nxt, True
            if ws is not None and ws.demoted:
                # the watcher completed its resync round-trip (re-list +
                # poll from the head): live again, retained again
                self._promote(ws)
            coalesced = 0
            aggressive = (ladder.watch_coalesce_aggressive()
                          if ladder is not None else False)
            threshold = 2 if aggressive else max(self.coalesce_min, 2)
            if len(events) >= threshold:
                events, coalesced = self._compact_shared(
                    since, nxt, events)
            if ws is not None:
                ws.cursor = nxt
                if events or coalesced:
                    ws.delivered += len(events)
                    ws.coalesced += coalesced
                    self.counters["delivered"] += len(events)
                    self.counters["coalesced"] += coalesced
                    self.stats_gen += 1
            self._observe(ws, cls, lag, coalesced)
            return events, nxt, False

    def _compact_shared(self, since: int, end: int, events):
        gen = (self.journal.start, end)
        if gen != self._compact_gen:
            self._compact_cache.clear()
            self._compact_gen = gen
        cached = self._compact_cache.get((since, end))
        if cached is None:
            compacted, n = compact_events(events)
            cached = (tuple(compacted), n)
            self._compact_cache[(since, end)] = cached
        return cached

    def _observe(self, ws, cls: str, lag: int, coalesced: int) -> None:
        """Metrics writes — observability only, never policy."""
        try:
            from volcano_tpu_torch.scheduler import metrics

            metrics.set_watch_queue_depth(ws.cls if ws is not None
                                          else cls, lag)
            if coalesced:
                metrics.register_watch_coalesced(coalesced)
        except Exception:
            pass

    # -- stats --------------------------------------------------------------

    def watch_stats(self) -> Dict:
        """Per-class watcher aggregates + journal occupancy, memoized on
        ``stats_gen`` (every watcher-map mutation bumps it — VT007 checks
        the contract, so this snapshot can never silently go stale)."""
        with self._lock:
            if self._stats_cache is not None \
                    and self._stats_cache_gen == self.stats_gen:
                return self._stats_cache
            journal = self.journal
            end = journal.start + len(journal.events)
            classes: Dict[str, Dict] = {}
            for wid in sorted(self.watchers):
                ws = self.watchers[wid]
                c = classes.setdefault(ws.cls, {
                    "watchers": 0, "demoted": 0, "lag_max": 0,
                    "delivered": 0, "coalesced": 0, "demotions": 0,
                    "resyncs": 0})
                c["watchers"] += 1
                c["demoted"] += 1 if ws.demoted else 0
                c["lag_max"] = max(c["lag_max"],
                                   max(end - ws.cursor, 0))
                c["delivered"] += ws.delivered
                c["coalesced"] += ws.coalesced
                c["demotions"] += ws.demotions
                c["resyncs"] += ws.resyncs
            out = {
                "classes": classes,
                "counters": dict(self.counters),
                "demotions_by_reason": dict(sorted(
                    self.demotions_by_reason.items())),
                "demote_lag": self.demote_lag,
                "journal": journal.stats(),
            }
            self._stats_cache = out
            self._stats_cache_gen = self.stats_gen
            return out
