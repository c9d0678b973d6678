"""Active/standby failover: warm standby follow + fenced takeover.

The elector (scheduler/leaderelection.py) decides WHO leads; this module
makes losing and gaining leadership SAFE and FAST:

- **fenced takeover** — on every acquisition the new epoch
  (elector.epoch(), the lease record's transition count + 1) is stamped
  onto the scheduler cache's effector write-path BEFORE the session loop
  starts, and the store (store/store.py) rejects any write still carrying
  an older epoch. A deposed leader mid-fused-chain or mid-express-commit
  therefore aborts through the ordinary effector-failure machinery
  (statement rewind, resync, express token drain) instead of
  double-binding — Omega-style optimistic concurrency stays safe across
  leader transitions;

- **warm standby** — while NOT leading, the scheduler's cache keeps
  following the watch stream (it mirrors synchronously by construction)
  and a follow loop keeps the expensive session-open state warm: the
  SnapshotKeeper's incremental snapshot, the long-lived node axis, and —
  because snapshots feed the same encoder buffers — the identity-token
  caches the warm path relies on. Takeover then opens its first session
  incrementally (zero wholesale snapshot rebuilds) and, in-process or
  with pre-warmed kernels, with zero recompiles. The express lane stays
  PARKED while standby (tokens and queue survive for the first led
  session to reconcile/drain).

The JAX package's simulator drives the same promote sequence
deterministically (volcano_tpu/sim/harness.py HA mode, not ported yet)
and audits the takeover bound + fencing balance continuously
(sim/auditor.py ha_fencing / ha_takeover rules).

Port of volcano_tpu/scheduler/ha.py. On the card "zero recompiles" means
no kernel build and no CUDA graph capture: a bucket's graph is cached
process-wide (ops/rounds_graph.py), so an in-process standby replays the
graph its peer captured. One trim: the ``except Exception`` around
arming the snapshot pair for a pipelined scheduler (a "jax-free host"
guard); the port's pipeline module imports on every host.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

from volcano_tpu_torch.scheduler.leaderelection import LeaderElector, ResourceLock

logger = logging.getLogger(__name__)


class WarmStandby:
    """Keeps a non-leading scheduler session-ready.

    ``follow_once()`` builds (and discards) a snapshot: the keeper
    re-clones only what moved since the last follow, the node axis is
    patched row-wise, and deletion churn is absorbed continuously — so
    the first POST-takeover session pays an incremental open, not the
    wholesale rebuild a cold cache would. ``start()`` runs it on a
    daemon thread between ``resume()``/``pause()`` (paused while this
    instance leads — live sessions snapshot for themselves)."""

    def __init__(self, cache, follow_period: float = 1.0):
        self.cache = cache
        self.follow_period = float(follow_period)
        self.stats: Dict[str, int] = {"follows": 0, "errors": 0}
        self._stop = threading.Event()
        self._following = threading.Event()
        self._following.set()
        self._thread: Optional[threading.Thread] = None

    def follow_once(self) -> None:
        self.cache.snapshot()
        self.stats["follows"] += 1

    def start(self) -> "WarmStandby":
        self.cache.run()
        self.cache.wait_for_cache_sync()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="ha-warm-standby")
        self._thread.start()
        return self

    def pause(self) -> None:
        """Leading now: sessions keep the keeper warm themselves."""
        self._following.clear()

    def resume(self) -> None:
        self._following.set()

    def stop(self) -> None:
        self._stop.set()
        self._following.set()  # release a paused waiter
        if self._thread is not None:
            self._thread.join(timeout=self.follow_period + 1.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._following.wait()
            if self._stop.is_set():
                return
            try:
                self.follow_once()
            except Exception:
                # a follow failure costs warmth, never correctness — the
                # next follow (or the takeover session) rebuilds honestly
                self.stats["errors"] += 1
                logger.exception("warm-standby follow failed")
            self._stop.wait(self.follow_period)


class FailoverScheduler:
    """One HA member: a Scheduler + elector + warm standby, wired so that

    - acquisition stamps the fence epoch, pauses the follow loop, unparks
      the express lane, and starts the session loop;
    - loss stops the loop (cache stays attached and hot), parks the
      express lane, and resumes following;
    - the deposed term's writes keep their stale stamp (the elector never
      regresses its epoch), so anything still in flight is fenced.

    This is the production-shaped twin of the simulator's deterministic
    promote path; tests drive both against one store."""

    def __init__(self, scheduler, store,
                 lock_namespace: str = "volcano-system",
                 lock_name: str = "vc-scheduler",
                 identity: str = "",
                 lease_duration: float = 15.0,
                 renew_deadline: float = 10.0,
                 retry_period: float = 5.0,
                 follow_period: float = 1.0):
        import os
        import socket

        self.scheduler = scheduler
        self.store = store
        identity = identity or f"{socket.gethostname()}-{os.getpid()}"
        if getattr(scheduler, "_pipeline", False):
            # a standby for a PIPELINED scheduler must keep BOTH halves
            # of the snapshot buffer pair warm: with the pair armed, each
            # follow_once alternates buffers, so the first led cycle (and
            # its first solve-ahead) both open incrementally — enabling
            # the pair only at takeover would pay a wholesale rebuild for
            # the second buffer right inside the takeover bound
            from volcano_tpu_torch.pipeline import pipeline_enabled

            if pipeline_enabled():
                scheduler.cache.enable_pipeline()
        self.standby = WarmStandby(scheduler.cache, follow_period)
        self.elector = LeaderElector(
            ResourceLock(store, lock_namespace, lock_name, identity),
            on_started_leading=self._on_acquired,
            on_stopped_leading=self._on_lost,
            lease_duration=lease_duration,
            renew_deadline=renew_deadline,
            retry_period=retry_period)
        self.transitions: List[Dict[str, float]] = []

    # -- elector callbacks (elector thread) ---------------------------------

    def _on_acquired(self) -> None:
        epoch = self.elector.epoch()
        self.standby.pause()
        self.scheduler.set_fence_epoch(epoch)
        self.scheduler.run()
        self.transitions.append({"epoch": epoch, "at": time.time()})
        logger.info("takeover complete: leading at epoch %d", epoch)

    def _on_lost(self) -> None:
        # cache stays attached + hot (stop_cache=False): this member is
        # the warm standby for the next transition; the stale fence stamp
        # stays on the effectors until the next acquisition replaces it
        self.scheduler.stop(stop_cache=False)
        self.standby.resume()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "FailoverScheduler":
        self.standby.start()
        self.elector.start()
        return self

    def stop(self) -> None:
        self.elector.stop()
        self.standby.stop()

    def is_leader(self) -> bool:
        return self.elector.is_leader()

    def healthy(self) -> bool:
        return self.elector.healthy()
