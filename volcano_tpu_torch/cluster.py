"""Single-process cluster: store + admission + controller manager +
scheduler + simulated kubelet.

This is the all-in-one analog of running the reference's three binaries
(vc-scheduler, vc-controllers, vc-admission) against an API server plus
kubelets (SURVEY.md §4 tier 3: "single-host integration driving the full
submit -> enqueue -> allocate -> bind -> status pipeline with a simulated
kubelet"). Deterministic tests drive ``step()``; ``run()`` starts the
threaded periodic loops.
"""

from __future__ import annotations

import copy
import time
from typing import Optional

from volcano_tpu_torch import admission
from volcano_tpu_torch.api import objects
from volcano_tpu_torch.controllers.garbagecollector import GarbageCollector
from volcano_tpu_torch.controllers.job import JobController
from volcano_tpu_torch.controllers.podgroup import PodGroupController
from volcano_tpu_torch.controllers.queue import QueueController
from volcano_tpu_torch.scheduler.cache import SchedulerCache
from volcano_tpu_torch.scheduler.scheduler import Scheduler
from volcano_tpu_torch.store.store import Store
from volcano_tpu_torch.utils import clock


class Kubelet:
    """Minimal node agent: bound pods start Running; deletion timestamps
    complete termination; tests flip pods to Succeeded/Failed themselves."""

    def __init__(self, store: Store):
        self.store = store

    def step(self) -> int:
        changed = 0
        for pod in list(self.store.list("Pod")):
            if pod.metadata.deletion_timestamp is not None:
                self.store.try_delete(
                    "Pod", pod.metadata.namespace, pod.metadata.name)
                changed += 1
                continue
            if pod.spec.node_name and pod.status.phase == objects.POD_PHASE_PENDING:
                updated = copy.deepcopy(pod)
                updated.status.phase = objects.POD_PHASE_RUNNING
                updated.status.start_time = clock.now()
                self.store.update_status(updated)
                changed += 1
        return changed


class Cluster:
    def __init__(
        self,
        scheduler_conf: Optional[str] = None,
        scheduler_name: str = "volcano",
        default_queue: str = "default",
        schedule_period: float = 0.1,
        gate_pods: bool = True,
    ):
        self.store = Store()
        admission.install(self.store, scheduler_name, gate_pods=gate_pods)

        self.job_controller = JobController(self.store)
        self.podgroup_controller = PodGroupController(self.store, scheduler_name)
        self.queue_controller = QueueController(self.store)
        self.gc = GarbageCollector(self.store)
        self.kubelet = Kubelet(self.store)

        self.cache = SchedulerCache(
            store=self.store, scheduler_name=scheduler_name,
            default_queue=default_queue)
        self.scheduler = Scheduler(
            self.cache, scheduler_conf=scheduler_conf or "",
            schedule_period=schedule_period)
        self._cache_running = False
        self._threaded = False

        # default queue exists out of the box (the installer YAML creates it)
        if self.store.try_get("Queue", "", default_queue) is None:
            q = objects.Queue(metadata=objects.ObjectMeta(name=default_queue))
            q.metadata.ensure_identity()
            self.store.create(q)

    # -- deterministic drive ----------------------------------------------

    def _ensure_cache(self) -> None:
        if not self._cache_running:
            self.cache.run()
            self.cache.wait_for_cache_sync()
            self._cache_running = True

    def step(self) -> None:
        """One convergence slice: controllers -> scheduler cycle ->
        controllers -> kubelet -> controllers."""
        self._ensure_cache()
        self.job_controller.process_all()
        self.podgroup_controller.process_all()
        self.scheduler.run_once()
        self.job_controller.process_all()
        self.kubelet.step()
        self.job_controller.process_all()
        self.queue_controller.process_all()
        self.gc.process_expired()

    def settle(self, steps: int = 10) -> None:
        for _ in range(steps):
            self.step()

    # -- threaded drive ----------------------------------------------------

    def run(self, scheduling: bool = True) -> None:
        """Start the threaded loops. With ``scheduling=False`` the process
        runs as an API-server analog — store + admission + controllers +
        kubelet + (externally) the gateway — and an out-of-process
        scheduler consumes it over RemoteStore watches, the reference's
        vc-scheduler-vs-API-server topology."""
        if scheduling:
            self._ensure_cache()
        self._threaded = True
        self._scheduling = scheduling
        self.job_controller.run()
        if scheduling:
            self.scheduler.run()
        import threading

        self._kubelet_stop = threading.Event()

        def kubelet_loop():
            while not self._kubelet_stop.is_set():
                self.kubelet.step()
                self.podgroup_controller.process_all()
                self.queue_controller.process_all()
                self.gc.process_expired()
                self._kubelet_stop.wait(0.05)

        self._kubelet_thread = threading.Thread(target=kubelet_loop, daemon=True)
        self._kubelet_thread.start()

    def stop(self) -> None:
        if self._threaded:
            self._kubelet_stop.set()
            self._kubelet_thread.join(timeout=5.0)
            if getattr(self, "_scheduling", True):
                self.scheduler.stop()
            self.job_controller.stop()
            self._threaded = False
