"""Job controller: watch streams -> sharded worker queues -> state machine
(volcano pkg/controllers/job/job_controller.go + job_controller_handler.go).

Requests for one job always land on the same worker (hash sharding,
job_controller.go:266-294), preserving per-job ordering. Tests can run
without threads via ``process_all()``; production uses ``run()``.
"""

from __future__ import annotations

import logging
import threading
from collections import deque
from typing import List, Optional

from volcano_tpu_torch.api import objects
from volcano_tpu_torch.api.objects import JobAction, JobEvent
from volcano_tpu_torch.controllers.apis import Request
from volcano_tpu_torch.controllers.cache import JobCache, job_key_by_name
from volcano_tpu_torch.controllers.job import plugins as job_plugins
from volcano_tpu_torch.controllers.job import state as job_state
from volcano_tpu_torch.controllers.job.actions import JobActions
from volcano_tpu_torch.controllers.job.helpers import is_controlled_by
from volcano_tpu_torch.controllers.job.policies import apply_policies
from volcano_tpu_torch.store.store import WatchHandler

logger = logging.getLogger(__name__)

MAX_REQUEUE_NUM = 15  # job_controller.go:59-64 retry budget


class JobController:
    def __init__(self, store, workers: int = 4):
        self.store = store
        self.cache = JobCache()
        self.workers = max(workers, 1)
        self.actions = JobActions(
            store, self.cache, self._plugins_of, self._resync_task)

        self._cond = threading.Condition()
        self._queues: List[deque] = [deque() for _ in range(self.workers)]
        self._command_queue: deque = deque()
        self._err_tasks: deque = deque()
        self._cascades: deque = deque()  # (job, JobInfo|None) to reap
        # failed requests wait here (the rate-limited requeue analog,
        # job_controller.go:59-64): sync mode retries them on the NEXT
        # process_all pass; threaded mode after an exponential backoff
        self._deferred: List = []
        self._inflight = 0
        self._stop = False
        self._threads: List[threading.Thread] = []
        self._plugin_cache = {}

        self._watch_regs = [
            ("Job", WatchHandler(
                added=self._add_job, updated=self._update_job,
                deleted=self._delete_job)),
            ("Pod", WatchHandler(
                added=self._add_pod, updated=self._update_pod,
                deleted=self._delete_pod)),
            ("Command", WatchHandler(added=self._add_command)),
            ("PodGroup", WatchHandler(updated=self._update_pod_group)),
        ]
        for kind, handler in self._watch_regs:
            store.watch(kind, handler)

    def detach(self) -> None:
        """Unregister store watches (sim restart-injection / teardown) so a
        replacement controller can take over the same store."""
        for kind, handler in self._watch_regs:
            self.store.unwatch(kind, handler)
        self._watch_regs = []

    # -- plugins -----------------------------------------------------------

    def _plugins_of(self, job: objects.Job):
        out = []
        for name, args in job.spec.plugins.items():
            key = (name, tuple(args))
            plugin = self._plugin_cache.get(key)
            if plugin is None:
                builder = job_plugins.get_plugin_builder(name)
                if builder is None:
                    logger.error("job plugin %s not found", name)
                    continue
                plugin = self._plugin_cache[key] = builder(self.store, list(args))
            out.append(plugin)
        return out

    # -- queueing ----------------------------------------------------------

    def _queue_for(self, key: str) -> deque:
        return self._queues[hash(key) % self.workers]

    def _enqueue(self, req: Request) -> None:
        key = job_key_by_name(req.namespace, req.job_name)
        with self._cond:
            self._queue_for(key).append(req)
            self._cond.notify_all()

    # -- watch handlers (fast; only mirror + enqueue) ----------------------

    def _add_job(self, job: objects.Job) -> None:
        try:
            self.cache.add(job)
        except ValueError as e:
            logger.error("failed to add job to cache: %s", e)
        self._enqueue(Request(
            namespace=job.metadata.namespace, job_name=job.metadata.name,
            event=JobEvent.OUT_OF_SYNC))

    def _update_job(self, old: objects.Job, new: objects.Job) -> None:
        # only spec changes or phase flips need a resync (handler.go:81-86)
        if (old.spec == new.spec
                and new.status.state.phase == old.status.state.phase):
            try:
                self.cache.update(new)
            except KeyError:
                pass
            return
        try:
            self.cache.update(new)
        except KeyError:
            pass
        self._enqueue(Request(
            namespace=new.metadata.namespace, job_name=new.metadata.name,
            event=JobEvent.OUT_OF_SYNC))

    def _delete_job(self, job: objects.Job) -> None:
        # cascade deletion: the reference relies on Kubernetes
        # OwnerReference garbage collection to reap a deleted Job's pods
        # and PodGroup (job_controller.go:418-448 stamps the owner refs;
        # the kube GC does the reaping). This substrate has no separate
        # GC controller, so the cascade lives here. The handler itself
        # stays within the watch contract (fast; only mirror + enqueue):
        # it snapshots the job's children from the controller cache,
        # drops the cache entry FIRST — so no worker can process a
        # POD_EVICTED request against the dead job and resurrect the
        # children via sync_job — and queues the reap for a worker.
        try:
            job_info = self.cache.get(job_key_by_name(
                job.metadata.namespace, job.metadata.name))
        except KeyError:
            job_info = None
        self.cache.delete(job)
        with self._cond:
            self._cascades.append((job, job_info))
            self._cond.notify_all()

    def _process_cascade(self, item) -> None:
        """Reap a deleted Job's children: pods (from the cache's per-job
        index — no namespace scan), the PodGroup, and plugin-controlled
        resources. Per-child error isolation: one failed delete must not
        abandon the rest (a logged orphan beats a silent cascade stop)."""
        job, job_info = item
        ns, name = job.metadata.namespace, job.metadata.name
        if job_info is not None:
            pod_names = [p.metadata.name
                         for pods in job_info.pods.values()
                         for p in pods.values()]
        else:
            # no cache snapshot (e.g. deletion raced a fresh restart):
            # fall back to the annotated-ownership scan
            pod_names = [p.metadata.name
                         for p in self.store.list("Pod", namespace=ns)
                         if p.metadata.annotations.get(
                             objects.JOB_NAME_KEY) == name]
        for pn in pod_names:
            try:
                self.store.try_delete("Pod", ns, pn)
            except Exception:  # noqa: BLE001
                logger.exception("cascade: failed to delete pod %s/%s",
                                 ns, pn)
        try:
            self.store.try_delete("PodGroup", ns, name)
        except Exception:  # noqa: BLE001
            logger.exception("cascade: failed to delete podgroup %s/%s",
                             ns, name)
        try:
            self.actions.plugin_on_job_delete(job)
        except Exception:  # noqa: BLE001
            logger.exception("cascade: plugin cleanup failed for %s/%s",
                             ns, name)

    def _pod_request(self, pod: objects.Pod) -> Optional[dict]:
        if not is_controlled_by(pod, objects.Job.KIND):
            return None
        job_name = pod.metadata.annotations.get(objects.JOB_NAME_KEY)
        version = pod.metadata.annotations.get(objects.JOB_VERSION_KEY)
        if job_name is None or version is None:
            return None
        return dict(namespace=pod.metadata.namespace, job_name=job_name,
                    job_version=int(version))

    def _add_pod(self, pod: objects.Pod) -> None:
        base = self._pod_request(pod)
        if base is None:
            return
        try:
            self.cache.add_pod(pod)
        except ValueError as e:
            logger.error("failed to add pod to cache: %s", e)
        self._enqueue(Request(event=JobEvent.OUT_OF_SYNC, **base))

    def _update_pod(self, old: objects.Pod, new: objects.Pod) -> None:
        base = self._pod_request(new)
        if base is None:
            return
        try:
            self.cache.update_pod(new)
        except KeyError as e:
            logger.error("failed to update pod in cache: %s", e)

        task_name = new.metadata.annotations.get(objects.TASK_SPEC_KEY, "")
        event = JobEvent.OUT_OF_SYNC
        exit_code = 0
        if (old.status.phase != objects.POD_PHASE_FAILED
                and new.status.phase == objects.POD_PHASE_FAILED):
            event = JobEvent.POD_FAILED
            if new.status.container_statuses:
                exit_code = new.status.container_statuses[0].exit_code
        if (old.status.phase != objects.POD_PHASE_SUCCEEDED
                and new.status.phase == objects.POD_PHASE_SUCCEEDED):
            if self.cache.task_completed(
                job_key_by_name(base["namespace"], base["job_name"]), task_name
            ):
                event = JobEvent.TASK_COMPLETED
        self._enqueue(Request(
            task_name=task_name, event=event, exit_code=exit_code, **base))

    def _delete_pod(self, pod: objects.Pod) -> None:
        base = self._pod_request(pod)
        if base is None:
            return
        self.cache.delete_pod(pod)
        self._enqueue(Request(
            task_name=pod.metadata.annotations.get(objects.TASK_SPEC_KEY, ""),
            event=JobEvent.POD_EVICTED, **base))

    def _add_command(self, cmd: objects.Command) -> None:
        if cmd.target_object is None or cmd.target_object.kind != objects.Job.KIND:
            return
        with self._cond:
            self._command_queue.append(cmd)
            self._cond.notify_all()

    def _update_pod_group(self, old: objects.PodGroup, new: objects.PodGroup) -> None:
        """Propagate PodGroup Unknown (gang broke while running) to the job
        (handler.go:398-430)."""
        if (old.status.phase != new.status.phase
                and new.status.phase == objects.PodGroupPhase.UNKNOWN):
            self._enqueue(Request(
                namespace=new.metadata.namespace,
                job_name=new.metadata.name,
                event=JobEvent.JOB_UNKNOWN))

    # -- command processing (exactly-once: delete then execute,
    #    handler.go:365-396) ----------------------------------------------

    def _process_command(self, cmd: objects.Command) -> None:
        if self.store.try_delete(
            "Command", cmd.metadata.namespace, cmd.metadata.name
        ) is None:
            return  # someone else consumed it
        self._enqueue(Request(
            namespace=cmd.metadata.namespace,
            job_name=cmd.target_object.name,
            event=JobEvent.COMMAND_ISSUED,
            action=cmd.action))

    # -- request processing ------------------------------------------------

    def _process_request(self, req: Request) -> None:
        """(job_controller.go:296-357)"""
        key = job_key_by_name(req.namespace, req.job_name)
        try:
            job_info = self.cache.get(key)
        except KeyError:
            logger.debug("job %s not found in cache, ignoring request", key)
            return
        action = apply_policies(job_info.job, req)
        st = job_state.new_state(
            job_info, self.actions.sync_job, self.actions.kill_job)
        try:
            st.execute(action)
        except Exception as e:
            requeues = getattr(req, "_requeues", 0)
            if requeues < MAX_REQUEUE_NUM:
                req._requeues = requeues + 1
                logger.warning("failed to handle %r (attempt %d): %s",
                               req, requeues + 1, e)
                import time as _time

                backoff = min(0.05 * (2 ** requeues), 5.0)
                with self._cond:
                    self._deferred.append((_time.monotonic() + backoff, req))
                    self._cond.notify_all()
            else:
                logger.exception("dropping request after %d attempts: %r",
                                 MAX_REQUEUE_NUM, req)
                self.store.record_event(
                    job_info.job, "Warning", "FailedRequest",
                    f"dropping {req} after {MAX_REQUEUE_NUM} attempts: {e}")

    def _resync_task(self, pod: objects.Pod) -> None:
        """(job_controller_resync.go:40-89): re-fetch and re-kill if alive."""
        with self._cond:
            self._err_tasks.append(pod)
            self._cond.notify_all()

    def _process_resync(self, pod: objects.Pod) -> None:
        live = self.store.try_get("Pod", pod.metadata.namespace, pod.metadata.name)
        if live is None:
            return
        self.store.try_delete("Pod", pod.metadata.namespace, pod.metadata.name)

    # -- execution ---------------------------------------------------------

    def _flush_deferred(self, ignore_backoff: bool) -> None:
        import time as _time

        now = _time.monotonic()
        with self._cond:
            still_waiting = []
            for fire_at, req in self._deferred:
                if ignore_backoff or fire_at <= now:
                    self._queue_for(
                        job_key_by_name(req.namespace, req.job_name)
                    ).append(req)
                else:
                    still_waiting.append((fire_at, req))
            self._deferred = still_waiting

    def process_all(self, max_iterations: int = 10000) -> int:
        """Drain every queue synchronously (deterministic test mode).
        Deferred (failed) requests from previous passes are retried once per
        pass; ones deferred DURING this pass wait for the next.
        Returns the number of requests processed."""
        self._flush_deferred(ignore_backoff=True)
        processed = 0
        for _ in range(max_iterations):
            item = None
            kind = None
            with self._cond:
                if self._cascades:
                    item, kind = self._cascades.popleft(), "cascade"
                elif self._command_queue:
                    item, kind = self._command_queue.popleft(), "command"
                elif self._err_tasks:
                    item, kind = self._err_tasks.popleft(), "resync"
                else:
                    for q in self._queues:
                        if q:
                            item, kind = q.popleft(), "request"
                            break
            if item is None:
                return processed
            processed += 1
            if kind == "cascade":
                self._process_cascade(item)
            elif kind == "command":
                self._process_command(item)
            elif kind == "resync":
                self._process_resync(item)
            else:
                self._process_request(item)
        raise RuntimeError("process_all did not converge")

    def run(self) -> None:
        """Start worker threads (one per shard + one command/resync drain)."""
        self._stop = False
        for i in range(self.workers):
            t = threading.Thread(target=self._worker, args=(i,), daemon=True)
            t.start()
            self._threads.append(t)
        t = threading.Thread(target=self._aux_worker, daemon=True)
        t.start()
        self._threads.append(t)

    def stop(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []

    def _worker(self, index: int) -> None:
        q = self._queues[index]
        while True:
            with self._cond:
                while not q and not self._stop:
                    self._cond.wait(0.2)
                if self._stop:
                    return
                req = q.popleft()
                self._inflight += 1
            try:
                self._process_request(req)
            finally:
                with self._cond:
                    self._inflight -= 1
                    self._cond.notify_all()

    def _aux_worker(self) -> None:
        while True:
            item = None
            kind = None
            self._flush_deferred(ignore_backoff=False)
            with self._cond:
                while not self._command_queue and not self._err_tasks \
                        and not self._cascades and not self._stop:
                    self._cond.wait(0.2)
                    break  # periodically re-check deferred backoffs
                if self._stop:
                    return
                if not self._command_queue and not self._err_tasks \
                        and not self._cascades:
                    continue
                if self._cascades:
                    item, kind = self._cascades.popleft(), "cascade"
                elif self._command_queue:
                    item, kind = self._command_queue.popleft(), "command"
                else:
                    item, kind = self._err_tasks.popleft(), "resync"
                self._inflight += 1
            try:
                if kind == "cascade":
                    self._process_cascade(item)
                elif kind == "command":
                    self._process_command(item)
                else:
                    self._process_resync(item)
            finally:
                with self._cond:
                    self._inflight -= 1
                    self._cond.notify_all()

    def drain(self, timeout: float = 10.0) -> bool:
        """Wait until all queues are empty and nothing is in flight."""
        def idle():
            return (not any(self._queues) and not self._command_queue
                    and not self._err_tasks and not self._deferred
                    and not self._cascades and self._inflight == 0)

        with self._cond:
            return self._cond.wait_for(idle, timeout)
