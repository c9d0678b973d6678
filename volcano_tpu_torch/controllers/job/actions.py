"""Job controller actions: syncJob / killJob / createJob
(volcano pkg/controllers/job/job_controller_actions.go).

All writes go through the store (the API-server analog); the controller's
JobCache is updated by its own watch handlers plus the explicit cache.update
the reference does after UpdateStatus.
"""

from __future__ import annotations

import copy
import logging
from typing import Dict, Optional, Set

from volcano_tpu_torch.api import objects
from volcano_tpu_torch.api.objects import JobPhase
from volcano_tpu_torch.controllers.apis import JobInfo
from volcano_tpu_torch.controllers.job import helpers
from volcano_tpu_torch.store.store import NotFoundError

logger = logging.getLogger(__name__)


def classify(pod: objects.Pod, counts: Dict[str, int]) -> None:
    """(job_controller_actions.go classifyAndAddUpPodBaseOnPhase)"""
    phase = pod.status.phase
    if phase == objects.POD_PHASE_PENDING:
        counts["pending"] += 1
    elif phase == objects.POD_PHASE_RUNNING:
        counts["running"] += 1
    elif phase == objects.POD_PHASE_SUCCEEDED:
        counts["succeeded"] += 1
    elif phase == objects.POD_PHASE_FAILED:
        counts["failed"] += 1
    else:
        counts["unknown"] += 1


class JobActions:
    """sync_job/kill_job implementations bound to a store + cache + plugins
    (the methods the state machine gets injected with)."""

    def __init__(self, store, cache, plugins_of, resync_task=None):
        self.store = store
        self.cache = cache
        self.plugins_of = plugins_of  # fn(job) -> [plugin instances]
        self.resync_task = resync_task or (lambda pod: None)

    # -- plugin hooks ------------------------------------------------------

    def plugin_on_job_add(self, job: objects.Job) -> None:
        for plugin in self.plugins_of(job):
            plugin.on_job_add(job)

    def plugin_on_job_delete(self, job: objects.Job) -> None:
        for plugin in self.plugins_of(job):
            plugin.on_job_delete(job)

    def plugin_on_pod_create(self, job: objects.Job, pod: objects.Pod) -> None:
        for plugin in self.plugins_of(job):
            plugin.on_pod_create(pod, job)

    # -- kill --------------------------------------------------------------

    def kill_job(self, job_info: JobInfo, pod_retain_phase: Set[str],
                 update_status) -> None:
        """(job_controller_actions.go:41-137)"""
        job = job_info.job
        counts = dict(pending=0, running=0, terminating=0, succeeded=0,
                      failed=0, unknown=0)
        errs = 0
        for pods in job_info.pods.values():
            for pod in pods.values():
                if pod.status.phase not in pod_retain_phase:
                    try:
                        self.store.delete(
                            "Pod", pod.metadata.namespace, pod.metadata.name)
                        counts["terminating"] += 1
                        continue
                    except NotFoundError:
                        counts["terminating"] += 1
                        continue
                    except Exception as e:  # pragma: no cover
                        logger.error("failed to delete pod %s: %s",
                                     pod.metadata.name, e)
                        errs += 1
                        self.resync_task(pod)
                classify(pod, counts)

        if errs:
            self.store.record_event(
                job, "Warning", "FailedDeletePods",
                f"Error deleting {errs} pods")
            raise RuntimeError(f"failed to kill {errs} pods")

        job = copy.deepcopy(job)
        # version is bumped only when the job is killed (actions.go:86-87)
        job.status.version += 1
        self._rebuild_status(job, counts)
        if update_status is not None and update_status(job.status):
            from volcano_tpu_torch.utils import clock

            job.status.state.last_transition_time = clock.now()
        self._write_status(job)

        # delete the PodGroup (actions.go:123-130)
        self.store.try_delete(
            "PodGroup", job.metadata.namespace, job.metadata.name)
        self.plugin_on_job_delete(job)
        self._write_status(job)  # controlled_resources changed by plugins

    # -- sync --------------------------------------------------------------

    def sync_job(self, job_info: JobInfo, update_status) -> None:
        """(job_controller_actions.go:177-335)"""
        job = copy.deepcopy(job_info.job)
        job = self.create_job(job)

        counts = dict(pending=0, running=0, terminating=0, succeeded=0,
                      failed=0, unknown=0)
        pod_to_create = []
        pod_to_delete = []

        for ts in job.spec.tasks:
            ts.template.name = ts.name
            pods = dict(job_info.pods.get(ts.name, {}))
            for i in range(ts.replicas):
                pod_name = helpers.make_pod_name(job.metadata.name, ts.name, i)
                pod = pods.pop(pod_name, None)
                if pod is None:
                    new_pod = helpers.create_job_pod(job, ts.template, i)
                    self.plugin_on_pod_create(job, new_pod)
                    pod_to_create.append(new_pod)
                else:
                    classify(pod, counts)
            pod_to_delete.extend(pods.values())  # beyond current replicas

        creation_errs = 0
        for pod in pod_to_create:
            try:
                self.store.create(pod)
                classify(pod, counts)
            except Exception as e:
                logger.error("failed to create pod %s for job %s: %s",
                             pod.metadata.name, job.metadata.name, e)
                creation_errs += 1
        if creation_errs:
            self.store.record_event(
                job, "Warning", "FailedCreatePods",
                f"Error creating {creation_errs} pods")
            raise RuntimeError(
                f"failed to create {creation_errs} pods of {len(pod_to_create)}")

        deletion_errs = 0
        for pod in pod_to_delete:
            try:
                self.store.delete("Pod", pod.metadata.namespace, pod.metadata.name)
                counts["terminating"] += 1
            except NotFoundError:
                counts["terminating"] += 1
            except Exception as e:  # pragma: no cover
                logger.error("failed to delete pod %s: %s", pod.metadata.name, e)
                deletion_errs += 1
                self.resync_task(pod)
        if deletion_errs:
            raise RuntimeError(f"failed to delete {deletion_errs} pods")

        self._rebuild_status(job, counts, keep_controlled=True)
        if update_status is not None and update_status(job.status):
            from volcano_tpu_torch.utils import clock

            job.status.state.last_transition_time = clock.now()
        self._write_status(job)

    # -- create ------------------------------------------------------------

    def create_job(self, job: objects.Job) -> objects.Job:
        """initJobStatus + plugins OnJobAdd + PVCs + PodGroup
        (actions.go:139-167)."""
        job = self.init_job_status(job)
        self.plugin_on_job_add(job)
        job = self.create_job_io_if_not_exist(job)
        self.create_pod_group_if_not_exist(job)
        return job

    def init_job_status(self, job: objects.Job) -> objects.Job:
        """(actions.go:518-537)"""
        if job.status.state.phase:
            return job
        job.status.state.phase = JobPhase.PENDING
        job.status.min_available = job.spec.min_available
        self._write_status(job)
        return job

    def create_job_io_if_not_exist(self, job: objects.Job) -> objects.Job:
        """Generate/verify volume claims; create missing PVCs
        (actions.go:338-432)."""
        need_update = False
        for volume in job.spec.volumes:
            vc_name = volume.volume_claim_name
            if not vc_name:
                while True:
                    vc_name = helpers.make_volume_claim_name(job.metadata.name)
                    if self.store.try_get(
                        "PersistentVolumeClaim", job.metadata.namespace, vc_name
                    ) is None:
                        break
                volume.volume_claim_name = vc_name
                need_update = True
                if volume.volume_claim is not None:
                    self._create_pvc(job, vc_name, volume.volume_claim)
                    job.status.controlled_resources[f"volume-pvc-{vc_name}"] = vc_name
                else:
                    job.status.controlled_resources[f"volume-emptyDir-{vc_name}"] = vc_name
            else:
                if (job.status.controlled_resources.get(f"volume-emptyDir-{vc_name}") == vc_name
                        or job.status.controlled_resources.get(f"volume-pvc-{vc_name}") == vc_name):
                    continue
                if self.store.try_get(
                    "PersistentVolumeClaim", job.metadata.namespace, vc_name
                ) is not None:
                    job.status.controlled_resources[f"volume-pvc-{vc_name}"] = vc_name
                else:
                    raise RuntimeError(
                        f"pvc {vc_name} is not found, the job will be in the "
                        f"Pending state until the PVC is created")
        if need_update:
            stored = self.store.get("Job", job.metadata.namespace, job.metadata.name)
            stored.spec.volumes = copy.deepcopy(job.spec.volumes)
            self.store.update(stored)
            self.cache.update(stored)
        return job

    def _create_pvc(self, job: objects.Job, vc_name: str, claim) -> None:
        pvc = objects.PersistentVolumeClaim(
            metadata=objects.ObjectMeta(
                name=vc_name, namespace=job.metadata.namespace,
                owner_references=[objects.OwnerReference(
                    kind=objects.Job.KIND, name=job.metadata.name,
                    uid=job.metadata.uid, controller=True)],
            ),
            requests=dict(claim) if isinstance(claim, dict) else {},
        )
        self.store.create(pvc)

    def create_pod_group_if_not_exist(self, job: objects.Job) -> None:
        """(actions.go:435-481; MinResources via calcPGMinResources:484-515)"""
        if self.store.try_get(
            "PodGroup", job.metadata.namespace, job.metadata.name
        ) is not None:
            return
        pg = objects.PodGroup(
            metadata=objects.ObjectMeta(
                name=job.metadata.name,
                namespace=job.metadata.namespace,
                annotations=dict(job.metadata.annotations),
                owner_references=[objects.OwnerReference(
                    kind=objects.Job.KIND, name=job.metadata.name,
                    uid=job.metadata.uid, controller=True)],
            ),
            spec=objects.PodGroupSpec(
                min_member=job.spec.min_available,
                queue=job.spec.queue,
                min_resources=calc_pg_min_resources(job),
                priority_class_name=job.spec.priority_class_name,
            ),
        )
        self.store.create(pg)

    # -- status plumbing ---------------------------------------------------

    def _rebuild_status(self, job: objects.Job, counts: Dict[str, int],
                        keep_controlled: bool = True) -> None:
        old = job.status
        job.status = objects.JobStatus(
            state=old.state,
            pending=counts["pending"],
            running=counts["running"],
            succeeded=counts["succeeded"],
            failed=counts["failed"],
            terminating=counts["terminating"],
            unknown=counts["unknown"],
            version=old.version,
            min_available=job.spec.min_available,
            retry_count=old.retry_count,
            controlled_resources=old.controlled_resources if keep_controlled else {},
        )

    def _write_status(self, job: objects.Job) -> None:
        stored = self.store.try_get("Job", job.metadata.namespace, job.metadata.name)
        if stored is None:
            return
        # replace (don't mutate) the canonical object so watch handlers see
        # a distinct old/new pair and can detect phase transitions
        updated = copy.deepcopy(stored)
        updated.status = job.status
        self.store.update_status(updated)
        try:
            self.cache.update(updated)
        except KeyError:  # pragma: no cover - deleted concurrently
            pass


def calc_pg_min_resources(job: objects.Job) -> Optional[Dict[str, object]]:
    """Sum of the first MinAvailable replicas' requests, tasks taken in
    priority order (actions.go:484-515). Task priority classes are rare;
    spec order is the declared priority here."""
    if job.spec.min_available <= 0:
        return None
    total: Dict[str, float] = {}
    counted = 0
    for ts in job.spec.tasks:
        for _ in range(ts.replicas):
            if counted >= job.spec.min_available:
                break
            counted += 1
            for container in ts.template.spec.containers:
                for name, quant in container.requests.items():
                    from volcano_tpu_torch.api.quantity import parse_quantity

                    total[name] = total.get(name, 0.0) + parse_quantity(quant)
    if not total:
        return None
    return {name: v for name, v in total.items()}
