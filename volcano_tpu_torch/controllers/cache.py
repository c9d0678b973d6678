"""Controller job cache: ns/name -> JobInfo under a lock, with a
deleted-jobs cleanup queue (volcano pkg/controllers/cache/cache.go:36)."""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from volcano_tpu_torch.api import objects
from volcano_tpu_torch.controllers.apis import JobInfo


def job_key(job: objects.Job) -> str:
    return f"{job.metadata.namespace}/{job.metadata.name}"


def job_key_by_name(namespace: str, name: str) -> str:
    return f"{namespace}/{name}"


def job_key_of_pod(pod: objects.Pod) -> Optional[str]:
    job_name = pod.metadata.annotations.get(objects.JOB_NAME_KEY)
    if not job_name:
        return None
    return job_key_by_name(pod.metadata.namespace, job_name)


class JobCache:
    """Thread-safe job cache (cache/cache.go:36-322). Pods observed before
    their Job are held in placeholder entries (AddPod path)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._jobs: Dict[str, JobInfo] = {}
        self.deleted_jobs: List[str] = []

    def get(self, key: str) -> JobInfo:
        with self._lock:
            info = self._jobs.get(key)
            if info is None or info.job is None:
                raise KeyError(f"failed to find job <{key}>")
            return info.clone()

    def add(self, job: objects.Job) -> None:
        with self._lock:
            key = job_key(job)
            info = self._jobs.get(key)
            if info is None:
                self._jobs[key] = JobInfo(
                    namespace=job.metadata.namespace,
                    name=job.metadata.name, job=job)
            elif info.job is None:
                info.set_job(job)  # placeholder from an early pod
            else:
                raise ValueError(f"duplicated jobInfo <{key}>")

    def update(self, job: objects.Job) -> None:
        with self._lock:
            info = self._jobs.get(job_key(job))
            if info is None:
                raise KeyError(f"failed to find job <{job_key(job)}>")
            info.job = job

    def delete(self, job: objects.Job) -> None:
        with self._lock:
            key = job_key(job)
            if key in self._jobs:
                self.deleted_jobs.append(key)
                del self._jobs[key]

    def add_pod(self, pod: objects.Pod) -> None:
        with self._lock:
            key = job_key_of_pod(pod)
            if key is None:
                raise ValueError(
                    f"failed to find jobName of Pod "
                    f"<{pod.metadata.namespace}/{pod.metadata.name}>")
            info = self._jobs.setdefault(
                key, JobInfo(namespace=pod.metadata.namespace,
                             name=pod.metadata.annotations[objects.JOB_NAME_KEY]))
            info.add_pod(pod)

    def update_pod(self, pod: objects.Pod) -> None:
        with self._lock:
            key = job_key_of_pod(pod)
            info = self._jobs.get(key) if key else None
            if info is None:
                raise KeyError(f"failed to find job of Pod <{pod.metadata.name}>")
            try:
                info.update_pod(pod)
            except KeyError:
                info.add_pod(pod)

    def delete_pod(self, pod: objects.Pod) -> None:
        with self._lock:
            key = job_key_of_pod(pod)
            info = self._jobs.get(key) if key else None
            if info is not None:
                info.delete_pod(pod)

    def task_completed(self, key: str, task_name: str) -> bool:
        """All pods of the task Succeeded (controllers/cache/cache.go
        TaskCompleted): at least one pod and none alive/incomplete."""
        with self._lock:
            info = self._jobs.get(key)
            if info is None:
                return False
            pods = info.pods.get(task_name, {})
            if not pods:
                return False
            return all(
                p.status.phase == objects.POD_PHASE_SUCCEEDED
                for p in pods.values()
            )
