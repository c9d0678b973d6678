"""Controller-side job view + work request
(volcano pkg/controllers/apis/job_info.go:12,122)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from volcano_tpu_torch.api import objects


@dataclass
class JobInfo:
    """The controller's view of one Job: the Job object + its pods indexed
    [task name][pod name] (job_info.go:12-40)."""

    namespace: str = ""
    name: str = ""
    job: Optional[objects.Job] = None
    pods: Dict[str, Dict[str, objects.Pod]] = field(default_factory=dict)

    def clone(self) -> "JobInfo":
        return JobInfo(
            namespace=self.namespace,
            name=self.name,
            job=self.job,
            pods={task: dict(pods) for task, pods in self.pods.items()},
        )

    def set_job(self, job: objects.Job) -> None:
        self.name = job.metadata.name
        self.namespace = job.metadata.namespace
        self.job = job

    def add_pod(self, pod: objects.Pod) -> None:
        task_name = pod.metadata.annotations.get(objects.TASK_SPEC_KEY)
        if not task_name:
            raise ValueError(
                f"failed to find taskName of Pod <{pod.metadata.namespace}/"
                f"{pod.metadata.name}>")
        self.pods.setdefault(task_name, {})[pod.metadata.name] = pod

    def update_pod(self, pod: objects.Pod) -> None:
        task_name = pod.metadata.annotations.get(objects.TASK_SPEC_KEY)
        if not task_name:
            raise ValueError(
                f"failed to find taskName of Pod <{pod.metadata.namespace}/"
                f"{pod.metadata.name}>")
        if pod.metadata.name not in self.pods.get(task_name, {}):
            raise KeyError(
                f"failed to find Pod <{pod.metadata.namespace}/"
                f"{pod.metadata.name}>")
        self.pods[task_name][pod.metadata.name] = pod

    def delete_pod(self, pod: objects.Pod) -> None:
        task_name = pod.metadata.annotations.get(objects.TASK_SPEC_KEY)
        if not task_name:
            raise ValueError(
                f"failed to find taskName of Pod <{pod.metadata.namespace}/"
                f"{pod.metadata.name}>")
        pods = self.pods.get(task_name, {})
        pods.pop(pod.metadata.name, None)
        if not pods:
            self.pods.pop(task_name, None)


@dataclass
class Request:
    """One unit of controller work (job_info.go:122-141)."""

    namespace: str = ""
    job_name: str = ""
    task_name: str = ""
    queue_name: str = ""
    event: str = ""
    action: str = ""
    exit_code: int = 0
    job_version: int = 0

    def __repr__(self) -> str:
        return (
            f"Job: {self.namespace}/{self.job_name}, Task:{self.task_name}, "
            f"Event:{self.event}, ExitCode:{self.exit_code}, "
            f"Action:{self.action}, JobVersion: {self.job_version}"
        )
