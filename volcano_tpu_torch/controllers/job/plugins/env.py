"""env job plugin: inject VK_TASK_INDEX into every container
(volcano pkg/controllers/job/plugins/env/env.go:46-56)."""

from __future__ import annotations

from volcano_tpu_torch.api import objects
from volcano_tpu_torch.controllers.job import helpers

TASK_VK_INDEX = "VK_TASK_INDEX"


class EnvPlugin:
    def __init__(self, store, arguments=None):
        self.store = store
        self.arguments = arguments or []

    def name(self) -> str:
        return "env"

    def on_pod_create(self, pod: objects.Pod, job: objects.Job) -> None:
        index = helpers.get_task_index(pod)
        for container in pod.spec.containers:
            container.env.append(
                objects.EnvVar(name=TASK_VK_INDEX, value=str(index)))

    def on_job_add(self, job: objects.Job) -> None:
        pass

    def on_job_delete(self, job: objects.Job) -> None:
        pass


def new(store, arguments):
    return EnvPlugin(store, arguments)
