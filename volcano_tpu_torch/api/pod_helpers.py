"""Pod → task helpers (volcano pkg/scheduler/api/{helpers.go,pod_info.go})."""

from __future__ import annotations

from volcano_tpu_torch.api import objects
from volcano_tpu_torch.api.resource import Resource
from volcano_tpu_torch.api.types import TaskStatus


def pod_key(pod: objects.Pod) -> str:
    """"namespace/name" key (helpers.go PodKey)."""
    return f"{pod.metadata.namespace}/{pod.metadata.name}"


def get_task_status(pod: objects.Pod) -> TaskStatus:
    """Pod phase + deletion/node state → TaskStatus (helpers.go getTaskStatus)."""
    phase = pod.status.phase
    if phase == objects.POD_PHASE_RUNNING:
        if pod.metadata.deletion_timestamp is not None:
            return TaskStatus.RELEASING
        return TaskStatus.RUNNING
    if phase == objects.POD_PHASE_PENDING:
        if pod.metadata.deletion_timestamp is not None:
            return TaskStatus.RELEASING
        if not pod.spec.node_name:
            return TaskStatus.PENDING
        return TaskStatus.BOUND
    if phase == objects.POD_PHASE_SUCCEEDED:
        return TaskStatus.SUCCEEDED
    if phase == objects.POD_PHASE_FAILED:
        return TaskStatus.FAILED
    return TaskStatus.UNKNOWN


def get_pod_resource_without_init_containers(pod: objects.Pod) -> Resource:
    """Sum of main-container requests (pod_info.go:66-74)."""
    result = Resource.empty()
    for container in pod.spec.containers:
        result.add(Resource.from_resource_list(container.requests))
    return result


def get_pod_resource_request(pod: objects.Pod) -> Resource:
    """max(sum of main containers, each init container) per dimension —
    init containers run sequentially (pod_info.go:53-62)."""
    result = get_pod_resource_without_init_containers(pod)
    for container in pod.spec.init_containers:
        result.set_max_resource(Resource.from_resource_list(container.requests))
    return result
