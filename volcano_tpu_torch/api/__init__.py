"""Scheduler-facing data model (the analog of volcano pkg/scheduler/api +
pkg/apis): typed objects, resource arithmetic, and the in-memory infos the
session operates on."""

from volcano_tpu_torch.api.quantity import parse_quantity, milli_value
from volcano_tpu_torch.api.resource import Resource, GPU_RESOURCE_NAME
from volcano_tpu_torch.api.types import (
    TaskStatus,
    NodePhase,
    ValidateResult,
    allocated_status,
)
from volcano_tpu_torch.api.objects import (
    ObjectMeta,
    Container,
    PodSpec,
    PodStatus,
    Pod,
    Toleration,
    Taint,
    NodeSpec,
    NodeStatus,
    Node,
    PodGroupSpec,
    PodGroupStatus,
    PodGroupCondition,
    PodGroup,
    PodGroupPhase,
    QueueSpec,
    QueueStatus,
    Queue,
    Command,
    GROUP_NAME_ANNOTATION_KEY,
    POD_PHASE_PENDING,
    POD_PHASE_RUNNING,
    POD_PHASE_SUCCEEDED,
    POD_PHASE_FAILED,
    POD_PHASE_UNKNOWN,
)
from volcano_tpu_torch.api.job_info import TaskInfo, JobInfo, new_task_info
from volcano_tpu_torch.api.node_info import NodeInfo
from volcano_tpu_torch.api.queue_info import QueueInfo
from volcano_tpu_torch.api.namespace_info import NamespaceInfo, NamespaceCollection
from volcano_tpu_torch.api.cluster_info import ClusterInfo
from volcano_tpu_torch.api.unschedule_info import FitError, FitErrors, FitFailure
from volcano_tpu_torch.api.pod_helpers import (
    pod_key,
    get_pod_resource_request,
    get_pod_resource_without_init_containers,
)
