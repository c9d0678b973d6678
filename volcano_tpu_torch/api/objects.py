"""The framework's API object model — the analog of volcano's CRDs and the
slice of core/v1 it consumes.

These are plain mutable dataclasses living in the in-process event store
(volcano_tpu_torch.store). They mirror:
- Pod/Node: the consumed subset of k8s core/v1;
- PodGroup/Queue: pkg/apis/scheduling/types.go;
- Job (batch): pkg/apis/batch/v1alpha1/job.go;
- Command (bus): pkg/apis/bus/v1alpha1/types.go.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

GROUP_NAME_ANNOTATION_KEY = "scheduling.volcano.sh/group-name"
TASK_SPEC_KEY = "volcano.sh/task-spec"
JOB_NAME_KEY = "volcano.sh/job-name"
JOB_VERSION_KEY = "volcano.sh/job-version"
NAMESPACE_WEIGHT_KEY = "volcano.sh/namespace.weight"

POD_PHASE_PENDING = "Pending"
POD_PHASE_RUNNING = "Running"
POD_PHASE_SUCCEEDED = "Succeeded"
POD_PHASE_FAILED = "Failed"
POD_PHASE_UNKNOWN = "Unknown"

_uid_counter = itertools.count(1)


def new_uid(prefix: str = "uid") -> str:
    return f"{prefix}-{next(_uid_counter):08d}"


@dataclass
class OwnerReference:
    kind: str = ""
    name: str = ""
    uid: str = ""
    controller: bool = False
    block_owner_deletion: bool = False


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    creation_timestamp: float = 0.0
    deletion_timestamp: Optional[float] = None
    resource_version: int = 0
    owner_references: List[OwnerReference] = field(default_factory=list)

    def ensure_identity(self) -> None:
        if not self.uid:
            self.uid = new_uid(self.name or "obj")
        if not self.creation_timestamp:
            from volcano_tpu_torch.utils import clock

            self.creation_timestamp = clock.now()


# ---------------------------------------------------------------------------
# Pod (consumed subset of core/v1)
# ---------------------------------------------------------------------------


@dataclass
class ContainerPort:
    container_port: int = 0
    host_port: int = 0
    protocol: str = "TCP"


@dataclass
class VolumeMount:
    name: str = ""
    mount_path: str = ""


@dataclass
class EnvVar:
    name: str = ""
    value: str = ""


@dataclass
class Container:
    name: str = ""
    image: str = ""
    command: List[str] = field(default_factory=list)
    requests: Dict[str, object] = field(default_factory=dict)
    limits: Dict[str, object] = field(default_factory=dict)
    ports: List[ContainerPort] = field(default_factory=list)
    env: List[EnvVar] = field(default_factory=list)
    volume_mounts: List[VolumeMount] = field(default_factory=list)


@dataclass
class Toleration:
    key: str = ""
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # NoSchedule | PreferNoSchedule | NoExecute | "" (all)

    def tolerates(self, taint: "Taint") -> bool:
        if self.effect and self.effect != taint.effect:
            return False
        if self.key == "":
            return self.operator == "Exists"
        if self.key != taint.key:
            return False
        if self.operator == "Exists":
            return True
        return self.value == taint.value


@dataclass
class LabelSelectorRequirement:
    key: str = ""
    operator: str = "In"  # In | NotIn | Exists | DoesNotExist
    values: List[str] = field(default_factory=list)


@dataclass
class LabelSelector:
    match_labels: Dict[str, str] = field(default_factory=dict)
    match_expressions: List[LabelSelectorRequirement] = field(default_factory=list)

    def matches(self, labels: Dict[str, str]) -> bool:
        for k, v in self.match_labels.items():
            if labels.get(k) != v:
                return False
        for req in self.match_expressions:
            present = req.key in labels
            if req.operator == "In":
                if not present or labels[req.key] not in req.values:
                    return False
            elif req.operator == "NotIn":
                if present and labels[req.key] in req.values:
                    return False
            elif req.operator == "Exists":
                if not present:
                    return False
            elif req.operator == "DoesNotExist":
                if present:
                    return False
        return True


@dataclass
class NodeSelectorRequirement:
    key: str = ""
    operator: str = "In"  # In | NotIn | Exists | DoesNotExist | Gt | Lt
    values: List[str] = field(default_factory=list)

    def matches(self, labels: Dict[str, str]) -> bool:
        present = self.key in labels
        req_val = labels.get(self.key)
        if self.operator == "In":
            return present and req_val in self.values
        if self.operator == "NotIn":
            return not present or req_val not in self.values
        if self.operator == "Exists":
            return present
        if self.operator == "DoesNotExist":
            return not present
        if self.operator in ("Gt", "Lt"):
            if not present or not self.values:
                return False
            have, want = _as_int(req_val), _as_int(self.values[0])
            if have is None or want is None:
                return False
            return have > want if self.operator == "Gt" else have < want
        return False


def _as_int(v) -> Optional[int]:
    try:
        return int(v)
    except (TypeError, ValueError):
        return None


@dataclass
class NodeSelectorTerm:
    match_expressions: List[NodeSelectorRequirement] = field(default_factory=list)

    def matches(self, labels: Dict[str, str]) -> bool:
        return all(r.matches(labels) for r in self.match_expressions)


@dataclass
class PreferredSchedulingTerm:
    weight: int = 0
    preference: NodeSelectorTerm = field(default_factory=NodeSelectorTerm)


@dataclass
class NodeAffinity:
    # requiredDuringSchedulingIgnoredDuringExecution: OR of terms
    required_terms: List[NodeSelectorTerm] = field(default_factory=list)
    preferred_terms: List[PreferredSchedulingTerm] = field(default_factory=list)


@dataclass
class PodAffinityTerm:
    label_selector: Optional[LabelSelector] = None
    namespaces: List[str] = field(default_factory=list)
    topology_key: str = "kubernetes.io/hostname"


@dataclass
class WeightedPodAffinityTerm:
    weight: int = 0
    pod_affinity_term: PodAffinityTerm = field(default_factory=PodAffinityTerm)


@dataclass
class PodAffinity:
    required_terms: List[PodAffinityTerm] = field(default_factory=list)
    preferred_terms: List[WeightedPodAffinityTerm] = field(default_factory=list)


@dataclass
class PodAntiAffinity:
    required_terms: List[PodAffinityTerm] = field(default_factory=list)
    preferred_terms: List[WeightedPodAffinityTerm] = field(default_factory=list)


@dataclass
class Affinity:
    node_affinity: Optional[NodeAffinity] = None
    pod_affinity: Optional[PodAffinity] = None
    pod_anti_affinity: Optional[PodAntiAffinity] = None


@dataclass
class Volume:
    name: str = ""
    persistent_volume_claim: str = ""  # claim name
    config_map: str = ""
    empty_dir: bool = False


@dataclass
class PodSpec:
    containers: List[Container] = field(default_factory=list)
    init_containers: List[Container] = field(default_factory=list)
    node_name: str = ""
    node_selector: Dict[str, str] = field(default_factory=dict)
    affinity: Optional[Affinity] = None
    tolerations: List[Toleration] = field(default_factory=list)
    priority: Optional[int] = None
    priority_class_name: str = ""
    scheduler_name: str = ""
    hostname: str = ""
    subdomain: str = ""
    restart_policy: str = "Always"
    volumes: List[Volume] = field(default_factory=list)
    service_account_name: str = ""


@dataclass
class ContainerStatus:
    name: str = ""
    exit_code: int = 0
    ready: bool = False


@dataclass
class PodCondition:
    type: str = ""
    status: str = ""
    reason: str = ""
    message: str = ""
    last_transition_time: float = 0.0


@dataclass
class PodStatus:
    phase: str = POD_PHASE_PENDING
    reason: str = ""
    message: str = ""
    conditions: List[PodCondition] = field(default_factory=list)
    container_statuses: List[ContainerStatus] = field(default_factory=list)
    init_container_statuses: List[ContainerStatus] = field(default_factory=list)
    start_time: Optional[float] = None


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)

    KIND = "Pod"


@dataclass
class PodTemplateSpec:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)


# ---------------------------------------------------------------------------
# Node
# ---------------------------------------------------------------------------


@dataclass
class Taint:
    key: str = ""
    value: str = ""
    effect: str = "NoSchedule"


@dataclass
class NodeCondition:
    type: str = "Ready"
    status: str = "True"


@dataclass
class NodeSpec:
    taints: List[Taint] = field(default_factory=list)
    unschedulable: bool = False


@dataclass
class NodeStatus:
    capacity: Dict[str, object] = field(default_factory=dict)
    allocatable: Dict[str, object] = field(default_factory=dict)
    conditions: List[NodeCondition] = field(default_factory=lambda: [NodeCondition()])


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)

    KIND = "Node"


# ---------------------------------------------------------------------------
# PodGroup / Queue (scheduling group; pkg/apis/scheduling/types.go)
# ---------------------------------------------------------------------------


class PodGroupPhase:
    PENDING = "Pending"
    RUNNING = "Running"
    UNKNOWN = "Unknown"
    INQUEUE = "Inqueue"


POD_GROUP_UNSCHEDULABLE_TYPE = "Unschedulable"
POD_GROUP_NOT_READY = "PodGroupNotReady"

NOT_ENOUGH_RESOURCES_REASON = "NotEnoughResources"
NOT_ENOUGH_PODS_REASON = "NotEnoughTasks"


@dataclass
class PodGroupCondition:
    type: str = ""
    status: str = ""  # "True" | "False"
    transition_id: str = ""
    last_transition_time: float = 0.0
    reason: str = ""
    message: str = ""


@dataclass
class PodGroupSpec:
    min_member: int = 0
    queue: str = ""
    priority_class_name: str = ""
    min_resources: Optional[Dict[str, object]] = None


@dataclass
class PodGroupStatus:
    phase: str = PodGroupPhase.PENDING
    conditions: List[PodGroupCondition] = field(default_factory=list)
    running: int = 0
    succeeded: int = 0
    failed: int = 0

    def clone(self) -> "PodGroupStatus":
        return PodGroupStatus(
            phase=self.phase,
            conditions=list(self.conditions),
            running=self.running,
            succeeded=self.succeeded,
            failed=self.failed,
        )


@dataclass
class PodGroup:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodGroupSpec = field(default_factory=PodGroupSpec)
    status: PodGroupStatus = field(default_factory=PodGroupStatus)

    KIND = "PodGroup"


@dataclass
class QueueSpec:
    weight: int = 1
    capability: Optional[Dict[str, object]] = None
    reclaimable: bool = True


@dataclass
class QueueStatus:
    state: str = "Open"
    unknown: int = 0
    pending: int = 0
    running: int = 0
    inqueue: int = 0


@dataclass
class Queue:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: QueueSpec = field(default_factory=QueueSpec)
    status: QueueStatus = field(default_factory=QueueStatus)

    KIND = "Queue"


# ---------------------------------------------------------------------------
# PriorityClass / quota / disruption-budget analogs
# ---------------------------------------------------------------------------


@dataclass
class PriorityClass:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    value: int = 0
    global_default: bool = False
    preemption_policy: str = "PreemptLowerPriority"

    KIND = "PriorityClass"


SYSTEM_CLUSTER_CRITICAL = "system-cluster-critical"
SYSTEM_NODE_CRITICAL = "system-node-critical"


@dataclass
class ResourceQuota:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    hard: Dict[str, object] = field(default_factory=dict)

    KIND = "ResourceQuota"


@dataclass
class PodDisruptionBudget:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    min_available: int = 0

    KIND = "PodDisruptionBudget"


@dataclass
class PersistentVolumeClaim:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    requests: Dict[str, object] = field(default_factory=dict)
    phase: str = "Pending"
    volume_name: str = ""  # bound PV (set by the volume binder)

    KIND = "PersistentVolumeClaim"


@dataclass
class PersistentVolume:
    """Cluster-scoped storage the volume binder assumes/binds PVCs
    against (the reference binds through the k8s volumebinder —
    pkg/scheduler/cache/cache.go:240-258; this is the store-native
    equivalent). Empty ``node_names`` means host-agnostic storage;
    otherwise the volume is local to those nodes and constrains
    placement at binding time."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    capacity: Dict[str, object] = field(default_factory=dict)  # {"storage": "10Gi"}
    node_names: List[str] = field(default_factory=list)
    claim_ref: str = ""  # "namespace/name" of the bound PVC
    phase: str = "Available"  # Available | Bound

    KIND = "PersistentVolume"


@dataclass
class ConfigMap:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    data: Dict[str, str] = field(default_factory=dict)

    KIND = "ConfigMap"


@dataclass
class Service:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    cluster_ip: str = ""  # "None" = headless
    selector: Dict[str, str] = field(default_factory=dict)

    KIND = "Service"


# ---------------------------------------------------------------------------
# batch Job (pkg/apis/batch/v1alpha1/job.go)
# ---------------------------------------------------------------------------


class JobEvent:
    """Events the lifecycle policy engine reacts to (job.go:120-144)."""

    ANY = "*"
    POD_FAILED = "PodFailed"
    POD_EVICTED = "PodEvicted"
    JOB_UNKNOWN = "Unknown"
    TASK_COMPLETED = "TaskCompleted"
    # internal
    OUT_OF_SYNC = "OutOfSync"
    COMMAND_ISSUED = "CommandIssued"


class JobAction:
    """Actions the job controller can take (job.go:146-172)."""

    ABORT_JOB = "AbortJob"
    RESTART_JOB = "RestartJob"
    RESTART_TASK = "RestartTask"
    TERMINATE_JOB = "TerminateJob"
    COMPLETE_JOB = "CompleteJob"
    RESUME_JOB = "ResumeJob"
    # internal
    SYNC_JOB = "SyncJob"
    ENQUEUE_JOB = "EnqueueJob"


class JobPhase:
    """Job lifecycle phases (job.go:223-246)."""

    PENDING = "Pending"
    ABORTING = "Aborting"
    ABORTED = "Aborted"
    RUNNING = "Running"
    RESTARTING = "Restarting"
    COMPLETING = "Completing"
    COMPLETED = "Completed"
    TERMINATING = "Terminating"
    TERMINATED = "Terminated"
    FAILED = "Failed"


@dataclass
class LifecyclePolicy:
    action: str = ""
    event: str = ""
    events: List[str] = field(default_factory=list)
    exit_code: Optional[int] = None
    timeout_seconds: Optional[float] = None


@dataclass
class TaskSpec:
    name: str = ""
    replicas: int = 0
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    policies: List[LifecyclePolicy] = field(default_factory=list)


@dataclass
class VolumeSpec:
    mount_path: str = ""
    volume_claim_name: str = ""
    volume_claim: Optional[Dict[str, object]] = None  # PVC spec (requests)


@dataclass
class JobSpec:
    scheduler_name: str = ""
    min_available: int = 0
    volumes: List[VolumeSpec] = field(default_factory=list)
    tasks: List[TaskSpec] = field(default_factory=list)
    policies: List[LifecyclePolicy] = field(default_factory=list)
    plugins: Dict[str, List[str]] = field(default_factory=dict)
    queue: str = ""
    max_retry: int = 3
    ttl_seconds_after_finished: Optional[int] = None
    priority_class_name: str = ""


@dataclass
class JobState:
    phase: str = JobPhase.PENDING
    reason: str = ""
    message: str = ""
    last_transition_time: float = 0.0


@dataclass
class JobStatus:
    state: JobState = field(default_factory=JobState)
    min_available: int = 0
    pending: int = 0
    running: int = 0
    succeeded: int = 0
    failed: int = 0
    terminating: int = 0
    unknown: int = 0
    version: int = 0
    retry_count: int = 0
    controlled_resources: Dict[str, str] = field(default_factory=dict)


@dataclass
class Job:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: JobSpec = field(default_factory=JobSpec)
    status: JobStatus = field(default_factory=JobStatus)

    KIND = "Job"


# ---------------------------------------------------------------------------
# bus Command (pkg/apis/bus/v1alpha1/types.go)
# ---------------------------------------------------------------------------


@dataclass
class Command:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    action: str = ""
    target_object: Optional[OwnerReference] = None
    reason: str = ""
    message: str = ""

    KIND = "Command"
