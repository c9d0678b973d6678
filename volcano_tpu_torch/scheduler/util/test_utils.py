"""Synthetic-object builders and fake effectors for tests and benchmarks
(the analog of volcano pkg/scheduler/util/test_utils.go).

The fakes plug into the Binder/Evictor/StatusUpdater/VolumeBinder seam of the
scheduler cache (cache/interface.go:58-76) — the same seam the TPU parity
harness and the deterministic replay benchmarks use.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from volcano_tpu_torch.api import objects


def build_resource_list(cpu: str, memory: str, **scalars) -> Dict[str, object]:
    """e.g. build_resource_list("2000m", "4Gi", **{"nvidia.com/gpu": "1"})"""
    rl: Dict[str, object] = {"cpu": cpu, "memory": memory}
    rl.update(scalars)
    return rl


def build_resource_list_with_pods(
    cpu: str, memory: str, pods: int = 110, **scalars
) -> Dict[str, object]:
    rl = build_resource_list(cpu, memory, **scalars)
    rl["pods"] = pods
    return rl


def build_node(
    name: str,
    allocatable: Dict[str, object],
    labels: Optional[Dict[str, str]] = None,
    capacity: Optional[Dict[str, object]] = None,
) -> objects.Node:
    node = objects.Node(
        metadata=objects.ObjectMeta(name=name, labels=dict(labels or {})),
        status=objects.NodeStatus(
            capacity=dict(capacity if capacity is not None else allocatable),
            allocatable=dict(allocatable),
        ),
    )
    node.metadata.ensure_identity()
    return node


def build_pod(
    namespace: str,
    name: str,
    node_name: str,
    phase: str,
    request: Dict[str, object],
    group_name: str = "",
    labels: Optional[Dict[str, str]] = None,
    node_selector: Optional[Dict[str, str]] = None,
    priority: Optional[int] = None,
) -> objects.Pod:
    annotations = {}
    if group_name:
        annotations[objects.GROUP_NAME_ANNOTATION_KEY] = group_name
    pod = objects.Pod(
        metadata=objects.ObjectMeta(
            name=name,
            namespace=namespace,
            uid=f"{namespace}-{name}",
            labels=dict(labels or {}),
            annotations=annotations,
        ),
        spec=objects.PodSpec(
            node_name=node_name,
            node_selector=dict(node_selector or {}),
            containers=[objects.Container(name="c", requests=dict(request))],
            priority=priority,
        ),
        status=objects.PodStatus(phase=phase),
    )
    pod.metadata.ensure_identity()
    return pod


def build_pod_group(
    name: str,
    namespace: str = "default",
    min_member: int = 1,
    queue: str = "default",
    phase: str = objects.PodGroupPhase.INQUEUE,
    min_resources: Optional[Dict[str, object]] = None,
) -> objects.PodGroup:
    pg = objects.PodGroup(
        metadata=objects.ObjectMeta(name=name, namespace=namespace),
        spec=objects.PodGroupSpec(
            min_member=min_member, queue=queue, min_resources=min_resources
        ),
        status=objects.PodGroupStatus(phase=phase),
    )
    pg.metadata.ensure_identity()
    return pg


def build_queue(name: str, weight: int = 1, capability=None) -> objects.Queue:
    q = objects.Queue(
        metadata=objects.ObjectMeta(name=name, namespace=""),
        spec=objects.QueueSpec(weight=weight, capability=capability),
    )
    q.metadata.ensure_identity()
    return q


class FakeBinder:
    """Records binds; signals each via a condition for completion waits
    (test_utils.go:98-120)."""

    def __init__(self):
        self.binds: Dict[str, str] = {}  # "ns/name" -> node
        self.channel: List[str] = []
        self._cond = threading.Condition()

    def bind(self, pod: objects.Pod, hostname: str) -> None:
        key = f"{pod.metadata.namespace}/{pod.metadata.name}"
        with self._cond:
            self.binds[key] = hostname
            self.channel.append(key)
            self._cond.notify_all()

    def bind_many(self, pairs) -> None:
        """Batch bind under one lock acquisition (bulk-apply fast path)."""
        keyed = [
            (f"{pod.metadata.namespace}/{pod.metadata.name}", hostname)
            for pod, hostname in pairs
        ]
        with self._cond:
            self.binds.update(keyed)
            self.channel.extend(k for k, _ in keyed)
            self._cond.notify_all()

    # the keyed path needs no pod objects (the k8s Bind subresource binds
    # by name + target); the bulk writeback then skips per-task .pod
    # extraction entirely and passes pods=None
    KEYED_NEEDS_PODS = False

    def bind_many_keyed(self, keys, pods, hosts) -> None:
        """Batch bind with caller-derived ns/name keys (the bulk-apply
        writeback already built them); skips 50k metadata re-derivations.
        ``pods`` may be None (see KEYED_NEEDS_PODS)."""
        with self._cond:
            self.binds.update(zip(keys, hosts))
            self.channel.extend(keys)
            self._cond.notify_all()

    def wait_for_binds(self, n: int, timeout: float = 5.0) -> bool:
        with self._cond:
            return self._cond.wait_for(lambda: len(self.binds) >= n, timeout)


class FakeEvictor:
    def __init__(self):
        self.evicts: List[str] = []
        self._cond = threading.Condition()

    def evict(self, pod: objects.Pod, reason: str = "") -> None:
        key = f"{pod.metadata.namespace}/{pod.metadata.name}"
        with self._cond:
            self.evicts.append(key)
            self._cond.notify_all()

    def wait_for_evicts(self, n: int, timeout: float = 5.0) -> bool:
        with self._cond:
            return self._cond.wait_for(lambda: len(self.evicts) >= n, timeout)


class FakeStatusUpdater:
    """No-op status updater (test_utils.go:139-152)."""

    def update_pod_condition(self, pod, condition) -> None:
        pass

    def update_pod_group(self, pg, status=None) -> None:
        pass


class FakeVolumeBinder:
    """No-op volume binder (test_utils.go:154-165). IS_NOOP lets the bulk
    apply path skip 2 calls per placement."""

    IS_NOOP = True

    def allocate_volumes(self, task, hostname: str) -> None:
        pass

    def bind_volumes(self, task) -> None:
        pass
