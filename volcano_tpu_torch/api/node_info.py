"""NodeInfo — per-node resource accounting (volcano pkg/scheduler/api/node_info.go).

The node holds *clones* of tasks so later status flips on the session's task
objects can't corrupt the accounting (node_info.go:196-197). Over-allocation
flips the node to NotReady/OutOfSync instead of corrupting state
(node_info.go:175-185).
"""

from __future__ import annotations

from typing import Dict, Optional

from volcano_tpu_torch.api import objects
from volcano_tpu_torch.api.pod_helpers import pod_key
from volcano_tpu_torch.api.resource import Resource
from volcano_tpu_torch.api.types import NodePhase, TaskStatus
from volcano_tpu_torch.api.job_info import TaskInfo


class NodeState:
    __slots__ = ("phase", "reason")

    def __init__(self, phase: NodePhase, reason: str = ""):
        self.phase = phase
        self.reason = reason


class NodeInfo:
    """Node-level aggregated accounting: Idle/Used/Releasing vs
    Allocatable/Capability (node_info.go:28-50)."""

    def __init__(self, node: Optional[objects.Node] = None):
        self.node = node
        self.releasing = Resource.empty()
        self.used = Resource.empty()
        self.tasks: Dict[str, TaskInfo] = {}
        self.others: Dict[str, object] = {}
        # accounting generation: bumped by every mutation of the node's
        # resource state (add/remove/update_task, set_node, and the bulk
        # writeback's direct idle/used deltas). The snapshot-captured
        # columnar node axis (cache/nodeaxis.py) records it so the encoder
        # can prove the capture still reflects this node
        self._acct_gen = 0

        if node is None:
            self.name = ""
            self.idle = Resource.empty()
            self.allocatable = Resource.empty()
            self.capability = Resource.empty()
        else:
            self.name = node.metadata.name
            self.idle = Resource.from_resource_list(node.status.allocatable)
            self.allocatable = Resource.from_resource_list(node.status.allocatable)
            self.capability = Resource.from_resource_list(node.status.capacity)

        self.state = NodeState(NodePhase.NOT_READY, "UnInitialized")
        self._set_node_state(node)

    # -- state -------------------------------------------------------------

    def ready(self) -> bool:
        return self.state.phase == NodePhase.READY

    def _set_node_state(self, node: Optional[objects.Node]) -> None:
        """(node_info.go:110-145)"""
        if node is None:
            self.state = NodeState(NodePhase.NOT_READY, "UnInitialized")
            return
        if not self.used.less_equal(Resource.from_resource_list(node.status.allocatable)):
            self.state = NodeState(NodePhase.NOT_READY, "OutOfSync")
            return
        for cond in node.status.conditions:
            if cond.type == "Ready" and cond.status != "True":
                self.state = NodeState(NodePhase.NOT_READY, "NotReady")
                return
        self.state = NodeState(NodePhase.READY)

    def set_node(self, node: objects.Node) -> None:
        """Refresh from the node object, recomputing accounting from held
        tasks (node_info.go:148-173)."""
        self._acct_gen += 1
        self._set_node_state(node)
        if not self.ready():
            return

        self.name = node.metadata.name
        self.node = node
        self.allocatable = Resource.from_resource_list(node.status.allocatable)
        self.capability = Resource.from_resource_list(node.status.capacity)
        self.idle = Resource.from_resource_list(node.status.allocatable)
        self.used = Resource.empty()

        for task in self.tasks.values():
            if task.status == TaskStatus.RELEASING:
                self.releasing.add(task.resreq)
            self.idle.sub(task.resreq)
            self.used.add(task.resreq)

    # -- task accounting ---------------------------------------------------

    def _allocate_idle(self, ti: TaskInfo) -> None:
        if ti.resreq.less_equal(self.idle):
            self.idle.sub(ti.resreq)
            return
        self.state = NodeState(NodePhase.NOT_READY, "OutOfSync")
        raise RuntimeError("Selected node NotReady")

    def add_task(self, task: TaskInfo) -> None:
        """(node_info.go:188-220)"""
        self._acct_gen += 1
        key = pod_key(task.pod) if task.pod is not None else f"{task.namespace}/{task.name}"
        if key in self.tasks:
            raise RuntimeError(
                f"task <{task.namespace}/{task.name}> already on node <{self.name}>"
            )
        # status-frozen copy: the map entry must not see later status flips
        # of the caller's object (node_info.go:188-220 clones for the same
        # reason), but resreq/init_resreq are never mutated in place
        # anywhere in the tree, so sharing them skips two Resource
        # deep-copies per placement — the statement-path analog of the bulk
        # writeback's shared_clone usage
        ti = task.shared_clone()
        if self.node is not None:
            if ti.status == TaskStatus.RELEASING:
                self._allocate_idle(ti)
                self.releasing.add(ti.resreq)
            elif ti.status == TaskStatus.PIPELINED:
                self.releasing.sub(ti.resreq)
            else:
                self._allocate_idle(ti)
            self.used.add(ti.resreq)
        self.tasks[key] = ti

    def remove_task(self, ti: TaskInfo) -> None:
        """(node_info.go:223-249)"""
        self._acct_gen += 1
        key = pod_key(ti.pod) if ti.pod is not None else f"{ti.namespace}/{ti.name}"
        task = self.tasks.get(key)
        if task is None:
            raise RuntimeError(
                f"failed to find task <{ti.namespace}/{ti.name}> on host <{self.name}>"
            )
        if self.node is not None:
            if task.status == TaskStatus.RELEASING:
                self.releasing.sub(task.resreq)
                self.idle.add(task.resreq)
            elif task.status == TaskStatus.PIPELINED:
                self.releasing.add(task.resreq)
            else:
                self.idle.add(task.resreq)
            self.used.sub(task.resreq)
        del self.tasks[key]

    def update_task(self, ti: TaskInfo) -> None:
        """remove_task + add_task, fused for the transitions the actions
        actually perform (evict: allocated->RELEASING, unevict back,
        pipeline commits). In those the idle/used movements of remove and
        add cancel exactly and the interleaved sufficiency checks are
        trivially true (remove just returned the same quantity add takes
        back), so the fused path applies only the net releasing/idle delta
        and refreshes the node-owned clone in place — bit-identical end
        state, minus two Resource deep-copies and two no-op epsilon checks
        per call. Transitions whose checks are REAL (from PIPELINED, or
        RELEASING->PIPELINED) and mismatched requests take the legacy
        remove+add path."""
        self._acct_gen += 1
        key = pod_key(ti.pod) if ti.pod is not None else f"{ti.namespace}/{ti.name}"
        cur = self.tasks.get(key)
        if cur is None:
            raise RuntimeError(
                f"failed to find task <{ti.namespace}/{ti.name}> on host <{self.name}>"
            )
        old, new = cur.status, ti.status
        RELEASING, PIPELINED = TaskStatus.RELEASING, TaskStatus.PIPELINED
        if cur.resreq != ti.resreq or (
            self.node is not None
            and (old == PIPELINED or (old == RELEASING and new == PIPELINED))
        ):
            self.remove_task(ti)
            self.add_task(ti)
            return
        if self.node is not None and old != new:
            req = ti.resreq
            if new == RELEASING and old != RELEASING:
                self.releasing.add(req)
            elif old == RELEASING and new != RELEASING:
                self.releasing.sub(req)
            elif new == PIPELINED:  # allocated -> PIPELINED
                self.idle.add(req)
                self.releasing.sub(req)
        # in-place refresh of the node-owned clone (remove+add would have
        # replaced it with ti.clone(); resreq is value-equal by the gate)
        cur.status = new
        cur.node_name = ti.node_name
        cur.priority = ti.priority
        cur.volume_ready = ti.volume_ready
        cur.init_resreq = ti.init_resreq  # never mutated via node maps
        cur.pod = ti.pod
        cur.row = ti.row
        cur.row_gen = ti.row_gen

    # -- misc --------------------------------------------------------------

    def clone(self) -> "NodeInfo":
        """Field-copying clone: the accounting Resources are deep-copied
        (the session and the bulk writeback mutate idle/used/releasing in
        place), tasks are status-frozen shared_clones, and the parsed
        allocatable/capability are copied WITHOUT re-parsing the node's
        quantity strings — the replay clone (clone_replay) re-derived all
        accounting through add_task, costing 12 parse_quantity calls and a
        per-task replay per node per snapshot. End state is identical
        (asserted by tests against clone_replay); the invariant that
        accounting == sum over held tasks is maintained incrementally by
        every mutator above."""
        res = NodeInfo.__new__(NodeInfo)
        res.node = self.node
        res.name = self.name
        res.releasing = self.releasing.clone()
        res.used = self.used.clone()
        res.idle = self.idle.clone()
        # allocatable/capability are REASSIGNED (set_node) but never
        # mutated in place anywhere in the tree — shared like task
        # resreqs, skipping two Resource deep-copies per node per snapshot
        res.allocatable = self.allocatable
        res.capability = self.capability
        res.tasks = {k: t.shared_clone() for k, t in self.tasks.items()}
        res.others = self.others
        res._acct_gen = self._acct_gen
        res.state = NodeState(self.state.phase, self.state.reason)
        return res

    def clone_replay(self) -> "NodeInfo":
        """Replay clone: rebuild accounting from the node object + held
        tasks through add_task (the original clone path). Kept as the
        oracle for clone() — any drift between the incremental accounting
        and the task set shows up as a mismatch between the two."""
        res = NodeInfo(self.node)
        for task in self.tasks.values():
            res.add_task(task)
        res.others = self.others
        res._acct_gen = self._acct_gen
        return res

    def pods(self) -> list:
        return [t.pod for t in self.tasks.values()]

    def __repr__(self) -> str:
        return (
            f"Node ({self.name}): idle <{self.idle}>, used <{self.used}>, "
            f"releasing <{self.releasing}>, state <{self.state.phase}, "
            f"{self.state.reason}>"
        )
