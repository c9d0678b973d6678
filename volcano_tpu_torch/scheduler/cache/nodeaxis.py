"""Snapshot-captured columnar node axis — the node-side twin of the pod
table (podtable.py).

The encoder's node arrays (idle/used/allocatable matrices, static predicate
bits, taint/resident/releasing flags, task counts) cost a handful of
O(nodes) Python walks per session when gathered from NodeInfo objects.
cache.snapshot() already clones every ready node; capturing the columns in
the same pass moves that cost off the measured session-actions path and
turns encode's node section into array slices.

Consistency: every NodeInfo resource mutation bumps node._acct_gen
(node_info.py); the capture records the clone's generation, and the encoder
re-validates all generations before trusting the columns (encoder.py
_node_axis_from_capture). A mismatch — any node touched between snapshot
and encode, e.g. by an action ordered before allocate — falls back to the
object walk, so stale columns can never be encoded.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

# flag bits (uint16)
F_READY = np.uint16(1)
F_NET_UNAVAILABLE = np.uint16(2)
F_MEM_PRESSURE = np.uint16(4)
F_DISK_PRESSURE = np.uint16(8)
F_PID_PRESSURE = np.uint16(16)
F_UNSCHEDULABLE = np.uint16(32)
F_RELEASING = np.uint16(64)
F_BLOCKING_TAINTS = np.uint16(128)
F_RESIDENT_PODS = np.uint16(256)


class NodeAxis:
    """Columns over the snapshot's ready nodes, name-sorted (the encoder's
    node order). ``scalars[attr]`` maps scalar resource name -> [N] array;
    attrs are "idle" / "used" / "alloc".

    The axis is LONG-LIVED when owned by the snapshot keeper
    (cache/snapkeeper.py): rows are patched in place between sessions for
    the nodes that actually changed, and ``epoch`` counts content changes
    so downstream caches (the encoder's node matrices, the solver's packed
    buffers) can trust an unchanged-epoch axis without re-reading it."""

    __slots__ = ("names", "nodes", "gens", "flags", "cpu", "mem",
                 "scalars", "scalar_names", "node_cnt", "max_tasks",
                 "epoch", "mat_cache")

    def __init__(self, names: List[str], nodes: list, gens: np.ndarray,
                 flags: np.ndarray, cpu: Dict[str, np.ndarray],
                 mem: Dict[str, np.ndarray],
                 scalars: Dict[str, Dict[str, np.ndarray]],
                 scalar_names: List[str],
                 node_cnt: np.ndarray, max_tasks: np.ndarray):
        self.names = names
        self.nodes = nodes
        self.gens = gens
        self.flags = flags
        self.cpu = cpu
        self.mem = mem
        self.scalars = scalars
        self.scalar_names = scalar_names
        self.node_cnt = node_cnt
        self.max_tasks = max_tasks
        self.epoch = 0
        # encoder-side memo of derived per-epoch products (node matrices);
        # invalidated wholesale when epoch moves (encoder._node_matrix)
        self.mat_cache: dict = {}

    def total_alloc(self):
        """Cluster-total allocatable as (milli_cpu, memory, {scalar: sum})
        — the columnar replacement for the per-node Resource.add loop the
        drf/proportion session-open passes used to run (drf.go:78-80).
        max_task_num deliberately excluded, as Resource.add excludes it."""
        return (
            float(self.cpu["alloc"].sum()),
            float(self.mem["alloc"].sum()),
            {rn: float(col.sum())
             for rn, col in self.scalars["alloc"].items()},
        )

    def add_total_into(self, res) -> None:
        """res += cluster-total allocatable (columnar). The one shared
        implementation of the axis-vs-walk totaling fold for session-open
        plugins (drf/proportion)."""
        mc, mem, scal = self.total_alloc()
        res.milli_cpu += mc
        res.memory += mem
        for rn, q in scal.items():
            res.add_scalar(rn, q)

    def validate(self) -> bool:
        """True when every captured node's accounting generation is
        unchanged (nothing mutated node state since snapshot)."""
        nodes = self.nodes
        n = len(nodes)
        if n == 0:
            return True
        gens = np.fromiter((nd._acct_gen for nd in nodes), np.int64, n)
        return bool(np.array_equal(gens, self.gens))


def add_total_allocatable(ssn, res) -> None:
    """res += total allocatable over the session's ready nodes, via the
    snapshot-captured axis when it is still generation-valid, else the
    per-node walk. Shared by drf/proportion on_session_open."""
    axis = getattr(ssn, "node_axis", None)
    if axis is not None and axis.validate():
        axis.add_total_into(res)
    else:
        for node in ssn.nodes.values():
            res.add(node.allocatable)


def _node_flag_bits(info) -> int:
    node = info.node
    bits = 0
    if node is not None:
        for cond in node.status.conditions:
            if cond.status != "True":
                continue
            if cond.type == "Ready":
                bits |= int(F_READY)
            elif cond.type == "NetworkUnavailable":
                bits |= int(F_NET_UNAVAILABLE)
            elif cond.type == "MemoryPressure":
                bits |= int(F_MEM_PRESSURE)
            elif cond.type == "DiskPressure":
                bits |= int(F_DISK_PRESSURE)
            elif cond.type == "PIDPressure":
                bits |= int(F_PID_PRESSURE)
        if node.spec.unschedulable:
            bits |= int(F_UNSCHEDULABLE)
        if any(t.effect in ("NoSchedule", "NoExecute")
               for t in node.spec.taints):
            bits |= int(F_BLOCKING_TAINTS)
    if not info.releasing.is_empty():
        bits |= int(F_RELEASING)
    if info.tasks:
        bits |= int(F_RESIDENT_PODS)
    return bits


def refresh_rows(axis: NodeAxis, updates) -> bool:
    """Patch the axis in place for ``updates`` = [(row_index, node), ...]
    (the snapshot keeper's dirty rows). Returns False when a node carries a
    scalar resource the axis has no column for — the caller must fall back
    to a full ``capture_node_axis`` (new resource dimensions reshape every
    scalar column). Bumps ``epoch`` and drops the derived-matrix memo."""
    scalar_set = set(axis.scalar_names)
    for _, nd in updates:
        for field in ("idle", "used", "allocatable"):
            sr = getattr(nd, field).scalar_resources
            if sr and not scalar_set.issuperset(sr):
                return False
    for i, nd in updates:
        axis.nodes[i] = nd
        axis.gens[i] = nd._acct_gen
        axis.flags[i] = _node_flag_bits(nd)
        axis.node_cnt[i] = len(nd.tasks)
        axis.max_tasks[i] = nd.allocatable.max_task_num
        for attr, field in (("idle", "idle"), ("used", "used"),
                            ("alloc", "allocatable")):
            r = getattr(nd, field)
            axis.cpu[attr][i] = r.milli_cpu
            axis.mem[attr][i] = r.memory
            cols = axis.scalars[attr]
            sr = r.scalar_resources
            for rn, col in cols.items():
                col[i] = sr.get(rn, 0.0) if sr else 0.0
    if updates:
        # the axis epoch is a DERIVED channel: rows only refresh after
        # the keeper's marks / _acct_gen sweep already moved the sealed
        # dirty-epoch and acct-sum components, so the fingerprint covers
        # it transitively (it memo-keys encoder matrices, nothing else)
        axis.epoch += 1  # vclint: disable=VT009 - derived memo key; sealed transitively via dirty_epoch + acct sum
        axis.mat_cache.clear()
    return True


def capture_node_axis(nodes_by_name: Dict[str, object]) -> Optional[NodeAxis]:
    """Build the columnar axis from the snapshot's (already cloned) ready
    nodes. Called by cache.snapshot() — the one place that already walks
    every node each cycle."""
    names = sorted(nodes_by_name)
    nodes = [nodes_by_name[n] for n in names]
    n = len(nodes)
    gens = np.fromiter((nd._acct_gen for nd in nodes), np.int64, n) \
        if n else np.zeros(0, np.int64)
    flags = np.fromiter((_node_flag_bits(nd) for nd in nodes), np.uint16, n) \
        if n else np.zeros(0, np.uint16)

    cpu: Dict[str, np.ndarray] = {}
    mem: Dict[str, np.ndarray] = {}
    scalars: Dict[str, Dict[str, np.ndarray]] = {}
    scalar_name_set: set = set()
    attr_objs = {}
    for attr, field in (("idle", "idle"), ("used", "used"),
                        ("alloc", "allocatable")):
        ress = [getattr(nd, field) for nd in nodes]
        attr_objs[attr] = ress
        cpu[attr] = np.array([r.milli_cpu for r in ress], np.float64)
        mem[attr] = np.array([r.memory for r in ress], np.float64)
        for r in ress:
            if r.scalar_resources:
                scalar_name_set.update(r.scalar_resources)
    for attr in ("idle", "used", "alloc"):
        cols = scalars[attr] = {}
        if scalar_name_set:
            ress = attr_objs[attr]
            for rn in sorted(scalar_name_set):
                cols[rn] = np.array(
                    [(r.scalar_resources or {}).get(rn, 0.0) for r in ress],
                    np.float64)

    node_cnt = np.fromiter((len(nd.tasks) for nd in nodes), np.int32, n) \
        if n else np.zeros(0, np.int32)
    max_tasks = np.fromiter(
        (nd.allocatable.max_task_num for nd in nodes), np.int32, n) \
        if n else np.zeros(0, np.int32)
    return NodeAxis(names, nodes, gens, flags, cpu, mem, scalars,
                    sorted(scalar_name_set), node_cnt, max_tasks)
