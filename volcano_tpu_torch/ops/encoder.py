"""Session -> dense-tensor encoder for the TPU allocate solver.

Packs the scheduler session (volcano pkg/scheduler/framework/session.go:37)
into the arrays consumed by ops.kernels.solve_allocate. Key ideas:

- **Predicate signatures**: pods stamped from one template share
  node-selector / affinity / toleration constraints, so static feasibility is
  an (S x N) mask with S << T instead of (T x N) — the inter-pod-affinity
  precompute suggested by the reference's own hot-loop analysis
  (predicates.go:281-299 is O(pods x nodes) in Go; here it's S host
  evaluations).
- **Exact order keys**: job/queue/namespace comparators
  (session_plugins.go:287-440) become rank arrays; dynamic keys (DRF share,
  gang readiness, proportion queue share) are recomputed on device each
  visit.
- **Fallback honesty**: any construct the kernel does not model (releasing
  resources -> pipelining, pod (anti-)affinity, host ports, unknown plugins
  on order/predicate/score extension points) raises EncoderFallback and the
  action runs the serial oracle loop instead.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cmp_to_key
from typing import Dict, List, Optional, Tuple

import numpy as np

from volcano_tpu_torch.api import objects
from volcano_tpu_torch.api.job_info import JobInfo, TaskInfo
from volcano_tpu_torch.api.node_info import NodeInfo
from volcano_tpu_torch.api.resource import (
    MIN_MEMORY,
    MIN_MILLI_CPU,
    MIN_MILLI_SCALAR,
    Resource,
)
from volcano_tpu_torch.api.types import TaskStatus
from volcano_tpu_torch.ops.kernels import SolveSpec
from volcano_tpu_torch.scheduler import conf
from volcano_tpu_torch.scheduler.plugins import nodeorder as nodeorder_mod
from volcano_tpu_torch.scheduler.plugins import predicates as predicates_mod

SUPPORTED_JOB_ORDER = ("priority", "gang", "drf")
SUPPORTED_QUEUE_ORDER = ("proportion",)
SUPPORTED_NODE_ORDER = ("nodeorder", "binpack")
SUPPORTED_PREDICATES = ("predicates",)
SUPPORTED_OVERUSED = ("proportion",)
SUPPORTED_JOB_READY = ("gang",)


class EncoderFallback(Exception):
    """The session uses a construct the batch kernel does not model; the
    caller must run the serial oracle loop."""


def _enabled_plugins(ssn, flag_name: str, fns: Dict) -> List[str]:
    """Plugin names with a registered fn and an enabled flag, in tier order
    (mirrors Session._tier_plugins)."""
    out = []
    for tier in ssn.tiers:
        for plugin in tier.plugins:
            if flag_name is not None and not conf.enabled(getattr(plugin, flag_name)):
                continue
            if plugin.name in fns:
                out.append(plugin.name)
    return out


def _plugin_args(ssn, name: str):
    from volcano_tpu_torch.scheduler.framework.arguments import Arguments

    for tier in ssn.tiers:
        for plugin in tier.plugins:
            if plugin.name == name:
                return Arguments(plugin.arguments)
    return Arguments({})


@dataclass
class EncodedSnapshot:
    spec: SolveSpec
    arrays: Dict[str, np.ndarray]
    # decode maps
    task_infos: List[TaskInfo] = field(default_factory=list)
    job_infos: List[JobInfo] = field(default_factory=list)
    node_names: List[str] = field(default_factory=list)
    resource_names: List[str] = field(default_factory=list)
    ns_names: List[str] = field(default_factory=list)
    queue_uids: List[str] = field(default_factory=list)
    num_to_find: int = 0
    rr0: int = 0
    # residue: pending tasks excluded from the device solve (pod affinity /
    # host ports) — left PENDING for the serial pass that runs after the
    # bulk apply; job_residue[j] counts them per encoded job
    residue_count: int = 0
    job_residue: Optional[np.ndarray] = None
    has_releasing: bool = False

    @property
    def shape(self) -> Tuple[int, ...]:
        return (
            len(self.task_infos),
            len(self.node_names),
            len(self.job_infos),
            self.arrays["queue_deserved"].shape[0],
            self.arrays["ns_active0"].shape[0],
            self.arrays["sig_mask"].shape[0],
        )


# trait helpers live in api/pod_traits.py (shared with the cache's columnar
# pod table); aliased here for the existing call sites
from volcano_tpu_torch.api.pod_traits import (  # noqa: E402
    has_host_ports as _has_host_ports,
    has_pod_affinity as _has_pod_affinity,
    pod_encode_traits as _pod_encode_traits,
    signature_key as _signature_key,
)


def _static_node_ok(node: NodeInfo, memory_p: bool, disk_p: bool, pid_p: bool) -> bool:
    """Task-independent predicate parts (predicates.py lines on node
    conditions / unschedulable / pressure)."""
    if not predicates_mod._node_condition(node, "Ready"):
        return False
    if predicates_mod._node_condition(node, "NetworkUnavailable"):
        return False
    if node.node is not None and node.node.spec.unschedulable:
        return False
    if memory_p and predicates_mod._node_condition(node, "MemoryPressure"):
        return False
    if disk_p and predicates_mod._node_condition(node, "DiskPressure"):
        return False
    if pid_p and predicates_mod._node_condition(node, "PIDPressure"):
        return False
    return True


def _resource_vec(res: Resource, names: List[str]) -> np.ndarray:
    return np.array([res.get(n) for n in names], np.float64)


# R -> (eps, is_scalar, res_unit); tiny and bounded by the handful of
# resource dimensionalities a deployment ever sees
_CONF_ARRAYS: Dict[int, tuple] = {}


def _conf_arrays(R: int) -> tuple:
    cached = _CONF_ARRAYS.get(R)
    if cached is None:
        eps = np.array(
            [MIN_MILLI_CPU, MIN_MEMORY] + [MIN_MILLI_SCALAR] * (R - 2),
            np.float64)
        is_scalar = np.array([False, False] + [True] * (R - 2))
        # integer quantization units for the rounds solver's exact cumsums:
        # milli-cpu, MiB, milli-scalar (eps/res_unit == 10 in every dim)
        res_unit = np.array([1.0, 1024.0 * 1024.0] + [1.0] * (R - 2),
                            np.float64)
        cached = _CONF_ARRAYS[R] = (eps, is_scalar, res_unit)
    return cached


def _qualifying_anti_terms(pod, batch_on: bool):
    """The required anti-affinity terms of `pod` IF it is device-placeable
    as an exclusion group member, else None.

    Qualifying shape (the common "at most one per node" pattern —
    reference predicates.go:281-299 workloads): every required term has a
    match_labels-only selector over the pod's own namespace scope with
    hostname topology, the pod matches its own selectors (so group members
    mutually exclude), there is no positive pod_affinity, and no preferred
    pod terms when the InterPodAffinity batch scorer is live (those move
    node scores, which the device solve would miss)."""
    aff = pod.spec.affinity
    if aff is None or aff.pod_anti_affinity is None:
        return None
    if aff.pod_affinity is not None:
        return None
    anti = aff.pod_anti_affinity
    if not anti.required_terms:
        return None
    if batch_on and anti.preferred_terms:
        return None
    labels = pod.metadata.labels
    for term in anti.required_terms:
        sel = term.label_selector
        if sel is None or sel.match_expressions or not sel.match_labels:
            return None
        if term.topology_key != "kubernetes.io/hostname":
            return None
        if term.namespaces and list(term.namespaces) != [pod.metadata.namespace]:
            return None
        if any(labels.get(k) != v for k, v in sel.match_labels.items()):
            return None  # pod must self-match (mutual exclusion)
    return anti.required_terms


def _single_host_port(pod):
    """The pod's (host_port, protocol) when it uses exactly ONE, else None
    (multi-port pods keep the serial residue path — the kernel carries one
    exclusion group per task)."""
    ports = [(p.host_port, p.protocol)
             for c in pod.spec.containers for p in c.ports if p.host_port > 0]
    return ports[0] if len(ports) == 1 else None


def _promote_exclusive(all_tasks, cand_idx, bulk_universe_idx, nodes,
                       batch_on, port_idx=()):
    """Try to promote affinity-flagged (and single-hostPort) pending tasks
    into device-placeable exclusion groups. Returns (gid_of: dict
    task_index -> group id, occ_rows: list of np.bool_[N] initial
    occupancy per group).

    A label group (keyed by its canonical term set) is promoted only when
    EVERY device-bound pending task matching any of its selectors carries
    the same key — otherwise a plain matcher placed by the bulk solve
    could land beside a group member without the kernel knowing (the
    serial residue pass would have seen it as resident). Port groups need
    no closure: every device-bound user of (port, protocol) is in the
    group by construction, and multi-port pods stay residue (placed after
    the bulk, they see device placements as residents). Demotion is always
    safe: it is exactly today's residue behavior."""
    # candidate classification
    keys: dict = {}
    members: dict = {}
    terms_of: dict = {}
    for ti in cand_idx:
        pod = all_tasks[ti].pod
        terms = _qualifying_anti_terms(pod, batch_on)
        if terms is None:
            continue
        key = tuple(sorted(
            (frozenset(t.label_selector.match_labels.items()),
             pod.metadata.namespace)
            for t in terms))
        keys[ti] = key
        members.setdefault(key, []).append(ti)
        terms_of.setdefault(key, (pod.metadata.namespace, terms))
    port_keys: dict = {}
    for ti in port_idx:
        pod = all_tasks[ti].pod
        hp = _single_host_port(pod)
        if hp is None:
            continue
        key = ("port", hp[0], hp[1])
        port_keys[ti] = key
        members.setdefault(key, []).append(ti)
    if not members:
        return {}, []

    # closure check: label-pair -> device-bound task indices (the plain
    # bulk set plus every qualifying candidate, INCLUDING port-promoted
    # pods — they are device-placed too and may carry labels a label
    # group's selector matches)
    pair_map: dict = {}
    universe = set(bulk_universe_idx) | set(keys) | set(port_keys)
    # sorted: pair_map candidate lists must not inherit set order, or two
    # replicas of the same snapshot could walk closure checks differently
    for ti in sorted(universe):
        pod = all_tasks[ti].pod
        if pod is None:
            continue
        ns = pod.metadata.namespace
        for k, v in pod.metadata.labels.items():
            pair_map.setdefault((ns, k, v), []).append(ti)
    demoted = set()
    for key, (ns, terms) in terms_of.items():
        for term in terms:
            pairs = list(term.label_selector.match_labels.items())
            cands = pair_map.get((ns, pairs[0][0], pairs[0][1]), [])
            for ti in cands:
                pod = all_tasks[ti].pod
                if any(pod.metadata.labels.get(k) != v for k, v in pairs):
                    continue
                if keys.get(ti) != key:
                    demoted.add(key)
                    break
            if key in demoted:
                break
    live = [key for key in members
            if key not in demoted and (key in terms_of or key[0] == "port")]
    if not live:
        return {}, []

    # initial occupancy from residents matching a group selector / holding
    # the group's host port; bail out of promotion wholesale if the scan
    # would be quadratic-scale
    n_res = sum(len(nd.tasks) for nd in nodes)
    if n_res * len(live) > 2_000_000:
        return {}, []
    gid = {key: g for g, key in enumerate(live)}
    occ_rows = [np.zeros(len(nodes), bool) for _ in live]
    label_live = [k for k in live if k in terms_of]
    port_live = [(k, gid[k]) for k in live if k not in terms_of]
    for ni, nd in enumerate(nodes):
        for t in nd.tasks.values():
            pod = t.pod
            if pod is None:
                continue
            ns = pod.metadata.namespace
            labels = pod.metadata.labels
            for key in label_live:
                kns, terms = terms_of[key]
                if ns != kns:
                    continue
                for term in terms:
                    if all(labels.get(k) == v
                           for k, v in term.label_selector.match_labels.items()):
                        occ_rows[gid[key]][ni] = True
                        break
            if port_live:
                used = {(p.host_port, p.protocol)
                        for c in pod.spec.containers
                        for p in c.ports if p.host_port > 0}
                if used:
                    for key, g in port_live:
                        if (key[1], key[2]) in used:
                            occ_rows[g][ni] = True
    gid_of = {ti: gid[key] for ti, key in keys.items() if key in gid}
    gid_of.update({ti: gid[key] for ti, key in port_keys.items()
                   if key in gid})
    return gid_of, occ_rows


def _fast_task_axis(jobs, j_count, nodes, table, prio_on, allow_residue,
                    batch_on=False, node_scalars=None):
    """Columnar task axis: validated gathers from the cache's pod table
    instead of walking task objects. Returns the tuple encode_session
    unpacks, or None to fall back (stale rows, rowless tasks).

    Semantics match the object walk exactly: same (job, -priority, ctime,
    uid) order, same residue rules, same per-job contiguity; only the
    session-signature NUMBERING differs (table-id order instead of
    first-encounter order), which nothing downstream depends on."""
    from volcano_tpu_torch.scheduler.cache.podtable import (
        FLAG_AFFINITY, FLAG_PORTS, FLAG_PVC, FLAG_REQ_EMPTY)

    from itertools import chain

    all_tasks: List[TaskInfo] = []
    rows_parts: list = []
    gens_parts: list = []
    nz_jobs: list = []
    nz_counts: list = []
    for ji, job in enumerate(jobs):
        # clone-captured columnar pending axis (job_info.py pending_axis):
        # no per-task walk unless the status index moved since snapshot
        ax = job.pending_axis() if hasattr(job, "pending_axis") else None
        if ax is not None:
            t_l, r_l, g_l = ax
            if not t_l:
                continue
        else:
            pend = job.task_status_index.get(TaskStatus.PENDING)
            if not pend:
                continue
            t_l = list(pend.values())
            r_l = [t.row for t in t_l]
            g_l = [t.row_gen for t in t_l]
        all_tasks.extend(t_l)
        rows_parts.append(r_l)
        gens_parts.append(g_l)
        nz_jobs.append(ji)
        nz_counts.append(len(t_l))
    p_count = len(all_tasks)
    if p_count == 0:
        return None  # legacy handles the empty axis trivially

    rows = np.fromiter(chain.from_iterable(rows_parts), np.int64, p_count)
    if rows.min() < 0:
        return None  # task(s) without table rows (podless) — object walk
    gens = np.fromiter(chain.from_iterable(gens_parts), np.int64, p_count)
    job_of_arr = np.repeat(np.asarray(nz_jobs, np.int64),
                           np.asarray(nz_counts, np.int64))

    scalar_set = set(table.scalar_names())
    if node_scalars is not None:
        # snapshot node-axis capture already unioned the node scalars
        # (may over-include all-zero dims — harmless, same caveat as
        # table.scalar_names)
        scalar_set.update(node_scalars)
    else:
        for node in nodes:
            if node.allocatable.scalar_resources:
                scalar_set.update(node.allocatable.scalar_resources)
    rnames = ["cpu", "memory", *sorted(scalar_set)]
    R = len(rnames)

    g = table.gather(rows, gens, rnames[2:])
    if g is None:
        return None  # rows went stale between snapshot and encode

    flags = g["flags"]
    nonempty = (flags & FLAG_REQ_EMPTY) == 0
    sub = np.nonzero(nonempty)[0] if not nonempty.all() \
        else np.arange(p_count)
    if sub.size == 0:
        return None
    uid = g["uid"]  # table-maintained object column; no per-session build
    prio = g["priority"] if prio_on else np.zeros(p_count, np.int64)
    order = np.lexsort(
        (uid[sub], g["ctime"][sub], -prio[sub], job_of_arr[sub]))
    sel = sub[order]  # indices into all_tasks, job-major sorted

    residue = ((flags & (FLAG_PORTS | FLAG_AFFINITY | FLAG_PVC)) != 0)[sel]
    task_excl = None
    excl_occ_rows: list = []
    if residue.any():
        if not allow_residue:
            # match the object walk's error specificity
            first = sel[np.argmax(residue)]
            if flags[first] & FLAG_AFFINITY:
                raise EncoderFallback("pod (anti-)affinity not modeled")
            raise EncoderFallback("host ports not modeled")
        # exclusion-group promotion: qualifying required-anti-affinity pods
        # (hostname topology, self-matching match_labels selectors) place
        # ON DEVICE under a per-(group, node) occupancy constraint instead
        # of the serial residue pass; ports / non-qualifying shapes remain
        # residue (FLAG_PORTS also set => stays residue: ports are live-
        # checked only serially)
        aff_only = ((flags[sel] & FLAG_AFFINITY) != 0) & \
            ((flags[sel] & (FLAG_PORTS | FLAG_PVC)) == 0) & residue
        ports_only = ((flags[sel] & FLAG_PORTS) != 0) & \
            ((flags[sel] & (FLAG_AFFINITY | FLAG_PVC)) == 0) & residue
        cand_idx = [int(sel[i]) for i in np.nonzero(aff_only)[0]]
        port_idx = [int(sel[i]) for i in np.nonzero(ports_only)[0]]
        keep_plain = [int(sel[i]) for i in np.nonzero(~residue)[0]]
        gid_of, excl_occ_rows = _promote_exclusive(
            all_tasks, cand_idx, keep_plain, nodes, batch_on,
            port_idx=port_idx)
        keep_mask = ~residue
        if gid_of:
            # vectorized promotion lookup: a per-task-id gid table beats
            # ~2 x O(T) Python dict probes on the columnar path
            gid_table = np.full(p_count, -1, np.int32)
            for ti, grp in gid_of.items():
                gid_table[ti] = grp
            keep_mask = keep_mask | (gid_table[sel] >= 0)
            keep = sel[keep_mask]
            task_excl = gid_table[keep]
        else:
            keep = sel[keep_mask]
            task_excl = np.full(keep.size, -1, np.int32)
        job_residue = np.bincount(
            job_of_arr[sel[~keep_mask]], minlength=j_count).astype(np.int32)
    else:
        keep = sel
        job_residue = np.zeros(j_count, np.int32)

    task_infos = [all_tasks[i] for i in keep]
    t_count = len(task_infos)
    if task_excl is None:
        task_excl = np.full(t_count, -1, np.int32)

    # session signature ids from table-global ids (numbering differs from
    # the object walk's first-encounter order; content is identical).
    # Table ids are small dense ints, so the dedup is bounded-id remapping
    # (three O(T)+O(S) passes) instead of np.unique's O(T log T) sort;
    # reversed assignment leaves each id's FIRST occurrence index.
    tsig = g["sig_id"][keep]
    nsig = int(tsig.max()) + 1 if tsig.size else 1
    first = np.zeros(nsig, np.int64)
    first[tsig[::-1]] = np.arange(tsig.size - 1, -1, -1, dtype=np.int64)
    present = np.zeros(nsig, bool)
    present[tsig] = True
    uniq = np.nonzero(present)[0]
    remap = np.zeros(nsig, np.int32)
    remap[uniq] = np.arange(uniq.size, dtype=np.int32)
    task_sig_arr = remap[tsig]
    first_idx = first[uniq]
    sig_rep = [task_infos[i] for i in first_idx]

    task_req = np.zeros((t_count, R), np.float64)
    task_initreq = np.zeros((t_count, R), np.float64)
    task_req[:, 0] = g["cpu"][keep]
    task_req[:, 1] = g["mem"][keep]
    task_initreq[:, 0] = g["init_cpu"][keep]
    task_initreq[:, 1] = g["init_mem"][keep]
    for si, rn in enumerate(rnames[2:], start=2):
        task_req[:, si] = g["scalars"][rn][keep]
        task_initreq[:, si] = g["init_scalars"][rn][keep]

    kept_jobs = job_of_arr[keep]
    job_task_count = np.bincount(kept_jobs, minlength=j_count).astype(np.int32)
    # kept tasks are job-major contiguous, so starts are the prefix sums
    job_task_start = np.zeros(j_count, np.int32)
    if j_count:
        np.cumsum(job_task_count[:-1], out=job_task_start[1:])

    return (rnames, task_infos, sig_rep, task_sig_arr,
            job_task_start, job_task_count, job_residue,
            task_req, task_initreq, task_excl, excl_occ_rows)


def encode_session(ssn, allow_residue: bool = False) -> EncodedSnapshot:
    """Build the dense solve inputs from a live session.

    Raises EncoderFallback when the session cannot be modeled; the allocate
    action then runs its serial loop (the parity oracle).

    With ``allow_residue`` (the rounds path), constructs the kernel does not
    model stop being session-wide cliffs:
    - pending tasks with pod (anti-)affinity or host ports are EXCLUDED
      from the device solve and left PENDING for a serial residue pass
      (full predicate fidelity at per-task cost);
    - nodes holding releasing capacity no longer abort encoding — the bulk
      solve places against idle only (conservative) and the serial pass
      pipelines leftovers onto releasing capacity;
    - required anti-affinity terms of EXISTING pods are honored for the
      bulk tasks through host-precomputed per-signature node masks (the
      predicates plugin's symmetry rule, predicates.go:281-299); soft
      (preferred) inter-pod terms only shift nodeorder scores and are a
      documented rounds-mode divergence.
    """
    from volcano_tpu_torch.scheduler.util import scheduler_helper

    # ---- capability checks -------------------------------------------------
    ns_order = _enabled_plugins(ssn, "enabled_namespace_order", ssn.namespace_order_fns)
    if any(p != "drf" for p in ns_order):
        raise EncoderFallback(f"unsupported namespace-order plugins: {ns_order}")
    if ssn.node_map_fns or ssn.node_reduce_fns:
        raise EncoderFallback("node map/reduce fns are not modeled")

    job_order = _enabled_plugins(ssn, "enabled_job_order", ssn.job_order_fns)
    if any(p not in SUPPORTED_JOB_ORDER for p in job_order):
        raise EncoderFallback(f"unsupported job-order plugins: {job_order}")
    queue_order = _enabled_plugins(ssn, "enabled_queue_order", ssn.queue_order_fns)
    if any(p not in SUPPORTED_QUEUE_ORDER for p in queue_order):
        raise EncoderFallback(f"unsupported queue-order plugins: {queue_order}")
    node_order = _enabled_plugins(ssn, "enabled_node_order", ssn.node_order_fns)
    if any(p not in SUPPORTED_NODE_ORDER for p in node_order):
        raise EncoderFallback(f"unsupported node-order plugins: {node_order}")
    predicates_on = _enabled_plugins(ssn, "enabled_predicate", ssn.predicate_fns)
    if any(p not in SUPPORTED_PREDICATES for p in predicates_on):
        raise EncoderFallback(f"unsupported predicate plugins: {predicates_on}")
    overused = _enabled_plugins(ssn, None, ssn.overused_fns)
    if any(p not in SUPPORTED_OVERUSED for p in overused):
        raise EncoderFallback(f"unsupported overused plugins: {overused}")
    job_ready = _enabled_plugins(ssn, "enabled_job_ready", ssn.job_ready_fns)
    if any(p not in SUPPORTED_JOB_READY for p in job_ready):
        raise EncoderFallback(f"unsupported job-ready plugins: {job_ready}")
    batch_order = _enabled_plugins(ssn, "enabled_node_order", ssn.batch_node_order_fns)
    if any(p not in ("nodeorder",) for p in batch_order):
        raise EncoderFallback(f"unsupported batch-node-order plugins: {batch_order}")

    # ---- node axis (name-sorted, = util.get_node_list order) ---------------
    # snapshot-captured columnar axis (cache/nodeaxis.py): valid only while
    # every node's accounting generation matches the capture — any session
    # mutation since snapshot falls back to the object walks below
    from volcano_tpu_torch.scheduler.cache import nodeaxis as _na

    axis = getattr(ssn, "node_axis", None)
    if axis is not None and (
            len(axis.names) != len(ssn.nodes) or not axis.validate()):
        axis = None
    if axis is not None:
        node_names = axis.names
        nodes = axis.nodes
        n_count = len(nodes)
        axis_flags = axis.flags
        has_releasing = bool((axis_flags & _na.F_RELEASING).any())
        if has_releasing and not allow_residue:
            raise EncoderFallback("releasing resources (pipeline path) not modeled")
        resident_idx = np.nonzero(axis_flags & _na.F_RESIDENT_PODS)[0]
    else:
        node_names = sorted(ssn.nodes)
        nodes = [ssn.nodes[n] for n in node_names]
        n_count = len(nodes)
        has_releasing = False
        for node in nodes:
            if not node.releasing.is_empty():
                if not allow_residue:
                    raise EncoderFallback(
                        "releasing resources (pipeline path) not modeled")
                has_releasing = True
        resident_idx = [ni for ni, node in enumerate(nodes) if node.tasks]
    sym_terms = []  # (anti-affinity term, owner namespace, node index)
    for ni in resident_idx:
        for t in nodes[ni].tasks.values():
            if t.pod is None:
                continue
            _, ports, aff = _pod_encode_traits(t.pod)
            if ports and not allow_residue:
                # existing ports only constrain residue tasks, which the
                # serial pass checks with full fidelity
                raise EncoderFallback("host ports not modeled")
            if aff:
                if not allow_residue:
                    raise EncoderFallback("pod (anti-)affinity not modeled")
                affinity = t.pod.spec.affinity
                if affinity.pod_anti_affinity is not None:
                    for term in affinity.pod_anti_affinity.required_terms:
                        sym_terms.append((term, t.pod.metadata.namespace, ni))

    # ---- eligible jobs (allocate.go:49-76 filter) --------------------------
    # when the registered validators are exactly the stock gang one, its
    # verdict is `valid_task_num >= min_available` (gang.py valid_job_fn) —
    # inlining it skips the per-job dispatch machinery (memo gate, flat-fn
    # loop, ValidateResult) on the encode hot path; any other validator set
    # keeps the full session dispatch
    valid_plugins = _enabled_plugins(ssn, None, ssn.job_valid_fns) \
        if hasattr(ssn, "job_valid_fns") else None
    gang_only_valid = valid_plugins == ["gang"]
    jobs: List[JobInfo] = []
    ssn_queues = ssn.queues
    for job in ssn.jobs.values():
        if job.pod_group is None or job.pod_group.status.phase == objects.PodGroupPhase.PENDING:
            continue
        if gang_only_valid:
            if job.valid_task_num() < job.min_available:
                continue
        else:
            vr = ssn.job_valid(job)
            if vr is not None and not vr.pass_:
                continue
        if job.queue not in ssn_queues:
            continue
        jobs.append(job)
    j_count = len(jobs)

    # with live anti-affinity symmetry terms, mask membership depends on a
    # pod's labels AND namespace (selector matching) — extend the signature
    # key so all pods sharing a signature also share symmetry verdicts
    # (otherwise an unlabeled representative could unmask labeled pods, or
    # vice versa)
    sym_active = bool(sym_terms)
    task_order_plugins = set(
        _enabled_plugins(ssn, "enabled_task_order", ssn.task_order_fns))

    # ---- flat task axis ----------------------------------------------------
    # fast path: the cache's columnar pod table (podtable.py) already holds
    # requests/priority/ctime/traits/signatures per pod — the whole task
    # axis becomes validated numpy gathers. Falls back to the object walk
    # when rows went stale, tasks lack rows, symmetry terms are live, or a
    # custom task-order plugin needs its comparator.
    table = getattr(getattr(ssn, "cache", None), "pod_table", None)
    fast = None
    if table is not None and not sym_active and task_order_plugins <= {"priority"}:
        fast = _fast_task_axis(
            jobs, j_count, nodes, table, bool(task_order_plugins),
            allow_residue, batch_on="nodeorder" in batch_order,
            node_scalars=axis.scalar_names if axis is not None else None)

    excl_occ_rows: list = []
    if fast is not None:
        (rnames, task_infos, sig_rep, task_sig_arr,
         job_task_start, job_task_count, job_residue,
         task_req, task_initreq, task_excl, excl_occ_rows) = fast
        R = len(rnames)
        t_count = len(task_infos)
        s_count = max(len(sig_rep), 1)
        task_has_pod = np.ones(t_count, bool)
    else:
        # resource dimensionality: cpu, memory + every scalar seen
        scalar_names: set = set()
        for job in jobs:
            for task in job.tasks.values():
                if task.resreq.scalar_resources:
                    scalar_names.update(task.resreq.scalar_resources)
                if task.init_resreq.scalar_resources:
                    scalar_names.update(task.init_resreq.scalar_resources)
        for node in nodes:
            if node.allocatable.scalar_resources:
                scalar_names.update(node.allocatable.scalar_resources)
        rnames = ["cpu", "memory", *sorted(scalar_names)]
        R = len(rnames)

        task_infos = []
        job_task_start = np.zeros(j_count, np.int32)
        job_task_count = np.zeros(j_count, np.int32)
        sig_index: Dict[str, int] = {}
        sig_rep = []
        task_sig: List[int] = []

        def order_key(a: TaskInfo, b: TaskInfo) -> int:
            return -1 if ssn.task_order_fn(a, b) else (1 if ssn.task_order_fn(b, a) else 0)

        # gather every job's pending tasks-with-requests (job-major, so each
        # job's block is contiguous after the job-primary sort below)
        all_tasks: List[TaskInfo] = []
        job_of: List[int] = []
        for ji, job in enumerate(jobs):
            pend = job.task_status_index.get(TaskStatus.PENDING)
            if not pend:
                continue
            for t in pend.values():
                if not t.resreq.is_empty():
                    all_tasks.append(t)
                    job_of.append(ji)
        p_count = len(all_tasks)

        # the priority plugin is the only stock task-order fn; its
        # comparator is exactly this key tuple (priority.py:20-24 + the
        # session creation/uid tie-break), so ONE C-level lexsort replaces
        # J per-job comparator sorts
        if p_count == 0:
            order: List[int] = []
        elif task_order_plugins <= {"priority"}:
            prio = (np.fromiter((t.priority for t in all_tasks), np.int64, p_count)
                    if task_order_plugins else np.zeros(p_count, np.int64))
            ctime = np.fromiter(
                ((t.pod.metadata.creation_timestamp if t.pod is not None else 0.0)
                 for t in all_tasks), np.float64, p_count)
            uid = np.array([t.uid for t in all_tasks])
            order = np.lexsort(
                (uid, ctime, -prio, np.asarray(job_of, np.int64))).tolist()
        else:
            # custom task-order fns: per-job comparator sort (job blocks
            # are contiguous in job_of by construction)
            order = []
            lo = 0
            while lo < p_count:
                hi = lo
                while hi < p_count and job_of[hi] == job_of[lo]:
                    hi += 1
                idxs = sorted(range(lo, hi),
                              key=cmp_to_key(
                                  lambda x, y: order_key(all_tasks[x], all_tasks[y])))
                order.extend(idxs)
                lo = hi

        job_residue = np.zeros(j_count, np.int32)
        cur_ji = -1
        for oi in order:
            t = all_tasks[oi]
            ji = job_of[oi]
            if ji != cur_ji:
                if cur_ji >= 0:
                    job_task_count[cur_ji] = len(task_infos) - int(job_task_start[cur_ji])
                job_task_start[ji] = len(task_infos)
                cur_ji = ji
            if t.pod is None:
                key = "<none>"
            else:
                key, ports, aff = _pod_encode_traits(t.pod)
                if aff:
                    if not allow_residue:
                        raise EncoderFallback("pod (anti-)affinity not modeled")
                    job_residue[ji] += 1
                    continue
                if ports:
                    if not allow_residue:
                        raise EncoderFallback("host ports not modeled")
                    job_residue[ji] += 1
                    continue
                if any(v.persistent_volume_claim
                       for v in t.pod.spec.volumes):
                    # volume assume/bind is live per-host logic
                    # (StoreVolumeBinder); the serial pass owns it
                    if not allow_residue:
                        raise EncoderFallback("pod volumes not modeled")
                    job_residue[ji] += 1
                    continue
                if sym_active:
                    key = (f"{key}|labels={sorted(t.pod.metadata.labels.items())!r}"
                           f"|ns={t.pod.metadata.namespace}")
            si = sig_index.get(key)
            if si is None:
                si = sig_index[key] = len(sig_rep)
                sig_rep.append(t)
            task_sig.append(si)
            task_infos.append(t)
        if cur_ji >= 0:
            job_task_count[cur_ji] = len(task_infos) - int(job_task_start[cur_ji])
        t_count = len(task_infos)
        s_count = max(len(sig_rep), 1)

        # column-wise fills: ~10x faster than per-task _resource_vec at 50k
        # tasks; the Resource objects are hoisted once so each column pays
        # one attribute chain, not two
        task_req = np.zeros((t_count, R), np.float64)
        task_initreq = np.zeros((t_count, R), np.float64)
        reqs = [t.resreq for t in task_infos]
        initreqs = [t.init_resreq for t in task_infos]
        task_req[:, 0] = [r.milli_cpu for r in reqs]
        task_req[:, 1] = [r.memory for r in reqs]
        task_initreq[:, 0] = [r.milli_cpu for r in initreqs]
        task_initreq[:, 1] = [r.memory for r in initreqs]
        for si, rn in enumerate(rnames[2:], start=2):
            task_req[:, si] = [
                (r.scalar_resources or {}).get(rn, 0.0) for r in reqs]
            task_initreq[:, si] = [
                (r.scalar_resources or {}).get(rn, 0.0) for r in initreqs]
        task_has_pod = np.array([t.pod is not None for t in task_infos], bool) \
            if task_infos else np.zeros(0, bool)
        task_sig_arr = (np.array(task_sig, np.int32)
                        if task_sig else np.zeros(0, np.int32))
        # the object walk (stale rows / custom task order / live symmetry
        # terms) never promotes exclusion groups — affinity tasks remain
        # residue exactly as before
        task_excl = np.full(t_count, -1, np.int32)

    # constant per dimensionality; memoized so steady-state sessions hand
    # the SAME ndarray objects to the solver (its pack-identity cache then
    # skips re-packing the conf group)
    eps, is_scalar, res_unit = _conf_arrays(R)
    task_nz_cpu = np.where(task_req[:, 0] != 0, task_req[:, 0],
                           nodeorder_mod.DEFAULT_MILLI_CPU_REQUEST)
    task_nz_mem = np.where(task_req[:, 1] != 0, task_req[:, 1],
                           nodeorder_mod.DEFAULT_MEMORY_REQUEST)

    # ---- task equivalence classes ------------------------------------------
    # tasks stamped from one template share (req, initreq, signature,
    # has_pod) and therefore produce IDENTICAL feasibility/score rows in the
    # rounds sweep; deduping collapses the (T x N) sweep to (K x N) with
    # K ~ #templates << T (the TPU-native analog of the reference's
    # per-template predicate work, equivalence classes instead of sampling)
    if t_count:
        cls_key = np.ascontiguousarray(np.concatenate(
            [task_req, task_initreq,
             task_sig_arr[:, None].astype(np.float64),
             task_has_pod[:, None].astype(np.float64),
             task_excl[:, None].astype(np.float64)], axis=1))
        # byte-view unique: one memcmp sort instead of np.unique(axis=0)'s
        # per-column lexsort; byte equality == value equality here (all
        # finite floats), and class IDs carry no semantics. The exclusion
        # group id is part of the key so each group gets its own class and
        # the kernel's per-class node masks can carry group occupancy.
        row_bytes = cls_key.view(
            np.dtype((np.void, cls_key.dtype.itemsize * cls_key.shape[1]))
        ).ravel()
        _, first_idx, task_cls = np.unique(
            row_bytes, return_index=True, return_inverse=True)
        task_cls = task_cls.astype(np.int32)
        cls_rows = cls_key[first_idx]
        excl_col = cls_rows[:, 2 * R + 2]
        if (excl_col >= 0).any():
            # exclusion-group classes first: they place in the earliest
            # rounds (grank spreading), their chunks then go dead, and the
            # kernel's dead-chunk skip drops the per-round sweep from
            # ceil(K/CHUNK) chunks to the few still-live plain ones —
            # class ids carry no other semantics
            perm = np.argsort(excl_col < 0, kind="stable")
            inv = np.empty(perm.size, np.int32)
            inv[perm] = np.arange(perm.size, dtype=np.int32)
            task_cls = inv[task_cls]
            cls_rows = cls_rows[perm]
        k_count = cls_rows.shape[0]
        cls_req = cls_rows[:, :R]
        cls_initreq = cls_rows[:, R:2 * R]
        cls_excl = cls_rows[:, 2 * R + 2].astype(np.int32)
        cls_sig = cls_rows[:, 2 * R].astype(np.int32)
        cls_has_pod = cls_rows[:, 2 * R + 1] != 0
        cls_nz_cpu = np.where(cls_req[:, 0] != 0, cls_req[:, 0],
                              nodeorder_mod.DEFAULT_MILLI_CPU_REQUEST)
        cls_nz_mem = np.where(cls_req[:, 1] != 0, cls_req[:, 1],
                              nodeorder_mod.DEFAULT_MEMORY_REQUEST)
    else:
        task_cls = np.zeros(0, np.int32)
        k_count = 1
        cls_req = np.zeros((1, R), np.float64)
        cls_initreq = np.zeros((1, R), np.float64)
        cls_sig = np.zeros(1, np.int32)
        cls_has_pod = np.zeros(1, bool)
        cls_excl = np.full(1, -1, np.int32)
        cls_nz_cpu = np.full(1, nodeorder_mod.DEFAULT_MILLI_CPU_REQUEST)
        cls_nz_mem = np.full(1, nodeorder_mod.DEFAULT_MEMORY_REQUEST)

    # ---- static predicate masks per signature ------------------------------
    pred_args = _plugin_args(ssn, "predicates")
    memory_p = pred_args.get_bool(predicates_mod.MEMORY_PRESSURE_PREDICATE, False)
    disk_p = pred_args.get_bool(predicates_mod.DISK_PRESSURE_PREDICATE, False)
    pid_p = pred_args.get_bool(predicates_mod.PID_PRESSURE_PREDICATE, False)
    check_pod_count = bool(predicates_on)

    sig_mask = np.ones((s_count, n_count), bool)
    if predicates_on:
        if axis is not None:
            f = axis.flags
            node_ok = ((f & _na.F_READY) != 0) \
                & ((f & _na.F_NET_UNAVAILABLE) == 0) \
                & ((f & _na.F_UNSCHEDULABLE) == 0)
            if memory_p:
                node_ok &= (f & _na.F_MEM_PRESSURE) == 0
            if disk_p:
                node_ok &= (f & _na.F_DISK_PRESSURE) == 0
            if pid_p:
                node_ok &= (f & _na.F_PID_PRESSURE) == 0
            tainted = np.nonzero(f & _na.F_BLOCKING_TAINTS)[0].tolist()
        else:
            node_ok = np.array(
                [_static_node_ok(n, memory_p, disk_p, pid_p) for n in nodes]
            )
            # nodes carrying schedulability-affecting taints, computed
            # once: a selector-free pod only needs per-node work on THOSE
            # nodes, which drops the common no-selector/no-taint signature
            # from O(N) Python calls to one mask copy
            tainted = [
                ni for ni, n in enumerate(nodes)
                if n.node is not None and any(
                    t.effect in ("NoSchedule", "NoExecute")
                    for t in n.node.spec.taints)
            ]
        for si, rep in enumerate(sig_rep):
            pod = rep.pod
            if pod is None:
                # the predicates plugin early-returns for podless tasks
                # (predicates.py predicate_fn: pod is None -> pass), so the
                # static mask must stay all-True for them
                continue
            aff = pod.spec.affinity
            selector_free = (
                not pod.spec.node_selector
                and (aff is None or aff.node_affinity is None
                     or not aff.node_affinity.required_terms))
            if selector_free:
                row = np.ones(n_count, bool)
                for ni in tainted:
                    row[ni] = predicates_mod.tolerates_taints(pod, nodes[ni])
            else:
                row = np.array(
                    [
                        predicates_mod.pod_matches_node_selector(pod, n)
                        and predicates_mod.tolerates_taints(pod, n)
                        for n in nodes
                    ]
                )
            sig_mask[si] = node_ok & row

        # required anti-affinity SYMMETRY of existing pods: a new pod that
        # matches an existing pod's anti-affinity selector is barred from
        # that pod's whole topology domain (predicates.py pod_affinity_fits
        # symmetry block). Signatures include pod labels+namespace when
        # symmetry terms are live (see sym_active), so one host check per
        # (deduped term, signature) covers every bulk task. Terms are
        # deduped by (selector, namespaces, topology domain) — a
        # 500-replica anti-affine deployment contributes ONE entry per
        # domain, not 500.
        seen_terms = set()
        domains: Dict[tuple, np.ndarray] = {}
        for term, owner_ns, ni in sym_terms:
            topo_v = predicates_mod._node_topology_value(
                nodes[ni], term.topology_key)
            dedup = (repr(term.label_selector), tuple(term.namespaces),
                     owner_ns, term.topology_key, topo_v)
            if dedup in seen_terms:
                continue
            seen_terms.add(dedup)
            dkey = (term.topology_key, topo_v)
            domain = domains.get(dkey)
            if domain is None:
                domain = domains[dkey] = np.array([
                    predicates_mod._node_topology_value(n, term.topology_key) == topo_v
                    for n in nodes
                ])
            for si, rep in enumerate(sig_rep):
                if rep.pod is not None and predicates_mod._selector_matches_pod(
                        term, rep.pod, owner_ns):
                    sig_mask[si, domain] = False

    # ---- static preferred node-affinity score per signature ----------------
    affinity_score = np.zeros((s_count, n_count), np.float64)
    use_nodeorder = "nodeorder" in node_order
    if use_nodeorder:
        for si, rep in enumerate(sig_rep):
            pod = rep.pod
            if pod is None or pod.spec.affinity is None or pod.spec.affinity.node_affinity is None:
                continue
            if pod.spec.affinity.node_affinity.preferred_terms:
                affinity_score[si] = [
                    nodeorder_mod.node_affinity_score(rep, n) for n in nodes
                ]

    # ---- node state (column-wise fills, like the task arrays) --------------
    def _node_matrix(attr: str) -> np.ndarray:
        if axis is not None:
            # memoized per (attr, dims) on the axis at its current epoch:
            # the keeper patches the axis in place and bumps the epoch
            # (clearing mat_cache), so an unchanged axis hands back the
            # SAME matrix objects session after session — the solver's
            # pack-identity cache rides on that to skip re-packing
            mkey = (attr, R, tuple(rnames[2:]))
            m = axis.mat_cache.get(mkey)
            if m is not None:
                return m
            cap_attr = "alloc" if attr == "allocatable" else attr
            m = np.zeros((n_count, R), np.float64)
            m[:, 0] = axis.cpu[cap_attr]
            m[:, 1] = axis.mem[cap_attr]
            cols = axis.scalars[cap_attr]
            for si, rn in enumerate(rnames[2:], start=2):
                col = cols.get(rn)
                if col is not None:
                    m[:, si] = col
            axis.mat_cache[mkey] = m
            return m
        if not nodes:
            return np.zeros((0, R))
        m = np.zeros((n_count, R), np.float64)
        ress = [getattr(n, attr) for n in nodes]
        m[:, 0] = [r.milli_cpu for r in ress]
        m[:, 1] = [r.memory for r in ress]
        for si, rn in enumerate(rnames[2:], start=2):
            m[:, si] = [
                (r.scalar_resources or {}).get(rn, 0.0) for r in ress]
        return m

    node_idle = _node_matrix("idle")
    node_used = _node_matrix("used")
    node_alloc = _node_matrix("allocatable")

    # int32 bound safety for the rounds kernel: segment accumulators are
    # limb-exact below 2^46 quantized units (rounds._seg_limbs), but the
    # quantized BOUNDS (per-node idle, per-queue deserved/allocated — all
    # <= cluster totals) are plain int32; a cluster whose per-dimension
    # total exceeds 2^31 quantized units would wrap them, so fall back
    # honestly instead
    if node_alloc.size:
        total_q = node_alloc.sum(axis=0) / res_unit
        if float(total_q.max()) >= 2.0**31 - 2.0**20:
            raise EncoderFallback(
                "cluster capacity exceeds int32 quantized-bound range "
                f"({total_q.max():.3g} units)")
    # ... and the limb accumulators sum REQUESTS (accepted or not), so the
    # total quantized pending request per dimension must stay under their
    # 2^46 exactness envelope
    if task_req.size:
        req_q = np.ceil(task_req / res_unit[None, :])
        if float(req_q.max()) >= 2.0**31:
            raise EncoderFallback(
                "a single task request exceeds int32 quantized range")
        total_req_q = req_q.sum(axis=0)
        if float(total_req_q.max()) >= 2.0**46:
            raise EncoderFallback(
                "total pending request exceeds the limb-exact cumsum range "
                f"({total_req_q.max():.3g} units)")
    if axis is not None:
        # epoch-gated COPIES: the keeper patches axis.node_cnt/max_tasks
        # in place between sessions, and the solver's pack-identity cache
        # must only ever see arrays whose identity implies their content
        cm = axis.mat_cache.get("cnt_max")
        if cm is None:
            cm = axis.mat_cache["cnt_max"] = (
                axis.node_cnt.copy(), axis.max_tasks.copy())
        node_cnt, node_max_tasks = cm
    else:
        node_cnt = np.array([len(n.tasks) for n in nodes], np.int32)
        node_max_tasks = np.array(
            [n.allocatable.max_task_num for n in nodes], np.int32)

    # ---- queues / namespaces ----------------------------------------------
    ns_names = sorted({job.namespace for job in jobs})
    ns_index = {n: i for i, n in enumerate(ns_names)}
    ns_count = max(len(ns_names), 1)

    queue_ids = sorted(
        {job.queue for job in jobs},
        key=lambda q: (ssn.queues[q].queue.metadata.creation_timestamp, ssn.queues[q].uid),
    )
    q_index = {q: i for i, q in enumerate(queue_ids)}
    q_count = max(len(queue_ids), 1)

    q_in_ns = np.zeros((ns_count, q_count), bool)
    for job in jobs:
        q_in_ns[ns_index[job.namespace], q_index[job.queue]] = True

    queue_deserved = np.zeros((q_count, R), np.float64)
    queue_present = np.zeros((q_count, R), bool)
    queue_alloc0 = np.zeros((q_count, R), np.float64)
    prop = ssn.plugins.get("proportion")
    if prop is not None:
        for q, qi in q_index.items():
            attr = prop.queue_opts.get(q)
            if attr is None:
                continue
            queue_deserved[qi] = _resource_vec(attr.deserved, rnames)
            queue_alloc0[qi] = _resource_vec(attr.allocated, rnames)
            present = {"cpu", "memory", *(attr.deserved.scalar_resources or {})}
            queue_present[qi] = [rn in present for rn in rnames]

    # ---- job arrays --------------------------------------------------------
    job_queue = np.array([q_index[j.queue] for j in jobs], np.int32) if jobs else np.zeros(0, np.int32)
    job_ns = np.array([ns_index[j.namespace] for j in jobs], np.int32) if jobs else np.zeros(0, np.int32)
    job_priority = np.array([j.priority for j in jobs], np.int32) if jobs else np.zeros(0, np.int32)
    job_min_available = np.array([j.min_available for j in jobs], np.int32) if jobs else np.zeros(0, np.int32)
    job_ready_base = np.array([j.ready_task_num() for j in jobs], np.int32) if jobs else np.zeros(0, np.int32)
    gang_ready_gate = "gang" in job_ready
    job_ready_threshold = job_min_available if gang_ready_gate else np.zeros(j_count, np.int32)

    # (ctime, uid) rank via one C-level lexsort over fixed-width columns —
    # same order as sorted(key=(ctime, uid)) at a fraction of the cost
    job_tie_rank = np.zeros(j_count, np.int32)
    if j_count:
        ctimes = np.fromiter((j.creation_timestamp for j in jobs),
                             np.float64, j_count)
        uids = np.array([j.uid for j in jobs])  # '<U..' fixed-width
        order_arr = np.lexsort((uids, ctimes))
        job_tie_rank[order_arr] = np.arange(j_count, dtype=np.int32)

    job_alloc0 = np.zeros((j_count, R), np.float64)
    drf = ssn.plugins.get("drf")
    drf_total = np.zeros(R, np.float64)
    drf_present = np.zeros(R, bool)
    ns_alloc0 = np.zeros((ns_count, R), np.float64)
    ns_weight = np.ones(ns_count, np.float64)
    if drf is not None:
        # column-wise fill (one attribute chain per column, not a
        # per-job _resource_vec array build — J np.array calls dominate
        # the job axis at 50k-task scale)
        attrs = [drf.job_attrs.get(job.uid) for job in jobs]
        allocs = [a.allocated if a is not None else None for a in attrs]
        if j_count:
            job_alloc0[:, 0] = [
                a.milli_cpu if a is not None else 0.0 for a in allocs]
            job_alloc0[:, 1] = [
                a.memory if a is not None else 0.0 for a in allocs]
            has_scalars = any(
                a is not None and a.scalar_resources for a in allocs)
            if has_scalars:
                for si, rn in enumerate(rnames[2:], start=2):
                    job_alloc0[:, si] = [
                        (a.scalar_resources or {}).get(rn, 0.0)
                        if a is not None else 0.0 for a in allocs]
        drf_total = _resource_vec(drf.total_resource, rnames)
        present = {"cpu", "memory", *(drf.total_resource.scalar_resources or {})}
        drf_present = np.array([rn in present for rn in rnames])
        for name, i in ns_index.items():
            opt = drf.namespace_opts.get(name)
            if opt is not None:
                ns_alloc0[i] = _resource_vec(opt.allocated, rnames)
            info = ssn.namespace_info.get(name)
            ns_weight[i] = info.get_weight() if info is not None else 1.0

    # ---- score weights -----------------------------------------------------
    binpack_w = np.zeros(R, np.float64)
    binpack_weight = 0.0
    use_binpack = "binpack" in node_order
    if use_binpack:
        bp = ssn.plugins.get("binpack")
        w = bp.weight
        if w.binpacking_weight == 0:
            use_binpack = False
        else:
            binpack_weight = float(w.binpacking_weight)
            for ri, rn in enumerate(rnames):
                if rn == "cpu":
                    binpack_w[ri] = w.binpacking_cpu
                elif rn == "memory":
                    binpack_w[ri] = w.binpacking_memory
                elif rn in w.binpacking_resources:
                    binpack_w[ri] = w.binpacking_resources[rn]

    no_args = _plugin_args(ssn, "nodeorder")
    least_req_weight = float(no_args.get_int(nodeorder_mod.LEAST_REQUESTED_WEIGHT, 1))
    balanced_weight = float(no_args.get_int(nodeorder_mod.BALANCED_RESOURCE_WEIGHT, 1))
    node_affinity_weight = float(no_args.get_int(nodeorder_mod.NODE_AFFINITY_WEIGHT, 1))

    g_count = max(len(excl_occ_rows), 1)
    excl_occ0 = (np.stack(excl_occ_rows) if excl_occ_rows
                 else np.zeros((1, n_count), bool))

    spec = SolveSpec(
        job_order_keys=tuple(job_order),
        use_drf_ns_order=bool(ns_order),
        use_prop_queue_order=bool(queue_order),
        use_prop_overused=bool(overused),
        check_pod_count=check_pod_count,
        use_binpack=use_binpack,
        use_nodeorder=use_nodeorder,
        use_exclusion=bool(excl_occ_rows),
    )

    arrays = dict(
        eps=eps,
        is_scalar=is_scalar,
        res_unit=res_unit,
        task_req=task_req,
        task_initreq=task_initreq,
        task_nz_cpu=task_nz_cpu,
        task_nz_mem=task_nz_mem,
        task_sig=task_sig_arr,
        task_has_pod=task_has_pod,
        task_cls=task_cls,
        cls_req=cls_req,
        cls_initreq=cls_initreq,
        cls_nz_cpu=cls_nz_cpu,
        cls_nz_mem=cls_nz_mem,
        cls_sig=cls_sig,
        cls_has_pod=cls_has_pod,
        cls_excl=cls_excl,
        excl_occ0=excl_occ0,
        task_job=np.repeat(
            np.arange(j_count, dtype=np.int32), job_task_count
        ) if t_count else np.zeros(0, np.int32),
        sig_mask=sig_mask,
        affinity_score=affinity_score,
        node_idle=node_idle.astype(np.float64, copy=False),
        node_used=node_used.astype(np.float64, copy=False),
        node_alloc=node_alloc.astype(np.float64, copy=False),
        node_cnt=node_cnt,
        node_max_tasks=node_max_tasks,
        node_real=np.ones(n_count, bool),
        real_n=np.int32(n_count),
        job_task_start=job_task_start,
        job_task_count=job_task_count,
        job_queue=job_queue,
        job_ns=job_ns,
        job_priority=job_priority,
        job_min_available=job_min_available,
        job_ready_base=job_ready_base,
        job_ready_threshold=job_ready_threshold.astype(np.int32),
        job_tie_rank=job_tie_rank,
        job_alloc0=job_alloc0,
        job_active0=np.ones(j_count, bool),
        queue_deserved=queue_deserved,
        queue_present=queue_present,
        queue_alloc0=queue_alloc0,
        queue_tie_rank=np.arange(q_count, dtype=np.int32),
        q_in_ns0=q_in_ns,
        ns_active0=np.array([i < len(ns_names) for i in range(ns_count)]),
        ns_rank=np.arange(ns_count, dtype=np.int32),
        ns_alloc0=ns_alloc0,
        ns_weight=ns_weight,
        drf_total=drf_total,
        drf_present=drf_present,
        binpack_w=binpack_w,
        binpack_weight=np.float64(binpack_weight),
        least_req_weight=np.float64(least_req_weight),
        balanced_weight=np.float64(balanced_weight),
        node_affinity_weight=np.float64(node_affinity_weight),
    )

    enc = EncodedSnapshot(
        spec=spec,
        arrays=arrays,
        task_infos=task_infos,
        job_infos=jobs,
        node_names=node_names,
        resource_names=rnames,
        ns_names=ns_names,
        queue_uids=queue_ids,
        num_to_find=scheduler_helper.calculate_num_of_feasible_nodes_to_find(n_count),
        rr0=scheduler_helper._last_processed_node_index,
        residue_count=int(job_residue.sum()),
        job_residue=job_residue,
        has_releasing=has_releasing,
    )
    return enc
