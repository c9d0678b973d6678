"""predicates — node feasibility checks
(volcano pkg/scheduler/plugins/predicates/predicates.go).

The reference chains upstream k8s predicate functions over a parallel
``cache.NodeInfo`` map it maintains with event handlers; here the same checks
are implemented natively over the session's NodeInfo (whose task set the
session keeps current through allocate/evict), in the same order:

pod count -> node condition -> unschedulable -> node selector (+ required
node affinity) -> host ports -> taints/tolerations -> optional memory/disk/
pid pressure -> pod (anti-)affinity with required-term symmetry.

Each failure raises FitFailure with reason strings matching upstream phrasing
so fit-error histograms are comparable.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from volcano_tpu_torch.api import objects
from volcano_tpu_torch.api.job_info import TaskInfo
from volcano_tpu_torch.api.node_info import NodeInfo
from volcano_tpu_torch.api.types import TaskStatus
from volcano_tpu_torch.api.unschedule_info import FitFailure
from volcano_tpu_torch.scheduler.framework.event_handlers import EventHandler
from volcano_tpu_torch.scheduler.framework.interface import Plugin

PLUGIN_NAME = "predicates"

MEMORY_PRESSURE_PREDICATE = "predicate.MemoryPressureEnable"
DISK_PRESSURE_PREDICATE = "predicate.DiskPressureEnable"
PID_PRESSURE_PREDICATE = "predicate.PIDPressureEnable"

NODE_POD_NUMBER_EXCEEDED = "node(s) pod number exceeded"

HOSTNAME_TOPOLOGY_KEY = "kubernetes.io/hostname"


def _node_topology_value(node: NodeInfo, key: str) -> str:
    labels = node.node.metadata.labels if node.node is not None else {}
    if key == HOSTNAME_TOPOLOGY_KEY and key not in labels:
        return node.name
    return labels.get(key, "")


def _pods_on_node(node: NodeInfo) -> List[objects.Pod]:
    return [t.pod for t in node.tasks.values() if t.pod is not None]


def _selector_matches_pod(term: objects.PodAffinityTerm, pod: objects.Pod, incoming_ns: str) -> bool:
    namespaces = term.namespaces or [incoming_ns]
    if pod.metadata.namespace not in namespaces:
        return False
    if term.label_selector is None:
        return False
    return term.label_selector.matches(pod.metadata.labels)


def pod_matches_node_selector(pod: objects.Pod, node: NodeInfo) -> bool:
    """nodeSelector AND required node-affinity terms (PodMatchNodeSelector)."""
    labels = node.node.metadata.labels if node.node is not None else {}
    for k, v in pod.spec.node_selector.items():
        if labels.get(k) != v:
            return False
    affinity = pod.spec.affinity
    if affinity is not None and affinity.node_affinity is not None:
        required = affinity.node_affinity.required_terms
        if required and not any(term.matches(labels) for term in required):
            return False
    return True


def tolerates_taints(pod: objects.Pod, node: NodeInfo) -> bool:
    """NoSchedule/NoExecute taints must be tolerated (PodToleratesNodeTaints)."""
    if node.node is None:
        return True
    for taint in node.node.spec.taints:
        if taint.effect not in ("NoSchedule", "NoExecute"):
            continue  # PreferNoSchedule never blocks
        if not any(t.tolerates(taint) for t in pod.spec.tolerations):
            return False
    return True


def host_ports_free(pod: objects.Pod, node: NodeInfo) -> bool:
    wanted = {
        (p.host_port, p.protocol)
        for c in pod.spec.containers
        for p in c.ports
        if p.host_port > 0
    }
    if not wanted:
        return True
    for existing in _pods_on_node(node):
        for c in existing.spec.containers:
            for p in c.ports:
                if p.host_port > 0 and (p.host_port, p.protocol) in wanted:
                    return False
    return True


def _affinity_term_satisfied(term: objects.PodAffinityTerm, pod: objects.Pod,
                             node: NodeInfo, all_nodes: List[NodeInfo],
                             domains=None, node_has_match=None) -> bool:
    """Some existing pod matching the selector runs in the node's topology
    domain for term.topology_key.

    ``domains`` (a callable key -> {value: [nodes]}, see the plugin's
    session-scoped index) restricts the sweep to the candidate node's OWN
    domain instead of re-filtering every node per call — the difference
    between O(domain) and the reference's O(pods x nodes) hot spot
    (predicates.go:281-299). Verdicts are identical: the domain list IS
    the set the full sweep's topology filter admits."""
    my_topo = _node_topology_value(node, term.topology_key)
    if domains is not None:
        others = domains(term.topology_key).get(my_topo, ())
    else:
        others = [o for o in all_nodes
                  if _node_topology_value(o, term.topology_key) == my_topo]
    for other in others:
        if node_has_match is not None:
            # label-pair index verdict: True/False are exact; None means
            # the index cannot decide (match_expressions, or a multi-pair
            # conjunction whose pairs all exist) and the pod scan runs
            r = node_has_match(term, pod.metadata.namespace, other)
            if r is True:
                return True
            if r is False:
                continue
        for existing in _pods_on_node(other):
            if _selector_matches_pod(term, existing, pod.metadata.namespace):
                return True
    return False


def _anti_affinity_violated(term: objects.PodAffinityTerm, pod: objects.Pod,
                            node: NodeInfo, all_nodes: List[NodeInfo],
                            domains=None, node_has_match=None) -> bool:
    return _affinity_term_satisfied(term, pod, node, all_nodes, domains,
                                    node_has_match)


def _term_matches_no_pod_but_self(term: objects.PodAffinityTerm, pod: objects.Pod,
                                  all_nodes: List[NodeInfo]) -> bool:
    """Upstream carve-out (vendored predicates.go:1380-1389): a required
    affinity term that matches NO existing pod anywhere is allowed when the
    incoming pod matches its own selector — so the first pod of a
    self-affine gang can land."""
    for other in all_nodes:
        for existing in _pods_on_node(other):
            if _selector_matches_pod(term, existing, pod.metadata.namespace):
                return False
    return _selector_matches_pod(term, pod, pod.metadata.namespace)


def _has_required_anti_affinity(pod: Optional[objects.Pod]) -> bool:
    if pod is None or pod.spec.affinity is None:
        return False
    anti = pod.spec.affinity.pod_anti_affinity
    return anti is not None and bool(anti.required_terms)


def pod_affinity_fits(
    pod: objects.Pod,
    node: NodeInfo,
    all_nodes: List[NodeInfo],
    anti_resident: Optional[Dict[str, Tuple[objects.Pod, str]]] = None,
    nodes_by_name: Optional[Dict[str, NodeInfo]] = None,
    domains=None,
    sym_excluded=None,
    node_has_match=None,
) -> bool:
    """(Anti-)affinity of the incoming pod plus required-term symmetry of
    existing pods. ``anti_resident`` (uid -> (pod, node_name)), when given,
    is an exact mirror of the pods with required anti-affinity currently on
    any node — the only pods the symmetry clause can match — letting the
    common no-anti-affinity session skip the O(nodes x pods) sweep the
    reference sidesteps with its affinity-only PodLister fast path
    (plugins/util/util.go:34-57). ``domains``/``sym_excluded`` (see the
    plugin) turn the remaining per-(pod, node) sweeps into domain-local
    scans and a set lookup — same verdicts, session-scale cost."""
    affinity = pod.spec.affinity
    if affinity is not None:
        if affinity.pod_affinity is not None:
            for term in affinity.pod_affinity.required_terms:
                if not _affinity_term_satisfied(term, pod, node, all_nodes,
                                                domains, node_has_match) and \
                        not _term_matches_no_pod_but_self(term, pod, all_nodes):
                    return False
        if affinity.pod_anti_affinity is not None:
            for term in affinity.pod_anti_affinity.required_terms:
                if _anti_affinity_violated(term, pod, node, all_nodes,
                                           domains, node_has_match):
                    return False
    if sym_excluded is not None:
        # precomputed per-pod exclusion domains (matching residents'
        # required anti-affinity terms): node rejected iff it sits in one
        for topo, val in sym_excluded:
            if _node_topology_value(node, topo) == val:
                return False
        return True
    # symmetry: existing pods' required anti-affinity must not match us
    if anti_resident is not None and nodes_by_name is not None:
        for existing, node_name in anti_resident.values():
            other = nodes_by_name.get(node_name)
            if other is None:
                continue
            for term in existing.spec.affinity.pod_anti_affinity.required_terms:
                if not _selector_matches_pod(term, pod, existing.metadata.namespace):
                    continue
                topo = term.topology_key
                if _node_topology_value(node, topo) == _node_topology_value(other, topo):
                    return False
        return True
    for other in all_nodes:
        for existing in _pods_on_node(other):
            ea = existing.spec.affinity
            if ea is None or ea.pod_anti_affinity is None:
                continue
            for term in ea.pod_anti_affinity.required_terms:
                if not _selector_matches_pod(term, pod, existing.metadata.namespace):
                    continue
                topo = term.topology_key
                if _node_topology_value(node, topo) == _node_topology_value(other, topo):
                    return False
    return True


def _node_condition(node: NodeInfo, cond_type: str) -> bool:
    if node.node is None:
        return False
    for cond in node.node.status.conditions:
        if cond.type == cond_type:
            return cond.status == "True"
    return False


class PredicatesPlugin(Plugin):
    def __init__(self, arguments=None):
        self.arguments = arguments or {}

    def name(self) -> str:
        return PLUGIN_NAME

    def on_session_open(self, ssn) -> None:
        from volcano_tpu_torch.scheduler.framework.arguments import Arguments

        args = self.arguments if isinstance(self.arguments, Arguments) else Arguments(self.arguments)
        memory_pressure = args.get_bool(MEMORY_PRESSURE_PREDICATE, False)
        disk_pressure = args.get_bool(DISK_PRESSURE_PREDICATE, False)
        pid_pressure = args.get_bool(PID_PRESSURE_PREDICATE, False)

        # The node set is fixed for the session; build the list once instead
        # of per predicate call (the serial sweep calls this O(tasks x nodes)
        # times).
        all_nodes = list(ssn.nodes.values())

        # anti_resident mirrors {pods with required anti-affinity currently
        # in some node's task map}. Maintained through session events:
        # allocate/pipeline add the task to a node; unallocate/unpipeline
        # remove it; evict fires deallocate but leaves the task on the node
        # as RELEASING (statement.py evict), so RELEASING deallocations are
        # kept. Bulk-applied placements (ops/solver._apply_bulk) never carry
        # (anti-)affinity — the encoder routes those tasks to the serial
        # residue pass — so bypassing the event machinery cannot stale this
        # index.
        anti_resident: Dict[str, Tuple[objects.Pod, str]] = {}
        # inverted symmetry index over the residents' required anti terms:
        # a single-kv match_labels term excludes its node's topology domain
        # for every incoming pod carrying that (scope-ns, k, v) label —
        # sym_single[(ns, k, v)] refcounts {(topo_key, topo_val): n}.
        # Terms the index cannot represent (multi-kv, match_expressions,
        # selector-less) stay in sym_complex[uid] for the per-pod scan.
        # Together they turn the per-incoming-pod symmetry sweep from
        # O(residents) selector matches into O(pod labels) dict lookups.
        sym_single: Dict[tuple, Dict[tuple, int]] = {}
        sym_complex: Dict[str, list] = {}

        def _sym_single_entries(pod: objects.Pod, node_name: str):
            """((scope_ns, k, v), (topo_key, topo_val)) pairs for the
            pod's index-representable terms — ONE classification shared by
            add and remove so the refcounts always balance; terms it skips
            are exactly the ones the caller routes to sym_complex."""
            other = ssn.nodes.get(node_name)
            for term in pod.spec.affinity.pod_anti_affinity.required_terms:
                sel = term.label_selector
                if other is not None and sel is not None \
                        and not sel.match_expressions \
                        and len(sel.match_labels) == 1:
                    ((k, v),) = sel.match_labels.items()
                    topo = (term.topology_key,
                            _node_topology_value(other, term.topology_key))
                    for scope_ns in (term.namespaces
                                     or [pod.metadata.namespace]):
                        yield (scope_ns, k, v), topo
                else:
                    yield None, term

        def _anti_add(uid: str, pod: objects.Pod, node_name: str) -> None:
            if uid in anti_resident:
                return  # idempotent (unevict re-fires allocate)
            anti_resident[uid] = (pod, node_name)
            for key, payload in _sym_single_entries(pod, node_name):
                if key is not None:
                    counts = sym_single.setdefault(key, {})
                    counts[payload] = counts.get(payload, 0) + 1
                else:
                    sym_complex.setdefault(uid, []).append(
                        (payload, pod.metadata.namespace, node_name))

        def _anti_remove(uid: str) -> Optional[tuple]:
            entry = anti_resident.pop(uid, None)
            if entry is None:
                return None
            pod, node_name = entry
            for key, payload in _sym_single_entries(pod, node_name):
                if key is not None:
                    counts = sym_single.get(key)
                    if counts is not None:
                        n = counts.get(payload, 0) - 1
                        if n <= 0:
                            counts.pop(payload, None)
                        else:
                            counts[payload] = n
            sym_complex.pop(uid, None)
            return entry

        for _node in all_nodes:
            for _t in _node.tasks.values():
                if _has_required_anti_affinity(_t.pod):
                    _anti_add(_t.uid, _t.pod, _node.name)

        # generation counter for caches derived from anti_resident: bumped
        # on every mutation so per-pod symmetry sets recompute exactly when
        # the resident picture changes mid-pass (the rebuild itself is
        # cheap — the inverted sym_single index above absorbs the
        # O(residents) work incrementally)
        anti_gen = [0]

        # per-node resident label-pair index: (uids, counts[(ns,k,v)],
        # ns_counts[ns]) built lazily per node from its live task map and
        # maintained through the same session events — turns "does any
        # resident match this selector" from a per-pod scan into dict
        # lookups (exact for single-pair match_labels selectors; multi-pair
        # positives and match_expressions fall back to the pod scan).
        # Laziness also keeps the bulk-apply bypass safe: the bulk writeback
        # fires no events, but it runs before any serial predicate does, so
        # a node's index is always FIRST built from post-bulk live state
        # (same argument as anti_resident above; allocate's bulk solve runs
        # at most once per session)
        node_label_idx: Dict[str, tuple] = {}
        uid_node: Dict[str, str] = {}

        def _build_label_idx(node: NodeInfo) -> tuple:
            uids, counts, ns_counts = set(), {}, {}
            for t in node.tasks.values():
                pod = t.pod
                if pod is None:
                    continue
                uids.add(t.uid)
                ns = pod.metadata.namespace
                ns_counts[ns] = ns_counts.get(ns, 0) + 1
                uid_node[t.uid] = node.name
                for k, v in pod.metadata.labels.items():
                    key = (ns, k, v)
                    counts[key] = counts.get(key, 0) + 1
            idx = (uids, counts, ns_counts)
            node_label_idx[node.name] = idx
            return idx

        def _label_idx_add(t) -> None:
            uid_node[t.uid] = t.node_name
            idx = node_label_idx.get(t.node_name)
            if idx is None:
                return
            uids, counts, ns_counts = idx
            if t.uid in uids:
                return  # idempotent (unevict re-fires allocate)
            uids.add(t.uid)
            ns = t.pod.metadata.namespace
            ns_counts[ns] = ns_counts.get(ns, 0) + 1
            for k, v in t.pod.metadata.labels.items():
                key = (ns, k, v)
                counts[key] = counts.get(key, 0) + 1

        def _label_idx_remove(t) -> None:
            # unpipeline clears node_name before the event; the uid map
            # remembers where the pod was
            name = uid_node.pop(t.uid, None) or t.node_name
            idx = node_label_idx.get(name) if name else None
            if idx is None:
                return
            uids, counts, ns_counts = idx
            if t.uid not in uids:
                return
            uids.discard(t.uid)
            ns = t.pod.metadata.namespace
            ns_counts[ns] = ns_counts.get(ns, 0) - 1
            for k, v in t.pod.metadata.labels.items():
                key = (ns, k, v)
                counts[key] = counts.get(key, 0) - 1

        def _node_has_match(term, incoming_ns: str, node: NodeInfo):
            """Exact True/False from the index, or None when the pod scan
            must decide (see _affinity_term_satisfied)."""
            sel = term.label_selector
            if sel is None:
                return False  # _selector_matches_pod is False for all pods
            if sel.match_expressions:
                return None
            idx = node_label_idx.get(node.name)
            if idx is None:
                idx = _build_label_idx(node)
            _, counts, ns_counts = idx
            namespaces = term.namespaces or [incoming_ns]
            pairs = sel.match_labels.items()
            if not pairs:
                # empty selector matches every pod in the namespace scope
                return any(ns_counts.get(ns, 0) > 0 for ns in namespaces)
            maybe = False
            for ns in namespaces:
                if all(counts.get((ns, k, v), 0) > 0 for k, v in pairs):
                    if len(pairs) == 1:
                        return True
                    maybe = True
            return None if maybe else False

        def _track_allocate(event) -> None:
            t = event.task
            if t.pod is not None and t.node_name:
                _label_idx_add(t)
            if _has_required_anti_affinity(t.pod) and t.node_name:
                _anti_add(t.uid, t.pod, t.node_name)
                anti_gen[0] += 1

        def _track_deallocate(event) -> None:
            t = event.task
            if t.pod is not None and t.status != TaskStatus.RELEASING:
                _label_idx_remove(t)
            if _has_required_anti_affinity(t.pod) and t.status != TaskStatus.RELEASING:
                if _anti_remove(t.uid) is not None:
                    anti_gen[0] += 1

        ssn.add_event_handler(EventHandler(
            _track_allocate, _track_deallocate,
            # the deallocate arm guards BOTH branches on status != RELEASING
            # — the tag lets the native engine skip it for evictions
            origin=(PLUGIN_NAME, self)))

        # session-scoped topology-domain index (node labels are fixed for
        # the session): key -> {value: [nodes]}, built lazily per key
        topo_domains: Dict[str, Dict[str, List[NodeInfo]]] = {}

        def _domains(key: str) -> Dict[str, List[NodeInfo]]:
            m = topo_domains.get(key)
            if m is None:
                m = topo_domains[key] = {}
                for nd in all_nodes:
                    m.setdefault(_node_topology_value(nd, key), []).append(nd)
            return m

        # per-incoming-pod symmetry exclusion domains, cached on the
        # anti_resident generation: one O(residents) scan per (pod,
        # generation) instead of per (pod, node) — the candidate sweep then
        # pays a set-membership check per node
        sym_cache: Dict[str, tuple] = {}

        def _sym_excluded(pod: objects.Pod):
            key = pod.metadata.uid or f"{pod.metadata.namespace}/{pod.metadata.name}"
            hit = sym_cache.get(key)
            if hit is not None and hit[0] == anti_gen[0]:
                return hit[1]
            # single-kv terms via the inverted index: O(pod labels) lookups
            excluded = set()
            ns = pod.metadata.namespace
            for k, v in pod.metadata.labels.items():
                counts = sym_single.get((ns, k, v))
                if counts:
                    excluded.update(counts)
            # the few complex-selector residents keep the per-pod scan
            for entries in sym_complex.values():
                for term, existing_ns, node_name in entries:
                    if _selector_matches_pod(term, pod, existing_ns):
                        other = ssn.nodes.get(node_name)
                        if other is not None:
                            excluded.add((
                                term.topology_key,
                                _node_topology_value(
                                    other, term.topology_key)))
            if len(sym_cache) > 8192:
                sym_cache.clear()
            sym_cache[key] = (anti_gen[0], excluded)
            return excluded

        def predicate_fn(task: TaskInfo, node: NodeInfo) -> None:
            pod = task.pod
            if pod is None:
                return

            # pod count (predicates.go:165)
            if node.allocatable.max_task_num <= len(node.tasks):
                raise FitFailure(NODE_POD_NUMBER_EXCEEDED)

            # node conditions (CheckNodeConditionPredicate)
            if not _node_condition(node, "Ready"):
                raise FitFailure("node(s) were not ready")
            if _node_condition(node, "NetworkUnavailable"):
                raise FitFailure("node(s) had network unavailable")

            # unschedulable spec (CheckNodeUnschedulablePredicate)
            if node.node is not None and node.node.spec.unschedulable:
                raise FitFailure("node(s) were unschedulable")

            # node selector + required node affinity
            if not pod_matches_node_selector(pod, node):
                raise FitFailure("node(s) didn't match node selector")

            # host ports
            if not host_ports_free(pod, node):
                raise FitFailure("node(s) didn't have free ports for the requested pod ports")

            # taints
            if not tolerates_taints(pod, node):
                raise FitFailure("node(s) had taints that the pod didn't tolerate")

            if memory_pressure and _node_condition(node, "MemoryPressure"):
                raise FitFailure("node(s) had memory pressure")
            if disk_pressure and _node_condition(node, "DiskPressure"):
                raise FitFailure("node(s) had disk pressure")
            if pid_pressure and _node_condition(node, "PIDPressure"):
                raise FitFailure("node(s) had pid pressure")

            # pod (anti-)affinity incl. required-term symmetry
            if (pod.spec.affinity is not None or anti_resident) and \
                    not pod_affinity_fits(pod, node, all_nodes,
                                          anti_resident, ssn.nodes,
                                          domains=_domains,
                                          sym_excluded=_sym_excluded(pod),
                                          node_has_match=_node_has_match):
                raise FitFailure("node(s) didn't match pod affinity/anti-affinity")

        ssn.add_predicate_fn(PLUGIN_NAME, predicate_fn)

        # residual surface for the allocate assist (ops/preemptview.py
        # alloc_best_node): exactly the chain links the dense base mask
        # cannot precompute — host ports and pod (anti-)affinity incl.
        # required-term symmetry — evaluated live with the same indexes
        # predicate_fn uses, so verdict conjunction is identical
        def residual_check(task: TaskInfo, node: NodeInfo) -> None:
            pod = task.pod
            if pod is None:
                return
            if not host_ports_free(pod, node):
                raise FitFailure(
                    "node(s) didn't have free ports for the requested pod ports")
            if (pod.spec.affinity is not None or anti_resident) and \
                    not pod_affinity_fits(pod, node, all_nodes,
                                          anti_resident, ssn.nodes,
                                          domains=_domains,
                                          sym_excluded=_sym_excluded(pod),
                                          node_has_match=_node_has_match):
                raise FitFailure(
                    "node(s) didn't match pod affinity/anti-affinity")

        def note_resident(task: TaskInfo) -> None:
            """Bulk-apply hook: a device-placed pod with required
            anti-affinity became resident without session events firing
            (ops/solver._apply_bulk exclusion groups)."""
            if t_pod := task.pod:
                _label_idx_add(task)
                if _has_required_anti_affinity(t_pod) and task.node_name:
                    _anti_add(task.uid, t_pod, task.node_name)
                    anti_gen[0] += 1

        self.note_resident = note_resident
        self.residual_check = residual_check
        self.needs_residual = lambda pod: (
            bool(anti_resident)
            or (pod is not None and (
                pod.spec.affinity is not None
                and (pod.spec.affinity.pod_affinity is not None
                     or pod.spec.affinity.pod_anti_affinity is not None)
                or any(p.host_port > 0 for c in pod.spec.containers
                       for p in c.ports))))


def new(arguments):
    return PredicatesPlugin(arguments)
