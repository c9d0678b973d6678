"""Scheduler-relevant pod traits: predicate signature key + host-port /
pod-affinity flags, cached per pod version.

Pods stamped from one template share node-selector / affinity / toleration
constraints, so static feasibility collapses to one row per *signature*
(S << T) — the compression both the TPU encoder (ops/encoder.py) and the
cache's columnar pod table (scheduler/cache/podtable.py) build on. The
reference evaluates these per (pod, node) in closures
(pkg/scheduler/plugins/predicates/predicates.go:165-299); here the per-pod
part is computed once per pod *version* and keyed for dedup.
"""

from __future__ import annotations

from typing import Optional

from volcano_tpu_torch.api import objects


def signature_key(pod: Optional[objects.Pod]) -> str:
    if pod is None:
        return "<none>"
    spec = pod.spec
    if not spec.node_selector and spec.affinity is None and not spec.tolerations:
        return "<plain>"
    parts = [repr(sorted(spec.node_selector.items()))]
    aff = spec.affinity
    if aff is not None and aff.node_affinity is not None:
        parts.append(repr([_term_repr(t) for t in aff.node_affinity.required_terms]))
        parts.append(
            repr([(p.weight, _term_repr(p.preference)) for p in aff.node_affinity.preferred_terms])
        )
    parts.append(repr([(t.key, t.operator, t.value, t.effect) for t in spec.tolerations]))
    return "|".join(parts)


def _term_repr(term) -> str:
    return repr(getattr(term, "match_expressions", term))


def has_pod_affinity(pod: Optional[objects.Pod]) -> bool:
    if pod is None or pod.spec.affinity is None:
        return False
    a = pod.spec.affinity
    return a.pod_affinity is not None or a.pod_anti_affinity is not None


def has_host_ports(pod: Optional[objects.Pod]) -> bool:
    if pod is None:
        return False
    # plain loops: this runs per fresh pod in hot paths and a genexpr-under-
    # any costs ~3x the common no-ports case
    for c in pod.spec.containers:
        for p in c.ports:
            if p.host_port > 0:
                return True
    return False


def pod_encode_traits(pod: objects.Pod):
    """(signature key, has_host_ports, has_pod_affinity), cached on the pod.

    Pod objects persist across sessions (snapshot clones TaskInfos but
    shares the pod reference), so caching amortizes the per-task
    string/scan work to one computation per pod *version*: the store bumps
    metadata.resource_version on every create/update (store.py:121-136),
    including in-place mutations re-stored by effectors, so the cache is
    keyed on it and recomputes whenever the pod changed."""
    rv = pod.metadata.resource_version
    try:
        cached_rv, traits = pod._enc_traits
        if cached_rv == rv:
            return traits
    except AttributeError:
        pass
    traits = (
        signature_key(pod),
        has_host_ports(pod),
        has_pod_affinity(pod),
    )
    pod._enc_traits = (rv, traits)
    return traits
