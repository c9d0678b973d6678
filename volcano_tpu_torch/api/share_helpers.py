"""Share/min helpers (volcano pkg/scheduler/api/helpers/)."""

from __future__ import annotations

from volcano_tpu_torch.api.resource import Resource


def share(l: float, r: float) -> float:
    if r == 0:
        return 0.0 if l == 0 else 1.0
    return l / r


def min_resource(l: Resource, r: Resource) -> Resource:
    res = Resource(min(l.milli_cpu, r.milli_cpu), min(l.memory, r.memory))
    if l.scalar_resources is None or r.scalar_resources is None:
        return res
    res.scalar_resources = {}
    for name, quant in l.scalar_resources.items():
        res.scalar_resources[name] = min(quant, r.scalar_resources.get(name, 0.0))
    return res
