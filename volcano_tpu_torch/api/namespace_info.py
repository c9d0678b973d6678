"""Namespace weights from ResourceQuotas
(volcano pkg/scheduler/api/namespace_info.go).

A namespace's weight is the max `volcano.sh/namespace.weight` hard-quota
value across its ResourceQuotas (namespace_info.go:75-130); default 1.
"""

from __future__ import annotations

from typing import Dict, Optional

from volcano_tpu_torch.api import objects
from volcano_tpu_torch.api.quantity import parse_quantity

DEFAULT_NAMESPACE_WEIGHT = 1
NAMESPACE_WEIGHT_KEY = objects.NAMESPACE_WEIGHT_KEY


class NamespaceInfo:
    __slots__ = ("name", "weight")

    def __init__(self, name: str, weight: int = DEFAULT_NAMESPACE_WEIGHT):
        self.name = name
        self.weight = weight

    def get_weight(self) -> int:
        if self.weight == 0:
            return DEFAULT_NAMESPACE_WEIGHT
        return self.weight


def _quota_weight(quota: objects.ResourceQuota) -> Optional[int]:
    if NAMESPACE_WEIGHT_KEY not in quota.hard:
        return None
    return int(parse_quantity(quota.hard[NAMESPACE_WEIGHT_KEY]))


class NamespaceCollection:
    """Tracks the weight-bearing quotas of one namespace; the effective
    weight is the max one still present."""

    def __init__(self, name: str):
        self.name = name
        # quota-name -> weight; max wins (the reference uses a heap keyed on
        # weight with named entries — a dict-max is equivalent).
        self._quota_weights: Dict[str, int] = {}

    def update(self, quota: objects.ResourceQuota) -> None:
        w = _quota_weight(quota)
        if w is None:
            self._quota_weights.pop(quota.metadata.name, None)
        else:
            self._quota_weights[quota.metadata.name] = w

    def delete(self, quota: objects.ResourceQuota) -> None:
        self._quota_weights.pop(quota.metadata.name, None)

    def snapshot(self) -> NamespaceInfo:
        if not self._quota_weights:
            return NamespaceInfo(self.name, DEFAULT_NAMESPACE_WEIGHT)
        return NamespaceInfo(self.name, max(self._quota_weights.values()))

    def empty(self) -> bool:
        return not self._quota_weights
