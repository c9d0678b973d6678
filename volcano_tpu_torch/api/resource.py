"""Resource vector arithmetic with the reference's epsilon semantics.

Parity-critical: binding decisions depend on the exact comparison semantics of
the reference implementation (volcano pkg/scheduler/api/resource_info.go):

- working units are milli-CPU, bytes of memory, and milli-units of arbitrary
  scalar resources (e.g. "nvidia.com/gpu");
- ``less_equal`` uses per-dimension epsilons (resource_info.go:267-301):
  10 milli-CPU, 10 MiB memory, 10 milli-scalar;
- ``sub`` asserts sufficiency first (resource_info.go:145-159);
- scalar dimensions absent from a Resource are treated as zero, with the same
  nil-map special cases the reference has.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional

from volcano_tpu_torch.api.quantity import milli_value, parse_quantity
from volcano_tpu_torch.utils.assertions import assertf

GPU_RESOURCE_NAME = "nvidia.com/gpu"

# Minimum meaningful quantities (resource_info.go:70-72).
MIN_MILLI_CPU = 10.0
MIN_MILLI_SCALAR = 10.0
MIN_MEMORY = 10.0 * 1024 * 1024

_NATIVE = ("cpu", "memory", "pods")


def is_scalar_resource_name(name: str) -> bool:
    """Mirrors k8s v1helper.IsScalarResourceName: extended resources
    (non-kubernetes.io domain-prefixed, not quota "requests.*" aliases),
    hugepages, and attachable volume counts."""
    if name.startswith("hugepages-") or name.startswith("attachable-volumes-"):
        return True
    if name.startswith("requests."):
        return False
    if "/" in name:
        return name.split("/", 1)[0] != "kubernetes.io"
    return False


class Resource:
    """A resource vector: milli_cpu (milli-cores), memory (bytes), and a map
    of scalar resources in milli-units.

    ``max_task_num`` (from the "pods" resource) is only consulted by
    predicates and deliberately excluded from arithmetic
    (resource_info.go:37-39).
    """

    __slots__ = ("milli_cpu", "memory", "scalar_resources", "max_task_num")

    def __init__(
        self,
        milli_cpu: float = 0.0,
        memory: float = 0.0,
        scalar_resources: Optional[Dict[str, float]] = None,
        max_task_num: int = 0,
    ):
        self.milli_cpu = float(milli_cpu)
        self.memory = float(memory)
        self.scalar_resources: Optional[Dict[str, float]] = scalar_resources
        self.max_task_num = max_task_num

    # -- constructors ------------------------------------------------------

    @classmethod
    def empty(cls) -> "Resource":
        return cls()

    @classmethod
    def from_resource_list(cls, rl: Optional[Dict[str, object]]) -> "Resource":
        """Build from a k8s-style resource list, e.g.
        ``{"cpu": "4", "memory": "8Gi", "pods": 110, "nvidia.com/gpu": 1}``
        (resource_info.go:75-93)."""
        r = cls()
        if not rl:
            return r
        for name, quant in rl.items():
            if name == "cpu":
                r.milli_cpu += milli_value(quant)
            elif name == "memory":
                r.memory += parse_quantity(quant)
            elif name == "pods":
                r.max_task_num += int(parse_quantity(quant))
            elif is_scalar_resource_name(name):
                r.add_scalar(name, milli_value(quant))
        return r

    def clone(self) -> "Resource":
        return Resource(
            self.milli_cpu,
            self.memory,
            dict(self.scalar_resources) if self.scalar_resources is not None else None,
            self.max_task_num,
        )

    # -- predicates --------------------------------------------------------

    def is_empty(self) -> bool:
        """True when every dimension is below its minimum meaningful value
        (resource_info.go:96-108)."""
        if not (self.milli_cpu < MIN_MILLI_CPU and self.memory < MIN_MEMORY):
            return False
        for quant in (self.scalar_resources or {}).values():
            if quant >= MIN_MILLI_SCALAR:
                return False
        return True

    def is_zero(self, name: str) -> bool:
        """True when the named dimension is below its minimum
        (resource_info.go:111-127)."""
        if name == "cpu":
            return self.milli_cpu < MIN_MILLI_CPU
        if name == "memory":
            return self.memory < MIN_MEMORY
        if self.scalar_resources is None:
            return True
        assertf(name in self.scalar_resources, "unknown resource %s", name)
        return self.scalar_resources.get(name, 0.0) < MIN_MILLI_SCALAR

    # -- arithmetic (mutating, returning self, like the reference) ---------

    def add(self, rr: "Resource") -> "Resource":
        self.milli_cpu += rr.milli_cpu
        self.memory += rr.memory
        for name, quant in (rr.scalar_resources or {}).items():
            if self.scalar_resources is None:
                self.scalar_resources = {}
            self.scalar_resources[name] = self.scalar_resources.get(name, 0.0) + quant
        return self

    def sub(self, rr: "Resource") -> "Resource":
        """Subtract, asserting sufficiency (resource_info.go:145-159)."""
        assertf(
            rr.less_equal(self),
            "resource is not sufficient to do operation: <%s> sub <%s>",
            self,
            rr,
        )
        self.milli_cpu -= rr.milli_cpu
        self.memory -= rr.memory
        if self.scalar_resources is None:
            return self
        for name, quant in (rr.scalar_resources or {}).items():
            self.scalar_resources[name] = self.scalar_resources.get(name, 0.0) - quant
        return self

    def multi(self, ratio: float) -> "Resource":
        self.milli_cpu *= ratio
        self.memory *= ratio
        for name in self.scalar_resources or {}:
            self.scalar_resources[name] *= ratio
        return self

    def set_max_resource(self, rr: Optional["Resource"]) -> None:
        """Per-dimension max, in place (resource_info.go:162-187)."""
        if rr is None:
            return
        if rr.milli_cpu > self.milli_cpu:
            self.milli_cpu = rr.milli_cpu
        if rr.memory > self.memory:
            self.memory = rr.memory
        for name, quant in (rr.scalar_resources or {}).items():
            if self.scalar_resources is None:
                self.scalar_resources = dict(rr.scalar_resources)
                return
            if quant > self.scalar_resources.get(name, 0.0):
                self.scalar_resources[name] = quant

    def fit_delta(self, rr: "Resource") -> "Resource":
        """Availability minus request, padded by the per-dimension minimum;
        any negative dimension marks insufficiency (resource_info.go:193-213)."""
        if rr.milli_cpu > 0:
            self.milli_cpu -= rr.milli_cpu + MIN_MILLI_CPU
        if rr.memory > 0:
            self.memory -= rr.memory + MIN_MEMORY
        for name, quant in (rr.scalar_resources or {}).items():
            if self.scalar_resources is None:
                self.scalar_resources = {}
            if quant > 0:
                self.scalar_resources[name] = (
                    self.scalar_resources.get(name, 0.0) - quant - MIN_MILLI_SCALAR
                )
        return self

    # -- comparisons -------------------------------------------------------

    def less(self, rr: "Resource") -> bool:
        """Strictly less on every dimension (resource_info.go:226-264,
        including its nil-map asymmetries)."""
        if not self.milli_cpu < rr.milli_cpu:
            return False
        if not self.memory < rr.memory:
            return False
        if self.scalar_resources is None:
            if rr.scalar_resources is not None:
                for quant in rr.scalar_resources.values():
                    if quant <= MIN_MILLI_SCALAR:
                        return False
            return True
        if rr.scalar_resources is None:
            return False
        for name, quant in self.scalar_resources.items():
            if not quant < rr.scalar_resources.get(name, 0.0):
                return False
        return True

    def less_equal(self, rr: "Resource") -> bool:
        """Less-or-equal with per-dimension epsilon tolerance
        (resource_info.go:267-301). THE feasibility comparison."""

        def le(l: float, r: float, diff: float) -> bool:
            return l < r or abs(l - r) < diff

        if not le(self.milli_cpu, rr.milli_cpu, MIN_MILLI_CPU):
            return False
        if not le(self.memory, rr.memory, MIN_MEMORY):
            return False
        if self.scalar_resources is None:
            return True
        for name, quant in self.scalar_resources.items():
            if quant <= MIN_MILLI_SCALAR:
                continue
            if rr.scalar_resources is None:
                return False
            if not le(quant, rr.scalar_resources.get(name, 0.0), MIN_MILLI_SCALAR):
                return False
        return True

    def diff(self, rr: "Resource") -> tuple["Resource", "Resource"]:
        """(increased, decreased) per-dimension differences
        (resource_info.go:304-336)."""
        inc, dec = Resource(), Resource()
        if self.milli_cpu > rr.milli_cpu:
            inc.milli_cpu += self.milli_cpu - rr.milli_cpu
        else:
            dec.milli_cpu += rr.milli_cpu - self.milli_cpu
        if self.memory > rr.memory:
            inc.memory += self.memory - rr.memory
        else:
            dec.memory += rr.memory - self.memory
        for name, quant in (self.scalar_resources or {}).items():
            rr_quant = (rr.scalar_resources or {}).get(name, 0.0)
            if quant > rr_quant:
                if inc.scalar_resources is None:
                    inc.scalar_resources = {}
                inc.scalar_resources[name] = (
                    inc.scalar_resources.get(name, 0.0) + quant - rr_quant
                )
            else:
                if dec.scalar_resources is None:
                    dec.scalar_resources = {}
                dec.scalar_resources[name] = (
                    dec.scalar_resources.get(name, 0.0) + rr_quant - quant
                )
        return inc, dec

    # -- accessors ---------------------------------------------------------

    def get(self, name: str) -> float:
        if name == "cpu":
            return self.milli_cpu
        if name == "memory":
            return self.memory
        if self.scalar_resources is None:
            return 0.0
        return self.scalar_resources.get(name, 0.0)

    def resource_names(self) -> list[str]:
        return ["cpu", "memory", *list(self.scalar_resources or {})]

    def add_scalar(self, name: str, quantity: float) -> None:
        self.set_scalar(name, (self.scalar_resources or {}).get(name, 0.0) + quantity)

    def set_scalar(self, name: str, quantity: float) -> None:
        if self.scalar_resources is None:
            self.scalar_resources = {}
        self.scalar_resources[name] = quantity

    # -- misc --------------------------------------------------------------

    def __repr__(self) -> str:
        s = f"cpu {self.milli_cpu:0.2f}, memory {self.memory:0.2f}"
        for name, quant in (self.scalar_resources or {}).items():
            s += f", {name} {quant:0.2f}"
        return s

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Resource):
            return NotImplemented
        if self.milli_cpu != other.milli_cpu or self.memory != other.memory:
            return False
        mine = {k: v for k, v in (self.scalar_resources or {}).items() if v != 0}
        theirs = {k: v for k, v in (other.scalar_resources or {}).items() if v != 0}
        return mine == theirs

    def __hash__(self):
        raise TypeError("Resource is mutable and unhashable")
