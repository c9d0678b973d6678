"""Kubernetes-style resource quantity parsing.

Accepts ints/floats directly, or strings in the k8s quantity grammar:
plain numbers ("2", "1.5", "1e3"), milli-suffixed ("500m"), binary
suffixes ("8Gi"), and decimal suffixes ("2k", "1G").
"""

from __future__ import annotations

_BINARY = {
    "Ki": 2**10,
    "Mi": 2**20,
    "Gi": 2**30,
    "Ti": 2**40,
    "Pi": 2**50,
    "Ei": 2**60,
}
_DECIMAL = {
    "k": 10**3,
    "M": 10**6,
    "G": 10**9,
    "T": 10**12,
    "P": 10**15,
    "E": 10**18,
}


def parse_quantity(q) -> float:
    """Parse a quantity into its base-unit value (cores, bytes, counts)."""
    if isinstance(q, (int, float)):
        return float(q)
    if not isinstance(q, str):
        raise TypeError(f"cannot parse quantity from {type(q)!r}")
    s = q.strip()
    if not s:
        raise ValueError("empty quantity")

    for suffix, mult in _BINARY.items():
        if s.endswith(suffix):
            return float(s[: -len(suffix)]) * mult
    if s.endswith("m"):
        return float(s[:-1]) / 1000.0
    # Decimal suffixes are single characters; check after "m" (milli) and
    # binary ("Mi" etc., already handled above).
    if s[-1] in _DECIMAL and not s[-1].isdigit():
        return float(s[:-1]) * _DECIMAL[s[-1]]
    return float(s)


def milli_value(q) -> float:
    """Quantity scaled to milli-units (the scheduler's working unit for CPU
    and scalar resources, matching k8s Quantity.MilliValue)."""
    return parse_quantity(q) * 1000.0
