"""Plugin argument map with typed getters
(volcano pkg/scheduler/framework/arguments.go:27-66)."""

from __future__ import annotations

from typing import Dict, Optional


class Arguments(dict):
    """str->str map; getters leave the default unchanged on missing/bad keys."""

    def get_int(self, key: str, default: int) -> int:
        v = self.get(key)
        if v is None or v == "":
            return default
        try:
            return int(v)
        except (TypeError, ValueError):
            return default

    def get_bool(self, key: str, default: bool) -> bool:
        v = self.get(key)
        if v is None or v == "":
            return default
        if isinstance(v, bool):
            return v
        return str(v).strip().lower() in ("1", "t", "true", "yes")

    def get_float(self, key: str, default: float) -> float:
        v = self.get(key)
        if v is None or v == "":
            return default
        try:
            return float(v)
        except (TypeError, ValueError):
            return default
