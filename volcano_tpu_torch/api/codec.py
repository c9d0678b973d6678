"""Wire codec for the API object model: dataclass <-> JSON-safe dicts.

The reference's CRDs travel as JSON through the Kubernetes API server;
here the same objects (api/objects.py dataclasses) travel through the
store gateway (store/gateway.py) to remote clients (store/remote.py,
vcctl --server). The model is deliberately JSON-shaped — plain
dataclasses of primitives, lists, string-keyed dicts and nested
dataclasses, no enums — so the codec is a generic reflection over
dataclass fields with type-hint-driven hydration.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Dict, Optional, get_type_hints

from volcano_tpu_torch.api import objects

# kind -> dataclass, for every store-storable object (classes declaring
# KIND) plus the nested types hydrate() reaches through type hints
_KINDS: Dict[str, type] = {}
for _name in dir(objects):
    _cls = getattr(objects, _name)
    if isinstance(_cls, type) and dataclasses.is_dataclass(_cls):
        kind = getattr(_cls, "KIND", None)
        if isinstance(kind, str) and kind:
            _KINDS[kind] = _cls

_hints_cache: Dict[type, Dict[str, Any]] = {}


def kind_class(kind: str) -> type:
    cls = _KINDS.get(kind)
    if cls is None:
        raise KeyError(f"unknown kind {kind!r}")
    return cls


def to_wire(obj: Any) -> Any:
    """Dataclass tree -> JSON-safe structure (no type tags needed: the
    receiver hydrates against the declared field types)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {
            f.name: to_wire(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
        }
    if isinstance(obj, dict):
        return {k: to_wire(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_wire(v) for v in obj]
    return obj


def envelope(obj: Any) -> dict:
    """{kind, object} wrapper for transport."""
    kind = getattr(obj, "KIND", None) or type(obj).__name__
    return {"kind": kind, "object": to_wire(obj)}


def from_envelope(data: dict) -> Any:
    return from_wire(kind_class(data["kind"]), data["object"])


def _hints(cls: type) -> Dict[str, Any]:
    h = _hints_cache.get(cls)
    if h is None:
        h = _hints_cache[cls] = get_type_hints(cls)
    return h


def from_wire(cls: type, data: Optional[dict]) -> Any:
    """Hydrate a dataclass tree from its wire form, using field type
    hints; unknown fields are ignored (forward compatibility)."""
    if data is None:
        return None
    hints = _hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        kwargs[f.name] = _hydrate(hints.get(f.name, Any), data[f.name])
    return cls(**kwargs)


def _hydrate(hint: Any, raw: Any) -> Any:
    if raw is None:
        return None
    origin = typing.get_origin(hint)
    if origin is typing.Union:  # Optional[X] and friends
        for arg in typing.get_args(hint):
            if arg is type(None):
                continue
            return _hydrate(arg, raw)
        return raw
    if origin in (list, tuple):
        (arg,) = typing.get_args(hint) or (Any,)
        return [_hydrate(arg, v) for v in raw]
    if origin is dict:
        args = typing.get_args(hint)
        varg = args[1] if len(args) == 2 else Any
        return {k: _hydrate(varg, v) for k, v in raw.items()}
    if isinstance(hint, type) and dataclasses.is_dataclass(hint):
        return from_wire(hint, raw)
    return raw
