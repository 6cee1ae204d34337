"""Generic dataclass <-> JSON-document codec for the API object model.

The reference serves JSON/protobuf through generated conversion code
(staging/src/k8s.io/api + apimachinery codecs); here the object model is
plain typed dataclasses (kubetpu_torch/api/types.py), so one reflective codec
covers every kind: field types drive decoding, defaults drive omission.
Documents use the dataclass field names verbatim (snake_case) — the wire
format is ours, not Kubernetes'.  A copy of kubetpu/client/codec.py.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Dict, Optional, get_args, get_origin, get_type_hints

from ..api import types as api

# kinds servable through the REST layer (reference: the scheduler-relevant
# resource registry subset, pkg/registry)
KINDS = {
    "Pod": api.Pod, "Node": api.Node, "Service": api.Service,
    "PersistentVolume": api.PersistentVolume,
    "PersistentVolumeClaim": api.PersistentVolumeClaim,
    "StorageClass": api.StorageClass, "CSINode": api.CSINode,
    "ReplicationController": api.ReplicationController,
    "ReplicaSet": api.ReplicaSet, "StatefulSet": api.StatefulSet,
    "PodDisruptionBudget": api.PodDisruptionBudget,
    "Event": None,  # resolved lazily (utils.events.Event)
}

_hints_cache: Dict[type, Dict[str, Any]] = {}


def _hints(cls) -> Dict[str, Any]:
    h = _hints_cache.get(cls)
    if h is None:
        h = get_type_hints(cls)
        _hints_cache[cls] = h
    return h


def to_doc(obj) -> Any:
    """Dataclass tree -> JSON-able document (None fields omitted)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {}
        for f in dataclasses.fields(obj):
            v = to_doc(getattr(obj, f.name))
            if v is None:
                continue
            out[f.name] = v
        return out
    if isinstance(obj, (list, tuple)):
        return [to_doc(x) for x in obj]
    if isinstance(obj, dict):
        return {k: to_doc(v) for k, v in obj.items()}
    if isinstance(obj, set):
        return sorted(obj)
    return obj


def from_doc(cls, doc: Any):
    """JSON document -> instance of the (possibly nested) annotated type."""
    if doc is None:
        return None
    origin = get_origin(cls)
    if origin is typing.Union:                    # Optional[T]
        args = [a for a in get_args(cls) if a is not type(None)]
        return from_doc(args[0], doc) if args else doc
    if origin in (list, tuple):
        (item_t, *_rest) = get_args(cls) or (Any,)
        seq = [from_doc(item_t, x) for x in doc]
        return tuple(seq) if origin is tuple else seq
    if origin is set:
        (item_t,) = get_args(cls) or (Any,)
        return {from_doc(item_t, x) for x in doc}
    if origin is dict:
        args = get_args(cls)
        val_t = args[1] if len(args) == 2 else Any
        return {k: from_doc(val_t, v) for k, v in doc.items()}
    if dataclasses.is_dataclass(cls):
        hints = _hints(cls)
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name in doc:
                kwargs[f.name] = from_doc(hints.get(f.name, Any), doc[f.name])
        return cls(**kwargs)
    return doc


def decode(kind: str, doc: Dict[str, Any]):
    cls = KINDS.get(kind)
    if cls is None and kind == "Event":
        from ..utils.events import Event
        cls = Event
    if cls is None:
        raise ValueError(f"unservable kind {kind!r}")
    return from_doc(cls, doc)
