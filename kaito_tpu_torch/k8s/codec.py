"""Typed kinds ⇄ Kubernetes wire JSON.

The reference gets this from apimachinery struct tags; here a generic
dataclass codec maps snake_case attributes to camelCase wire keys, so
the SAME typed objects the in-process Store serves round-trip through a
real API server (group ``kaito-tpu.io/v1``, the shapes in
``config/crd/``).  Anything that is not one of our kinds travels as
:class:`Unstructured` with its payload passed through verbatim.

A copy of ``kaito_tpu.k8s.codec``.
"""

from __future__ import annotations

import dataclasses
import re
import typing
from typing import Any, Optional

from kaito_tpu_torch.api import (
    InferenceSet,
    ModelMirror,
    MultiRoleInference,
    RAGEngine,
    Workspace,
)
from kaito_tpu_torch.api.meta import KaitoObject, ObjectMeta
from kaito_tpu_torch.controllers.objects import _API_VERSIONS, Unstructured
from kaito_tpu_torch.controllers.runtime import ControllerRevision

GROUP_VERSION = "kaito-tpu.io/v1"

TYPED_KINDS = {c.kind: c for c in (
    Workspace, InferenceSet, RAGEngine, MultiRoleInference, ModelMirror)}

# kind -> (api path prefix, plural, namespaced)
RESOURCES: dict[str, tuple[str, str, bool]] = {
    "Workspace": ("/apis/kaito-tpu.io/v1", "workspaces", True),
    "InferenceSet": ("/apis/kaito-tpu.io/v1", "inferencesets", True),
    "RAGEngine": ("/apis/kaito-tpu.io/v1", "ragengines", True),
    "MultiRoleInference": ("/apis/kaito-tpu.io/v1",
                           "multiroleinferences", True),
    "ModelMirror": ("/apis/kaito-tpu.io/v1", "modelmirrors", False),
    "ControllerRevision": ("/apis/apps/v1", "controllerrevisions", True),
    "Node": ("/api/v1", "nodes", False),
    "Service": ("/api/v1", "services", True),
    "ConfigMap": ("/api/v1", "configmaps", True),
    "PersistentVolumeClaim": ("/api/v1", "persistentvolumeclaims", True),
    "StatefulSet": ("/apis/apps/v1", "statefulsets", True),
    "Deployment": ("/apis/apps/v1", "deployments", True),
    "Job": ("/apis/batch/v1", "jobs", True),
    "NodePool": ("/apis/karpenter.sh/v1", "nodepools", False),
    "NodeClaim": ("/apis/karpenter.sh/v1", "nodeclaims", False),
    "InferencePool": ("/apis/inference.networking.x-k8s.io/v1",
                      "inferencepools", True),
}

# our CRDs declare the status subresource: spec and status update
# through different endpoints
STATUS_SUBRESOURCE = set(TYPED_KINDS)


def camel(s: str) -> str:
    # "id" follows the Go/k8s acronym convention on the wire
    # (reference: ragengine_types.go json:"modelID")
    parts = s.split("_")
    return parts[0] + "".join(
        "ID" if p == "id" else p.title() for p in parts[1:])


def _enc(v: Any) -> Any:
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        out = {}
        for f in dataclasses.fields(v):
            val = getattr(v, f.name)
            if val is None:
                continue
            out[camel(f.name)] = _enc(val)
        return out
    if isinstance(v, list):
        return [_enc(x) for x in v]
    if isinstance(v, dict):
        return {k: _enc(x) for k, x in v.items()}
    return v


_MISSING = object()


def _dec_value(tp: Any, w: Any) -> Any:
    origin = typing.get_origin(tp)
    if origin is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if w is None:
            return None
        return _dec_value(args[0], w)
    if origin in (list,):
        (elem,) = typing.get_args(tp) or (Any,)
        return [_dec_value(elem, x) for x in (w or [])]
    if origin in (dict,):
        args = typing.get_args(tp)
        val_t = args[1] if len(args) == 2 else Any
        return {k: _dec_value(val_t, x) for k, x in (w or {}).items()}
    if dataclasses.is_dataclass(tp):
        return _dec_dataclass(tp, w or {})
    if tp in (int, float, str, bool) and w is not None:
        return tp(w)
    return w


def _legacy_camel(s: str) -> str:
    """Pre-acronym spelling (``modelId``): read-compat for CRs
    persisted by builds before camel() learned the ID convention."""
    parts = s.split("_")
    return parts[0] + "".join(p.title() for p in parts[1:])


def _dec_dataclass(cls: type, d: dict) -> Any:
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        w = d.get(camel(f.name), _MISSING)
        if w is _MISSING:
            w = d.get(_legacy_camel(f.name), _MISSING)
        if w is _MISSING:
            continue
        kwargs[f.name] = _dec_value(hints[f.name], w)
    return cls(**kwargs)


def meta_to_wire(m: ObjectMeta) -> dict:
    d: dict = {"name": m.name}
    if m.namespace:
        d["namespace"] = m.namespace
    if m.labels:
        d["labels"] = dict(m.labels)
    if m.annotations:
        d["annotations"] = dict(m.annotations)
    if m.finalizers:
        d["finalizers"] = list(m.finalizers)
    if m.owner_references:
        d["ownerReferences"] = list(m.owner_references)
    if m.uid:
        d["uid"] = m.uid
    if m.generation:
        d["generation"] = m.generation
    if m.resource_version:
        d["resourceVersion"] = str(m.resource_version)
    if m.creation_timestamp:
        d["creationTimestamp"] = m.creation_timestamp
    if m.deletion_timestamp:
        d["deletionTimestamp"] = m.deletion_timestamp
    return d


def meta_from_wire(d: dict) -> ObjectMeta:
    rv_raw = str(d.get("resourceVersion", "") or "0")
    rv = int(rv_raw) if rv_raw.isdigit() else abs(hash(rv_raw)) % 10**9
    return ObjectMeta(
        name=d.get("name", ""),
        namespace=d.get("namespace", "default"),
        labels=dict(d.get("labels") or {}),
        annotations=dict(d.get("annotations") or {}),
        finalizers=list(d.get("finalizers") or []),
        owner_references=list(d.get("ownerReferences") or []),
        uid=d.get("uid", ""),
        generation=int(d.get("generation", 1) or 1),
        resource_version=rv,
        creation_timestamp=d.get("creationTimestamp", ""),
        deletion_timestamp=d.get("deletionTimestamp"),
    )


def to_wire(obj: KaitoObject) -> dict:
    if isinstance(obj, ControllerRevision):
        return {"apiVersion": "apps/v1", "kind": obj.kind,
                "metadata": meta_to_wire(obj.metadata),
                "data": obj.data, "revision": obj.revision}
    if isinstance(obj, Unstructured):
        d = {"apiVersion": _API_VERSIONS.get(obj.kind, "v1"),
             "kind": obj.kind, "metadata": meta_to_wire(obj.metadata)}
        if obj.spec:
            d["spec"] = obj.spec
        if obj.status:
            d["status"] = obj.status
        return d
    d = {"apiVersion": GROUP_VERSION, "kind": obj.kind,
         "metadata": meta_to_wire(obj.metadata)}
    for name, v in vars(obj).items():
        if name in ("metadata", "kind") or v is None:
            continue
        d["status" if name == "status" else camel(name)] = _enc(v)
    return d


def from_wire(d: dict) -> KaitoObject:
    from kaito_tpu_torch.api.conversion import convert_to_hub, is_legacy

    if is_legacy(d):
        # hub-and-spoke conversion (reference: ragengine_conversion.go)
        d = convert_to_hub(d)
    kind = d["kind"]
    meta = meta_from_wire(d.get("metadata", {}))
    if kind == "ControllerRevision":
        return ControllerRevision(meta, data=dict(d.get("data") or {}),
                                  revision=int(d.get("revision", 0) or 0))
    cls = TYPED_KINDS.get(kind)
    if cls is None:
        return Unstructured(kind, meta, spec=dict(d.get("spec") or {}),
                            status=dict(d.get("status") or {}))
    hints = typing.get_type_hints(cls.__init__)
    kwargs = {}
    for pname, ptype in hints.items():
        if pname in ("meta", "return"):
            continue
        w = d.get(camel(pname))
        if w is None:
            continue
        kwargs[pname] = _dec_value(ptype, w)
    obj = cls(meta, **kwargs)
    status_w = d.get("status")
    if status_w and dataclasses.is_dataclass(getattr(obj, "status", None)):
        obj.status = _dec_dataclass(type(obj.status), status_w)
    return obj


def resource_path(kind: str, namespace: Optional[str] = None,
                  name: Optional[str] = None,
                  subresource: str = "") -> str:
    """REST path for a kind (list/collection path when name is None)."""
    try:
        prefix, plural, namespaced = RESOURCES[kind]
    except KeyError:
        raise KeyError(f"kind {kind!r} has no registered REST mapping")
    if namespaced and namespace:
        path = f"{prefix}/namespaces/{namespace}/{plural}"
    else:
        path = f"{prefix}/{plural}"
    if name:
        path += f"/{name}"
    if subresource:
        path += f"/{subresource}"
    return path
