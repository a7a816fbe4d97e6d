"""Generic (unstructured) cluster objects: Nodes, NodePools,
StatefulSets, Services, Jobs — anything that isn't one of our typed
kinds lives in the store as an Unstructured with a YAML-shaped payload.

A copy of ``kaito_tpu.controllers.objects``.
"""

from __future__ import annotations

from typing import Optional

from kaito_tpu_torch.api.meta import KaitoObject, ObjectMeta


class Unstructured(KaitoObject):
    def __init__(self, kind: str, meta: ObjectMeta,
                 spec: Optional[dict] = None, status: Optional[dict] = None):
        self.kind = kind
        super().__init__(meta)
        self.spec = spec or {}
        self.status = status or {}

    def to_dict(self) -> dict:
        return {
            "apiVersion": _API_VERSIONS.get(self.kind, "v1"),
            "kind": self.kind,
            "metadata": {
                "name": self.metadata.name,
                "namespace": self.metadata.namespace,
                "labels": dict(self.metadata.labels),
                "annotations": dict(self.metadata.annotations),
            },
            "spec": self.spec,
        }


_API_VERSIONS = {
    "Node": "v1",
    "Service": "v1",
    "ConfigMap": "v1",
    "StatefulSet": "apps/v1",
    "Deployment": "apps/v1",
    "ControllerRevision": "apps/v1",
    "Job": "batch/v1",
    "NodePool": "karpenter.sh/v1",
    "NodeClaim": "karpenter.sh/v1",
    "PersistentVolumeClaim": "v1",
    "InferencePool": "inference.networking.x-k8s.io/v1",
}


def node(name: str, labels: dict, ready: bool = True) -> Unstructured:
    return Unstructured(
        "Node", ObjectMeta(name=name, namespace="", labels=dict(labels)),
        status={"ready": ready})


def is_node_ready(n: Unstructured) -> bool:
    return bool(n.status.get("ready"))
