"""Core k8s manifest rendering (dict-shaped; reference analogue is the
functional-options generator ``pkg/utils/generator/generator.go`` +
``pkg/workspace/manifests/manifests.go``).

A copy of ``kaito_tpu.manifests.core``.
"""

from __future__ import annotations

from typing import Optional

from kaito_tpu_torch.api.meta import ObjectMeta
from kaito_tpu_torch.controllers.objects import Unstructured
from kaito_tpu_torch.sku.catalog import RESOURCE_TPU


def generate_service(name: str, namespace: str, selector: dict,
                     port: int = 5000, headless: bool = False,
                     labels: Optional[dict] = None) -> Unstructured:
    spec = {
        "selector": dict(selector),
        "ports": [{"name": "http", "port": port, "targetPort": port}],
    }
    if headless:
        spec["clusterIP"] = "None"
        spec["publishNotReadyAddresses"] = True
    return Unstructured(
        "Service",
        ObjectMeta(name=name, namespace=namespace, labels=dict(labels or {})),
        spec=spec)


def generate_headless_service(name: str, namespace: str, selector: dict,
                              labels: Optional[dict] = None) -> Unstructured:
    """Pod-identity DNS for multi-host rendezvous (the reference uses a
    headless service for Ray leader discovery, manifests.go; ours feeds
    the JAX coordinator address <name>-0.<name>-headless...)."""
    return generate_service(f"{name}-headless", namespace, selector,
                            headless=True, labels=labels)


def generate_statefulset(
    name: str,
    namespace: str,
    *,
    replicas: int,
    labels: dict,
    node_selector: dict,
    containers: list[dict],
    init_containers: Optional[list[dict]] = None,
    volumes: Optional[list[dict]] = None,
    service_name: str = "",
    tolerations: Optional[list[dict]] = None,
) -> Unstructured:
    pod_spec = {
        "nodeSelector": dict(node_selector),
        "containers": containers,
        "tolerations": tolerations or [
            {"key": RESOURCE_TPU, "operator": "Exists",
             "effect": "NoSchedule"}],
    }
    if init_containers:
        pod_spec["initContainers"] = init_containers
    if volumes:
        pod_spec["volumes"] = volumes
    return Unstructured(
        "StatefulSet",
        ObjectMeta(name=name, namespace=namespace, labels=dict(labels)),
        spec={
            "replicas": replicas,
            "serviceName": service_name or f"{name}-headless",
            "podManagementPolicy": "Parallel",
            "selector": {"matchLabels": dict(labels)},
            "template": {
                "metadata": {"labels": dict(labels)},
                "spec": pod_spec,
            },
        })
