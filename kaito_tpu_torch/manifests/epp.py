"""Endpoint-picker (EPP) workload rendering.

Both controllers render an InferencePool whose ``extensionRef`` names
``<cr>-epp``; these helpers render the Deployment + Service that make
the ref resolve (docs/routing.md).  The picker is the in-repo
``kaito_tpu.runtime.epp`` service: the backend set is passed as
``--backend url[=role[/group]]`` args, recomputed by the owning
reconciler whenever replicas come and go (the in-miniature analogue of
the GAIE EPP watching pods behind the pool selector).

A copy of ``kaito_tpu.manifests.epp`` that renders from the catalog
entry the set is served on: the picker runs as ``python -m
<package>.runtime.epp`` from the entry's image, so a GPU set's picker is
the port's.  Without an entry (a template that does not plan) it is the
JAX package's, as the JAX operator renders it.
"""

from __future__ import annotations

import json
from typing import Optional

from kaito_tpu_torch.api.meta import ObjectMeta
from kaito_tpu_torch.controllers.objects import Unstructured
from kaito_tpu_torch.manifests.core import generate_service
from kaito_tpu_torch.sku.catalog import TPU_IMAGE, TPUChipSpec

EPP_PORT = 5000
LABEL_EPP = "kaito-tpu.io/epp"


def build_epp_command(backends: list[str], *,
                      plugins_config: Optional[dict] = None,
                      block_chars: int = 0,
                      draining: Optional[list[str]] = None,
                      kv_pool: bool = False,
                      adapter_affinity: bool = False,
                      package: str = "kaito_tpu") -> list[str]:
    """The container command: one ``--backend`` per replica spec
    (``url[=role[/group]]``), the plugin chain inline as JSON, and one
    ``--drain-backend`` per replica the autoscaler is retiring (the
    picker keeps relaying its in-flight work but stops scoring it).
    ``kv_pool`` mirrors the engines' ``kaito-tpu.io/kv-pool``
    annotation: the picker scrapes holder adverts and emits fetch
    hints only when the replicas actually publish (docs/kv-pool.md).
    ``adapter_affinity`` mirrors ``kaito-tpu.io/adapters`` the same
    way: resident-adapter adverts are only worth scraping when the
    replicas run the adapter cache (docs/multi-lora.md).  ``package`` is
    the engine package whose picker runs."""
    cmd = ["python", "-m", f"{package}.runtime.epp",
           "--port", str(EPP_PORT)]
    for spec in backends:
        cmd += ["--backend", spec]
    for url in draining or []:
        cmd += ["--drain-backend", url]
    if plugins_config:
        cmd += ["--plugins-config",
                json.dumps(plugins_config, sort_keys=True)]
    if block_chars:
        cmd += ["--block-chars", str(block_chars)]
    if kv_pool:
        cmd += ["--kv-pool"]
    if adapter_affinity:
        cmd += ["--adapter-affinity"]
    return cmd


def generate_epp_workload(name: str, namespace: str, *,
                          backends: list[str],
                          owner: Optional[dict] = None,
                          plugins_config: Optional[dict] = None,
                          draining: Optional[list[str]] = None,
                          kv_pool: bool = False,
                          adapter_affinity: bool = False,
                          chip: Optional[TPUChipSpec] = None) -> list:
    """Render the ``<name>`` (conventionally ``<cr>-epp``) Deployment +
    Service the InferencePool's extensionRef resolves to, running the
    picker of ``chip``'s engine package from its image (None: the JAX
    package's)."""
    package = chip.engine_package if chip is not None else "kaito_tpu"
    image = chip.image if chip is not None else TPU_IMAGE
    labels = {LABEL_EPP: name}
    owners = [owner] if owner else []
    deploy = Unstructured(
        "Deployment",
        ObjectMeta(name=name, namespace=namespace, labels=dict(labels),
                   owner_references=list(owners)),
        spec={
            "replicas": 1,
            "selector": {"matchLabels": dict(labels)},
            "template": {
                "metadata": {"labels": dict(labels)},
                "spec": {
                    "containers": [{
                        "name": "epp",
                        "image": image,
                        "command": build_epp_command(
                            backends, plugins_config=plugins_config,
                            draining=draining, kv_pool=kv_pool,
                            adapter_affinity=adapter_affinity,
                            package=package),
                        "ports": [{"containerPort": EPP_PORT}],
                        "readinessProbe": {
                            "httpGet": {"path": "/router/stats",
                                        "port": EPP_PORT},
                            "periodSeconds": 5,
                        },
                        "resources": {
                            "requests": {"cpu": "500m", "memory": "1Gi"},
                        },
                    }],
                },
            },
        })
    svc = generate_service(name, namespace, labels, port=EPP_PORT,
                           labels=labels)
    svc.metadata.owner_references = list(owners)
    return [deploy, svc]
