"""RAGEngine reconciler.

Parity: ``pkg/ragengine/controllers/ragengine_controller.go:82`` +
``preset_rag.go:198`` — provision optional compute, render the RAG
service Deployment (env vars carry embedding/LLM/vector-DB config) +
Service, guardrails ConfigMap volume, conditions.

A copy of ``kaito_tpu.controllers.ragengine`` with a GPU half: when
``spec.compute.instanceType`` resolves to a GPU entry of the catalog
(``a3-*``), the Deployment runs ``python -m kaito_tpu_torch.rag.app``
from the entry's image, on the entry's nodes (its node selector and
toleration), and a local embedder asks for one of the entry's devices
(``nvidia.com/gpu``).  A TPU instance type renders what the JAX
operator renders.
"""

from __future__ import annotations

from kaito_tpu_torch.api.meta import Condition, ObjectMeta, set_condition
from kaito_tpu_torch.api.ragengine import (
    COND_RAG_RESOURCE_READY,
    COND_RAG_SERVICE_READY,
    RAGEngine,
)
from kaito_tpu_torch.controllers.objects import Unstructured
from kaito_tpu_torch.controllers.runtime import Reconciler, Result, update_with_retry
from kaito_tpu_torch.manifests.core import generate_service
from kaito_tpu_torch.sku.catalog import TPUSliceSpec, machine_chip

LABEL_RAGENGINE = "kaito-tpu.io/ragengine"


def rag_env(rag: RAGEngine) -> list[dict]:
    """Env contract consumed by kaito_tpu.rag.app (reference:
    pkg/ragengine/manifests/manifests.go:155 env block + config.py)."""
    s = rag.spec
    env = [
        {"name": "LLM_INFERENCE_URL", "value": s.inference_service.url},
        {"name": "LLM_CONTEXT_WINDOW",
         "value": str(s.inference_service.context_window_size or 0)},
        {"name": "VECTOR_DB_ENGINE", "value": s.storage.vector_db.engine},
        {"name": "VECTOR_DB_URL", "value": s.storage.vector_db.url},
    ]
    if s.embedding.local is not None:
        env.append({"name": "EMBEDDING_MODEL_ID",
                    "value": s.embedding.local.model_id})
    if s.embedding.remote is not None:
        env.append({"name": "REMOTE_EMBEDDING_URL",
                    "value": s.embedding.remote.url})
    if s.guardrails.enabled:
        env.append({"name": "GUARDRAILS_POLICY_FILE",
                    "value": "/mnt/guardrails/policy.yaml"})
    return env


def generate_rag_deployment(rag: RAGEngine) -> Unstructured:
    labels = {LABEL_RAGENGINE: rag.metadata.name}
    volumes, mounts = [], []
    if rag.spec.guardrails.enabled and rag.spec.guardrails.config_map_ref:
        volumes.append({"name": "guardrails",
                        "configMap": {"name": rag.spec.guardrails.config_map_ref}})
        mounts.append({"name": "guardrails", "mountPath": "/mnt/guardrails"})
    resources = {}
    if rag.spec.embedding.local is not None:
        # local embedding model runs on one TPU chip (north-star item)
        resources = {"requests": {"google.com/tpu": "1"},
                     "limits": {"google.com/tpu": "1"}}
    dep = _rag_deployment(rag, labels, volumes, mounts, resources)
    instance = rag.spec.compute.instance_type
    chip = machine_chip(instance)
    if chip is not None and chip.engine_package != "kaito_tpu":
        pod = dep.spec["template"]["spec"]
        c = pod["containers"][0]
        c["image"] = chip.image
        c["command"] = ["python", "-m", f"{chip.engine_package}.rag.app",
                        "--port", "5000"]
        if resources:
            c["resources"] = {"requests": {chip.resource: "1"},
                              "limits": {chip.resource: "1"}}
        pod["nodeSelector"] = TPUSliceSpec(
            chip, topology=chip.valid_topologies[0],
            machine_type=instance).node_selector()
        pod["tolerations"] = [{"key": chip.resource, "operator": "Exists",
                               "effect": "NoSchedule"}]
    return dep


def _rag_deployment(rag: RAGEngine, labels: dict, volumes: list,
                    mounts: list, resources: dict) -> Unstructured:
    return Unstructured(
        "Deployment",
        ObjectMeta(name=rag.metadata.name, namespace=rag.metadata.namespace,
                   labels=labels,
                   owner_references=[{"kind": "RAGEngine",
                                      "name": rag.metadata.name}]),
        spec={
            "replicas": 1,
            "selector": {"matchLabels": labels},
            "template": {
                "metadata": {"labels": labels},
                "spec": {
                    "containers": [{
                        "name": "rag",
                        "image": "ghcr.io/kaito-tpu/rag:latest",
                        "command": ["python", "-m", "kaito_tpu.rag.app",
                                    "--port", "5000"],
                        "env": rag_env(rag),
                        "ports": [{"containerPort": 5000}],
                        "volumeMounts": mounts,
                        "resources": resources,
                        "readinessProbe": {
                            "httpGet": {"path": "/health", "port": 5000}},
                    }],
                    "volumes": volumes,
                },
            },
        })


class RAGEngineReconciler(Reconciler):
    kind = "RAGEngine"

    def reconcile(self, rag: RAGEngine) -> Result:
        if rag.metadata.deletion_timestamp:
            return Result()
        rag.default()
        errs = rag.validate()
        if errs:
            self._set_cond(rag, COND_RAG_RESOURCE_READY, "False",
                           "ValidationFailed", "; ".join(errs))
            return Result()
        self._set_cond(rag, COND_RAG_RESOURCE_READY, "True", "Ready", "")

        dep = generate_rag_deployment(rag)
        if self.store.try_get("Deployment", rag.metadata.namespace,
                              dep.metadata.name) is None:
            self.store.create(dep)
        svc_name = rag.metadata.name
        if self.store.try_get("Service", rag.metadata.namespace, svc_name) is None:
            self.store.create(generate_service(
                svc_name, rag.metadata.namespace,
                {LABEL_RAGENGINE: rag.metadata.name}))

        live = self.store.get("Deployment", rag.metadata.namespace,
                              dep.metadata.name)
        ready = live.status.get("readyReplicas", 0) >= 1
        self._set_cond(rag, COND_RAG_SERVICE_READY,
                       "True" if ready else "False",
                       "Ready" if ready else "Pending", "")
        return Result() if ready else Result(requeue_after=5.0)

    def _set_cond(self, rag, type_, status, reason, message):
        def mutate(o):
            set_condition(o.status.conditions, Condition(
                type=type_, status=status, reason=reason, message=message))
        update_with_retry(self.store, "RAGEngine", rag.metadata.namespace,
                          rag.metadata.name, mutate)
