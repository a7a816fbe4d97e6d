"""MultiRoleInference reconciler: prefill/decode disaggregation.

Parity: ``pkg/controllers/multiroleinference/controller.go:404-720`` —
one InferenceSet per role (shared served-model-name, role labels), a
default endpoint-picker plugin config for PD-aware routing, an
InferencePool per MRI, readiness aggregated across roles.

TPU-native KV hand-off: prefill pods publish KV pages for a request;
the decode pod pulls them over DCN/host-DMA (kaito_tpu.engine.pd);
the EPP routes a request's decode phase to the replica that already
holds its KV.

A copy of ``kaito_tpu.controllers.multiroleinference``.  Each role's
child Workspaces render ``--inference-role <role>`` into the engine
command (``manifests/inference.py``), which both engines' servers take.
The picker is rendered from the catalog entry of the roles' machine
type (``manifests/epp.py``): a GPU MRI's picker is the port's.
"""

from __future__ import annotations

from typing import Optional

from kaito_tpu_torch.api.inferenceset import (
    InferenceSet,
    InferenceSetSpec,
    WorkspaceTemplate,
)
from kaito_tpu_torch.api.meta import Condition, ObjectMeta, set_condition
from kaito_tpu_torch.api.multiroleinference import (
    ROLE_DECODE,
    ROLE_PREFILL,
    MultiRoleInference,
)
from kaito_tpu_torch.api.workspace import InferenceSpec, ResourceSpec
from kaito_tpu_torch.controllers.inferenceset import COND_SET_READY
from kaito_tpu_torch.controllers.objects import Unstructured
from kaito_tpu_torch.controllers.runtime import Reconciler, Result, Store, update_with_retry
from kaito_tpu_torch.sku.catalog import TPUChipSpec, machine_chip

LABEL_MRI = "kaito-tpu.io/multirole-inference"
LABEL_ROLE = "kaito-tpu.io/inference-role"

COND_MRI_READY = "MultiRoleInferenceReady"


def default_pd_plugins_config() -> dict:
    """EPP plugin chain for PD-aware routing (reference:
    defaultPDPluginsConfig, controller.go:566): prefill/decode filter +
    KV-locality scorer + queue-depth scorer."""
    return {
        "plugins": [
            {"type": "pd-filter"},
            {"type": "kv-locality-scorer", "weight": 2},
            {"type": "queue-depth-scorer", "weight": 1},
        ],
    }


class MultiRoleInferenceReconciler(Reconciler):
    kind = "MultiRoleInference"

    def reconcile(self, mri: MultiRoleInference) -> Result:
        if mri.metadata.deletion_timestamp:
            for iset in self.store.list(
                    "InferenceSet", mri.metadata.namespace,
                    labels={LABEL_MRI: mri.metadata.name}):
                self.store.delete("InferenceSet", iset.metadata.namespace,
                                  iset.metadata.name)
            return Result()
        mri.default()
        errs = mri.validate()
        if errs:
            self._set_cond(mri, COND_MRI_READY, "False", "ValidationFailed",
                           "; ".join(errs))
            return Result()

        all_ready = True
        for role in mri.spec.roles:
            iset = self._ensure_role_set(mri, role)
            ready = (iset.status.ready_replicas >= role.replicas)
            all_ready &= ready

            def set_role(o, rt=role.type, rd=ready):
                o.status.role_ready[rt] = rd
            update_with_retry(self.store, "MultiRoleInference",
                              mri.metadata.namespace, mri.metadata.name,
                              set_role)

        self._ensure_inference_pool(mri)
        self._ensure_epp(mri)
        self._set_cond(mri, COND_MRI_READY,
                       "True" if all_ready else "False",
                       "Ready" if all_ready else "RolesPending",
                       "")
        return Result() if all_ready else Result(requeue_after=5.0)

    @staticmethod
    def _serving_chip(mri: MultiRoleInference) -> Optional[TPUChipSpec]:
        """The catalog entry of the first role whose machine type the
        catalog knows (None: the JAX package's picker)."""
        for role in mri.spec.roles:
            chip = machine_chip(role.instance_type)
            if chip is not None:
                return chip
        return None

    def _ensure_role_set(self, mri: MultiRoleInference, role) -> InferenceSet:
        name = f"{mri.metadata.name}-{role.type}"
        existing = self.store.try_get("InferenceSet", mri.metadata.namespace, name)
        if existing is not None:
            if existing.spec.replicas != role.replicas:
                def scale(o):
                    o.spec.replicas = role.replicas
                existing = update_with_retry(
                    self.store, "InferenceSet", mri.metadata.namespace, name, scale)
            return existing
        # role runtime config rides the engine config surface; decode
        # pods get the routing sidecar / KV-pull env via role labels
        iset = InferenceSet(
            ObjectMeta(name=name, namespace=mri.metadata.namespace,
                       labels={LABEL_MRI: mri.metadata.name,
                               LABEL_ROLE: role.type},
                       owner_references=[{"kind": "MultiRoleInference",
                                          "name": mri.metadata.name,
                                          "uid": mri.metadata.uid}]),
            InferenceSetSpec(
                replicas=role.replicas,
                template=WorkspaceTemplate(
                    resource=ResourceSpec(instance_type=role.instance_type,
                                          tpu_topology=role.tpu_topology),
                    inference=InferenceSpec(preset=mri.spec.model.name),
                    labels={LABEL_MRI: mri.metadata.name, LABEL_ROLE: role.type},
                    annotations={"kaito-tpu.io/inference-role": role.type},
                )))
        return self.store.create(iset)

    def _ensure_inference_pool(self, mri: MultiRoleInference) -> None:
        name = f"{mri.metadata.name}-pool"
        if self.store.try_get("InferencePool", mri.metadata.namespace, name):
            return
        plugins = mri.spec.epp_plugins_config or default_pd_plugins_config()
        self.store.create(Unstructured(
            "InferencePool",
            ObjectMeta(name=name, namespace=mri.metadata.namespace,
                       owner_references=[{"kind": "MultiRoleInference",
                                          "name": mri.metadata.name}]),
            spec={
                "targetPortNumber": 5000,
                "selector": {LABEL_MRI: mri.metadata.name},
                "extensionRef": {"name": f"{mri.metadata.name}-epp"},
                "eppPluginsConfig": plugins,
            }))

    def _ensure_epp(self, mri: MultiRoleInference) -> None:
        """Render the PD-aware endpoint picker the pool's extensionRef
        names: backend specs carry ``=role/group`` so the picker's
        pd-filter and kv-locality-scorer can steer decode requests to
        the prefill-owning replica group (docs/routing.md)."""
        from kaito_tpu_torch.api.workspace import LABEL_CREATED_BY_INFERENCESET
        from kaito_tpu_torch.manifests.epp import EPP_PORT, generate_epp_workload

        ns = mri.metadata.namespace
        backends = []
        for ws in self.store.list("Workspace", ns,
                                  labels={LABEL_MRI: mri.metadata.name}):
            role = ws.metadata.labels.get(LABEL_ROLE, "")
            group = ws.metadata.labels.get(LABEL_CREATED_BY_INFERENCESET, "")
            backends.append(
                f"http://{ws.metadata.name}:{EPP_PORT}={role}/{group}")
        backends.sort()
        plugins = mri.spec.epp_plugins_config or default_pd_plugins_config()
        objs = generate_epp_workload(
            f"{mri.metadata.name}-epp", ns, backends=backends,
            plugins_config=plugins,
            owner={"kind": "MultiRoleInference", "name": mri.metadata.name},
            chip=self._serving_chip(mri))
        for obj in objs:
            existing = self.store.try_get(obj.kind, ns, obj.metadata.name)
            if existing is None:
                self.store.create(obj)
            elif (obj.kind == "Deployment"
                  and existing.spec["template"]["spec"]["containers"][0]
                  ["command"]
                  != obj.spec["template"]["spec"]["containers"][0]
                  ["command"]):
                existing.spec = obj.spec
                self.store.update(existing)

    def _set_cond(self, mri, type_, status, reason, message):
        def mutate(o):
            set_condition(o.status.conditions, Condition(
                type=type_, status=status, reason=reason, message=message))
        update_with_retry(self.store, "MultiRoleInference",
                          mri.metadata.namespace, mri.metadata.name, mutate)
