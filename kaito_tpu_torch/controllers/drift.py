"""Drift reconciler: safe rolling node replacement.

Parity: ``pkg/controllers/drift/controller.go:96-246`` — when a node of
a workspace is marked drifted AND the workspace's InferenceSet has at
least one other ready replica, open that workspace's NodePool drift
budget (0→1) so the provisioner can replace the node; close budgets
once drift clears.  One pool at a time cluster-wide.

A copy of ``kaito_tpu.controllers.drift``.  A GPU node carries the
same owner label (``provision/karpenter.py``), so a drifted A3 node is
seen the same way; the budget request is keyed by its owner alone.
"""

from __future__ import annotations

from kaito_tpu_torch.api.meta import condition_true
from kaito_tpu_torch.api.workspace import (
    COND_INFERENCE_READY,
    LABEL_CREATED_BY_INFERENCESET,
)
from kaito_tpu_torch.controllers.runtime import Reconciler, Result, Store
from kaito_tpu_torch.k8s.events import record_event
from kaito_tpu_torch.provision.karpenter import LABEL_OWNER
from kaito_tpu_torch.provision.provisioner import ProvisionRequest
from kaito_tpu_torch.sku.catalog import CHIP_CATALOG, TPUSliceSpec


class DriftReconciler(Reconciler):
    kind = "Workspace"

    def __init__(self, store: Store, provisioner):
        super().__init__(store)
        self.provisioner = provisioner

    def _drifted_owners(self) -> set[str]:
        out = set()
        for n in self.store.list("Node"):
            if n.status.get("drifted"):
                owner = n.metadata.labels.get(LABEL_OWNER)
                if owner:
                    out.add(owner)
        return out

    def _has_ready_sibling(self, ws) -> bool:
        iset_name = ws.metadata.labels.get(LABEL_CREATED_BY_INFERENCESET)
        if not iset_name:
            return False
        siblings = self.store.list(
            "Workspace", ws.metadata.namespace,
            labels={LABEL_CREATED_BY_INFERENCESET: iset_name})
        return any(
            s.metadata.name != ws.metadata.name
            and condition_true(s.status.conditions, COND_INFERENCE_READY)
            for s in siblings)

    def _req(self, ws) -> ProvisionRequest:
        # budget toggling only needs the owner name; slice spec is moot
        # (a GPU Workspace's pools are found by the same owner label)
        return ProvisionRequest(
            owner_name=ws.metadata.name,
            owner_namespace=ws.metadata.namespace,
            slice_spec=TPUSliceSpec(chip=CHIP_CATALOG["v5e"], topology="1x1"))

    def reconcile_drift(self) -> Result:
        """Cluster-wide pass (not per-object): open at most ONE budget."""
        drifted = self._drifted_owners()
        opened = False
        for ws in self.store.list("Workspace"):
            req = self._req(ws)
            if ws.metadata.name in drifted and not opened \
                    and self._has_ready_sibling(ws):
                self.provisioner.set_drift_budget(req, True)
                opened = True
                record_event(self.store, ws, "Warning", "DriftDetected",
                             "drifted node detected; disruption budget "
                             "opened for rolling replacement")
            else:
                self.provisioner.set_drift_budget(req, False)
        return Result(requeue_after=30.0 if drifted else 0.0)

    def reconcile(self, obj) -> Result:
        return self.reconcile_drift()
