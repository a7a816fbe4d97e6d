"""BYO provisioner: no-op provisioning against user-labeled nodes.

Parity: ``pkg/nodeprovision/byo-provisioner/byo_provisioner.go:131`` —
nodes are matched purely by the workspace's labelSelector; the slice
shape is derived from the nodes' TPU labels
(sku.get_tpu_config_from_node_labels), never created.

A copy of ``kaito_tpu.provision.byo``.
"""

from __future__ import annotations

from kaito_tpu_torch.controllers.objects import is_node_ready
from kaito_tpu_torch.controllers.runtime import Store
from kaito_tpu_torch.provision.provisioner import ProvisionRequest


class BYOProvisioner:
    name = "byo"

    def __init__(self, store: Store):
        self.store = store

    def provision(self, req: ProvisionRequest) -> None:
        return  # bring-your-own: nothing to create

    def ensure_ready(self, req: ProvisionRequest) -> tuple[bool, list[str]]:
        nodes = self.store.list("Node", labels=req.extra_labels or None)
        if req.preferred_nodes:
            nodes = [n for n in nodes if n.metadata.name in req.preferred_nodes] or nodes
        ready = sorted(n.metadata.name for n in nodes if is_node_ready(n))
        want = req.slice_spec.num_hosts * req.num_slices
        return len(ready) >= want, ready[:want] if len(ready) >= want else ready

    def deprovision(self, req: ProvisionRequest) -> None:
        return

    def node_selector(self, req: ProvisionRequest) -> dict[str, str]:
        return dict(req.extra_labels)

    def set_drift_budget(self, req: ProvisionRequest, allow: bool) -> None:
        return
