"""NodeProvisioner interface.

Parity with the reference's pluggable provisioning backend
(``pkg/nodeprovision/provisioner.go:36-100``): ProvisionNodes /
EnsureNodesReady / DeleteNodes / BuildNodeSelector, re-expressed for
TPU slices — the unit of provisioning is a slice (NodePool whose nodes
carry ``gke-tpu-accelerator``/``gke-tpu-topology`` labels), not a VM
count.

A copy of ``kaito_tpu.provision.provisioner``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Protocol

from kaito_tpu_torch.sku.catalog import TPUSliceSpec


@dataclass
class ProvisionRequest:
    owner_name: str
    owner_namespace: str
    slice_spec: TPUSliceSpec
    num_slices: int = 1
    extra_labels: dict[str, str] = field(default_factory=dict)
    preferred_nodes: list[str] = field(default_factory=list)


class NodeProvisioner(Protocol):
    name: str

    def provision(self, req: ProvisionRequest) -> None:
        """Ensure capacity objects exist (idempotent)."""

    def ensure_ready(self, req: ProvisionRequest) -> tuple[bool, list[str]]:
        """Returns (all slices ready, ready node names)."""

    def deprovision(self, req: ProvisionRequest) -> None:
        """Tear down capacity for the owner."""

    def node_selector(self, req: ProvisionRequest) -> dict[str, str]:
        """Labels the workload pods must schedule onto."""

    def set_drift_budget(self, req: ProvisionRequest, allow: bool) -> None:
        """Open/close the rolling node-replacement budget (drift)."""
