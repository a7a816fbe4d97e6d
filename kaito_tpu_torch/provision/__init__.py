"""A copy of ``kaito_tpu.provision``."""

from kaito_tpu_torch.provision.provisioner import NodeProvisioner, ProvisionRequest  # noqa: F401
from kaito_tpu_torch.provision.karpenter import KarpenterTPUProvisioner  # noqa: F401
from kaito_tpu_torch.provision.byo import BYOProvisioner  # noqa: F401
from kaito_tpu_torch.provision.fake import FakeCloud  # noqa: F401


def new_node_provisioner(kind: str, store):
    """Factory (reference: ``pkg/nodeprovision/manager/factory.go:66``)."""
    if kind == "karpenter":
        return KarpenterTPUProvisioner(store)
    if kind == "byo":
        return BYOProvisioner(store)
    raise ValueError(f"unknown node provisioner {kind!r} (karpenter|byo)")
