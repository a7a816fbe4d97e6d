"""Real-cluster backend: wire codec, REST client, and a Store adapter
speaking the Kubernetes API (the counterpart of the reference's
controller-runtime client + pkg/k8sclient singletons).  A copy of
``kaito_tpu.k8s``."""

from kaito_tpu_torch.k8s.client import KubeClient
from kaito_tpu_torch.k8s.codec import from_wire, to_wire
from kaito_tpu_torch.k8s.store import KubeStore

__all__ = ["KubeClient", "KubeStore", "from_wire", "to_wire"]
