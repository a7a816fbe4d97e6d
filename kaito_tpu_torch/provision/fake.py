"""FakeCloud: a simulated Karpenter + cloud backend.

Watches NodePool objects in the store and materializes Node objects
with the right TPU labels after a configurable number of ticks — the
fake topology/provisioner backend SURVEY.md §4 calls out as the
reference's weakest testing area (its e2e needs a real cluster + GPU
quota).  Supports failure injection per pool.

A copy of ``kaito_tpu.provision.fake``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from kaito_tpu_torch.controllers.objects import Unstructured, node
from kaito_tpu_torch.controllers.runtime import Store
from kaito_tpu_torch.provision.karpenter import LABEL_OWNER, LABEL_SLICE_INDEX
from kaito_tpu_torch.sku.catalog import (
    LABEL_TPU_ACCELERATOR,
    LABEL_TPU_MACHINE,
    LABEL_TPU_TOPOLOGY,
)


@dataclass
class FakeCloud:
    store: Store
    provision_delay_ticks: int = 0       # ticks before nodes appear
    fail_pools: set = field(default_factory=set)  # pool names that never come up
    _pending: dict = field(default_factory=dict)

    def tick(self) -> None:
        """Advance the simulated cloud one step."""
        for pool in self.store.list("NodePool"):
            name = pool.metadata.name
            if name in self.fail_pools:
                continue
            existing = {
                n.metadata.name
                for n in self.store.list("Node")
                if n.metadata.name.startswith(f"{name}-node-")
            }
            want = int(pool.spec.get("replicas", 1))
            if len(existing) >= want:
                continue
            waited = self._pending.get(name, 0)
            if waited < self.provision_delay_ticks:
                self._pending[name] = waited + 1
                continue
            tmpl = pool.spec.get("template", {})
            labels = dict(tmpl.get("metadata", {}).get("labels", {}))
            for r in tmpl.get("spec", {}).get("requirements", []):
                if r.get("values"):
                    labels[r["key"]] = r["values"][0]
            for i in range(want):
                node_name = f"{name}-node-{i}"
                if node_name in existing:
                    continue
                self.store.create(node(node_name, labels, ready=True))

        # kubelet sim: StatefulSets/Jobs on ready nodes come up
        for ss in self.store.list("StatefulSet"):
            want = int(ss.spec.get("replicas", 1))
            if ss.status.get("readyReplicas", 0) < want:
                def mark(o, want=want):
                    o.status["readyReplicas"] = want
                from kaito_tpu_torch.controllers.runtime import update_with_retry

                update_with_retry(self.store, "StatefulSet",
                                  ss.metadata.namespace, ss.metadata.name, mark)
        for dep in self.store.list("Deployment"):
            want = int(dep.spec.get("replicas", 1))
            if dep.status.get("readyReplicas", 0) < want:
                def mark(o, want=want):
                    o.status["readyReplicas"] = want
                from kaito_tpu_torch.controllers.runtime import update_with_retry

                update_with_retry(self.store, "Deployment",
                                  dep.metadata.namespace, dep.metadata.name, mark)
        for job in self.store.list("Job"):
            if not job.status.get("succeeded") and not job.status.get("failed"):
                def mark(o):
                    o.status["succeeded"] = 1
                from kaito_tpu_torch.controllers.runtime import update_with_retry

                update_with_retry(self.store, "Job", job.metadata.namespace,
                                  job.metadata.name, mark)

        # garbage-collect nodes of deleted pools (cloud reclaim)
        pools = {p.metadata.name for p in self.store.list("NodePool")}
        for n in self.store.list("Node"):
            owner_pool = n.metadata.name.rsplit("-node-", 1)[0]
            if "-node-" in n.metadata.name and owner_pool not in pools:
                self.store.delete("Node", "", n.metadata.name)

    def mark_drifted(self, node_name: str) -> None:
        """Failure/drift injection: flag a node as drifted (the drift
        controller reacts the way the reference reacts to Karpenter
        NodeClaim Drifted conditions)."""
        def mutate(n):
            n.status["drifted"] = True

        from kaito_tpu_torch.controllers.runtime import update_with_retry

        update_with_retry(self.store, "Node", "", node_name, mutate)
