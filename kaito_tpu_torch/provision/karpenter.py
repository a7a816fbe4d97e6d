"""Karpenter provisioner for GKE TPU slices.

The TPU-native re-design of ``pkg/nodeprovision/karpenter``
(provisioner.go:311/:460, nodepool.go:96): one ``karpenter.sh/v1
NodePool`` per workspace slice with TPU requirements —
``cloud.google.com/gke-tpu-accelerator`` + ``gke-tpu-topology`` +
machine type — replicas = number of hosts in the slice, drift budget
closed (0) by default and opened to 1 by the drift controller.

Readiness follows the reference's snapshot design
(``provisioner.go:391-489`` nodeReadinessSnapshot + EnsureNodesReady):
one point-in-time :class:`NodeReadinessSnapshot` per reconcile counts
ready slice nodes, ready BYO ``preferredNodes`` covering part of the
want (``countCoveredNodes``, :245), and TPU device capacity
(``CheckIfNodePluginsReady`` — here the ``google.com/tpu`` allocatable
on each node).  The snapshot also powers per-slice status conditions
(``CollectNodeStatusInfo``, :538), provision-to-ready seconds (a
BASELINE.json headline metric), and the node-repair path (delete
persistently NotReady nodes so the pool replaces them).

A copy of ``kaito_tpu.provision.karpenter`` that reads the slice's
catalog entry: the NodePool's requirements are the entry's accelerator
label (and topology label, where its nodes carry one) and the machine
type, its taint the entry's, and capacity the entry's device resource
(``nvidia.com/gpu`` on an A3 node).  A TPU slice renders what the JAX
provisioner renders.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

from kaito_tpu_torch.api.meta import ObjectMeta
from kaito_tpu_torch.controllers.objects import Unstructured, is_node_ready
from kaito_tpu_torch.controllers.runtime import Store, update_with_retry
from kaito_tpu_torch.k8s.events import record_event
from kaito_tpu_torch.provision.provisioner import ProvisionRequest
from kaito_tpu_torch.sku.catalog import LABEL_TPU_MACHINE

LABEL_OWNER = "kaito-tpu.io/workspace"
LABEL_SLICE_INDEX = "kaito-tpu.io/slice-index"
ANNOTATION_PROVISION_START = "kaito-tpu.io/provision-start"
ANNOTATION_READY_AT = "kaito-tpu.io/ready-at"

# a node NotReady this long (while its pool wants it) gets deleted so
# the pool replaces it — the repair analogue of Karpenter node
# auto-repair on NodeClaim health
DEFAULT_REPAIR_AFTER_S = 300.0


@dataclass
class SliceReadiness:
    """Point-in-time readiness of ONE slice's capacity."""

    index: int
    want: int
    pool_exists: bool
    ready_nodes: list[str] = field(default_factory=list)
    not_ready_nodes: list[str] = field(default_factory=list)
    byo_covered: list[str] = field(default_factory=list)
    capacity_short: list[str] = field(default_factory=list)  # no TPU alloc

    @property
    def ready(self) -> bool:
        return (self.pool_exists
                and len(self.ready_nodes) + len(self.byo_covered) >= self.want
                and not self.capacity_short)

    def message(self) -> str:
        parts = [f"slice {self.index}: "
                 f"{len(self.ready_nodes) + len(self.byo_covered)}"
                 f"/{self.want} ready"]
        if not self.pool_exists:
            parts.append("pool missing")
        if self.not_ready_nodes:
            parts.append(f"notReady={','.join(self.not_ready_nodes)}")
        if self.capacity_short:
            parts.append(f"noTPUCapacity={','.join(self.capacity_short)}")
        if self.byo_covered:
            parts.append(f"byo={len(self.byo_covered)}")
        return " ".join(parts)


@dataclass
class NodeReadinessSnapshot:
    slices: list[SliceReadiness]

    @property
    def all_ready(self) -> bool:
        return all(s.ready for s in self.slices)

    @property
    def ready_nodes(self) -> list[str]:
        out: set[str] = set()
        for s in self.slices:
            out.update(s.ready_nodes)
            out.update(s.byo_covered)
        return sorted(out)

    def condition(self) -> dict:
        """One workspace-status condition summarizing every slice (the
        CollectNodeStatusInfo analogue)."""
        if self.all_ready:
            return {"status": "True", "reason": "NodesReady",
                    "message": f"{len(self.ready_nodes)} nodes ready"}
        return {"status": "False", "reason": "NodeClaimNotReady",
                "message": "; ".join(s.message() for s in self.slices
                                     if not s.ready)}


class KarpenterTPUProvisioner:
    name = "karpenter"

    def __init__(self, store: Store, repair_after_s: float = DEFAULT_REPAIR_AFTER_S):
        self.store = store
        self.repair_after_s = repair_after_s

    # ------------------------------------------------------------------

    def _pool_name(self, req: ProvisionRequest, idx: int) -> str:
        return f"{req.owner_name}-slice-{idx}"

    def render_nodepool(self, req: ProvisionRequest, idx: int) -> dict:
        """The NodePool spec rendered for a real cluster (and stored as
        Unstructured in-process)."""
        s = req.slice_spec
        chip = s.chip
        requirements = [{"key": chip.accelerator_key, "operator": "In",
                         "values": [chip.accelerator_label]}]
        if chip.topology_key:
            requirements.append({"key": chip.topology_key, "operator": "In",
                                 "values": [s.topology]})
        requirements.append({"key": LABEL_TPU_MACHINE, "operator": "In",
                             "values": [s.machine_type] if s.machine_type else []})
        labels = {
            LABEL_OWNER: req.owner_name,
            LABEL_SLICE_INDEX: str(idx),
            **req.extra_labels,
        }
        return {
            "replicas": s.num_hosts,
            "disruption": {"budgets": [{"nodes": "0"}]},  # drift closed
            "template": {
                "metadata": {"labels": labels},
                "spec": {
                    "requirements": requirements,
                    "taints": [{"key": chip.resource, "value": "present",
                                "effect": "NoSchedule"}],
                },
            },
        }

    # -- NodeProvisioner -----------------------------------------------

    def provision(self, req: ProvisionRequest) -> None:
        for idx in range(req.num_slices):
            name = self._pool_name(req, idx)
            if self.store.try_get("NodePool", "", name) is None:
                pool = Unstructured(
                    "NodePool",
                    ObjectMeta(name=name, namespace="",
                               labels={LABEL_OWNER: req.owner_name},
                               annotations={
                                   ANNOTATION_PROVISION_START:
                                   f"{time.time():.3f}"}),
                    spec=self.render_nodepool(req, idx))
                self.store.create(pool)
                record_event(self.store, pool, "Normal",
                             "ProvisioningStarted",
                             f"created NodePool {name} for "
                             f"{req.owner_namespace}/{req.owner_name} "
                             f"({req.slice_spec.num_hosts} host(s), "
                             f"topology {req.slice_spec.topology})")

    def _byo_covered(self, req: ProvisionRequest) -> list[str]:
        """Ready preferredNodes with the right accelerator label AND
        live TPU capacity count toward the want (reference
        countCoveredNodes, provisioner.go:245-309)."""
        covered = []
        chip = req.slice_spec.chip
        for name in req.preferred_nodes:
            n = self.store.try_get("Node", "", name)
            if n is None or not is_node_ready(n):
                continue
            if n.metadata.labels.get(chip.accelerator_key) == chip.accelerator_label \
                    and self._has_capacity(n, chip.resource):
                covered.append(name)
        return covered

    @staticmethod
    def _has_capacity(n: Unstructured, resource: str) -> bool:
        """Device capacity check (the GPU-plugin-readiness analogue):
        when the node advertises allocatable, it must carry the entry's
        ``resource`` (google.com/tpu chips, nvidia.com/gpu cards); nodes
        without an allocatable map (fakes, freshly registered) pass on
        their Ready condition alone."""
        alloc = n.status.get("allocatable")
        if not isinstance(alloc, dict):
            return True
        return int(str(alloc.get(resource, "0"))) > 0

    def build_readiness_snapshot(self, req: ProvisionRequest
                                 ) -> NodeReadinessSnapshot:
        byo = self._byo_covered(req)
        slices = []
        for idx in range(req.num_slices):
            pool = self.store.try_get("NodePool", "",
                                      self._pool_name(req, idx))
            sr = SliceReadiness(index=idx, want=req.slice_spec.num_hosts,
                                pool_exists=pool is not None,
                                byo_covered=list(byo) if idx == 0 else [])
            nodes = self.store.list("Node", labels={
                LABEL_OWNER: req.owner_name, LABEL_SLICE_INDEX: str(idx)})
            now = time.time()
            for n in nodes:
                if not is_node_ready(n):
                    sr.not_ready_nodes.append(n.metadata.name)
                    self._stamp_not_ready(n, now)
                elif not self._has_capacity(n, req.slice_spec.chip.resource):
                    sr.capacity_short.append(n.metadata.name)
                else:
                    sr.ready_nodes.append(n.metadata.name)
                    self._clear_not_ready(n)
            slices.append(sr)
        return NodeReadinessSnapshot(slices=slices)

    def _stamp_not_ready(self, n: Unstructured, now: float) -> None:
        if "notReadySince" in n.status:
            return

        def mutate(o, now=now):
            o.status["notReadySince"] = now

        try:
            update_with_retry(self.store, "Node", "", n.metadata.name, mutate)
        except Exception:
            pass   # races with node deletion are benign

    def _clear_not_ready(self, n: Unstructured) -> None:
        """A recovered node's outage clock resets — otherwise a later
        brief blip would read as one long outage and repair would
        delete a healthy-but-flapping host immediately."""
        if "notReadySince" not in n.status:
            return

        def mutate(o):
            o.status.pop("notReadySince", None)

        try:
            update_with_retry(self.store, "Node", "", n.metadata.name, mutate)
        except Exception:
            pass

    def ensure_ready_snapshot(self, req: ProvisionRequest
                              ) -> NodeReadinessSnapshot:
        """One snapshot per reconcile: readiness decision, node list,
        status condition, and ready-at stamping all derive from it
        (callers must not rebuild it — each build is a full Node/Pool
        list against the store)."""
        snap = self.build_readiness_snapshot(req)
        if snap.all_ready:
            self._stamp_ready(req)
        return snap

    def ensure_ready(self, req: ProvisionRequest) -> tuple[bool, list[str]]:
        snap = self.ensure_ready_snapshot(req)
        return snap.all_ready, snap.ready_nodes

    def _stamp_ready(self, req: ProvisionRequest) -> None:
        """Record first-all-ready time per pool (provision-to-ready
        seconds is a BASELINE.json headline metric)."""
        for idx in range(req.num_slices):
            name = self._pool_name(req, idx)
            pool = self.store.try_get("NodePool", "", name)
            if pool is None or ANNOTATION_READY_AT in pool.metadata.annotations:
                continue

            def mutate(p):
                p.metadata.annotations[ANNOTATION_READY_AT] = \
                    f"{time.time():.3f}"

            update_with_retry(self.store, "NodePool", "", name, mutate)

    def provision_seconds(self, req: ProvisionRequest) -> Optional[float]:
        """Seconds from NodePool creation to first all-ready, maxed
        over the request's slices (None until ready)."""
        worst = None
        for idx in range(req.num_slices):
            pool = self.store.try_get("NodePool", "",
                                      self._pool_name(req, idx))
            if pool is None:
                return None
            ann = pool.metadata.annotations
            if ANNOTATION_READY_AT not in ann \
                    or ANNOTATION_PROVISION_START not in ann:
                return None
            dt = float(ann[ANNOTATION_READY_AT]) \
                - float(ann[ANNOTATION_PROVISION_START])
            worst = dt if worst is None else max(worst, dt)
        return worst

    def repair_unhealthy(self, req: ProvisionRequest) -> list[str]:
        """Node repair: delete nodes NotReady longer than
        ``repair_after_s`` while their pool still wants them — the pool
        (cloud) replaces them.  Returns the deleted node names."""
        deleted = []
        now = time.time()
        for idx in range(req.num_slices):
            for n in self.store.list("Node", labels={
                    LABEL_OWNER: req.owner_name,
                    LABEL_SLICE_INDEX: str(idx)}):
                if is_node_ready(n):
                    continue
                since = n.status.get("notReadySince")
                if since is None or now - float(since) < self.repair_after_s:
                    continue
                self.store.delete("Node", "", n.metadata.name)
                deleted.append(n.metadata.name)
                record_event(self.store, n, "Warning", "NodeRepaired",
                             f"deleted NotReady node {n.metadata.name} "
                             f"after {now - float(since):.0f}s; pool will "
                             f"replace it")
        return deleted

    def deprovision(self, req: ProvisionRequest) -> None:
        for pool in self.store.list("NodePool",
                                    labels={LABEL_OWNER: req.owner_name}):
            self.store.delete("NodePool", "", pool.metadata.name)

    def node_selector(self, req: ProvisionRequest) -> dict[str, str]:
        sel = dict(req.slice_spec.node_selector())
        sel[LABEL_OWNER] = req.owner_name
        return sel

    def set_drift_budget(self, req: ProvisionRequest, allow: bool) -> None:
        for pool in self.store.list("NodePool",
                                    labels={LABEL_OWNER: req.owner_name}):
            def mutate(p, allow=allow):
                p.spec["disruption"]["budgets"] = [
                    {"nodes": "1" if allow else "0"}]

            update_with_retry(self.store, "NodePool", "", pool.metadata.name,
                              mutate)
