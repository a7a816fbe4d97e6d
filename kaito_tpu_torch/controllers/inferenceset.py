"""InferenceSet reconciler: replica manager over Workspaces.

Parity: ``pkg/inferenceset/inferenceset_controller.go:195-493`` —
create/delete child Workspaces from the template (deleting not-ready
replicas first on scale-down), guard with expectations against
stale-cache over-creation, surface scale-subresource status
(replicas/readyReplicas/selector) for KEDA/HPA, aggregate per-replica
benchmark TPM, and install the Gateway API InferencePool + EPP.

A copy of ``kaito_tpu.controllers.inferenceset``.  The endpoint picker
is rendered from the catalog entry the template resolves to
(``manifests/epp.py``): a GPU set's picker is the port's.
"""

from __future__ import annotations

import logging
from typing import Optional

from kaito_tpu_torch.api.inferenceset import InferenceSet
from kaito_tpu_torch.api.meta import Condition, ObjectMeta, condition_true, set_condition
from kaito_tpu_torch.api.workspace import (
    ANNOTATION_DRAINING,
    COND_INFERENCE_READY,
    LABEL_CREATED_BY_INFERENCESET,
    Workspace,
)
from kaito_tpu_torch.controllers.objects import Unstructured
from kaito_tpu_torch.controllers.runtime import (
    Expectations,
    Reconciler,
    Result,
    Store,
    update_with_retry,
)
from kaito_tpu_torch.controllers.workspace import BENCH_METRIC_PEAK_TPM
from kaito_tpu_torch.k8s.events import record_event
from kaito_tpu_torch.sku.catalog import TPUChipSpec, machine_chip

logger = logging.getLogger(__name__)

COND_SET_READY = "InferenceSetReady"


def make_child_workspace(iset: InferenceSet, index: int) -> Workspace:
    """Render the index-th replica Workspace from the set's template.
    Module-level so the autoscaler can plan the NEXT replica (warm-pool
    provisioning needs its name and slice shape before it exists)."""
    import copy

    t = iset.spec.template
    name = f"{iset.metadata.name}-{index}"
    return Workspace(
        ObjectMeta(
            name=name, namespace=iset.metadata.namespace,
            labels={**t.labels,
                    LABEL_CREATED_BY_INFERENCESET: iset.metadata.name},
            annotations=dict(t.annotations),
            owner_references=[{"kind": "InferenceSet",
                               "name": iset.metadata.name,
                               "uid": iset.metadata.uid}]),
        resource=copy.deepcopy(t.resource),
        inference=copy.deepcopy(t.inference))


class InferenceSetReconciler(Reconciler):
    kind = "InferenceSet"

    def __init__(self, store: Store, gateway_api_enabled: bool = False):
        super().__init__(store)
        self.expectations = Expectations()
        self.gateway_api_enabled = gateway_api_enabled
        store.watch(self._observe)

    def _observe(self, event: str, kind: str, obj) -> None:
        if kind != "Workspace":
            return
        owner = obj.metadata.labels.get(LABEL_CREATED_BY_INFERENCESET)
        if not owner:
            return
        key = f"{obj.metadata.namespace}/{owner}"
        if event == "ADDED":
            self.expectations.creation_observed(key)
        elif event == "DELETED":
            self.expectations.deletion_observed(key)

    # ------------------------------------------------------------------

    def _children(self, iset: InferenceSet) -> list[Workspace]:
        return self.store.list(
            "Workspace", iset.metadata.namespace,
            labels={LABEL_CREATED_BY_INFERENCESET: iset.metadata.name})

    def _make_child(self, iset: InferenceSet, index: int) -> Workspace:
        return make_child_workspace(iset, index)

    def _nodes_per_replica(self, iset: InferenceSet,
                           children: list[Workspace]) -> int:
        """Nodes one replica costs, for the nodeCountLimit guard.
        Observed child status wins; with no children yet (scale from
        zero) the template is planned instead — defaulting to 1 there
        over-admitted multi-node presets exactly when the guard matters
        most.  Planning failures fall back to 1 (the workspace
        reconciler will surface PlanFailed on the child itself)."""
        observed = [c.status.target_node_count for c in children
                    if c.status.target_node_count > 0]
        if observed:
            return max(observed)
        try:
            from kaito_tpu_torch.controllers.workspace import plan_workspace

            ws = self._make_child(iset, 0)
            _, plan, _ = plan_workspace(self.store, ws)
            return max(1, plan.num_hosts * ws.resource.count)
        except Exception:
            logger.debug("template plan failed for %s; node guard "
                         "assumes 1 node/replica", iset.metadata.name,
                         exc_info=True)
            return 1

    def reconcile(self, iset: InferenceSet) -> Result:
        if iset.metadata.deletion_timestamp:
            for ws in self._children(iset):
                self.store.delete("Workspace", ws.metadata.namespace,
                                  ws.metadata.name)
            return Result()
        iset.default()
        errs = iset.validate()
        if errs:
            self._set_cond(iset, COND_SET_READY, "False", "ValidationFailed",
                           "; ".join(errs))
            return Result()

        key = f"{iset.metadata.namespace}/{iset.metadata.name}"
        if not self.expectations.satisfied(key):
            return Result(requeue_after=1.0)

        children = self._children(iset)
        want = iset.spec.replicas

        # node-count guard (spec.nodeCountLimit)
        if iset.spec.node_count_limit:
            max_replicas = iset.spec.node_count_limit \
                // self._nodes_per_replica(iset, children)
            want = min(want, max(max_replicas, 0))

        if len(children) < want:
            used = {c.metadata.name for c in children}
            creating = 0
            # probe indices unboundedly: scale-up/down churn leaves
            # sparse index sets (e.g. {0, 3, 7}), so any fixed probe
            # range can run out of fresh names before reaching want
            i = 0
            while len(children) + creating < want:
                child = self._make_child(iset, i)
                i += 1
                if child.metadata.name in used:
                    continue
                self.expectations.expect_creations(key, 1)
                self.store.create(child)
                creating += 1
            if creating:
                record_event(self.store, iset, "Normal", "ScalingUp",
                             f"created {creating} replica workspace(s) "
                             f"toward {want}")
        elif len(children) > want:
            # delete draining-marked first (the autoscaler already
            # flushed their traffic through the EPP), then not-ready
            # (reference: :222-247)
            def victim_order(ws):
                return (not ws.metadata.annotations.get(ANNOTATION_DRAINING),
                        condition_true(ws.status.conditions,
                                       COND_INFERENCE_READY))

            victims = sorted(children, key=victim_order)[: len(children) - want]
            for v in victims:
                self.expectations.expect_deletions(key, 1)
                self.store.delete("Workspace", v.metadata.namespace,
                                  v.metadata.name)
            if victims:
                record_event(self.store, iset, "Normal", "ScalingDown",
                             f"deleted {len(victims)} replica workspace(s) "
                             f"toward {want}")

        children = self._children(iset)
        ready = [c for c in children
                 if condition_true(c.status.conditions, COND_INFERENCE_READY)]
        tpm = sum(c.status.performance.metrics.get(BENCH_METRIC_PEAK_TPM, 0.0)
                  for c in ready)

        def set_status(o):
            o.status.replicas = len(children)
            o.status.ready_replicas = len(ready)
            o.status.selector = f"{LABEL_CREATED_BY_INFERENCESET}={iset.metadata.name}"
            o.status.aggregated_peak_tokens_per_minute = tpm
            set_condition(o.status.conditions, Condition(
                type=COND_SET_READY,
                status="True" if len(ready) >= want and want >= 0 else "False",
                reason="Ready" if len(ready) >= want else "ScalingUp",
                message=f"{len(ready)}/{want} replicas ready"))
        update_with_retry(self.store, "InferenceSet", iset.metadata.namespace,
                          iset.metadata.name, set_status)
        was_ready = condition_true(iset.status.conditions, COND_SET_READY)
        if len(ready) >= want and not was_ready:
            record_event(self.store, iset, "Normal", "RolloutComplete",
                         f"{len(ready)}/{want} replicas ready")

        if self.gateway_api_enabled:
            self._ensure_inference_pool(iset)
            self._ensure_epp(iset)
        return Result() if len(ready) >= want else Result(requeue_after=5.0)

    def _serving_chip(self, iset: InferenceSet) -> Optional[TPUChipSpec]:
        """The catalog entry the template resolves to: by machine type,
        else by planning a BYO replica; None when the template does not
        plan (its children surface PlanFailed)."""
        chip = machine_chip(iset.spec.template.resource.instance_type)
        if chip is None:
            try:
                from kaito_tpu_torch.controllers.workspace import plan_workspace

                _, plan, _ = plan_workspace(self.store,
                                            self._make_child(iset, 0))
                chip = plan.chip
            except Exception:
                return None
        return chip

    def _ensure_inference_pool(self, iset: InferenceSet) -> None:
        """Install the Gateway API InferencePool + endpoint picker
        (reference: ensureGatewayAPIInferenceExtension :493 via Flux
        HelmRelease; we render the InferencePool object directly)."""
        name = f"{iset.metadata.name}-pool"
        if self.store.try_get("InferencePool", iset.metadata.namespace, name):
            return
        self.store.create(Unstructured(
            "InferencePool",
            ObjectMeta(name=name, namespace=iset.metadata.namespace,
                       owner_references=[{"kind": "InferenceSet",
                                          "name": iset.metadata.name}]),
            spec={
                "targetPortNumber": 5000,
                "selector": {LABEL_CREATED_BY_INFERENCESET: iset.metadata.name},
                "extensionRef": {"name": f"{iset.metadata.name}-epp"},
            }))

    def _ensure_epp(self, iset: InferenceSet) -> None:
        """Render the endpoint picker the pool's extensionRef names
        (docs/routing.md): a Deployment running the serving engine
        package's ``runtime.epp`` plus its Service.  The backend set is
        the replica workspaces' Services, recomputed every reconcile so
        scale-up/down keeps the picker's ``--backend`` args current."""
        from kaito_tpu_torch.manifests.epp import EPP_PORT, generate_epp_workload

        ns = iset.metadata.namespace
        children = self._children(iset)
        backends = sorted(f"http://{c.metadata.name}:{EPP_PORT}"
                          for c in children)
        draining = sorted(f"http://{c.metadata.name}:{EPP_PORT}"
                          for c in children
                          if c.metadata.annotations.get(ANNOTATION_DRAINING))
        # the same kaito-tpu.io/kv-pool annotation the workspace
        # template renders into --kv-pool on the engines also arms the
        # picker's advert scraper + fetch hints, so the two sides of
        # the cluster KV pool can never be enabled apart (the template
        # is what child workspaces inherit; the CR metadata is the
        # manual escape hatch)
        kv_pool = str(
            iset.spec.template.annotations.get("kaito-tpu.io/kv-pool")
            or iset.metadata.annotations.get("kaito-tpu.io/kv-pool")
            or "").lower() in ("true", "1", "on", "enabled")
        # same coupling for multi-LoRA: the kaito-tpu.io/adapters
        # document the template renders into --adapter-slots on the
        # engines arms the picker's /v1/adapters residency scraper +
        # adapter-affinity scorer (docs/multi-lora.md)
        adapter_affinity = bool(str(
            iset.spec.template.annotations.get("kaito-tpu.io/adapters")
            or iset.metadata.annotations.get("kaito-tpu.io/adapters")
            or "").strip())
        objs = generate_epp_workload(
            f"{iset.metadata.name}-epp", ns, backends=backends,
            draining=draining, kv_pool=kv_pool,
            adapter_affinity=adapter_affinity,
            owner={"kind": "InferenceSet", "name": iset.metadata.name},
            chip=self._serving_chip(iset))
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

    def _set_cond(self, iset, type_, status, reason, message):
        def mutate(o):
            set_condition(o.status.conditions, Condition(
                type=type_, status=status, reason=reason, message=message))
        update_with_retry(self.store, "InferenceSet", iset.metadata.namespace,
                          iset.metadata.name, mutate)
