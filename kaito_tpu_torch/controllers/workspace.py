"""Workspace reconciler.

The core orchestration loop (reference:
``pkg/workspace/controllers/workspace_controller.go:116`` Reconcile):
finalizer → ControllerRevision → plan slice via estimator/planner →
provision TPU capacity → gate on ModelMirror → render + apply workload
→ sync conditions/status.  The mesh planner replaces the reference's
EstimateNodeCount + configureParallelism pair: a single decision
produces both the capacity ask and the parallelism layout.

A copy of ``kaito_tpu.controllers.workspace`` over the port's catalog:
``plan_workspace`` resolves GPU machine types (GKE's A3) and GPU BYO
nodes (GPU feature discovery's labels) as well as TPU ones, and plans a
GPU Workspace for the port's engine (``parallel.plan``): a plan the
port's server would refuse fails at plan time (``PlanFailed``).  The annotation parses are
the port's own (``engine/qos.py``, ``models/registry.py``,
``manifests/inference.py``).
"""

from __future__ import annotations

import logging
from typing import Optional

from kaito_tpu_torch.api.meta import Condition, ObjectMeta, get_condition, set_condition
from kaito_tpu_torch.api.modelmirror import (
    PHASE_READY,
    ModelMirror,
    ModelMirrorSpec,
    MirrorSource,
)
from kaito_tpu_torch.api.workspace import (
    ANNOTATION_DISABLE_BENCHMARK,
    ANNOTATION_UPGRADE_TO,
    COND_BENCHMARK_COMPLETE,
    COND_INFERENCE_READY,
    COND_NODE_CLAIM_READY,
    COND_RESOURCE_READY,
    COND_SLO_HEALTHY,
    COND_TUNING_STARTED,
    COND_WORKSPACE_SUCCEEDED,
    LABEL_WORKSPACE_NAME,
    Workspace,
)
from kaito_tpu_torch.k8s.events import record_event
from kaito_tpu_torch.controllers.objects import Unstructured
from kaito_tpu_torch.controllers.runtime import (
    Reconciler,
    Result,
    Store,
    sync_controller_revision,
    update_with_retry,
)
from kaito_tpu_torch.manifests.inference import generate_inference_workload
from kaito_tpu_torch.manifests.tuning_job import generate_tuning_job
from kaito_tpu_torch.models.registry import get_model_by_name
from kaito_tpu_torch.parallel.plan import ParallelPlan, plan_parallelism
from kaito_tpu_torch.provision.provisioner import ProvisionRequest
from kaito_tpu_torch.sku.catalog import (
    TPUSliceSpec,
    get_slice_config_from_node_labels,
    is_known_machine_type,
    machine_chip,
)

logger = logging.getLogger(__name__)

FINALIZER = "kaito-tpu.io/workspace-finalizer"
BENCH_METRIC_PEAK_TPM = "peakTokensPerMinute"


def plan_workspace(store: Store, ws: Workspace):
    """Preset + instance type -> (model metadata, ParallelPlan,
    TPUSliceSpec).  Module-level so consumers that plan a Workspace
    that does not exist yet — the InferenceSet node-count guard and
    the autoscaler's warm-pool render — share one decision with the
    reconcile path instead of re-deriving capacity math."""
    md = get_model_by_name(ws.preset_name)
    chip = machine_chip(ws.resource.instance_type)
    if chip is None:
        # BYO path: derive chip from an existing labeled node (a TPU
        # node's GKE labels, or a GPU node's feature-discovery labels)
        spec = None
        for n in store.list("Node", labels=ws.resource.label_selector or None):
            spec = get_slice_config_from_node_labels(n.metadata.labels)
            if spec:
                break
        if spec is None:
            raise ValueError(
                f"cannot determine TPU generation for {ws.metadata.name}: "
                f"unknown instance type and no labeled BYO nodes")
        chip = spec.chip
    workload = "train" if ws.tuning is not None else "serve"
    target = None
    if ws.resource.tpu_topology:
        from kaito_tpu_torch.sku.catalog import topology_chips

        target = topology_chips(ws.resource.tpu_topology)
    # an int8 KV pool halves bytes/token, so the planner can fit the
    # same context on fewer chips (estimator threads the byte width
    # through kv_bytes_per_token)
    kv_dtype = ws.metadata.annotations.get(
        "kaito-tpu.io/kv-cache-dtype", "")
    # weight-only quantization shrinks weight bytes (int8: 1/2, int4:
    # ~1/4 with group scales), so the same model fits fewer chips; a
    # bogus scheme fails the plan (PlanFailed condition + event) before
    # any capacity is asked for, mirroring the qos/speculative-draft
    # pattern (docs/quantization.md)
    quant = ws.metadata.annotations.get("kaito-tpu.io/quantization", "")
    if quant and quant not in ("int8", "int4"):
        # mirrors engine/quant.py QUANT_SCHEMES without importing the
        # engine (the controller stays jax-free, like the qos check)
        raise ValueError(
            f"invalid kaito-tpu.io/quantization annotation: unknown "
            f"scheme {quant!r} (known: int8, int4)")
    # speculative-draft pairing fails the plan (PlanFailed
    # condition + event) when the named draft is unknown or shares
    # no tokenizer with the target — before any capacity is asked
    # for (docs/speculative.md)
    from kaito_tpu_torch.models.registry import resolve_speculative_draft
    resolve_speculative_draft(md, ws.metadata.annotations.get(
        "kaito-tpu.io/speculative-draft", ""))
    # a malformed QoS document fails the plan (PlanFailed condition +
    # event) before any capacity is asked for, instead of crash-looping
    # the engine pod at startup (docs/qos.md)
    from kaito_tpu_torch.engine.qos import parse_qos_config
    try:
        parse_qos_config(ws.metadata.annotations.get(
            "kaito-tpu.io/qos", ""))
    except ValueError as e:
        raise ValueError(f"invalid kaito-tpu.io/qos annotation: {e}")
    # a malformed multi-LoRA document fails the plan the same way —
    # the parse helper lives in manifests (jax-free) and is the exact
    # code the renderer runs, so plan-time acceptance == render-time
    # acceptance (docs/multi-lora.md)
    from kaito_tpu_torch.manifests.inference import (
        parse_adapters_annotation, parse_comm_overlap_annotation,
        parse_devprof_annotation, parse_flight_annotation,
        parse_itl_annotation, parse_kv_pool_disk_annotation,
        parse_structured_output_annotation)
    try:
        parse_adapters_annotation(ws.metadata.annotations.get(
            "kaito-tpu.io/adapters", ""))
    except ValueError as e:
        raise ValueError(f"invalid kaito-tpu.io/adapters annotation: {e}")
    # a malformed devprof interval fails the plan the same way — the
    # exact parse the renderer runs, so plan-time acceptance ==
    # render-time acceptance (docs/observability.md)
    try:
        parse_devprof_annotation(ws.metadata.annotations.get(
            "kaito-tpu.io/devprof", ""))
    except ValueError as e:
        raise ValueError(f"invalid kaito-tpu.io/devprof annotation: {e}")
    # a malformed comm-overlap gate fails the plan the same way — the
    # exact parse the renderer runs, so plan-time acceptance ==
    # render-time acceptance (docs/multichip.md)
    try:
        parse_comm_overlap_annotation(ws.metadata.annotations.get(
            "kaito-tpu.io/comm-overlap", ""))
    except ValueError as e:
        raise ValueError(
            f"invalid kaito-tpu.io/comm-overlap annotation: {e}")
    # a malformed structured-output document fails the plan the same
    # way — again the exact parse the renderer runs, so plan-time
    # acceptance == render-time acceptance (docs/structured-output.md)
    try:
        parse_structured_output_annotation(ws.metadata.annotations.get(
            "kaito-tpu.io/structured-output", ""))
    except ValueError as e:
        raise ValueError(
            f"invalid kaito-tpu.io/structured-output annotation: {e}")
    # a malformed ITL gate or flight-recorder dir fails the plan the
    # same way — the exact parses the renderer runs, so plan-time
    # acceptance == render-time acceptance (docs/observability.md)
    try:
        parse_itl_annotation(ws.metadata.annotations.get(
            "kaito-tpu.io/itl", ""))
    except ValueError as e:
        raise ValueError(f"invalid kaito-tpu.io/itl annotation: {e}")
    try:
        parse_flight_annotation(
            ws.metadata.annotations.get("kaito-tpu.io/flight-dir", ""),
            ws.metadata.annotations.get(
                "kaito-tpu.io/flight-max-bundles", ""))
    except ValueError as e:
        raise ValueError(
            f"invalid kaito-tpu.io/flight-dir annotation: {e}")
    # a malformed SSD-tier budget (or one named without the pool)
    # fails the plan the same way — the exact parse the renderer runs,
    # so plan-time acceptance == render-time acceptance
    # (docs/kv-pool.md "Tier 3: SSD")
    try:
        parse_kv_pool_disk_annotation(
            ws.metadata.annotations.get("kaito-tpu.io/kv-pool-disk", ""),
            ws.metadata.annotations.get("kaito-tpu.io/kv-pool", ""))
    except ValueError as e:
        raise ValueError(
            f"invalid kaito-tpu.io/kv-pool-disk annotation: {e}")
    # CP prefill auto-carve is evidence-gated (plan_parallelism
    # docstring: BENCH_r05 cp_speedup 0.68 < 1.0) — serve plans
    # only carve a sequence axis when the user opts in
    cp_opt_in = ws.metadata.annotations.get(
        "kaito-tpu.io/cp-autocarve", "") == "true"
    plan = plan_parallelism(md, chip, workload=workload,
                            target_chips=target,
                            kv_dtype_bytes=1 if kv_dtype == "int8" else 2,
                            quantization=quant or None,
                            cp_autocarve=cp_opt_in)
    slice_spec = TPUSliceSpec(
        chip=chip, topology=plan.topology,
        machine_type=ws.resource.instance_type
        if is_known_machine_type(ws.resource.instance_type) else "")
    return md, plan, slice_spec


class WorkspaceReconciler(Reconciler):
    kind = "Workspace"

    def __init__(self, store: Store, provisioner, feature_gates=None):
        super().__init__(store)
        self.provisioner = provisioner
        self.gates = feature_gates or {}

    # ------------------------------------------------------------------

    def reconcile(self, ws: Workspace) -> Result:
        if ws.metadata.deletion_timestamp:
            return self._finalize(ws)
        if FINALIZER not in ws.metadata.finalizers:
            ws.metadata.finalizers.append(FINALIZER)
            ws = self.store.update(ws)

        ws.default()
        errs = ws.validate()
        if errs:
            if self._set_cond(ws, COND_RESOURCE_READY, "False",
                              "ValidationFailed", "; ".join(errs)):
                record_event(self.store, ws, "Warning", "ValidationFailed",
                             "; ".join(errs))
            return Result()

        sync_controller_revision(self.store, ws, ws.revision_payload())

        try:
            md, plan, slice_spec = self._plan(ws)
        except (KeyError, ValueError) as e:
            if self._set_cond(ws, COND_RESOURCE_READY, "False", "PlanFailed",
                              str(e)):
                record_event(self.store, ws, "Warning", "PlanFailed", str(e))
            return Result()

        # capacity
        req = ProvisionRequest(
            owner_name=ws.metadata.name,
            owner_namespace=ws.metadata.namespace,
            slice_spec=slice_spec,
            num_slices=plan.num_slices * ws.resource.count,
            extra_labels=dict(ws.resource.label_selector),
            preferred_nodes=list(ws.resource.preferred_nodes))
        self.provisioner.provision(req)
        # snapshot-capable provisioners (karpenter) build ONE snapshot
        # per reconcile: readiness, node list, and the status condition
        # all derive from it (reference nodeReadinessSnapshot/
        # CollectNodeStatusInfo, provisioner.go:391-560)
        snap_cond = None
        if hasattr(self.provisioner, "ensure_ready_snapshot"):
            snap = self.provisioner.ensure_ready_snapshot(req)
            ready, nodes = snap.all_ready, snap.ready_nodes
            snap_cond = snap.condition()
        else:
            ready, nodes = self.provisioner.ensure_ready(req)
        # node repair runs regardless of overall readiness: a dead node
        # in an otherwise-covered slice still pins its pool replica
        # slot and must be replaced
        if hasattr(self.provisioner, "repair_unhealthy"):
            repaired = self.provisioner.repair_unhealthy(req)
            if repaired:
                logger.info("repairing NotReady nodes for %s: %s",
                            ws.metadata.name, repaired)
                record_event(self.store, ws, "Warning", "NodeRepaired",
                             f"deleted NotReady nodes for replacement: "
                             f"{', '.join(repaired)}")
        prov_s = (self.provisioner.provision_seconds(req)
                  if hasattr(self.provisioner, "provision_seconds") else None)

        def set_target(o):
            o.status.target_node_count = plan.num_hosts * ws.resource.count
            o.status.worker_nodes = nodes
            o.status.observed_generation = o.metadata.generation
            if prov_s is not None:
                o.status.performance.metrics[
                    "provision_to_ready_seconds"] = round(prov_s, 3)
        ws = update_with_retry(self.store, "Workspace", ws.metadata.namespace,
                               ws.metadata.name, set_target)

        if not ready:
            if self._set_cond(ws, COND_NODE_CLAIM_READY, "False",
                              snap_cond["reason"] if snap_cond
                              else "Provisioning",
                              snap_cond["message"] if snap_cond
                              else f"{len(nodes)} nodes ready"):
                record_event(self.store, ws, "Normal", "ProvisioningStarted",
                             f"waiting for {slice_spec.chip.family} capacity "
                             f"({len(nodes)} nodes ready)")
            return Result(requeue_after=5.0)
        ready_msg = f"{len(nodes)} nodes ready"
        if prov_s is not None:
            ready_msg += f" (provisioned in {prov_s:.1f}s)"
        if self._set_cond(ws, COND_NODE_CLAIM_READY, "True", "NodesReady",
                          ready_msg):
            record_event(self.store, ws, "Normal", "NodeClaimSatisfied",
                         ready_msg)
        self._set_cond(ws, COND_RESOURCE_READY, "True", "ResourceReady", "")

        # weight cache gate (reference: ensureModelMirror :173 +
        # waitForModelMirror :291, behind the ModelMirror feature gate)
        if self.gates.get("modelMirror") and md.hf_id:
            if not self._ensure_model_mirror(md):
                return Result(requeue_after=5.0)

        if ws.tuning is not None:
            return self._reconcile_tuning(ws, md, plan, req)
        return self._reconcile_inference(ws, md, plan, req)

    # ------------------------------------------------------------------

    def _plan(self, ws: Workspace):
        return plan_workspace(self.store, ws)

    def _ensure_model_mirror(self, md) -> bool:
        name = md.name.replace("/", "-")
        mirror = self.store.try_get("ModelMirror", "", name)
        if mirror is None:
            self.store.create(ModelMirror(
                ObjectMeta(name=name, namespace=""),
                ModelMirrorSpec(source=MirrorSource(model_id=md.hf_id))))
            return False
        return mirror.status.phase == PHASE_READY

    # ------------------------------------------------------------------

    def _reconcile_inference(self, ws: Workspace, md, plan: ParallelPlan,
                             req: ProvisionRequest) -> Result:
        node_selector = self.provisioner.node_selector(req)
        benchmark = ws.metadata.annotations.get(ANNOTATION_DISABLE_BENCHMARK) != "true"
        objs = generate_inference_workload(ws, md, plan, node_selector,
                                           benchmark=benchmark)
        for obj in objs:
            self._apply(obj, ws)

        # image upgrade (reference: workspace_controller.go:676-685)
        upgrade_to = ws.metadata.annotations.get(ANNOTATION_UPGRADE_TO)
        if upgrade_to:
            bumped = {"v": False}

            def bump(ss):
                c = ss.spec["template"]["spec"]["containers"][0]
                base = c["image"].rsplit(":", 1)[0]
                bumped["v"] = c["image"] != f"{base}:{upgrade_to}"
                c["image"] = f"{base}:{upgrade_to}"
            update_with_retry(self.store, "StatefulSet", ws.metadata.namespace,
                              ws.metadata.name, bump)
            if bumped["v"]:
                record_event(self.store, ws, "Normal", "UpgradeApplied",
                             f"base image rolled to version {upgrade_to}")

        ss = self.store.try_get("StatefulSet", ws.metadata.namespace,
                                ws.metadata.name)
        ready = bool(ss) and ss.status.get("readyReplicas", 0) >= ss.spec["replicas"]
        if self._set_cond(ws, COND_INFERENCE_READY,
                          "True" if ready else "False",
                          "InferenceReady" if ready else "PodsPending",
                          f"{(ss.status.get('readyReplicas', 0) if ss else 0)}"
                          f"/{plan.num_hosts} ready"):
            record_event(self.store, ws, "Normal",
                         "RolloutComplete" if ready else "RolloutStarted",
                         f"{(ss.status.get('readyReplicas', 0) if ss else 0)}"
                         f"/{plan.num_hosts} replicas ready")

        # benchmark result ingestion (reference: benchmark.go tails pod
        # logs for KAITO_BENCHMARK_RESULT; our probe posts to the SS
        # status, same contract re-homed)
        bench = (ss.status.get("benchmark") if ss else None) or {}
        if benchmark and ready and bench:
            # failure surfaces as a condition instead of silently
            # recording zeros (reference: benchmark result parse
            # failures flip the workspace condition, benchmark.go)
            try:
                tpm = float(bench.get("total_tpm") or 0.0)
                n_errors = int(bench.get("errors") or 0)
                failed = bool(bench.get("error")) or (
                    tpm <= 0.0 and n_errors > 0)
                fail_msg = str(bench.get("error")
                               or f"{n_errors} request errors, "
                                  f"zero throughput")
            except (TypeError, ValueError) as e:
                # a malformed payload IS a benchmark failure — it must
                # flip the condition, not crash the reconcile
                failed, fail_msg = True, f"malformed benchmark result: {e}"
            if failed:
                if self._set_cond(ws, COND_BENCHMARK_COMPLETE, "False",
                                  "BenchmarkFailed", fail_msg):
                    record_event(self.store, ws, "Warning", "BenchmarkFailed",
                                 fail_msg)
            else:
                def record(o):
                    o.status.performance.metrics[BENCH_METRIC_PEAK_TPM] = \
                        float(bench.get("total_tpm", 0.0))
                    o.status.performance.config = {
                        k: str(v) for k, v in bench.items()
                        if k != "total_tpm"}
                ws = update_with_retry(self.store, "Workspace",
                                       ws.metadata.namespace,
                                       ws.metadata.name, record)
                if self._set_cond(ws, COND_BENCHMARK_COMPLETE, "True",
                                  "BenchmarkComplete", ""):
                    record_event(
                        self.store, ws, "Normal", "BenchmarkComplete",
                        f"probe measured "
                        f"{float(bench.get('total_tpm', 0.0)):.0f} tok/min")
            # SLO verdict folding (runtime/slo.py): the probe ships the
            # engine's /debug/slo snapshot inside the benchmark result;
            # kubectl get workspace then shows the SLOHealthy condition
            verdict = bench.get("slo")
            if isinstance(verdict, dict):
                from kaito_tpu_torch.runtime.slo import condition_from_verdict

                status, reason, message = condition_from_verdict(verdict)
                if self._set_cond(ws, COND_SLO_HEALTHY, status, reason,
                                  message):
                    record_event(self.store, ws,
                                 "Normal" if status == "True" else "Warning",
                                 reason, message)
        if ready:
            self._set_cond(ws, COND_WORKSPACE_SUCCEEDED, "True", "Ready", "")
        return Result() if ready else Result(requeue_after=5.0)

    def _reconcile_tuning(self, ws: Workspace, md, plan: ParallelPlan,
                          req: ProvisionRequest) -> Result:
        node_selector = self.provisioner.node_selector(req)
        job = generate_tuning_job(ws, md, plan, node_selector)
        self._apply(job, ws)
        self._set_cond(ws, COND_TUNING_STARTED, "True", "JobCreated", "")
        live = self.store.try_get("Job", ws.metadata.namespace, job.metadata.name)
        if live and live.status.get("succeeded"):
            self._set_cond(ws, COND_WORKSPACE_SUCCEEDED, "True", "JobSucceeded", "")
            return Result()
        if live and live.status.get("failed"):
            self._set_cond(ws, COND_WORKSPACE_SUCCEEDED, "False", "JobFailed",
                           str(live.status.get("message", "")))
            return Result()
        return Result(requeue_after=5.0)

    # ------------------------------------------------------------------

    def _apply(self, obj: Unstructured, owner: Workspace) -> None:
        """Create-or-selectively-update (reference: selective field
        update, workspace_controller.go:655-668 — replicas/template only,
        so external controllers' fields survive)."""
        obj.metadata.owner_references = [{
            "kind": "Workspace", "name": owner.metadata.name,
            "uid": owner.metadata.uid}]
        existing = self.store.try_get(obj.kind, obj.metadata.namespace,
                                      obj.metadata.name)
        if existing is None:
            self.store.create(obj)
            return
        if obj.kind == "StatefulSet":
            def mutate(cur):
                cur.spec["replicas"] = obj.spec["replicas"]
                # keep a live image upgrade (annotation path) sticky
                new_tmpl = obj.spec["template"]
                cur_img = cur.spec["template"]["spec"]["containers"][0].get("image")
                new_tmpl["spec"]["containers"][0]["image"] = cur_img or \
                    new_tmpl["spec"]["containers"][0]["image"]
                cur.spec["template"] = new_tmpl
            update_with_retry(self.store, obj.kind, obj.metadata.namespace,
                              obj.metadata.name, mutate)
        elif obj.kind == "Service" and existing.spec != obj.spec:
            # Services drift too (ports/selector edits must reconcile
            # back); clusterIP-style immutable fields aren't modeled
            # in-process, so the rendered spec wins wholesale.  The
            # equality gate keeps no-drift resyncs write-free (no
            # resourceVersion churn / spurious MODIFIED events).
            def mutate_svc(cur):
                cur.spec = dict(obj.spec)
            update_with_retry(self.store, obj.kind, obj.metadata.namespace,
                              obj.metadata.name, mutate_svc)

    def _set_cond(self, ws: Workspace, type_: str, status: str, reason: str,
                  message: str) -> bool:
        """Upsert the condition; True when the STATUS transitioned
        (the event-worthy edge — reason/message churn is not)."""
        changed = {"v": False}

        def mutate(o):
            prev = get_condition(o.status.conditions, type_)
            changed["v"] = prev is None or prev.status != status
            set_condition(o.status.conditions, Condition(
                type=type_, status=status, reason=reason, message=message,
                observed_generation=o.metadata.generation))
        update_with_retry(self.store, "Workspace", ws.metadata.namespace,
                          ws.metadata.name, mutate)
        return changed["v"]

    def _finalize(self, ws: Workspace) -> Result:
        try:
            md, plan, slice_spec = self._plan(ws)
            req = ProvisionRequest(
                owner_name=ws.metadata.name,
                owner_namespace=ws.metadata.namespace,
                slice_spec=slice_spec, num_slices=plan.num_slices)
            self.provisioner.deprovision(req)
        except Exception:
            logger.exception("deprovision during finalize failed; continuing")
        for kind in ("StatefulSet", "Service", "Job"):
            for obj in self.store.list(kind, ws.metadata.namespace):
                if any(ref.get("name") == ws.metadata.name
                       for ref in obj.metadata.owner_references):
                    self.store.delete(kind, obj.metadata.namespace,
                                      obj.metadata.name)
        if FINALIZER in ws.metadata.finalizers:
            def strip(o):
                if FINALIZER in o.metadata.finalizers:
                    o.metadata.finalizers.remove(FINALIZER)
            update_with_retry(self.store, "Workspace", ws.metadata.namespace,
                              ws.metadata.name, strip)
        return Result()
