"""Controller manager: wires every reconciler behind feature gates.

Parity: ``cmd/workspace/main.go:100-405`` — flag parsing, gate
validation, provisioner factory, controller wiring, and the run loop.
In-process it drives watch-triggered reconciliation plus periodic
resync; against a real cluster the same wiring hangs off informers.

A copy of ``kaito_tpu.controllers.manager``: ``python -m
kaito_tpu_torch.controllers.manager`` runs the operator over the port's
controllers (every flag of the JAX ``main``).
"""

from __future__ import annotations

import argparse
import logging
import threading
import time
from typing import Optional

from kaito_tpu_torch.controllers.drift import DriftReconciler
from kaito_tpu_torch.controllers.inferenceset import InferenceSetReconciler
from kaito_tpu_torch.controllers.metrics import ManagerMetrics, start_manager_server
from kaito_tpu_torch.controllers.modelmirror import ModelMirrorReconciler
from kaito_tpu_torch.controllers.multiroleinference import MultiRoleInferenceReconciler
from kaito_tpu_torch.controllers.autoupgrade import AutoUpgradeRunner
from kaito_tpu_torch.controllers.ragengine import RAGEngineReconciler
from kaito_tpu_torch.controllers.runtime import Store
from kaito_tpu_torch.controllers.workspace import WorkspaceReconciler
from kaito_tpu_torch.featuregates import parse_feature_gates
from kaito_tpu_torch.provision import new_node_provisioner
from kaito_tpu_torch.runtime.fleet import FleetTelemetry

logger = logging.getLogger(__name__)


class Manager:
    def __init__(self, store: Optional[Store] = None,
                 node_provisioner: str = "karpenter",
                 feature_gates: str = "",
                 base_image_version: str = "latest",
                 metrics: Optional[ManagerMetrics] = None):
        self.store = store or Store()
        self.metrics = metrics or ManagerMetrics()
        events = getattr(self.store, "events", None)
        if events is not None:
            self.metrics.attach_event_counter(events)
        if hasattr(self.store, "on_watch_restart"):
            self.store.on_watch_restart = \
                lambda kind: self.metrics.watch_restarts.inc(kind=kind)
        self.gates = parse_feature_gates(feature_gates)
        self.provisioner = new_node_provisioner(
            "byo" if self.gates["disableNodeAutoProvisioning"] else node_provisioner,
            self.store)

        self.workspace = WorkspaceReconciler(self.store, self.provisioner,
                                             self.gates)
        self.reconcilers = [self.workspace]
        if self.gates["enableInferenceSetController"]:
            self.inferenceset = InferenceSetReconciler(
                self.store,
                gateway_api_enabled=self.gates["gatewayAPIInferenceExtension"])
            self.reconcilers.append(self.inferenceset)
        if self.gates["enableMultiRoleInferenceController"]:
            self.mri = MultiRoleInferenceReconciler(self.store)
            self.reconcilers.append(self.mri)
        if self.gates["modelMirror"]:
            self.modelmirror = ModelMirrorReconciler(self.store)
            self.reconcilers.append(self.modelmirror)
        self.ragengine = RAGEngineReconciler(self.store)
        self.reconcilers.append(self.ragengine)
        self.drift = DriftReconciler(self.store, self.provisioner)
        self.autoupgrade = (
            AutoUpgradeRunner(self.store, base_image_version)
            if self.gates["enableBaseImageAutoUpgrade"] else None)
        # fleet telemetry plane (the autoscaler's read side): cheap to
        # construct — no threads or sockets until run()/start()
        self.fleet = FleetTelemetry(self.store)
        self.fleet.register_metrics(self.metrics.registry)
        # the actuation half: consumes fleet signals, mutates replicas
        self.autoscaler = None
        if self.gates["autoscaler"]:
            from kaito_tpu_torch.controllers.autoscaler import AutoscalerController

            self.autoscaler = AutoscalerController(self.store, self.fleet,
                                                   self.provisioner)
            self.autoscaler.register_metrics(self.metrics.registry)

        self._stop = threading.Event()

    def _reconcile_one(self, rec, obj) -> None:
        """One instrumented reconcile: counted, timed, and recorded as
        a span (trace id = object key, so ``/debug/trace?trace_id=
        Workspace/ns/name`` shows one CR's reconcile history)."""
        controller = type(rec).__name__
        trace_id = f"{rec.kind}/{obj.metadata.namespace}/{obj.metadata.name}"
        result = "ok"
        t0 = time.monotonic()
        try:
            with self.metrics.tracer.span(f"reconcile.{rec.kind}", trace_id,
                                          controller=controller):
                res = rec.reconcile(obj)
            if res is not None and (res.requeue or res.requeue_after > 0):
                result = "requeue"
        except Exception:
            result = "error"
            logger.exception("reconcile %s/%s failed", rec.kind,
                             obj.metadata.name)
        self.metrics.observe_reconcile(controller, result,
                                       time.monotonic() - t0)

    def resync(self) -> None:
        """One full reconcile pass over every kind."""
        self.metrics.resync_total.inc()
        for rec in self.reconcilers:
            for obj in self.store.list(rec.kind):
                self._reconcile_one(rec, obj)
        t0 = time.monotonic()
        drift_result = "ok"
        try:
            with self.metrics.tracer.span("reconcile.Drift", "Drift/cluster",
                                          controller="DriftReconciler"):
                self.drift.reconcile_drift()
        except Exception:
            drift_result = "error"
            logger.exception("drift pass failed")
        self.metrics.observe_reconcile("DriftReconciler", drift_result,
                                       time.monotonic() - t0)
        if self.autoupgrade:
            self.autoupgrade.tick()
        self.metrics.refresh_conditions(self.store)
        # fleet pass: rebuild targets from the store, then fold the
        # latest scrapes into signals.  No-op when nothing reported.
        try:
            self.fleet.refresh_targets()
            self.fleet.apply_signals()
        except Exception:
            logger.exception("fleet telemetry pass failed")
        if self.autoscaler is not None:
            t0 = time.monotonic()
            asc_result = "ok"
            try:
                with self.metrics.tracer.span(
                        "reconcile.Autoscaler", "Autoscaler/cluster",
                        controller="AutoscalerController"):
                    self.autoscaler.tick()
            except Exception:
                asc_result = "error"
                logger.exception("autoscaler pass failed")
            self.metrics.observe_reconcile("AutoscalerController",
                                           asc_result,
                                           time.monotonic() - t0)

    def run(self, interval: float = 2.0) -> None:
        logger.info("manager running; gates=%s", self.gates)
        self.fleet.start()
        try:
            while not self._stop.is_set():
                self.resync()
                self._stop.wait(interval)
        finally:
            self.fleet.stop()

    def stop(self) -> None:
        self._stop.set()


def main(argv=None):
    import os

    ap = argparse.ArgumentParser(prog="kaito-tpu-manager")
    ap.add_argument("--node-provisioner", default="karpenter",
                    choices=["karpenter", "byo"])
    ap.add_argument("--feature-gates", default="")
    ap.add_argument("--base-image-version", default="latest")
    ap.add_argument("--resync-seconds", type=float, default=0.0,
                    help="0 = auto: 2s in-memory, 30s against a real API "
                         "server (watch events carry the fast path)")
    ap.add_argument("--kube-api-url", default="",
                    help="API server base URL (in-cluster service-account "
                         "config is used when unset)")
    ap.add_argument("--in-memory-store", action="store_true",
                    help="use the in-process store even in-cluster (dev)")
    ap.add_argument("--namespace",
                    default=os.environ.get("POD_NAMESPACE", "default"))
    ap.add_argument("--disable-preset-autogen", action="store_true",
                    help="do not auto-generate presets for unregistered "
                         "org/model ids (catalog + HF hub)")
    ap.add_argument("--metrics-port", type=int, default=8080,
                    help="manager /metrics + /debug/trace port (0 = off; "
                         "matches the chart's metrics containerPort)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    # production preset auto-generation: unregistered org/model
    # Workspaces resolve via the committed catalog, then the HF hub
    # (reference: GeneratePreset at reconcile time,
    # presets/workspace/generator/generator.go:805-830).  Wired at the
    # entrypoint — not in Manager.__init__ — so embedding a Manager
    # (tests, tools) never silently switches the process-global
    # registry onto the network path.
    if not args.disable_preset_autogen:
        from kaito_tpu_torch.models.hub import install_default_fetcher

        install_default_fetcher()

    store = None
    in_cluster = "KUBERNETES_SERVICE_HOST" in os.environ
    if not args.in_memory_store and (args.kube_api_url or in_cluster):
        from kaito_tpu_torch.k8s import KubeClient, KubeStore

        store = KubeStore(KubeClient(base_url=args.kube_api_url),
                          namespace=args.namespace)
        logger.info("using Kubernetes API store (%s)",
                    args.kube_api_url or "in-cluster")
    mgr = Manager(store=store, node_provisioner=args.node_provisioner,
                  feature_gates=args.feature_gates,
                  base_image_version=args.base_image_version)
    if args.metrics_port:
        start_manager_server(mgr.metrics, port=args.metrics_port,
                             fleet=mgr.fleet)
    if store is not None:
        # informer analogue: watch streams feed the expectations and
        # event-driven callbacks registered by the reconcilers
        from kaito_tpu_torch.k8s.codec import TYPED_KINDS

        store.start_watching(list(TYPED_KINDS))
    resync = args.resync_seconds or (30.0 if store is not None else 2.0)
    mgr.run(resync)


if __name__ == "__main__":
    main()
