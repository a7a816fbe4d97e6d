"""ModelMirror reconciler: cluster-scoped weight cache.

Parity: ``pkg/modelmirror/controllers/modelmirror_controller.go:60-345``
— managed mode ensures shared storage (GKE: Filestore RWX PVC or a GCS
bucket) and a download Job that fetches the model into it, tracking
Pending → Downloading → Ready; static mode trusts pre-seeded storage.

A copy of ``kaito_tpu.controllers.modelmirror``.
"""

from __future__ import annotations

from kaito_tpu_torch.api.meta import Condition, ObjectMeta, set_condition
from kaito_tpu_torch.api.modelmirror import (
    PHASE_DOWNLOADING,
    PHASE_FAILED,
    PHASE_PENDING,
    PHASE_READY,
    ModelMirror,
)
from kaito_tpu_torch.controllers.objects import Unstructured
from kaito_tpu_torch.controllers.runtime import Reconciler, Result, update_with_retry
from kaito_tpu_torch.k8s.events import record_event

MIRROR_NAMESPACE = "kaito-tpu-system"


def generate_download_job(mirror: ModelMirror) -> Unstructured:
    """Weight-fetch Job (reference: pkg/modelmirror/download/job.go:33,
    hf-transfer into the PVC; ours prefers GCS via gsutil when a bucket
    is configured)."""
    src = mirror.spec.source
    if mirror.spec.storage.bucket:
        cmd = (f"python -m kaito_tpu.runtime.weight_fetch "
               f"--model-id {src.model_id} "
               f"--dest gs://{mirror.spec.storage.bucket}/{src.model_id}")
    else:
        cmd = (f"python -m kaito_tpu.runtime.weight_fetch "
               f"--model-id {src.model_id} --dest /mnt/models/{src.model_id}")
    spec = {
        "backoffLimit": 3,
        "template": {"spec": {
            "restartPolicy": "Never",
            "containers": [{
                "name": "downloader",
                "image": "ghcr.io/kaito-tpu/engine:latest",
                "command": ["sh", "-c", cmd],
                "volumeMounts": [] if mirror.spec.storage.bucket else
                [{"name": "models", "mountPath": "/mnt/models"}],
            }],
            "volumes": [] if mirror.spec.storage.bucket else
            [{"name": "models", "persistentVolumeClaim":
              {"claimName": f"{mirror.metadata.name}-models"}}],
        }},
    }
    return Unstructured(
        "Job", ObjectMeta(name=f"{mirror.metadata.name}-download",
                          namespace=MIRROR_NAMESPACE),
        spec=spec)


class ModelMirrorReconciler(Reconciler):
    kind = "ModelMirror"

    def reconcile(self, mirror: ModelMirror) -> Result:
        if mirror.metadata.deletion_timestamp:
            return Result()
        mirror.default()
        errs = mirror.validate()
        if errs:
            self._set_phase(mirror, PHASE_FAILED, "; ".join(errs))
            return Result()

        if mirror.spec.mode == "static":
            self._set_phase(mirror, PHASE_READY, "static storage trusted")
            return Result()

        # managed: ensure RWX PVC unless a bucket is used
        if not mirror.spec.storage.bucket:
            pvc_name = f"{mirror.metadata.name}-models"
            if self.store.try_get("PersistentVolumeClaim", MIRROR_NAMESPACE,
                                  pvc_name) is None:
                self.store.create(Unstructured(
                    "PersistentVolumeClaim",
                    ObjectMeta(name=pvc_name, namespace=MIRROR_NAMESPACE),
                    spec={"accessModes": ["ReadWriteMany"],
                          "storageClassName":
                          mirror.spec.storage.storage_class_name or "filestore-rwx",
                          "resources": {"requests":
                                        {"storage": mirror.spec.storage.size}}}))

        job_name = f"{mirror.metadata.name}-download"
        job = self.store.try_get("Job", MIRROR_NAMESPACE, job_name)
        if job is None:
            self.store.create(generate_download_job(mirror))
            self._set_phase(mirror, PHASE_DOWNLOADING, "download job created")
            return Result(requeue_after=10.0)
        if job.status.get("succeeded"):
            self._set_phase(mirror, PHASE_READY, "weights cached")
            return Result()
        if job.status.get("failed"):
            self._set_phase(mirror, PHASE_FAILED,
                            str(job.status.get("message", "download failed")))
            return Result()
        self._set_phase(mirror, PHASE_DOWNLOADING, "downloading")
        return Result(requeue_after=10.0)

    _PHASE_EVENTS = {
        PHASE_DOWNLOADING: ("Normal", "DownloadStarted"),
        PHASE_READY: ("Normal", "MirrorReady"),
        PHASE_FAILED: ("Warning", "MirrorFailed"),
    }

    def _set_phase(self, mirror, phase, message):
        prev = {"phase": None}

        def mutate(o):
            prev["phase"] = o.status.phase
            o.status.phase = phase
            set_condition(o.status.conditions, Condition(
                type="Ready", status="True" if phase == PHASE_READY else "False",
                reason=phase, message=message))
        update_with_retry(self.store, "ModelMirror", mirror.metadata.namespace,
                          mirror.metadata.name, mutate)
        if prev["phase"] != phase and phase in self._PHASE_EVENTS:
            etype, reason = self._PHASE_EVENTS[phase]
            record_event(self.store, mirror, etype, reason, message)
