"""ModelMirror: cluster-scoped model weight cache.

Parity: ``api/v1alpha1/modelmirror_types.go:29-127`` — managed mode
downloads weights into shared storage (on GKE: a GCS bucket or Filestore
RWX volume instead of Azure Blob CSI); static mode trusts pre-seeded
storage.  Phases Pending → Downloading → Ready.

A copy of ``kaito_tpu.api.modelmirror``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from kaito_tpu_torch.api.meta import Condition, KaitoObject, ObjectMeta

PHASE_PENDING = "Pending"
PHASE_DOWNLOADING = "Downloading"
PHASE_READY = "Ready"
PHASE_FAILED = "Failed"


@dataclass
class MirrorSource:
    registry: str = "huggingface"
    model_id: str = ""
    access_secret: str = ""


@dataclass
class MirrorStorage:
    size: str = "100Gi"
    storage_class_name: str = ""
    bucket: str = ""                     # GCS bucket alternative to PVC


@dataclass
class ModelMirrorSpec:
    mode: str = "managed"                # managed | static
    source: MirrorSource = field(default_factory=MirrorSource)
    storage: MirrorStorage = field(default_factory=MirrorStorage)


@dataclass
class ModelMirrorStatus:
    phase: str = PHASE_PENDING
    conditions: list[Condition] = field(default_factory=list)
    downloaded_bytes: int = 0


class ModelMirror(KaitoObject):
    kind = "ModelMirror"

    def __init__(self, meta: ObjectMeta, spec: Optional[ModelMirrorSpec] = None):
        super().__init__(meta)
        self.spec = spec or ModelMirrorSpec()
        self.status = ModelMirrorStatus()

    def default(self) -> None:
        if not self.spec.mode:
            self.spec.mode = "managed"
        if (self.spec.mode == "managed" and not self.spec.storage.bucket
                and not self.spec.storage.storage_class_name):
            self.spec.storage.storage_class_name = "filestore-rwx"

    def validate(self) -> list[str]:
        errs = []
        if self.spec.mode not in ("managed", "static"):
            errs.append(f"mode {self.spec.mode!r} must be managed|static")
        if self.spec.mode == "managed" and not self.spec.source.model_id:
            errs.append("source.modelID required in managed mode")
        if not (self.spec.storage.bucket or self.spec.storage.storage_class_name
                or self.spec.mode == "static"):
            errs.append("storage.bucket or storage.storageClassName required")
        return errs
