"""Workspace: the primary user-facing kind.

TPU-native re-design of the reference's Workspace CRD
(``api/v1beta1/workspace_types.go:286-302``): ``resource`` asks for TPU
capacity (instance type is a TPU machine type; ``tpu_topology`` replaces
the MIG ``partition``), ``inference`` selects a preset/template plus
config and adapters, ``tuning`` describes a fine-tune job.  Validation
and defaulting follow ``workspace_validation.go``/``workspace_default.go``
semantics re-expressed for slices.

A copy of ``kaito_tpu.api.workspace`` whose ``resource.instanceType``
may also name a GPU machine type of the catalog (GKE's A3 types).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from kaito_tpu_torch.api.meta import Condition, KaitoObject, ObjectMeta
from kaito_tpu_torch.models.registry import is_valid_preset
from kaito_tpu_torch.sku.catalog import is_known_machine_type, parse_topology

# condition types (parity with the reference's condition model,
# workspace_controller.go:694-1107)
COND_RESOURCE_READY = "ResourceReady"
COND_NODE_CLAIM_READY = "NodeClaimReady"
COND_INFERENCE_READY = "InferenceReady"
COND_TUNING_STARTED = "TuningJobStarted"
COND_WORKSPACE_SUCCEEDED = "WorkspaceSucceeded"
COND_BENCHMARK_COMPLETE = "BenchmarkComplete"
# folded from the benchmark probe's /debug/slo verdict (runtime/slo.py)
COND_SLO_HEALTHY = "SLOHealthy"
# fleet telemetry verdict (runtime/fleet.py): True when a scaling
# action is signalled (pressure/saturated/idle), False when nominal
COND_SCALING_SIGNAL = "ScalingSignal"

# annotations / labels (our namespace, same roles as kaito.sh/*)
ANNOTATION_DISABLE_BENCHMARK = "kaito-tpu.io/disable-benchmark"
ANNOTATION_UPGRADE_TO = "kaito-tpu.io/upgrade-to-version"
# scale-down victim mark (controllers/autoscaler.py): the EPP renders
# this replica's backend as draining (picker stops scoring it,
# in-flight requests finish) before the Workspace is deleted
ANNOTATION_DRAINING = "kaito-tpu.io/draining"
LABEL_WORKSPACE_NAME = "kaito-tpu.io/workspace"
LABEL_CREATED_BY_INFERENCESET = "kaito-tpu.io/workspace-created-by-inferenceset"

MAX_SLICES_PER_WORKSPACE = 4   # pipeline-over-DCN cap (the reference caps
                               # PP at 3 nodes for a vLLM Ray bug; ours is
                               # a planner policy, not a bug workaround)


@dataclass
class ResourceSpec:
    """TPU capacity request."""

    instance_type: str = "ct5lp-hightpu-4t"
    count: int = 1                       # slices (node pools), not VMs
    tpu_topology: str = ""               # e.g. "4x4"; "" = planner decides
    label_selector: dict[str, str] = field(default_factory=dict)
    preferred_nodes: list[str] = field(default_factory=list)


@dataclass
class AdapterSpec:
    name: str = ""
    source_image: str = ""
    strength: float = 1.0


@dataclass
class InferenceSpec:
    preset: str = ""                     # preset name or HF id
    template: Optional[dict] = None      # raw pod template escape hatch
    config: str = ""                     # name of config map with engine YAML
    adapters: list[AdapterSpec] = field(default_factory=list)


@dataclass
class TuningInput:
    urls: list[str] = field(default_factory=list)
    image: str = ""
    volume: Optional[dict] = None


@dataclass
class TuningOutput:
    image: str = ""
    image_push_secret: str = ""
    volume: Optional[dict] = None


@dataclass
class TuningSpec:
    preset: str = ""
    method: str = "lora"                 # lora | qlora | full
    config: str = ""
    input: TuningInput = field(default_factory=TuningInput)
    output: TuningOutput = field(default_factory=TuningOutput)


@dataclass
class PerformanceStatus:
    metrics: dict[str, float] = field(default_factory=dict)
    config: dict[str, str] = field(default_factory=dict)


@dataclass
class WorkspaceStatus:
    conditions: list[Condition] = field(default_factory=list)
    target_node_count: int = 0
    worker_nodes: list[str] = field(default_factory=list)
    performance: PerformanceStatus = field(default_factory=PerformanceStatus)
    observed_generation: int = 0


class Workspace(KaitoObject):
    kind = "Workspace"

    def __init__(self, meta: ObjectMeta,
                 resource: Optional[ResourceSpec] = None,
                 inference: Optional[InferenceSpec] = None,
                 tuning: Optional[TuningSpec] = None):
        super().__init__(meta)
        self.resource = resource or ResourceSpec()
        self.inference = inference
        self.tuning = tuning
        self.status = WorkspaceStatus()

    # -- defaulting (reference: workspace_default.go) -------------------

    def default(self) -> None:
        if self.resource.count < 1:
            self.resource.count = 1
        if self.inference and self.inference.preset:
            self.inference.preset = self.inference.preset.strip()
        if self.tuning and not self.tuning.method:
            self.tuning.method = "lora"

    # -- validation (reference: workspace_validation.go:66) -------------

    def validate(self) -> list[str]:
        errs: list[str] = []
        if not self.metadata.name:
            errs.append("metadata.name is required")
        if self.inference is None and self.tuning is None:
            errs.append("one of inference or tuning must be set")
        if self.inference is not None and self.tuning is not None:
            errs.append("inference and tuning are mutually exclusive")

        r = self.resource
        if r.instance_type and not is_known_machine_type(r.instance_type) \
                and not r.label_selector:
            errs.append(
                f"resource.instanceType {r.instance_type!r} is not a known TPU "
                f"machine type and no labelSelector is set (BYO requires a selector)")
        if r.tpu_topology:
            try:
                parse_topology(r.tpu_topology)
            except ValueError as e:
                errs.append(f"resource.tpuTopology: {e}")
        if r.count < 1 or r.count > MAX_SLICES_PER_WORKSPACE:
            errs.append(
                f"resource.count must be in [1, {MAX_SLICES_PER_WORKSPACE}]")

        if self.inference is not None:
            i = self.inference
            if not i.preset and i.template is None:
                errs.append("inference.preset or inference.template is required")
            if i.preset and "/" not in i.preset and not is_valid_preset(i.preset):
                errs.append(f"inference.preset {i.preset!r} is not a known preset "
                            f"(HF ids must be org/name)")
            seen = set()
            for a in i.adapters:
                if not a.name or not a.source_image:
                    errs.append("inference.adapters entries need name and source")
                if a.name in seen:
                    errs.append(f"duplicate adapter name {a.name!r}")
                seen.add(a.name)
                if not (0.0 < a.strength <= 1.0):
                    errs.append(f"adapter {a.name!r} strength must be in (0, 1]")

        if self.tuning is not None:
            t = self.tuning
            if not t.preset:
                errs.append("tuning.preset is required")
            elif "/" not in t.preset and not is_valid_preset(t.preset):
                errs.append(f"tuning.preset {t.preset!r} is not a known preset")
            if t.method not in ("lora", "qlora", "full"):
                errs.append(f"tuning.method {t.method!r} must be lora|qlora|full")
            if not (t.input.urls or t.input.image or t.input.volume):
                errs.append("tuning.input needs one of urls, image, volume")
            if not (t.output.image or t.output.volume):
                errs.append("tuning.output needs image or volume")
        return errs

    # -- helpers --------------------------------------------------------

    @property
    def preset_name(self) -> str:
        if self.inference is not None:
            return self.inference.preset
        if self.tuning is not None:
            return self.tuning.preset
        return ""

    def revision_payload(self) -> dict:
        """The spec hash input for ControllerRevision tracking
        (reference: workspace_controller.go:384-494 hashes
        resource/inference/tuning)."""
        from dataclasses import asdict

        return {
            "resource": asdict(self.resource),
            "inference": asdict(self.inference) if self.inference else None,
            "tuning": asdict(self.tuning) if self.tuning else None,
        }
