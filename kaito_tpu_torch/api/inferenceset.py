"""InferenceSet: replicated Workspaces with autoscale surface.

Parity with ``api/v1beta1/inferenceset_types.go:39-165``: replicas +
workspace template + selector for the HPA/KEDA scale subresource,
nodeCountLimit guard, rolling update strategy, auto-upgrade maintenance
window (cron).

A copy of ``kaito_tpu.api.inferenceset``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from kaito_tpu_torch.api.meta import Condition, KaitoObject, ObjectMeta
from kaito_tpu_torch.api.workspace import InferenceSpec, ResourceSpec


@dataclass
class MaintenanceWindow:
    cron: str = ""              # 5-field cron in UTC
    duration_minutes: int = 60


@dataclass
class AutoUpgradePolicy:
    enabled: bool = False
    maintenance_window: MaintenanceWindow = field(default_factory=MaintenanceWindow)


@dataclass
class WorkspaceTemplate:
    resource: ResourceSpec = field(default_factory=ResourceSpec)
    inference: InferenceSpec = field(default_factory=InferenceSpec)
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)


@dataclass
class AutoscalePolicy:
    """First-class autoscale surface consumed by the closed-loop
    actuator (``controllers/autoscaler.py``).  The fleet telemetry
    plane's hints (``SignalPolicy.scale_to_zero_hint`` /
    ``max_replicas_hint``) are derived from the SAME fields so
    ``status.recommended_replicas`` and actuation never disagree."""

    enabled: bool = False
    min_replicas: int = 1
    max_replicas: int = 0               # 0 = bounded only by nodeCountLimit
    scale_to_zero: bool = False         # sustained idle may park the set at 0
    idle_grace_s: float = 600.0         # extra idle dwell before scale-down
    scale_up_stabilization_s: float = 30.0
    scale_down_stabilization_s: float = 300.0
    scale_up_cooldown_s: float = 60.0
    scale_down_cooldown_s: float = 300.0
    drain_grace_s: float = 30.0         # EPP drain window before delete
    warm_pool: int = 1                  # replicas provisioned ahead on pressure
    warm_pool_gc_s: float = 600.0       # sustained non-pressure before warm GC

    def default(self) -> None:
        if self.min_replicas < 0:
            self.min_replicas = 0
        if self.max_replicas < 0:
            self.max_replicas = 0
        if self.warm_pool < 0:
            self.warm_pool = 0
        for f in ("idle_grace_s", "scale_up_stabilization_s",
                  "scale_down_stabilization_s", "scale_up_cooldown_s",
                  "scale_down_cooldown_s", "drain_grace_s",
                  "warm_pool_gc_s"):
            if getattr(self, f) < 0:
                setattr(self, f, 0.0)

    def validate(self) -> list[str]:
        errs = []
        if not self.enabled:
            return errs
        if self.min_replicas == 0 and not self.scale_to_zero:
            errs.append("autoscale.minReplicas 0 requires "
                        "autoscale.scaleToZero")
        if self.max_replicas and self.max_replicas < max(1, self.min_replicas):
            errs.append("autoscale.maxReplicas must be >= minReplicas")
        return errs

    def floor(self) -> int:
        """Lowest replica count sustained idle may park the set at:
        0 when scale-to-zero is on, else minReplicas (>= 1)."""
        return 0 if self.scale_to_zero else max(1, self.min_replicas)


@dataclass
class InferenceSetSpec:
    replicas: int = 1
    template: WorkspaceTemplate = field(default_factory=WorkspaceTemplate)
    node_count_limit: int = 0           # 0 = unlimited
    update_strategy: str = "RollingUpdate"
    auto_upgrade: AutoUpgradePolicy = field(default_factory=AutoUpgradePolicy)
    autoscale: AutoscalePolicy = field(default_factory=AutoscalePolicy)


@dataclass
class InferenceSetStatus:
    replicas: int = 0
    ready_replicas: int = 0
    selector: str = ""                  # scale-subresource label selector
    conditions: list[Condition] = field(default_factory=list)
    aggregated_peak_tokens_per_minute: float = 0.0
    # fleet telemetry plane (runtime/fleet.py): rolling scaling signal
    # + replica hint.  Read-side only — nothing actuates on these yet.
    scaling_signal: str = ""            # idle|nominal|pressure|saturated
    recommended_replicas: int = 0


class InferenceSet(KaitoObject):
    kind = "InferenceSet"

    def __init__(self, meta: ObjectMeta, spec: Optional[InferenceSetSpec] = None):
        super().__init__(meta)
        self.spec = spec or InferenceSetSpec()
        self.status = InferenceSetStatus()

    def default(self) -> None:
        if self.spec.replicas < 0:
            self.spec.replicas = 0
        if not self.spec.update_strategy:
            self.spec.update_strategy = "RollingUpdate"
        self.spec.autoscale.default()

    def validate(self) -> list[str]:
        errs = []
        if self.spec.replicas < 0:
            errs.append("spec.replicas must be >= 0")
        if self.spec.update_strategy not in ("RollingUpdate", "OnDelete"):
            errs.append(f"spec.updateStrategy {self.spec.update_strategy!r} invalid")
        if self.spec.node_count_limit < 0:
            errs.append("spec.nodeCountLimit must be >= 0")
        if self.spec.auto_upgrade.enabled and not self.spec.auto_upgrade.maintenance_window.cron:
            errs.append("autoUpgrade.maintenanceWindow.cron required when enabled")
        if not self.spec.template.inference.preset and self.spec.template.inference.template is None:
            errs.append("template.inference.preset or template is required")
        errs.extend(self.spec.autoscale.validate())
        return errs
