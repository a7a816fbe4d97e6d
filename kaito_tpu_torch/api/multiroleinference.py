"""MultiRoleInference: prefill/decode disaggregation.

Parity: ``api/v1alpha1/multiroleinference_types.go:74-130`` — a model +
per-role scaling (prefill/decode) with role-specific instance types and
runtime config, plus the endpoint-picker plugin config that makes the
gateway route prefill→decode pairs.

A copy of ``kaito_tpu.api.multiroleinference``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from kaito_tpu_torch.api.meta import Condition, KaitoObject, ObjectMeta

ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"


@dataclass
class RoleSpec:
    type: str = ROLE_DECODE             # prefill | decode
    replicas: int = 1
    instance_type: str = "ct5lp-hightpu-4t"
    tpu_topology: str = ""
    runtime_config: dict = field(default_factory=dict)


@dataclass
class MRIModelSpec:
    name: str = ""
    model_access_secret: str = ""


@dataclass
class MultiRoleInferenceSpec:
    model: MRIModelSpec = field(default_factory=MRIModelSpec)
    roles: list[RoleSpec] = field(default_factory=list)
    epp_plugins_config: dict = field(default_factory=dict)


@dataclass
class MultiRoleInferenceStatus:
    conditions: list[Condition] = field(default_factory=list)
    role_ready: dict[str, bool] = field(default_factory=dict)


class MultiRoleInference(KaitoObject):
    kind = "MultiRoleInference"

    def __init__(self, meta: ObjectMeta,
                 spec: Optional[MultiRoleInferenceSpec] = None):
        super().__init__(meta)
        self.spec = spec or MultiRoleInferenceSpec()
        self.status = MultiRoleInferenceStatus()

    def default(self) -> None:
        for r in self.spec.roles:
            if r.replicas < 0:
                r.replicas = 0

    def validate(self) -> list[str]:
        errs = []
        if not self.spec.model.name:
            errs.append("model.name required")
        types = [r.type for r in self.spec.roles]
        if sorted(set(types)) != [ROLE_DECODE, ROLE_PREFILL]:
            errs.append("roles must contain exactly one prefill and one decode role")
        if len(types) != len(set(types)):
            errs.append("duplicate role types")
        return errs
