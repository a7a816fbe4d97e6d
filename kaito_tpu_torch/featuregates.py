"""Feature gates (parity: ``pkg/featuregates/featuregates.go:17-57``).

Same map-based surface, TPU-relevant names: parse "a=true,b=false"
strings, validate against the known set, expose defaults.

A copy of ``kaito_tpu.featuregates``.
"""

from __future__ import annotations

DEFAULT_GATES: dict[str, bool] = {
    "disableNodeAutoProvisioning": False,
    "gatewayAPIInferenceExtension": False,
    "enableInferenceSetController": True,
    "enableMultiRoleInferenceController": False,
    "modelMirror": False,
    "modelStreaming": False,
    "enableBaseImageAutoUpgrade": False,
    "autoscaler": False,
    "pallasAttention": True,
    "sequenceParallelism": True,
}


def parse_feature_gates(s: str) -> dict[str, bool]:
    gates = dict(DEFAULT_GATES)
    if not s:
        return gates
    for pair in s.split(","):
        pair = pair.strip()
        if not pair:
            continue
        if "=" not in pair:
            raise ValueError(f"invalid feature gate {pair!r}, want name=bool")
        name, val = pair.split("=", 1)
        name = name.strip()
        if name not in DEFAULT_GATES:
            raise ValueError(
                f"unknown feature gate {name!r}; known: {sorted(DEFAULT_GATES)}")
        lowered = val.strip().lower()
        if lowered not in ("true", "false"):
            raise ValueError(f"feature gate {name!r} value {val!r} not a bool")
        gates[name] = lowered == "true"
    return gates
