"""Multi-tenant QoS configuration.

The port's own copy of ``kaito_tpu/engine/qos.py``: the ``adapters``
map routes a tenant's requests to its LoRA adapter
(:meth:`QoSConfig.adapter_of`, read by the server when a request's
``model`` field names none).

One JSON document describes the tenant classes an engine serves:

.. code-block:: json

    {
      "classes": {
        "guaranteed":  {"priority": 100, "weight": 8,
                        "max_queue_len": 64, "tokens_per_s": 0},
        "best-effort": {"priority": 0,   "weight": 1,
                        "max_queue_len": 16, "tokens_per_s": 2000}
      },
      "tenants": {"acme": "guaranteed"},
      "default_class": "best-effort"
    }

The document travels exactly like ``kv-cache-dtype`` did: a
``kaito-tpu.io/qos`` Workspace annotation, validated at plan time by
the workspace controller, rendered into ``--qos-config`` by
``manifests/inference.py``, parsed here into an immutable
:class:`QoSConfig` the engine, rate limiter, metrics and SLO watchdog
all share.  With no document the whole QoS plane is off: one implicit
tenant, the legacy single-FIFO admission and newest-preempts-first
eviction, byte-identical metrics exposition.

Semantics:

- ``priority`` — higher admits first and is preempted last.  Admission
  is strict across priorities; deficit-round-robin ``weight`` shares
  capacity among tenants OF THE SAME priority.
- ``max_queue_len`` — per-tenant waiting-queue budget (0 = only the
  engine-global limit applies).
- ``tokens_per_s`` — sustained token budget (prompt + generated,
  post-paid against a burst-capable bucket; 0 = unlimited).
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Optional

# tenant ids become metric label values and flow through HTTP headers:
# keep them label-safe and boundedly sized
_TENANT_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")

DEFAULT_TENANT = "default"

# canonical class names with well-known ranks; EPP priority scoring
# understands these even without the full document (the picker runs in
# its own pod and only sees the header)
WELL_KNOWN_PRIORITIES = {
    "guaranteed": 100,
    "premium": 75,
    "standard": 50,
    "best-effort": 0,
}

# token-bucket burst: a tenant may spend this many seconds of its
# sustained rate at once before shedding starts
BURST_SECONDS = 2.0


@dataclasses.dataclass(frozen=True)
class TenantClass:
    name: str
    priority: int = 0          # higher = admitted first, preempted last
    weight: int = 1            # DRR share within the same priority
    max_queue_len: int = 0     # per-tenant queue budget (0 = global only)
    tokens_per_s: float = 0.0  # sustained token budget (0 = unlimited)


class QoSConfig:
    """Parsed, validated tenant-class map."""

    def __init__(self, classes: dict[str, TenantClass],
                 tenants: dict[str, str], default_class: str,
                 adapters: Optional[dict[str, str]] = None):
        self.classes = classes
        self.tenants = tenants
        self.default_class = default_class
        # tenant -> LoRA adapter name: parsed and validated as in the
        # JAX package, refused by parse_qos_config while non-empty
        self.adapters = dict(adapters or {})

    def class_of(self, tenant: str,
                 priority: str = "") -> TenantClass:
        """Resolve a request's class: an explicit priority header names
        a class directly, else the tenant map, else the default."""
        if priority and priority in self.classes:
            return self.classes[priority]
        name = self.tenants.get(tenant, self.default_class)
        return self.classes[name]

    def weight_of(self, tenant: str) -> int:
        return self.class_of(tenant).weight

    def adapter_of(self, tenant: str) -> str:
        """The adapter a tenant's requests default to ("" = base)."""
        return self.adapters.get(tenant, "")

    def to_dict(self) -> dict:
        out = {
            "classes": {n: dataclasses.asdict(c)
                        for n, c in sorted(self.classes.items())},
            "tenants": dict(sorted(self.tenants.items())),
            "default_class": self.default_class,
        }
        if self.adapters:
            # omitted when empty so pre-adapter documents round-trip
            # byte-identically
            out["adapters"] = dict(sorted(self.adapters.items()))
        return out


def valid_tenant(tenant: str) -> bool:
    return bool(_TENANT_RE.match(tenant))


def priority_rank(name: str) -> float:
    """Normalized [0, 1] rank for a priority-class NAME, for scorers
    that see only the header (the EPP).  Numeric strings clamp to
    [0, 100]; unknown names score neutral so a custom class is never
    punished for being custom."""
    if not name:
        return 0.0
    try:
        return min(100, max(0, int(name))) / 100.0
    except ValueError:
        pass
    if name in WELL_KNOWN_PRIORITIES:
        return WELL_KNOWN_PRIORITIES[name] / 100.0
    return 0.5


def parse_qos_config(text: str) -> Optional["QoSConfig"]:
    """Parse ``--qos-config`` (inline JSON, or ``@path`` to a file).
    Empty input returns None — QoS off.  Raises ValueError on any
    malformed document."""
    text = (text or "").strip()
    if not text:
        return None
    if text.startswith("@"):
        with open(text[1:], encoding="utf-8") as f:
            text = f.read()
    try:
        doc = json.loads(text)
    except json.JSONDecodeError as e:
        raise ValueError(f"qos config is not valid JSON: {e}") from None
    if not isinstance(doc, dict):
        raise ValueError("qos config must be a JSON object")
    raw_classes = doc.get("classes")
    if not isinstance(raw_classes, dict) or not raw_classes:
        raise ValueError("qos config needs a non-empty 'classes' map")
    classes: dict[str, TenantClass] = {}
    for name, spec in raw_classes.items():
        if not valid_tenant(name):
            raise ValueError(f"qos class name {name!r} is not label-safe")
        if not isinstance(spec, dict):
            raise ValueError(f"qos class {name!r} must be an object")
        unknown = set(spec) - {"priority", "weight", "max_queue_len",
                               "tokens_per_s"}
        if unknown:
            raise ValueError(f"qos class {name!r} has unknown "
                             f"field(s): {sorted(unknown)}")
        try:
            cls = TenantClass(
                name=name,
                priority=int(spec.get("priority", 0)),
                weight=int(spec.get("weight", 1)),
                max_queue_len=int(spec.get("max_queue_len", 0)),
                tokens_per_s=float(spec.get("tokens_per_s", 0.0)))
        except (TypeError, ValueError) as e:
            raise ValueError(f"qos class {name!r}: {e}") from None
        if cls.weight < 1:
            raise ValueError(f"qos class {name!r}: weight must be >= 1")
        if cls.max_queue_len < 0 or cls.tokens_per_s < 0:
            raise ValueError(f"qos class {name!r}: budgets must be >= 0")
        classes[name] = cls
    tenants = doc.get("tenants", {})
    if not isinstance(tenants, dict):
        raise ValueError("qos 'tenants' must be a tenant -> class map")
    for tenant, cls_name in tenants.items():
        if not valid_tenant(tenant):
            raise ValueError(f"qos tenant {tenant!r} is not label-safe")
        if cls_name not in classes:
            raise ValueError(f"qos tenant {tenant!r} maps to unknown "
                             f"class {cls_name!r}")
    adapters = doc.get("adapters", {})
    if not isinstance(adapters, dict):
        raise ValueError("qos 'adapters' must be a tenant -> adapter map")
    for tenant, adapter in adapters.items():
        if not valid_tenant(tenant):
            raise ValueError(f"qos adapter tenant {tenant!r} is not "
                             f"label-safe")
        # adapter names become metric labels and /v1/models ids: hold
        # them to the same label-safe contract as tenants
        if not isinstance(adapter, str) or not valid_tenant(adapter):
            raise ValueError(f"qos adapter name {adapter!r} for tenant "
                             f"{tenant!r} is not label-safe")
    default_class = doc.get("default_class", "")
    if not default_class:
        if len(classes) == 1:
            default_class = next(iter(classes))
        else:
            raise ValueError("qos config needs 'default_class' when "
                             "more than one class is defined")
    if default_class not in classes:
        raise ValueError(f"qos default_class {default_class!r} is not "
                         f"a defined class")
    return QoSConfig(classes, dict(tenants), default_class, dict(adapters))
