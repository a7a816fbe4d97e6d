"""Typed-object machinery shared by all our API kinds.

The in-process analogue of k8s apimachinery for the CRD surface the
reference defines in ``api/v1beta1`` — metadata, conditions, and a
generation/resourceVersion model rich enough for controller-runtime
style reconciliation and ControllerRevision histories.  Objects
serialize to/from plain dicts (YAML-shaped), so real cluster backends
can adapt them 1:1.

A copy of ``kaito_tpu.api.meta``.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Any, Optional


def now_iso() -> str:
    return datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    finalizers: list[str] = field(default_factory=list)
    owner_references: list[dict] = field(default_factory=list)
    uid: str = ""
    generation: int = 1
    resource_version: int = 0
    creation_timestamp: str = field(default_factory=now_iso)
    deletion_timestamp: Optional[str] = None

    @property
    def key(self) -> tuple[str, str]:
        return (self.namespace, self.name)


@dataclass
class Condition:
    """status.conditions entry (mirrors metav1.Condition semantics)."""

    type: str
    status: str = "Unknown"          # "True" | "False" | "Unknown"
    reason: str = ""
    message: str = ""
    last_transition_time: str = field(default_factory=now_iso)
    observed_generation: int = 0


def set_condition(conditions: list[Condition], new: Condition) -> None:
    """Upsert keeping last_transition_time stable when status unchanged
    (the semantics the reference relies on via meta.SetStatusCondition)."""
    for i, c in enumerate(conditions):
        if c.type == new.type:
            if c.status == new.status:
                new.last_transition_time = c.last_transition_time
            conditions[i] = new
            return
    conditions.append(new)


def get_condition(conditions: list[Condition], type_: str) -> Optional[Condition]:
    for c in conditions:
        if c.type == type_:
            return c
    return None


def condition_true(conditions: list[Condition], type_: str) -> bool:
    c = get_condition(conditions, type_)
    return c is not None and c.status == "True"


class KaitoObject:
    """Base for API kinds: metadata + deep-copyable spec/status."""

    kind: str = ""

    def __init__(self, meta: ObjectMeta):
        self.metadata = meta

    def deepcopy(self):
        return copy.deepcopy(self)
