"""Controller runtime: typed object store, reconcilers, revisions,
expectations.

The in-process equivalent of the reference's controller-runtime usage
plus its test fakes (``pkg/utils/test/mock_client.go:34``), designed the
way SURVEY.md §4 says the reference should have been: the SAME store
backs production reconciliation loops and tests, so multi-component
behavior (workspace → provisioner → nodes → statefulset → status) is
exercisable end-to-end without a cluster.  A real-cluster backend can
implement Store against the k8s API 1:1.

A copy of ``kaito_tpu.controllers.runtime``.
"""

from __future__ import annotations

import copy
import hashlib
import json
import logging
import threading
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Optional

from kaito_tpu_torch.api.meta import KaitoObject, ObjectMeta, now_iso

logger = logging.getLogger(__name__)


class ConflictError(Exception):
    """Optimistic-concurrency conflict (stale resourceVersion)."""


class NotFoundError(Exception):
    pass


class Store:
    """Namespaced typed object store with resourceVersion semantics and
    watch callbacks."""

    def __init__(self):
        self._objects: dict[str, dict[tuple[str, str], KaitoObject]] = defaultdict(dict)
        self._lock = threading.RLock()
        self._rv = 0
        self._watchers: list[Callable[[str, str, KaitoObject], None]] = []
        self._uid = 0
        # in-memory Event sink (k8s/events.py): reconcilers record
        # operator-visible transitions here; tests and the fake store
        # read them back.  Imported lazily — k8s.store imports this
        # module, so a top-level import would cycle.
        from kaito_tpu_torch.k8s.events import EventRecorder

        self.events = EventRecorder()

    # -- CRUD ----------------------------------------------------------

    def create(self, obj: KaitoObject) -> KaitoObject:
        with self._lock:
            kind = obj.kind
            key = obj.metadata.key
            if key in self._objects[kind]:
                raise ConflictError(f"{kind} {key} already exists")
            self._rv += 1
            self._uid += 1
            obj.metadata.resource_version = self._rv
            obj.metadata.uid = obj.metadata.uid or f"uid-{self._uid}"
            stored = obj.deepcopy()
            self._objects[kind][key] = stored
            self._notify("ADDED", kind, stored)
            return stored.deepcopy()

    def get(self, kind: str, namespace: str, name: str) -> KaitoObject:
        with self._lock:
            obj = self._objects[kind].get((namespace, name))
            if obj is None:
                raise NotFoundError(f"{kind} {namespace}/{name} not found")
            return obj.deepcopy()

    def try_get(self, kind: str, namespace: str, name: str) -> Optional[KaitoObject]:
        try:
            return self.get(kind, namespace, name)
        except NotFoundError:
            return None

    def list(self, kind: str, namespace: Optional[str] = None,
             labels: Optional[dict[str, str]] = None) -> list[KaitoObject]:
        with self._lock:
            out = []
            for (ns, _), obj in self._objects[kind].items():
                if namespace is not None and ns != namespace:
                    continue
                if labels and any(obj.metadata.labels.get(k) != v
                                  for k, v in labels.items()):
                    continue
                out.append(obj.deepcopy())
            return sorted(out, key=lambda o: o.metadata.name)

    def update(self, obj: KaitoObject) -> KaitoObject:
        with self._lock:
            kind, key = obj.kind, obj.metadata.key
            current = self._objects[kind].get(key)
            if current is None:
                raise NotFoundError(f"{kind} {key} not found")
            if obj.metadata.resource_version != current.metadata.resource_version:
                raise ConflictError(
                    f"{kind} {key}: stale resourceVersion "
                    f"{obj.metadata.resource_version} != {current.metadata.resource_version}")
            self._rv += 1
            obj.metadata.resource_version = self._rv
            stored = obj.deepcopy()
            self._objects[kind][key] = stored
            self._notify("MODIFIED", kind, stored)
            # finalizer-aware deletion completion
            if stored.metadata.deletion_timestamp and not stored.metadata.finalizers:
                del self._objects[kind][key]
                self._notify("DELETED", kind, stored)
            return stored.deepcopy()

    def delete(self, kind: str, namespace: str, name: str) -> None:
        """Mark deleted; object lingers until finalizers clear."""
        with self._lock:
            obj = self._objects[kind].get((namespace, name))
            if obj is None:
                raise NotFoundError(f"{kind} {namespace}/{name} not found")
            if obj.metadata.finalizers:
                if not obj.metadata.deletion_timestamp:
                    obj.metadata.deletion_timestamp = now_iso()
                    self._rv += 1
                    obj.metadata.resource_version = self._rv
                    self._notify("MODIFIED", kind, obj.deepcopy())
                return
            del self._objects[kind][(namespace, name)]
            self._notify("DELETED", kind, obj.deepcopy())

    # -- watch ---------------------------------------------------------

    def watch(self, fn: Callable[[str, str, KaitoObject], None]) -> None:
        self._watchers.append(fn)

    def _notify(self, event: str, kind: str, obj: KaitoObject) -> None:
        for fn in list(self._watchers):
            try:
                fn(event, kind, obj)
            except Exception:
                logger.exception("watch callback failed")


def update_with_retry(store: Store, kind: str, namespace: str, name: str,
                      mutate: Callable[[KaitoObject], None],
                      attempts: int = 5) -> KaitoObject:
    """Optimistic-concurrency retry loop (reference:
    ``pkg/utils/workspace/workspace.go`` UpdateWorkspaceWithRetry)."""
    last: Exception = RuntimeError("no attempts")
    for _ in range(attempts):
        obj = store.get(kind, namespace, name)
        mutate(obj)
        try:
            return store.update(obj)
        except ConflictError as e:
            last = e
    raise last


# ---------------------------------------------------------------------------
# ControllerRevision (reference: workspace_controller.go:384-494)
# ---------------------------------------------------------------------------

MAX_REVISION_HISTORY = 10


@dataclass
class ControllerRevision(KaitoObject):
    kind = "ControllerRevision"

    def __init__(self, meta: ObjectMeta, data: dict, revision: int):
        super().__init__(meta)
        self.data = data
        self.revision = revision


def hash_spec(payload: dict) -> str:
    blob = json.dumps(payload, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def sync_controller_revision(store: Store, owner: KaitoObject,
                             payload: dict) -> ControllerRevision:
    """Record the owner's spec as a numbered revision; dedupe on hash;
    prune history beyond MAX_REVISION_HISTORY."""
    h = hash_spec(payload)
    ns = owner.metadata.namespace
    prefix = f"{owner.metadata.name}-rev-"
    revisions = [r for r in store.list("ControllerRevision", ns)
                 if r.metadata.name.startswith(prefix)]
    revisions.sort(key=lambda r: r.revision)
    if revisions and revisions[-1].data.get("hash") == h:
        return revisions[-1]
    next_num = (revisions[-1].revision + 1) if revisions else 1
    rev = ControllerRevision(
        ObjectMeta(name=f"{prefix}{next_num}", namespace=ns,
                   labels={"kaito-tpu.io/owner": owner.metadata.name}),
        data={"hash": h, "payload": payload},
        revision=next_num)
    store.create(rev)
    for old in revisions[: max(0, len(revisions) + 1 - MAX_REVISION_HISTORY)]:
        store.delete("ControllerRevision", ns, old.metadata.name)
    return rev


# ---------------------------------------------------------------------------
# Expectations (reference: pkg/utils/controller.go:86-242)
# ---------------------------------------------------------------------------

class Expectations:
    """Guards replica managers against stale-cache over-creation: a
    controller records how many creates/deletes it issued and skips
    resync until the watch events arrive."""

    def __init__(self):
        self._adds: dict[str, int] = defaultdict(int)
        self._dels: dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    def expect_creations(self, key: str, n: int) -> None:
        with self._lock:
            self._adds[key] += n

    def expect_deletions(self, key: str, n: int) -> None:
        with self._lock:
            self._dels[key] += n

    def creation_observed(self, key: str) -> None:
        with self._lock:
            if self._adds[key] > 0:
                self._adds[key] -= 1

    def deletion_observed(self, key: str) -> None:
        with self._lock:
            if self._dels[key] > 0:
                self._dels[key] -= 1

    def satisfied(self, key: str) -> bool:
        with self._lock:
            return self._adds[key] <= 0 and self._dels[key] <= 0

    def clear(self, key: str) -> None:
        with self._lock:
            self._adds.pop(key, None)
            self._dels.pop(key, None)


# ---------------------------------------------------------------------------
# Reconciler loop
# ---------------------------------------------------------------------------

@dataclass
class Result:
    requeue: bool = False
    requeue_after: float = 0.0


class Reconciler:
    """Base reconciler: subclasses implement reconcile(obj) -> Result."""

    kind: str = ""

    def __init__(self, store: Store):
        self.store = store

    def reconcile(self, obj: KaitoObject) -> Result:
        raise NotImplementedError

    def reconcile_key(self, namespace: str, name: str) -> Result:
        obj = self.store.try_get(self.kind, namespace, name)
        if obj is None:
            return Result()
        return self.reconcile(obj)

    def reconcile_all(self, max_passes: int = 10) -> None:
        """Drive reconciliation to a fixed point (test/dev harness; the
        production manager wires watch events into a workqueue)."""
        for _ in range(max_passes):
            requeued = False
            for obj in self.store.list(self.kind):
                res = self.reconcile(obj)
                requeued |= res.requeue or res.requeue_after > 0
            if not requeued:
                return
