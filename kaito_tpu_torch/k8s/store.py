"""Store adapter over the Kubernetes API.

Implements the exact Store surface the reconcilers already use
(``controllers/runtime.py``) against a real API server, so the
whole controller layer becomes deployable without changes: the manager
constructs ``Manager(store=KubeStore(...))`` and every reconcile now
round-trips through the cluster (reference analogue:
``cmd/workspace/main.go:206`` ctrl.NewManager + its cached client).

Semantics mapping:
- resourceVersion conflicts -> HTTP 409 -> ConflictError (the retry
  helpers work unchanged)
- finalizer-gated deletion is native k8s behavior
- our CRDs declare the status subresource, so update() writes spec and
  status through their separate endpoints
- watch() fans server watch streams into the same callback signature
  the in-memory Store uses (event, kind, object)

A copy of ``kaito_tpu.k8s.store``.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Optional

from kaito_tpu_torch.api.meta import KaitoObject
from kaito_tpu_torch.controllers.runtime import ConflictError, NotFoundError
from kaito_tpu_torch.k8s.client import ApiError, KubeClient
from kaito_tpu_torch.k8s.codec import (
    STATUS_SUBRESOURCE,
    from_wire,
    resource_path,
    to_wire,
)

logger = logging.getLogger(__name__)


class KubeStore:
    """Store-compatible adapter over a KubeClient."""

    def __init__(self, client: Optional[KubeClient] = None,
                 namespace: str = "default"):
        self.client = client or KubeClient()
        self.namespace = namespace
        self._watchers: list[Callable[[str, str, KaitoObject], None]] = []
        self._watch_stop = threading.Event()
        self._watch_threads: list[threading.Thread] = []
        # Events recorded by reconcilers mirror to the API server as
        # real v1.Event objects (and stay greppable in-memory too)
        from kaito_tpu_torch.k8s.events import EventRecorder, KubeEventSink

        self.events = EventRecorder(
            sink=KubeEventSink(self.client, namespace=namespace))
        # manager metrics hook: called with the kind each time a watch
        # stream ends and the loop reconnects
        self.on_watch_restart: Optional[Callable[[str], None]] = None

    # -- CRUD ----------------------------------------------------------

    def _ns(self, obj_or_ns) -> str:
        if isinstance(obj_or_ns, str):
            return obj_or_ns or self.namespace
        return obj_or_ns.metadata.namespace or self.namespace

    def create(self, obj: KaitoObject) -> KaitoObject:
        wire = to_wire(obj)
        wire["metadata"].pop("resourceVersion", None)
        path = resource_path(obj.kind, self._ns(obj))
        try:
            out = self.client.request_json("POST", path, body=wire)
        except ApiError as e:
            if e.status == 409:
                raise ConflictError(str(e)) from None
            raise
        created = from_wire(out)
        if obj.kind in STATUS_SUBRESOURCE and wire.get("status"):
            # POST ignores status on subresource kinds; push it after
            try:
                wire_st = to_wire(created)
                wire_st["status"] = wire["status"]
                out = self.client.request_json(
                    "PUT", resource_path(obj.kind, self._ns(obj),
                                         obj.metadata.name, "status"),
                    body=wire_st)
                created = from_wire(out)
            except ApiError:
                logger.debug("status subresource write skipped", exc_info=True)
        return created

    def get(self, kind: str, namespace: str, name: str) -> KaitoObject:
        try:
            out = self.client.request_json(
                "GET", resource_path(kind, namespace or self.namespace, name))
        except ApiError as e:
            if e.status == 404:
                raise NotFoundError(f"{kind} {namespace}/{name} not found") \
                    from None
            raise
        return from_wire(out)

    def try_get(self, kind: str, namespace: str, name: str
                ) -> Optional[KaitoObject]:
        try:
            return self.get(kind, namespace, name)
        except NotFoundError:
            return None

    def list(self, kind: str, namespace: Optional[str] = None,
             labels: Optional[dict[str, str]] = None) -> list[KaitoObject]:
        path = resource_path(kind, namespace)
        query = {}
        if labels:
            query["labelSelector"] = ",".join(
                f"{k}={v}" for k, v in sorted(labels.items()))
        out = self.client.request_json("GET", path, query=query or None)
        items = []
        for item in out.get("items", []):
            item.setdefault("kind", kind)
            items.append(from_wire(item))
        return sorted(items, key=lambda o: o.metadata.name)

    def update(self, obj: KaitoObject) -> KaitoObject:
        wire = to_wire(obj)
        ns = self._ns(obj)
        path = resource_path(obj.kind, ns, obj.metadata.name)
        try:
            out = self.client.request_json("PUT", path, body=wire)
        except ApiError as e:
            if e.status == 409:
                raise ConflictError(str(e)) from None
            if e.status == 404:
                raise NotFoundError(str(e)) from None
            raise
        if obj.kind in STATUS_SUBRESOURCE and wire.get("status"):
            st_wire = dict(out)
            st_wire["status"] = wire["status"]
            try:
                out = self.client.request_json(
                    "PUT", path + "/status", body=st_wire)
            except ApiError as e:
                if e.status == 409:
                    raise ConflictError(str(e)) from None
                if e.status != 404:
                    raise
                # the main PUT finalized a deletion: nothing to update
        return from_wire(out)

    def delete(self, kind: str, namespace: str, name: str) -> None:
        try:
            self.client.request_json(
                "DELETE", resource_path(kind, namespace or self.namespace,
                                        name))
        except ApiError as e:
            if e.status == 404:
                raise NotFoundError(f"{kind} {namespace}/{name} not found") \
                    from None
            raise

    # -- watch ---------------------------------------------------------

    def watch(self, fn: Callable[[str, str, KaitoObject], None]) -> None:
        self._watchers.append(fn)

    def _notify(self, event: str, kind: str, obj: KaitoObject) -> None:
        for fn in list(self._watchers):
            try:
                fn(event, kind, obj)
            except Exception:
                logger.exception("watch callback failed")

    def start_watching(self, kinds: list[str]) -> None:
        """Spawn one reconnecting watch stream per kind; events fan into
        the registered callbacks (informer analogue)."""
        for kind in kinds:
            t = threading.Thread(target=self._watch_loop, args=(kind,),
                                 daemon=True, name=f"watch-{kind}")
            t.start()
            self._watch_threads.append(t)

    def _watch_loop(self, kind: str) -> None:
        path = resource_path(kind, None)
        last_rv = {"rv": ""}
        while not self._watch_stop.is_set():
            def handler(evt_type: str, wire: dict, kind=kind):
                if not evt_type or not wire:
                    return
                # resume token: reconnects continue from the last seen
                # event instead of silently dropping the gap
                rv = (wire.get("metadata") or {}).get("resourceVersion", "")
                if rv:
                    last_rv["rv"] = rv
                wire.setdefault("kind", kind)
                self._notify(evt_type, kind, from_wire(wire))

            self.client.watch(path, handler, self._watch_stop,
                              resource_version=last_rv["rv"])
            if not self._watch_stop.is_set() and self.on_watch_restart:
                try:
                    self.on_watch_restart(kind)
                except Exception:
                    logger.debug("watch-restart hook failed", exc_info=True)
            self._watch_stop.wait(1.0)

    def stop_watching(self) -> None:
        self._watch_stop.set()
