"""Admission webhook server.

Parity with the reference's knative-style admission webhooks
(``pkg/workspace/webhooks/webhooks.go:39``): a validating +
defaulting endpoint for our kinds, speaking the k8s
``admission.k8s.io/v1`` AdmissionReview protocol on stdlib HTTP(S).
The schema logic itself lives on the typed kinds (api/*.validate and
.default) — the webhook is a thin transport.

A copy of ``kaito_tpu.controllers.webhook``.
"""

from __future__ import annotations

import argparse
import base64
import copy
import json
import logging
import ssl
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

logger = logging.getLogger(__name__)


def _load_kind(kind: str, payload: dict):
    """Build a typed object from a YAML-shaped admission object."""
    from kaito_tpu_torch.api import (
        InferenceSet,
        ModelMirror,
        MultiRoleInference,
        ObjectMeta,
        RAGEngine,
        Workspace,
    )
    from kaito_tpu_torch.api.inferenceset import InferenceSetSpec, WorkspaceTemplate
    from kaito_tpu_torch.api.workspace import (
        AdapterSpec,
        InferenceSpec,
        ResourceSpec,
        TuningInput,
        TuningOutput,
        TuningSpec,
    )

    meta_d = payload.get("metadata", {})
    meta = ObjectMeta(name=meta_d.get("name", ""),
                      namespace=meta_d.get("namespace", "default"),
                      labels=dict(meta_d.get("labels", {})),
                      annotations=dict(meta_d.get("annotations", {})))

    def resource_spec(d):
        return ResourceSpec(
            instance_type=d.get("instanceType", "ct5lp-hightpu-4t"),
            count=int(d.get("count", 1)),
            tpu_topology=d.get("tpuTopology", ""),
            label_selector=dict(d.get("labelSelector", {}) or {}),
            preferred_nodes=list(d.get("preferredNodes", []) or []))

    if kind == "Workspace":
        inference = None
        if "inference" in payload:
            i = payload["inference"] or {}
            inference = InferenceSpec(
                preset=i.get("preset", ""), template=i.get("template"),
                config=i.get("config", ""),
                adapters=[AdapterSpec(name=a.get("name", ""),
                                      source_image=a.get("sourceImage", ""),
                                      strength=float(a.get("strength", 1.0)))
                          for a in i.get("adapters", []) or []])
        tuning = None
        if "tuning" in payload:
            t = payload["tuning"] or {}
            inp = t.get("input", {}) or {}
            out = t.get("output", {}) or {}
            tuning = TuningSpec(
                preset=t.get("preset", ""), method=t.get("method", "lora"),
                config=t.get("config", ""),
                input=TuningInput(urls=list(inp.get("urls", []) or []),
                                  image=inp.get("image", ""),
                                  volume=inp.get("volume")),
                output=TuningOutput(image=out.get("image", ""),
                                    image_push_secret=out.get("imagePushSecret", ""),
                                    volume=out.get("volume")))
        return Workspace(meta, resource=resource_spec(payload.get("resource", {})),
                         inference=inference, tuning=tuning)
    raise KeyError(kind)


class AdmissionHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def _write_json(self, payload: dict):
        body = json.dumps(payload).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _respond(self, review: dict, allowed: bool, message: str = "",
                 patch: Optional[list] = None):
        resp = {"uid": review.get("request", {}).get("uid", ""),
                "allowed": allowed}
        if message:
            resp["status"] = {"message": message}
        if patch:
            resp["patchType"] = "JSONPatch"
            resp["patch"] = base64.b64encode(json.dumps(patch).encode()).decode()
        self._write_json({"apiVersion": "admission.k8s.io/v1",
                          "kind": "AdmissionReview",
                          "response": resp})

    def _respond_conversion(self, review: dict):
        """CRD ConversionReview v1 (reference: the conversion webhook
        behind api/v1alpha1/*_conversion.go): objects convert to the
        requested version in EITHER direction — spoke->hub on writes
        of legacy manifests, hub->spoke when clients read at the
        served legacy version."""
        from kaito_tpu_torch.api.conversion import HUB_VERSION, convert

        req = review.get("request", {})
        desired = req.get("desiredAPIVersion", "") or HUB_VERSION
        converted = [convert(obj, desired) for obj in req.get("objects", [])]
        self._write_json({
            "apiVersion": "apiextensions.k8s.io/v1",
            "kind": "ConversionReview",
            "response": {"uid": req.get("uid", ""),
                         "result": {"status": "Success"},
                         "convertedObjects": converted}})

    def do_POST(self):
        try:
            n = int(self.headers.get("Content-Length", "0"))
            review = json.loads(self.rfile.read(n))
            if self.path.startswith("/convert"):
                return self._respond_conversion(review)
            req = review.get("request", {})
            kind = req.get("kind", {}).get("kind", "")
            obj = req.get("object", {}) or {}
        except (ValueError, json.JSONDecodeError):
            self.send_response(400)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return

        try:
            typed = _load_kind(kind, obj)
        except KeyError:
            return self._respond(review, True)  # kinds we don't gate

        if self.path.startswith("/default"):
            before = copy.deepcopy(obj)
            typed.default()
            patch = []
            if typed.resource.count != int(
                    (before.get("resource") or {}).get("count", 0) or 0):
                patch.append({"op": "add" if "resource" not in before else "replace",
                              "path": "/resource/count"
                              if "resource" in before else "/resource",
                              "value": typed.resource.count
                              if "resource" in before
                              else {"count": typed.resource.count}})
            return self._respond(review, True, patch=patch or None)

        typed.default()
        errs = typed.validate()
        if errs:
            return self._respond(review, False, message="; ".join(errs))
        return self._respond(review, True)


def make_server(host: str = "0.0.0.0", port: int = 9443,
                certfile: str = "", keyfile: str = "") -> ThreadingHTTPServer:
    server = ThreadingHTTPServer((host, port), AdmissionHandler)
    if certfile:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(certfile, keyfile or None)
        server.socket = ctx.wrap_socket(server.socket, server_side=True)
    return server


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=9443)
    ap.add_argument("--tls-cert", default="")
    ap.add_argument("--tls-key", default="")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    make_server(port=args.port, certfile=args.tls_cert,
                keyfile=args.tls_key).serve_forever()


if __name__ == "__main__":
    main()
