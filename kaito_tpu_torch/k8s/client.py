"""Minimal Kubernetes REST client (stdlib-only).

The counterpart of the reference's controller-runtime client
(the reference's `pkg/k8sclient/`, `cmd/workspace/main.go:206`): CRUD +
watch over HTTPS with bearer-token auth.  In-cluster configuration
follows the standard service-account contract
(KUBERNETES_SERVICE_HOST/_PORT + /var/run/secrets/kubernetes.io);
explicit base_url/token win for tests and out-of-cluster use.

A copy of ``kaito_tpu.k8s.client``.
"""

from __future__ import annotations

import json
import logging
import os
import ssl
import threading
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, Iterator, Optional

logger = logging.getLogger(__name__)

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class ApiError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.message = message


class KubeClient:
    def __init__(self, base_url: str = "", token: str = "",
                 ca_path: str = "", insecure: bool = False):
        if not base_url:
            host = os.environ.get("KUBERNETES_SERVICE_HOST", "")
            port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            if not host:
                raise RuntimeError(
                    "no base_url and not running in-cluster "
                    "(KUBERNETES_SERVICE_HOST unset)")
            base_url = f"https://{host}:{port}"
            token_file = os.path.join(SA_DIR, "token")
            if not token and os.path.exists(token_file):
                token = open(token_file).read().strip()
            if not ca_path and os.path.exists(os.path.join(SA_DIR, "ca.crt")):
                ca_path = os.path.join(SA_DIR, "ca.crt")
        self.base_url = base_url.rstrip("/")
        self.token = token
        if self.base_url.startswith("https"):
            self._ctx = ssl.create_default_context(
                cafile=ca_path or None)
            if insecure:
                self._ctx.check_hostname = False
                self._ctx.verify_mode = ssl.CERT_NONE
        else:
            self._ctx = None

    # -- low-level -----------------------------------------------------

    def _request(self, method: str, path: str,
                 body: Optional[dict] = None,
                 query: Optional[dict] = None,
                 timeout: float = 30.0):
        url = self.base_url + path
        if query:
            url += "?" + urllib.parse.urlencode(query)
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Accept", "application/json")
        if data is not None:
            req.add_header("Content-Type", "application/json")
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        try:
            return urllib.request.urlopen(req, timeout=timeout,
                                          context=self._ctx)
        except urllib.error.HTTPError as e:
            msg = e.read().decode(errors="replace")
            raise ApiError(e.code, msg) from None

    def request_json(self, method: str, path: str,
                     body: Optional[dict] = None,
                     query: Optional[dict] = None) -> dict:
        with self._request(method, path, body, query) as resp:
            return json.loads(resp.read())

    # -- watch ---------------------------------------------------------

    def watch(self, path: str, handler: Callable[[str, dict], None],
              stop: threading.Event,
              resource_version: str = "") -> None:
        """Stream watch events (JSON lines) until ``stop`` is set; the
        caller owns reconnect cadence via repeated calls."""
        query = {"watch": "true"}
        if resource_version:
            query["resourceVersion"] = resource_version
        try:
            with self._request("GET", path, query=query,
                               timeout=330.0) as resp:
                for line in resp:
                    if stop.is_set():
                        return
                    line = line.strip()
                    if not line:
                        continue
                    evt = json.loads(line)
                    handler(evt.get("type", ""), evt.get("object", {}))
        except (ApiError, OSError, json.JSONDecodeError) as e:
            if not stop.is_set():
                logger.warning("watch %s ended: %s", path, e)
