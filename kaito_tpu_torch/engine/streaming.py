"""Streaming weight load: safetensors over ranged reads, no local copy.

Counterpart of ``kaito_tpu.engine.streaming``.  Instead of staging a
full HF snapshot on disk before loading, the engine reads each tensor's
exact byte span from the blob store (GCS ranged GETs authorized by the
GKE metadata server, a pre-provisioned token, or a plain HTTP(S) file
server) and hands the tensors to :func:`weights.assemble_params`, which
builds the stacked parameter tree.  A checkpoint then needs no local
disk, and a cold start is bounded by the network, not copy + load.

The safetensors layout makes this cheap: one small ranged read for each
shard's JSON header, then one ranged read per tensor.  Every span is
read through ``torch.frombuffer`` with the dtype table of
:func:`weights.read_safetensors` (bf16 included), so the module needs no
package beyond torch and the standard library.
"""

from __future__ import annotations

import json
import logging
import os
import struct
import time
import urllib.error
import urllib.request
from typing import Callable, Optional

import torch

from kaito_tpu_torch.engine.weights import _ST_DTYPES, assemble_params

logger = logging.getLogger(__name__)

INDEX_FILE = "model.safetensors.index.json"
SINGLE_FILE = "model.safetensors"


class HTTPRangeReader:
    """Ranged reads against any HTTP(S) file server.

    One persistent connection per reader (keep-alive), so a load of
    thousands of tensors pays one TLS handshake; transient errors (5xx,
    resets) are retried with backoff.
    """

    def __init__(self, base_url: str,
                 token_provider: Optional[Callable[[], str]] = None,
                 retries: int = 4):
        import urllib.parse

        self.base_url = base_url.rstrip("/")
        self.token_provider = token_provider
        self.retries = retries
        u = urllib.parse.urlsplit(self.base_url)
        self._scheme, self._host, self._prefix = u.scheme, u.netloc, u.path
        self._conn = None
        self.bytes_read = 0
        self.requests = 0

    def _connect(self):
        import http.client

        if self._conn is None:
            cls = (http.client.HTTPSConnection if self._scheme == "https"
                   else http.client.HTTPConnection)
            self._conn = cls(self._host, timeout=120)
        return self._conn

    def _drop(self):
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass
            self._conn = None

    def read(self, path: str, start: Optional[int] = None,
             end: Optional[int] = None) -> bytes:
        """``end`` is exclusive; both None read the whole object."""
        headers = {}
        if start is not None:
            tail = str(end - 1) if end is not None else ""
            headers["Range"] = f"bytes={start}-{tail}"
        last: Exception = RuntimeError("no attempts")
        for attempt in range(self.retries + 1):
            if self.token_provider:
                headers["Authorization"] = f"Bearer {self.token_provider()}"
            try:
                conn = self._connect()
                conn.request("GET", f"{self._prefix}/{path}", headers=headers)
                resp = conn.getresponse()
                data = resp.read()
                if resp.status == 404:
                    raise urllib.error.HTTPError(
                        f"{self.base_url}/{path}", 404, "not found",
                        resp.headers, None)
                if resp.status in (429, 500, 502, 503, 504):
                    raise OSError(f"HTTP {resp.status} (transient)")
                if resp.status not in (200, 206):
                    raise urllib.error.HTTPError(
                        f"{self.base_url}/{path}", resp.status,
                        data[:200].decode(errors="replace"),
                        resp.headers, None)
                if start is not None and resp.status != 206:
                    # a server that ignores Range would hand back whole
                    # shards (and break the offsets): refuse it
                    raise RuntimeError(
                        f"{self._host} ignored Range (HTTP 200 for "
                        f"{path}); streaming needs a range-capable store")
                self.bytes_read += len(data)
                self.requests += 1
                return data
            except urllib.error.HTTPError:
                raise
            except RuntimeError:
                raise
            except Exception as e:   # transient: resets, timeouts, 5xx
                last = e
                self._drop()
                if attempt < self.retries:
                    time.sleep(min(2.0 ** attempt * 0.2, 5.0))
        raise last


_gcp_token_cache: dict = {"token": "", "expiry": 0.0}


def gcp_metadata_token() -> str:
    """Workload-identity access token from the GKE metadata server."""
    now = time.monotonic()
    if _gcp_token_cache["expiry"] - now > 60:
        return _gcp_token_cache["token"]
    req = urllib.request.Request(
        "http://metadata.google.internal/computeMetadata/v1/instance/"
        "service-accounts/default/token",
        headers={"Metadata-Flavor": "Google"})
    with urllib.request.urlopen(req, timeout=10) as resp:
        data = json.loads(resp.read())
    _gcp_token_cache["token"] = data["access_token"]
    _gcp_token_cache["expiry"] = now + float(data.get("expires_in", 300))
    return _gcp_token_cache["token"]


def env_token() -> str:
    """Static bearer token from ``KAITO_STREAM_TOKEN``.  Raises when it
    is unset: an empty Bearer header would surface as opaque 401s on
    every ranged GET instead of one error at start-up."""
    tok = os.environ.get("KAITO_STREAM_TOKEN", "")
    if not tok:
        raise RuntimeError(
            "weights location uses the +token scheme but "
            "KAITO_STREAM_TOKEN is unset (secret mount missing?)")
    return tok


def _gcs_base(location: str) -> str:
    bucket, _, prefix = location[len("gs://"):].partition("/")
    base = f"https://storage.googleapis.com/{bucket}"
    return base + (f"/{prefix}" if prefix else "")


# scheme -> (base URL of a location, token provider); extend with
# register_credential_provider
CREDENTIAL_PROVIDERS: dict = {
    "gs": (_gcs_base, gcp_metadata_token),
    "https+token": (lambda loc: "https://" + loc.split("://", 1)[1],
                    env_token),
    "http+token": (lambda loc: "http://" + loc.split("://", 1)[1],
                   env_token),
}


def register_credential_provider(scheme: str, base_url_of, token_provider):
    """Add a blob-store scheme (an S3 or Azure signer, say): weight
    locations ``scheme://...`` then resolve through it."""
    CREDENTIAL_PROVIDERS[scheme] = (base_url_of, token_provider)


def make_reader(location: str) -> HTTPRangeReader:
    """Resolve a weights location through the credential registry:
    ``gs://`` takes the GKE metadata server's token, ``http(s)+token://``
    ``KAITO_STREAM_TOKEN``, and plain http(s) passes through."""
    scheme = location.split("://", 1)[0] if "://" in location else ""
    entry = CREDENTIAL_PROVIDERS.get(scheme)
    if entry is not None:
        base_url_of, token_provider = entry
        return HTTPRangeReader(base_url_of(location),
                               token_provider=token_provider or None)
    return HTTPRangeReader(location)


class SafetensorsStream:
    """Header-indexed ranged access to one or more safetensors shards."""

    def __init__(self, reader: HTTPRangeReader):
        self.reader = reader
        # tensor name -> (file, dtype string, shape, absolute start, end)
        self.index: dict[str, tuple[str, str, tuple, int, int]] = {}
        for f in self._discover_files():
            self._index_file(f)

    def _discover_files(self) -> list[str]:
        try:
            idx = json.loads(self.reader.read(INDEX_FILE))
            return sorted(set(idx.get("weight_map", {}).values()))
        except urllib.error.HTTPError as e:
            if e.code != 404:
                raise    # auth and permission problems surface
            return [SINGLE_FILE]

    def _index_file(self, fname: str) -> None:
        head = self.reader.read(fname, 0, 8)
        (n,) = struct.unpack("<Q", head)
        header = json.loads(self.reader.read(fname, 8, 8 + n))
        data_base = 8 + n
        for name, meta in header.items():
            if name == "__metadata__":
                continue
            a, b = meta["data_offsets"]
            self.index[name] = (fname, meta["dtype"], tuple(meta["shape"]),
                                data_base + a, data_base + b)

    def keys(self) -> list[str]:
        return sorted(self.index)

    def read_tensor(self, name: str) -> Optional[torch.Tensor]:
        entry = self.index.get(name)
        if entry is None:
            return None
        fname, dtype_s, shape, start, end = entry
        dtype = _ST_DTYPES.get(dtype_s)
        if dtype is None:
            raise ValueError(f"{fname}: tensor {name!r} has unsupported dtype "
                             f"{dtype_s}")
        if end == start:
            return torch.empty(shape, dtype=dtype)
        # a writable copy of the span: torch.frombuffer over bytes would
        # alias an immutable buffer
        blob = bytearray(self.reader.read(fname, start, end))
        return torch.frombuffer(blob, dtype=dtype).reshape(shape)


def stream_safetensors_params(model, location: str,
                              reader: Optional[HTTPRangeReader] = None) -> dict:
    """The stacked parameter tree of ``model``, each tensor's byte span
    streamed from ``location``, with no staging copy.  Prints one
    ``KAITO_WEIGHTS_STREAM_RESULT`` line (seconds, bytes, requests,
    MiB/s), the cold-start record."""
    t0 = time.monotonic()
    reader = reader or make_reader(location)
    stream = SafetensorsStream(reader)
    params = assemble_params(model, stream.read_tensor, stream.keys())
    secs = time.monotonic() - t0
    print("KAITO_WEIGHTS_STREAM_RESULT " + json.dumps({
        "location": location, "seconds": round(secs, 2),
        "bytes": reader.bytes_read, "requests": reader.requests,
        "mib_per_s": round(reader.bytes_read / 2**20 / max(secs, 1e-6), 1),
    }), flush=True)
    logger.info("streamed %.1f MiB in %.1fs (%d ranged reads) from %s",
                reader.bytes_read / 2**20, secs, reader.requests, location)
    return params


def is_stream_location(location: str) -> bool:
    """Whether the engine streams ``location`` instead of reading it as a
    directory: ``http://``, ``https://``, or any scheme of the credential
    registry (``gs://``, ``http(s)+token://``, registered ones).  The JAX
    engine streams only ``gs://``, ``http://`` and ``https://``, so a
    ``+token`` location, which its registry resolves, reaches its disk
    loader there."""
    scheme = location.split("://", 1)[0] if "://" in location else ""
    return scheme in ("http", "https") or scheme in CREDENTIAL_PROVIDERS
