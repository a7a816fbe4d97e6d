"""Prefill/decode disaggregation: the chunked, overlapped KV hand-off.

The port's own copy of ``kaito_tpu/engine/pd.py``.  A prefill engine
stages a request's KV pages, ships them over the pod side channel (HTTP
on the engine port) and the decode engine writes them into its own
pages and continues from the prompt boundary, with no prefill compute.

- The prefill engine stages a COMPACT DEVICE COPY of the request's pages
  (one gather on the engine thread, on its stream, with an event
  recorded after it); a background thread drains it into pinned host
  memory chunk by chunk (~8 MiB over layer/page ranges).  A chunk can be
  pulled the moment it lands.  With ``lazy_drain`` the drain waits for
  the first host consumer: a colocated decode engine takes the device
  slabs instead and the bytes never touch the host.
- The decode engine admits the request at once and assembles arriving
  chunks between steps, then writes the slab IN PLACE into the pool
  tensors it holds (``index_copy_``), as the host KV tier restores: every
  captured decode window and verify graph keeps the pool's addresses.
- ``should_transfer`` is the transfer-vs-recompute break-even: short
  prompts recompute locally instead.

Wire format: each chunk is ``{json header}\\n`` + raw K bytes + raw V
bytes (+ the fp32 page-scale slabs of an int8 pool), layer-major and
canonical: all KV heads, whatever either engine's tensor parallelism.
The header names the dtype as the JAX package does (``"bfloat16"``,
``"float32"``, ``"int8"``), so the bytes are the JAX writer's.  The
bytes move through torch (``view(torch.uint8)``, ``torch.frombuffer``),
never through a numpy bfloat16 array.
"""

from __future__ import annotations

import json
import logging
import math
import threading
import time
from dataclasses import dataclass
from typing import Optional

import torch

from kaito_tpu_torch.engine.devprof import phase_scope
from kaito_tpu_torch.utils.failpoints import FAILPOINTS

logger = logging.getLogger(__name__)

CHUNK_TARGET_BYTES = 8 << 20
STAGE_TTL_S = 120.0
# lazy_drain staged exports keep their device copy until the first host
# consumer starts the drain; past this grace the registry starts it, so
# an unpulled export degrades to host memory, never to a card-memory leak
EXPORT_DRAIN_GRACE_S = 5.0

# the wire's dtype names (the JAX package's numpy / ml_dtypes names)
WIRE_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
               "float32": torch.float32, "int8": torch.int8}
_WIRE_NAMES = {v: k for k, v in WIRE_DTYPES.items()}


def wire_dtype(name: str) -> torch.dtype:
    """The torch dtype of a wire dtype name; ValueError for one the wire
    does not carry."""
    try:
        return WIRE_DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported KV wire dtype {name!r}") from None


def dtype_name(dt: torch.dtype) -> str:
    """The wire name of a pool dtype."""
    try:
        return _WIRE_NAMES[dt]
    except KeyError:
        raise ValueError(f"KV dtype {dt} has no wire name") from None


# ---------------------------------------------------------------------------
# chunk planning + wire format
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ChunkPlan:
    """A [layer_lo:layer_hi, page_lo:page_hi] slab of a request's KV."""

    layer_lo: int
    layer_hi: int
    page_lo: int
    page_hi: int

    def to_json(self) -> list[int]:
        return [self.layer_lo, self.layer_hi, self.page_lo, self.page_hi]

    @staticmethod
    def from_json(v) -> "ChunkPlan":
        return ChunkPlan(*map(int, v))


def plan_chunks(n_layers: int, n_pages: int, bytes_per_layer_page: int,
                target_bytes: int = CHUNK_TARGET_BYTES) -> list[ChunkPlan]:
    """Split [n_layers, n_pages] into ~target_bytes slabs.

    Whole layers are grouped while they fit; a single layer wider than
    the target splits over page ranges.  ``bytes_per_layer_page`` counts
    K and V together."""
    plans: list[ChunkPlan] = []
    layer_bytes = max(1, n_pages * bytes_per_layer_page)
    if layer_bytes <= target_bytes:
        layers_per = max(1, target_bytes // layer_bytes)
        for lo in range(0, n_layers, layers_per):
            plans.append(ChunkPlan(lo, min(lo + layers_per, n_layers), 0, n_pages))
    else:
        pages_per = max(1, target_bytes // bytes_per_layer_page)
        for layer in range(n_layers):
            for p in range(0, n_pages, pages_per):
                plans.append(ChunkPlan(layer, layer + 1, p,
                                       min(p + pages_per, n_pages)))
    return plans


def _bytes_view(t: torch.Tensor) -> memoryview:
    """The C-order bytes of host tensor ``t`` as a flat view (a copy only
    when ``t`` is not contiguous)."""
    return memoryview(t.detach().contiguous().reshape(-1).view(torch.uint8).numpy())


def serialize_chunk(k: torch.Tensor, v: torch.Tensor,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None) -> bytearray:
    """One chunk on the wire: its JSON header, a newline, then K, V (and
    an int8 pool's fp32 scale slabs), each copied once into the buffer
    (host tensors; a card's are copied to the host first)."""
    head = {"shape": list(k.shape),
            "v_shape": list(v.shape),
            "dtype": dtype_name(k.dtype)}
    parts = [k, v]
    if k_scale is not None:
        # quantized KV: the fp32 page-scale slabs ride the same chunk
        head["ks_shape"] = list(k_scale.shape)
        head["vs_shape"] = list(v_scale.shape)
        parts += [k_scale.float(), v_scale.float()]
    hb = json.dumps(head).encode() + b"\n"
    sizes = [t.numel() * t.element_size() for t in parts]
    buf = bytearray(len(hb) + sum(sizes))
    buf[:len(hb)] = hb
    off = len(hb)
    for t, n in zip(parts, sizes):
        if n:
            buf[off:off + n] = _bytes_view(t.cpu())
        off += n
    return buf


def _from_raw(buf: bytearray, off: int, shape: tuple, dt: torch.dtype) -> torch.Tensor:
    n = math.prod(shape) * dt.itemsize
    if n == 0:
        return torch.empty(shape, dtype=dt)
    return torch.frombuffer(buf, dtype=torch.uint8, count=n,
                            offset=off).view(dt).reshape(shape)


def _chunk_layout(payload) -> tuple:
    """A chunk's header parts, checked against its length: (the body's
    offset, dtype, K / V / scale shapes, their byte sizes)."""
    cut = payload.index(b"\n")
    meta = json.loads(bytes(payload[:cut]))
    k_shape = tuple(meta["shape"])
    # V carries its OWN shape: an MLA pool's V is zero-size
    v_shape = tuple(meta.get("v_shape", meta["shape"]))
    dt = wire_dtype(meta["dtype"])
    nk = math.prod(k_shape) * dt.itemsize
    nv = math.prod(v_shape) * dt.itemsize
    ks_shape = tuple(meta["ks_shape"]) if "ks_shape" in meta else None
    vs_shape = tuple(meta["vs_shape"]) if "vs_shape" in meta else None
    nks = math.prod(ks_shape) * 4 if ks_shape is not None else 0
    nvs = math.prod(vs_shape) * 4 if vs_shape is not None else 0
    size = len(payload) - cut - 1
    if size != nk + nv + nks + nvs:
        raise ValueError(f"chunk body is {size} bytes, expected "
                         f"{nk + nv + nks + nvs} for K {k_shape} + V "
                         f"{v_shape} {meta['dtype']}"
                         + (f" + scales {ks_shape}/{vs_shape}"
                            if ks_shape is not None else ""))
    return (cut + 1, dt, (k_shape, v_shape, ks_shape, vs_shape), (nk, nv, nks, nvs))


def deserialize_chunk(payload: bytes) -> tuple[
        torch.Tensor, torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """A chunk's host tensors ``(k, v, k_scale, v_scale)``, the scales
    None for an unquantized pool; ValueError when the body's length
    disagrees with its header."""
    start, dt, (k_shape, v_shape, ks_shape, vs_shape), (nk, nv, nks, _) = \
        _chunk_layout(payload)
    body = bytearray(memoryview(payload)[start:])
    k = _from_raw(body, 0, k_shape, dt)
    v = _from_raw(body, nk, v_shape, dt)
    ks = vs = None
    if ks_shape is not None:
        ks = _from_raw(body, nk + nv, ks_shape, torch.float32)
        vs = _from_raw(body, nk + nv + nks, vs_shape, torch.float32)
    return k, v, ks, vs


def pack_transfer(meta: dict, payload: bytes) -> bytes:
    return json.dumps(meta).encode() + b"\n" + payload


def unpack_transfer(blob: bytes) -> tuple[dict, bytes]:
    head, _, payload = blob.partition(b"\n")
    return json.loads(head), payload


# ---------------------------------------------------------------------------
# one-shot export/import on the pool tensors
# ---------------------------------------------------------------------------

def _shards(cache) -> list:
    """The pools of every shard: a tensor-parallel engine holds one
    ``KVCache`` per shard, each with ``Hkv / n`` of the KV heads."""
    return list(cache) if isinstance(cache, (list, tuple)) else [cache]


def _check_flat(shards: list) -> None:
    if shards[0].k.ndim != 5:
        raise NotImplementedError(
            "pipeline-staged KV pools wait for pipeline parallelism "
            "(ROADMAP queue 1, M19)")


def _gather_canonical(cache, pages: list[int]):
    """A device gather of a request's pages in the CANONICAL layer-major
    layout ``(k, v, k_scale, v_scale)`` ([L, n, ps, Hkv, D]; the scales
    [L, n, Hkv] or None), on the first shard's device: the shards of a
    tensor-parallel pool join along the KV-head axis."""
    shards = _shards(cache)
    _check_flat(shards)
    dev = shards[0].k.device
    parts = {"k": [], "v": [], "ks": [], "vs": []}
    for c in shards:
        idx = torch.tensor(pages, dtype=torch.long, device=c.k.device)
        parts["k"].append(c.k.index_select(1, idx).to(dev))
        parts["v"].append(c.v.index_select(1, idx).to(dev))
        if c.k_scale is not None:
            parts["ks"].append(c.k_scale.index_select(1, idx).to(dev))
            parts["vs"].append(c.v_scale.index_select(1, idx).to(dev))

    def join(xs, dim):
        if not xs:
            return None
        return xs[0] if len(xs) == 1 else torch.cat(xs, dim=dim)

    return (join(parts["k"], 3), join(parts["v"], 3),
            join(parts["ks"], 2), join(parts["vs"], 2))


def _slab_meta(k, v, ks, vs, **fields) -> dict:
    """A canonical slab's wire meta in the JAX writer's key order: the
    shapes and dtype, then ``fields``, then an int8 pool's scale
    shapes."""
    meta = {"shape": [int(s) for s in k.shape],
            "v_shape": [int(s) for s in v.shape],
            "dtype": dtype_name(k.dtype), **fields}
    if ks is not None:
        meta["ks_shape"] = [int(s) for s in ks.shape]
        meta["vs_shape"] = [int(s) for s in vs.shape]
    return meta


def export_kv(cache, pages: list[int]) -> tuple[dict, bytes]:
    """Gather a request's pages to the host in one shot (the canonical
    wire layout); returns (meta, payload).  The chunked path below is
    the serving one; this is the simple primitive for tests and small
    in-process hand-offs."""
    k, v, ks, vs = _gather_canonical(cache, pages)
    return _slab_meta(k, v, ks, vs), serialize_chunk(k, v, ks, vs)


def import_kv(cache, pages: list[int], payload: bytes, meta: dict) -> None:
    """Write a one-shot transfer into the local pool, in place."""
    k, v, ks, vs = deserialize_chunk(payload)
    import_arrays(cache, pages, k, v, ks, vs)


@phase_scope("kv_import")
def import_arrays(cache, pages: list[int], k: torch.Tensor, v: torch.Tensor,
                  k_scale: Optional[torch.Tensor] = None,
                  v_scale: Optional[torch.Tensor] = None,
                  after: Optional["torch.cuda.Event"] = None) -> None:
    """Write a fully assembled canonical [L, n_pages, ...] slab into page
    slots ``pages`` of the pool IN PLACE (``index_copy_``: the pool
    tensors keep their storage).  A tensor-parallel pool takes each
    shard's contiguous run of KV heads, the split ``shard_leaf`` cuts.
    ``after`` (a staged export's gather event) orders a device-to-device
    copy behind the gather it reads.  Shapes, dtypes and the int8 scales
    are checked as the JAX package's ``import_arrays`` checks them."""
    shards = _shards(cache)
    _check_flat(shards)
    n = len(shards)
    c0 = shards[0]
    L = c0.k.shape[0]
    tail = list(c0.k.shape[2:])
    tail[1] *= n
    vtail = list(c0.v.shape[2:])
    vtail[1] *= n
    expect = (L, len(pages)) + tuple(tail)
    if tuple(k.shape) != expect:
        raise ValueError(f"KV shape mismatch: got {tuple(k.shape)}, cache wants {expect}")
    expect_v = (L, len(pages)) + tuple(vtail)
    if tuple(v.shape) != expect_v:
        raise ValueError(f"KV V shape mismatch: got {tuple(v.shape)}, cache wants "
                         f"{expect_v}")
    if (c0.k_scale is not None) != (k_scale is not None):
        # never write bf16 wire bytes into an int8 pool (or drop the
        # scales of an int8 slab into a bf16 pool)
        raise ValueError(
            "KV quantization mismatch: "
            + ("pool is int8 but the transfer carries no page scales"
               if c0.k_scale is not None else
               "transfer carries page scales but the pool is not int8")
            + " — prefill and decode roles must run the same --kv-cache-dtype")
    if k_scale is not None:
        expect_s = (L, len(pages), c0.k_scale.shape[-1] * n)
        if tuple(k_scale.shape) != expect_s or tuple(v_scale.shape) != expect_s:
            raise ValueError(f"KV scale shape mismatch: got {tuple(k_scale.shape)}, "
                             f"cache wants {expect_s}")
    ks = k.chunk(n, dim=3) if n > 1 else (k,)
    vs = v.chunk(n, dim=3) if n > 1 else (v,)
    kss = vss = None
    if k_scale is not None:
        kss = k_scale.chunk(n, dim=2) if n > 1 else (k_scale,)
        vss = v_scale.chunk(n, dim=2) if n > 1 else (v_scale,)
    for j, c in enumerate(shards):
        dev = c.k.device
        if after is not None and dev.type == "cuda":
            torch.cuda.current_stream(dev).wait_event(after)
        idx = torch.tensor(pages, dtype=torch.long, device=dev)
        c.k.index_copy_(1, idx, ks[j].to(dev, c.k.dtype, non_blocking=True))
        if c.v.numel():
            c.v.index_copy_(1, idx, vs[j].to(dev, c.v.dtype, non_blocking=True))
        if kss is not None:
            c.k_scale.index_copy_(1, idx, kss[j].to(dev, torch.float32,
                                                     non_blocking=True))
            c.v_scale.index_copy_(1, idx, vss[j].to(dev, torch.float32,
                                                     non_blocking=True))


# ---------------------------------------------------------------------------
# prefill side: staged export with a background drain to host
# ---------------------------------------------------------------------------

class StagedExport:
    """A finished prefill's KV, draining device to host chunk by chunk.

    Construction happens on the engine thread and does only the device
    gather (compact [L, n_pages, ...] copies of K and V) and records an
    event after it; the host copies run on a background thread into
    pinned memory, one chunk at a time, and the device copies are
    released after the last chunk, so card memory is held only while the
    drain runs (or, with ``lazy_drain``, until a consumer or the
    registry's grace starts it)."""

    def __init__(self, k_dev, v_dev, meta: dict, plans: list[ChunkPlan],
                 prompt_tokens: list[int], first_token: int,
                 lazy_drain: bool = False, ks_dev=None, vs_dev=None,
                 event=None):
        self.meta = meta
        self.plans = plans
        self.prompt_tokens = prompt_tokens
        self.first_token = first_token
        self.created = time.monotonic()
        # refreshed by KVExportRegistry.get() so a slow multi-chunk pull
        # keeps the entry alive: the TTL ages on this, not on `created`
        self.last_access = self.created
        self._k_dev, self._v_dev = k_dev, v_dev
        self._ks_dev, self._vs_dev = ks_dev, vs_dev
        # recorded on the prefill engine's stream after the gather: the
        # drain and a colocated importer wait on it
        self.event = event
        self._chunks: list[Optional[bytes]] = [None] * len(plans)
        self._ready = [threading.Event() for _ in plans]
        self._error: Optional[str] = None
        self._served = 0
        self._lock = threading.Lock()
        self._blob_lock = threading.Lock()
        self._blob: Optional[bytes] = None
        self._drain_lock = threading.Lock()
        self._drain_started = False
        if not lazy_drain:
            self.ensure_draining()

    @property
    def draining(self) -> bool:
        with self._drain_lock:
            return self._drain_started

    def ensure_draining(self) -> None:
        """Start the device-to-host drain once (idempotent)."""
        with self._drain_lock:
            if self._drain_started:
                return
            self._drain_started = True
        threading.Thread(target=self._drain, daemon=True,
                         name="pd-export-copier").start()

    def device_slabs(self):
        """The staged canonical device copies ``(k, v)``, plus
        ``(k_scale, v_scale)`` for an int8 pool, for a colocated
        device-to-device hand-off; None once the drain released them.
        The references stay valid after the drain ends."""
        with self._drain_lock:
            if self._k_dev is None:
                return None
            if self._ks_dev is not None:
                return self._k_dev, self._v_dev, self._ks_dev, self._vs_dev
            return self._k_dev, self._v_dev

    def _drain(self):
        try:
            FAILPOINTS.fire("pd.export_drain")
            if self.event is not None:
                self.event.synchronize()
            slabs = [t for t in (self._k_dev, self._v_dev, self._ks_dev, self._vs_dev)
                     if t is not None]
            if slabs[0].device.type == "cuda":
                # the whole slab to pinned host memory in one copy each
                host = []
                for t in slabs:
                    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    h.copy_(t)
                    host.append(h)
                slabs = host
            for i, p in enumerate(self.plans):
                sl = (slice(p.layer_lo, p.layer_hi), slice(p.page_lo, p.page_hi))
                self._chunks[i] = serialize_chunk(*[t[sl] for t in slabs])
                self._ready[i].set()
        except Exception as e:  # a device fault or a shape bug: fail loudly
            self._error = f"{type(e).__name__}: {e}"
            for ev in self._ready:
                ev.set()
        finally:
            with self._drain_lock:
                self._k_dev = self._v_dev = None   # release the device copy
                self._ks_dev = self._vs_dev = None

    @property
    def n_chunks(self) -> int:
        return len(self.plans)

    def get_chunk(self, i: int, timeout: float = 60.0, consume: bool = True) -> bytes:
        """Block until chunk ``i`` has landed on the host; return its
        bytes.  ``consume`` frees the chunk after the read (each chunk is
        pulled once), bounding staged host memory."""
        if not 0 <= i < len(self.plans):
            raise IndexError(f"chunk {i} out of range ({len(self.plans)})")
        self.ensure_draining()
        if not self._ready[i].wait(timeout):
            raise TimeoutError(f"chunk {i} not ready after {timeout:.0f}s")
        if self._error:
            raise RuntimeError(f"export copier failed: {self._error}")
        with self._lock:
            data = self._chunks[i]
            if data is None:
                raise KeyError(f"chunk {i} already consumed")
            if consume:
                self._chunks[i] = None
                self._served += 1
        # chaos hook: an armed "pd.chunk" corrupt point flips bytes on the
        # wire so the receive-side shape checks are exercised end to end
        return FAILPOINTS.corrupt("pd.chunk", data, chunk=i)

    def restage_chunk(self, i: int, data: bytes) -> None:
        """Put a consumed chunk back (a send failed after the claim)."""
        with self._lock:
            if self._chunks[i] is None:
                self._chunks[i] = data
                self._served -= 1

    @property
    def fully_served(self) -> bool:
        with self._lock:
            return self._served >= len(self.plans)

    def wait_all(self, timeout: float = 120.0) -> None:
        self.ensure_draining()
        deadline = time.monotonic() + timeout
        for ev in self._ready:
            if not ev.wait(max(0.0, deadline - time.monotonic())):
                raise TimeoutError("export copier did not finish")
        if self._error:
            raise RuntimeError(f"export copier failed: {self._error}")

    def whole_blob(self) -> bytes:
        """The single-payload wire form (one serialized slab covering
        every page), built once from the chunks and cached, so a retried
        or concurrent pull gets the same bytes."""
        with self._blob_lock:
            if self._blob is None:
                self.wait_all()
                dt = wire_dtype(self.meta["dtype"])
                k = torch.empty(tuple(self.meta["shape"]), dtype=dt)
                v = torch.empty(tuple(self.meta.get("v_shape", self.meta["shape"])),
                                dtype=dt)
                ks = vs = None
                if "ks_shape" in self.meta:
                    ks = torch.empty(tuple(self.meta["ks_shape"]), dtype=torch.float32)
                    vs = torch.empty(tuple(self.meta["vs_shape"]), dtype=torch.float32)
                for i, p in enumerate(self.plans):
                    ck, cv, cks, cvs = deserialize_chunk(self.get_chunk(i))
                    k[p.layer_lo:p.layer_hi, p.page_lo:p.page_hi] = ck
                    v[p.layer_lo:p.layer_hi, p.page_lo:p.page_hi] = cv
                    if ks is not None:
                        ks[p.layer_lo:p.layer_hi, p.page_lo:p.page_hi] = cks
                        vs[p.layer_lo:p.layer_hi, p.page_lo:p.page_hi] = cvs
                self._blob = serialize_chunk(k, v, ks, vs)
            return self._blob


def slab_plans(k, v, ks=None, vs=None) -> list[ChunkPlan]:
    """The chunk plan of a canonical slab (its bytes a layer-page)."""
    per_layer_page = (math.prod(k.shape[2:]) + math.prod(v.shape[2:])) * k.dtype.itemsize
    if ks is not None:
        per_layer_page += (math.prod(ks.shape[2:]) + math.prod(vs.shape[2:])) * 4
    return plan_chunks(int(k.shape[0]), int(k.shape[1]), per_layer_page,
                       CHUNK_TARGET_BYTES)


def stage_export(cache, pages: list[int], *, n_tokens: int, model: str,
                 prompt_tokens: list[int], first_token: int,
                 lazy_drain: bool = False, trace_id: str = "") -> StagedExport:
    """Engine-thread entry: the device gather, an event after it, and the
    chunk plan; the returned export drains (now, or lazily)."""
    k_dev, v_dev, ks_dev, vs_dev = _gather_canonical(cache, pages)
    event = None
    if k_dev.device.type == "cuda":
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(k_dev.device))
    plans = slab_plans(k_dev, v_dev, ks_dev, vs_dev)
    meta = _slab_meta(k_dev, v_dev, ks_dev, vs_dev, n_tokens=n_tokens, model=model,
                      chunks=[p.to_json() for p in plans])
    if trace_id:
        # the decode role's spans land under the SAME X-Request-Id
        meta["trace_id"] = trace_id
    return StagedExport(k_dev, v_dev, meta, plans, prompt_tokens, first_token,
                        lazy_drain=lazy_drain, ks_dev=ks_dev, vs_dev=vs_dev,
                        event=event)


class KVExportRegistry:
    """Prefill-side staging area: finished prefills wait here until the
    decode engine pulls them (TTL-bounded, so abandoned transfers do not
    pin memory)."""

    def __init__(self, ttl_s: float = STAGE_TTL_S):
        self._items: dict[str, StagedExport] = {}
        self._lock = threading.Lock()
        self.ttl_s = ttl_s

    def put(self, req_id: str, exp: StagedExport) -> None:
        with self._lock:
            self._gc()
            self._items[req_id] = exp

    def get(self, req_id: str) -> Optional[StagedExport]:
        """Non-consuming lookup (chunked pulls consume chunk by chunk; the
        entry drops once every chunk has been served)."""
        with self._lock:
            exp = self._items.get(req_id)
            if exp is not None and exp.fully_served:
                del self._items[req_id]
                return None
            if exp is not None:
                exp.last_access = time.monotonic()
            return exp

    def pop(self, req_id: str) -> Optional[StagedExport]:
        with self._lock:
            return self._items.pop(req_id, None)

    def drop_served(self, req_id: str) -> None:
        with self._lock:
            exp = self._items.get(req_id)
            if exp is not None and exp.fully_served:
                del self._items[req_id]

    def _gc(self) -> None:
        now = time.monotonic()
        dead = [k for k, e in self._items.items() if now - e.last_access > self.ttl_s]
        for k in dead:
            del self._items[k]

    def tick(self, grace_s: float = EXPORT_DRAIN_GRACE_S) -> None:
        """Periodic upkeep from the engine loop: TTL-collect abandoned
        entries, and start the drain of a lazy entry older than the grace
        whose colocated consumer never came."""
        now = time.monotonic()
        with self._lock:
            self._gc()
            stale = [e for e in self._items.values()
                     if not e.draining and now - e.created > grace_s]
        for e in stale:
            e.ensure_draining()

    def __len__(self) -> int:
        """Live (not yet exhausted) entries."""
        with self._lock:
            return sum(1 for e in self._items.values() if not e.fully_served)


# ---------------------------------------------------------------------------
# decode side: chunked receive state (assembled by the scheduler loop)
# ---------------------------------------------------------------------------

class ChunkedImport:
    """Receive-side state of one request's KV transfer in flight.

    The server's puller thread ``feed``s chunks as they arrive; the
    engine loop assembles them into host buffers between steps (at most
    ``max_n`` a call), and when the last one lands ONE in-place write
    moves the slab into the pool.  The inactivity timeout measures chunk
    ARRIVAL, never the admission queue or the assembly."""

    def __init__(self, meta: dict, plans: list[ChunkPlan], first_token: int,
                 deadline_s: float = 120.0):
        self.meta = meta
        self.plans = plans
        self.first_token = first_token
        self.deadline_s = deadline_s
        self.n_scattered = 0          # chunks assembled into host buffers
        self._pending: list[tuple[int, bytes]] = []
        self._n_fed = 0
        self._last_fed = time.monotonic()
        self._error: Optional[str] = None
        self._transient = False
        self._lock = threading.Lock()
        dt = wire_dtype(meta["dtype"])
        self._k_full = torch.empty(tuple(meta["shape"]), dtype=dt)
        self._v_full = torch.empty(tuple(meta.get("v_shape", meta["shape"])), dtype=dt)
        self._ks_full = self._vs_full = None
        if "ks_shape" in meta:
            self._ks_full = torch.empty(tuple(meta["ks_shape"]), dtype=torch.float32)
            self._vs_full = torch.empty(tuple(meta["vs_shape"]), dtype=torch.float32)

    @property
    def n_chunks(self) -> int:
        return len(self.plans)

    def feed(self, idx: int, payload: bytes) -> None:
        with self._lock:
            self._pending.append((idx, payload))
            self._n_fed += 1
            self._last_fed = time.monotonic()

    def set_error(self, msg: str, transient: bool = False) -> None:
        """``transient`` marks a failure worth a retry by recompute (a
        network drop the puller reports), as opposed to a permanent one
        (shape, corruption)."""
        with self._lock:
            self._error = msg
            self._transient = transient

    @property
    def transient(self) -> bool:
        with self._lock:
            return self._transient

    @property
    def error(self) -> Optional[str]:
        with self._lock:
            if self._error:
                return self._error
            if (self._n_fed < self.n_chunks
                    and time.monotonic() - self._last_fed > self.deadline_s):
                return (f"KV transfer stalled: no chunk for {self.deadline_s:.0f}s "
                        f"({self._n_fed}/{self.n_chunks} arrived)")
        return None

    def assemble(self, max_n: int = 4) -> int:
        """Deserialize up to ``max_n`` arrived chunks into the host
        buffers; returns how many landed."""
        with self._lock:
            got, self._pending = self._pending[:max_n], self._pending[max_n:]
        for idx, payload in got:
            p = self.plans[idx]
            start, dt, shapes, sizes = _chunk_layout(payload)
            k_shape, v_shape, ks_shape, _ = shapes
            rows = (p.layer_hi - p.layer_lo, p.page_hi - p.page_lo)
            expect = rows + tuple(self._k_full.shape[2:])
            expect_v = rows + tuple(self._v_full.shape[2:])
            if k_shape != expect or v_shape != expect_v:
                raise ValueError(f"chunk {idx} shape mismatch: got K {k_shape} "
                                 f"V {v_shape}, plan wants K {expect} V {expect_v}")
            if dt != self._k_full.dtype:
                raise ValueError(f"chunk {idx} dtype {dt} != meta {self._k_full.dtype}")
            if (ks_shape is not None) != (self._ks_full is not None):
                raise ValueError(f"chunk {idx} quantization mismatch: chunk scales="
                                 f"{'yes' if ks_shape is not None else 'no'}, meta scales="
                                 f"{'yes' if self._ks_full is not None else 'no'}")
            sl = (slice(p.layer_lo, p.layer_hi), slice(p.page_lo, p.page_hi))
            src, off = memoryview(payload), start
            for full, shape, n in zip((self._k_full, self._v_full, self._ks_full,
                                       self._vs_full), shapes, sizes):
                if full is None:
                    continue
                if tuple(full[sl].shape) != shape:
                    raise ValueError(f"chunk {idx} scale shape {shape} != plan "
                                     f"{tuple(full[sl].shape)}")
                if n:
                    # whole layers, or a page range of one: a contiguous
                    # slice of the buffer, written straight from the wire
                    dst = full[sl]
                    assert dst.is_contiguous()
                    _bytes_view(dst)[:] = src[off:off + n]
                off += n
            self.n_scattered += 1
        return len(got)

    @property
    def complete(self) -> bool:
        return self.n_scattered >= self.n_chunks

    def full_arrays(self) -> tuple:
        """``(k, v)`` or ``(k, v, k_scale, v_scale)``: star-unpack into
        :func:`import_arrays`."""
        assert self.complete
        if self._ks_full is not None:
            return self._k_full, self._v_full, self._ks_full, self._vs_full
        return self._k_full, self._v_full


# ---------------------------------------------------------------------------
# transfer-vs-recompute break-even
# ---------------------------------------------------------------------------

class TransferCostModel:
    """Live-calibrated constants of the break-even decision: EWMA
    self-measurements of the link (completed chunked imports), the
    recompute rate (completed prefills) and the disk tier's read rate.
    Until a side has a sample, its static prior stays in effect."""

    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self._lock = threading.Lock()
        self.net_bytes_s: Optional[float] = None
        self.prefill_tok_s: Optional[float] = None
        self.disk_bytes_s: Optional[float] = None
        self.transfer_samples = 0
        self.prefill_samples = 0
        self.disk_samples = 0

    def _ewma(self, cur: Optional[float], x: float) -> float:
        return x if cur is None else (1 - self.alpha) * cur + self.alpha * x

    def note_transfer(self, nbytes: int, seconds: float) -> None:
        if nbytes <= 0 or seconds <= 1e-6:
            return
        with self._lock:
            self.net_bytes_s = self._ewma(self.net_bytes_s, nbytes / seconds)
            self.transfer_samples += 1

    def note_prefill(self, tokens: int, seconds: float) -> None:
        if tokens <= 0 or seconds <= 1e-6:
            return
        with self._lock:
            self.prefill_tok_s = self._ewma(self.prefill_tok_s, tokens / seconds)
            self.prefill_samples += 1

    def note_disk_read(self, nbytes: int, seconds: float) -> None:
        if nbytes <= 0 or seconds <= 1e-6:
            return
        with self._lock:
            self.disk_bytes_s = self._ewma(self.disk_bytes_s, nbytes / seconds)
            self.disk_samples += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {"net_bytes_s": self.net_bytes_s,
                    "prefill_tok_s": self.prefill_tok_s,
                    "disk_bytes_s": self.disk_bytes_s,
                    "transfer_samples": self.transfer_samples,
                    "prefill_samples": self.prefill_samples,
                    "disk_samples": self.disk_samples}


def estimate_params(arch) -> int:
    """Approximate parameter count from the architecture dims (embed +
    per-layer attention and MLP), enough for a FLOPs estimate."""
    H = arch.hidden_size
    attn = H * (arch.num_heads * arch.head_dim) \
        + 2 * H * (arch.num_kv_heads * arch.head_dim) \
        + (arch.num_heads * arch.head_dim) * H
    n_exp = getattr(arch, "num_experts", 0) or 1
    mlp = 3 * H * arch.intermediate_size * n_exp
    return arch.vocab_size * H * 2 + arch.num_layers * (attn + mlp)


# the static priors: ~20 Gb/s of pod-to-pod network, and the NVIDIA H100
# SXM5 data sheet's dense bf16 peak (989.4 TFLOP/s) at a conservative
# prefill utilization
NET_BYTES_S_PRIOR = 2.5e9
CHIP_FLOPS_PRIOR = 989.4e12
PREFILL_MFU_PRIOR = 0.35


def transfer_cost(n_tokens: int, arch, dtype_bytes: int = 2, *,
                  net_bytes_s: float = NET_BYTES_S_PRIOR,
                  chip_flops: float = CHIP_FLOPS_PRIOR,
                  mfu: float = PREFILL_MFU_PRIOR,
                  scale_bytes_per_token: float = 0.0,
                  measured: Optional[TransferCostModel] = None) -> dict:
    """Estimated KV-transfer time against local recompute time.  The
    static defaults are order-of-magnitude priors, used only where
    ``measured`` has no sample for that side.  ``scale_bytes_per_token``
    adds an int8 pool's fp32 page scales (8 * L * Hkv / page_size a
    token) to the wire volume."""
    kv_bytes = (2 * arch.num_layers * n_tokens * arch.num_kv_heads
                * arch.head_dim * dtype_bytes)
    kv_bytes = int(kv_bytes + scale_bytes_per_token * n_tokens)
    m = measured.snapshot() if measured is not None else {}
    net = m.get("net_bytes_s") or net_bytes_s
    transfer_s = kv_bytes / net
    if m.get("prefill_tok_s"):
        recompute_s = n_tokens / m["prefill_tok_s"]
    else:
        recompute_s = 2.0 * estimate_params(arch) * n_tokens / (chip_flops * mfu)
    return {"kv_bytes": kv_bytes, "transfer_s": transfer_s,
            "recompute_s": recompute_s,
            "calibrated": bool(m.get("net_bytes_s") or m.get("prefill_tok_s"))}


def should_transfer(n_tokens: int, arch, dtype_bytes: int = 2, **kw) -> bool:
    c = transfer_cost(n_tokens, arch, dtype_bytes, **kw)
    return c["transfer_s"] < c["recompute_s"]


def should_import_from_disk(nbytes: int, n_tokens: int,
                            measured: Optional[TransferCostModel]) -> bool:
    """Break-even of the disk tier: import unless BOTH the read rate and
    the prefill rate have real samples AND the measured read time exceeds
    the measured recompute time (priors never veto)."""
    if measured is None:
        return True
    m = measured.snapshot()
    if not (m.get("disk_bytes_s") and m.get("prefill_tok_s")):
        return True
    return nbytes / m["disk_bytes_s"] < n_tokens / m["prefill_tok_s"]
