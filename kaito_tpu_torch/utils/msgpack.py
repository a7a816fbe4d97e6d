"""A pure-Python MessagePack codec for flax's array layout.

The card machine has neither ``msgpack`` nor ``flax``, and a LoRA
adapter artifact (``tuning.lora``) is ``flax.serialization.to_bytes`` of
a flat ``{name: ndarray}`` dict.  This module reads and writes that
layout:

- maps, str, bin, ints, floats, nil, booleans and arrays (lists);
- ext type 1, an ndarray: a packed ``(shape, dtype name, C-order
  bytes)``; ``bfloat16`` by name, read as ``torch.bfloat16`` through a
  16-bit view.  Every other array comes back as a CPU tensor too (a
  numpy array where torch has no such dtype); ext type 3, a numpy
  scalar, comes back as one;
- flax's chunked form (``__msgpack_chunked_array__``) for leaves over
  :data:`MAX_CHUNK_SIZE` bytes, written and read as flax does.

:func:`packb` picks the encodings ``msgpack.packb`` picks (the smallest
int and length forms, str for text, bin for bytes, float64 for floats),
so for the same tree it writes the bytes ``flax.serialization.to_bytes``
writes.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

# flax.serialization.MAX_CHUNK_SIZE: a leaf of more bytes is written as
# a dict of flat chunks of at most this many bytes
MAX_CHUNK_SIZE = 2 ** 30
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY = 1
EXT_NPSCALAR = 3


# ---------------------------------------------------------------------------
# Arrays
# ---------------------------------------------------------------------------

def _as_numpy(x) -> np.ndarray:
    """A tensor or array as a numpy array and its dtype name; bfloat16
    becomes its uint16 bits."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), None
    a = np.asarray(x)
    name = a.dtype.name
    return a, ("bfloat16" if name == "bfloat16" else None)


def _ndarray_bytes(x) -> bytes:
    a, name = _as_numpy(x)
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serializable")
    return packb((list(a.shape), name or a.dtype.name, a.tobytes("C")))


def _ndarray_from(data: bytes):
    shape, name, buf = unpackb(data, raw=True)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype=np.int16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    a = np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)
    try:
        return torch.from_numpy(a.copy())
    except TypeError:
        return a.copy()


def _is_array(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.size * x.dtype.itemsize


def _chunk(x) -> dict:
    """flax's ``_chunk``: the flat array cut into pieces of at most
    MAX_CHUNK_SIZE bytes, shape and pieces as {"0": ..., "1": ...}."""
    item = x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / item))
    flat = x.reshape(-1)
    n = flat.numel() if isinstance(flat, torch.Tensor) else flat.size
    chunks = [flat[i:i + size] for i in range(0, n, size)]
    return {CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    parts = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if all(isinstance(p, torch.Tensor) for p in parts):
        return torch.cat(parts).reshape(shape)
    return np.concatenate([np.asarray(p) for p in parts]).reshape(shape)


def _chunk_leaves(tree):
    """flax's ``_chunk_array_leaves_in_place``, on a copy: dict values
    (and a bare top-level array) over MAX_CHUNK_SIZE bytes chunked."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if _is_array(v):
                out[k] = _chunk(v) if _nbytes(v) > MAX_CHUNK_SIZE else v
            elif isinstance(v, dict):
                out[k] = _chunk_leaves(v)
            else:
                out[k] = v
        return out
    if _is_array(tree) and _nbytes(tree) > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def _unchunk_leaves(tree):
    """flax's ``_unchunk_array_leaves_in_place``."""
    if isinstance(tree, dict):
        if CHUNKED in tree:
            return _unchunk(tree)
        for k, v in tree.items():
            if isinstance(v, dict):
                tree[k] = _unchunk_leaves(v)
    return tree


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------

def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 0x80:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n & 0xFF)
    elif n >= 0:
        for tag, fmt, lim in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                              (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if n < lim:
                out.append(tag)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(f"int {n} does not fit msgpack")
    else:
        for tag, fmt, lim in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                              (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if n >= -lim:
                out.append(tag)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(f"int {n} does not fit msgpack")


def _pack_len(n: int, out: bytearray, fix: int, fix_max: int, tags) -> None:
    """A length header: the fix form below ``fix_max``, else the first
    of ``tags`` ((tag, struct format, limit), ...) that holds ``n``."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for tag, fmt, lim in tags:
        if n < lim:
            out.append(tag)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} does not fit msgpack")


_STR = ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32))
_BIN = ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16), (0xC6, ">I", 1 << 32))
_ARR = ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32))
_MAP = ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
_EXT = ((0xC7, ">B", 1 << 8), (0xC8, ">H", 1 << 16), (0xC9, ">I", 1 << 32))


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    n = len(data)
    if n in _FIXEXT:
        out.append(_FIXEXT[n])
    else:
        _pack_len(n, out, None, 0, _EXT)
    out += struct.pack(">b", code)
    out += data


def _pack(x: Any, out: bytearray) -> None:
    if x is None:
        out.append(0xC0)
    elif x is True:
        out.append(0xC3)
    elif x is False:
        out.append(0xC2)
    elif type(x) is int:
        _pack_int(x, out)
    elif type(x) is float:
        out.append(0xCB)
        out += struct.pack(">d", x)
    elif type(x) is str:
        b = x.encode("utf-8")
        _pack_len(len(b), out, 0xA0, 32, _STR)
        out += b
    elif type(x) in (bytes, bytearray, memoryview):
        b = bytes(x)
        _pack_len(len(b), out, None, 0, _BIN)
        out += b
    elif type(x) in (list, tuple):
        _pack_len(len(x), out, 0x90, 16, _ARR)
        for v in x:
            _pack(v, out)
    elif type(x) is dict:
        _pack_len(len(x), out, 0x80, 16, _MAP)
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    elif _is_array(x):
        _pack_ext(EXT_NDARRAY, _ndarray_bytes(x), out)
    elif isinstance(x, np.generic):
        _pack_ext(EXT_NPSCALAR, _ndarray_bytes(np.asarray(x)), out)
    else:
        raise TypeError(f"cannot serialize {type(x).__name__}")


def packb(x: Any) -> bytes:
    """MessagePack bytes of ``x`` (no chunking)."""
    out = bytearray()
    _pack(x, out)
    return bytes(out)


def to_bytes(tree: dict) -> bytes:
    """``flax.serialization.to_bytes`` of a dict tree whose leaves are
    tensors, numpy arrays or plain values: flax's state dict (keys as
    str, lists and tuples as {"0": ..., "1": ...}), large leaves
    chunked."""
    return packb(_chunk_leaves(_state_dict(tree)))


def _state_dict(tree):
    if isinstance(tree, dict):
        return {str(k): _state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    return tree


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        p = self.pos
        if p + n > len(self.data):
            raise ValueError("truncated msgpack data")
        self.pos = p + n
        return self.data[p:p + n]

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def text(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _ndarray_from(data)
        if code == EXT_NPSCALAR:
            a = _ndarray_from(data)
            return a.item() if isinstance(a, torch.Tensor) else a[()]
        raise ValueError(f"unknown msgpack ext type {code}")

    def read(self):
        t = self.unpack(">B")
        if t < 0x80:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.read() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self.text(t & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if t in fixed:
            return self.unpack(fixed[t])
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H",
                0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I",
                0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if t in lens:
            n = self.unpack(lens[t])
            if t in (0xC4, 0xC5, 0xC6):
                return bytes(self.take(n))
            if t in (0xD9, 0xDA, 0xDB):
                return self.text(n)
            if t in (0xDC, 0xDD):
                return [self.read() for _ in range(n)]
            if t in (0xDE, 0xDF):
                return self.map(n)
            return self.ext(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if t in fixext:
            return self.ext(fixext[t])
        raise ValueError(f"unknown msgpack type byte 0x{t:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def unpackb(data: bytes, raw: bool = False):
    """The value packed in ``data`` (str as bytes when ``raw``)."""
    r = _Reader(data, raw)
    x = r.read()
    if r.pos != len(r.data):
        raise ValueError("extra bytes after the msgpack value")
    return x


def restore(data: bytes):
    """``flax.serialization.msgpack_restore``: the tree with its arrays
    as CPU tensors and chunked leaves joined."""
    return _unchunk_leaves(unpackb(data))
