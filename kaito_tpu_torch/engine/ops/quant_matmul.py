"""Fused dequant matmul for quantized weights: the CUDA kernels and their
plain version.

Counterpart of ``kaito_tpu.engine.ops.quant_matmul``.  One CUDA source
(``kaito_tpu_torch/csrc/quant_matmul.cu``) holds the kernels, with the
scheme and the prefetch as template parameters; they replace the Pallas
TPU kernel ``quant_matmul`` (``_int8_kernel``, K4, ``_int4_kernel``, K5,
and their layer-ahead prefetch variants ``_int8_kernel_pf`` /
``_int4_kernel_pf``, K6): a decode-shaped ``x [rows, K] @ W`` against an
int8 or packed-int4 QTensor (``engine.quant``) whose device-memory
stream is the quantized bytes.  The source's header note says what
bounds it on the H100 and how it is laid out.

:func:`quant_linear` is the ``nn.linear`` entry point.  Routing follows
the JAX package: a call whose leading dims hold at most ``MAX_ROWS``
rows goes to :func:`quant_matmul_cuda`, which launches the kernel for
tensors on the card and runs :func:`quant_matmul_plain` for tensors on
the CPU; a wider (prefill-shaped) call dequantizes and multiplies with
``torch.matmul`` (:func:`dequant_matmul`), as the JAX package leaves
such calls to XLA outside any Pallas kernel.  ``prefetch=`` (the next
layer's slab, threaded by the tensor-parallel decode ring) routes to K6
when :func:`prefetch_ok` holds, else it is dropped.  The weight planes
may be column chunks of wider planes (last dim contiguous, rows any
distance apart): the kernels read them in place.  ``launches_int8``,
``launches_int4``, ``launches_int8_pf`` and ``launches_int4_pf`` on the
wrapper count the launches of K4, K5 and K6.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from kaito_tpu_torch.engine.quant import dequant_weight, unpack_int4
from kaito_tpu_torch.ops import build

# decode batches are skinny (max_num_seqs rows); anything wider is
# prefill-shaped and goes through the plain dot
MAX_ROWS = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# K6 engages for a next-layer slab (codes + scales) of at most this many
# bytes: the live chunk and the prefetched one both have to stay in the
# H100's 50 MB L2, beside the activations, for the prefetch to survive
# to its use (the header note of csrc/quant_matmul.cu).  A larger slab
# is dropped, as the Pallas kernel drops one over its VMEM budget.
PREFETCH_L2_BUDGET = 16 << 20


def quant_matmul_plain(x: torch.Tensor, w: dict) -> torch.Tensor:
    """``x [.., K] @ w`` with the kernel's arithmetic: fp32 products and
    sums; the int8 per-column scale folded after the whole dot, each int4
    group's scale after that group's dot; one cast to x's dtype."""
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K).float()
    if "q8" in w:
        out = (x2 @ w["q8"].float()) * w["scale"]
    else:
        q = unpack_int4(w["q4"]).float()                 # [K, N]
        G, N = w["scale"].shape
        part = torch.einsum("rgk,gkn->rgn", x2.reshape(-1, G, K // G),
                            q.reshape(G, K // G, N))
        out = (part * w["scale"]).sum(dim=1)
    return out.to(x.dtype).reshape(*lead, out.shape[-1])


def dequant_matmul(x: torch.Tensor, w: dict) -> torch.Tensor:
    """The route past the kernel (counterpart of ``dequant_matmul_jax``):
    int8 multiplies the codes in x's dtype and scales after the dot, in
    x's dtype; int4 dequantizes to x's dtype first."""
    if "q8" in w:
        return (x @ w["q8"].to(x.dtype)) * w["scale"].to(x.dtype)
    return x @ dequant_weight(w, x.dtype)


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _planes(w: dict) -> tuple[torch.Tensor, torch.Tensor]:
    return (w["q4"], w["scale"]) if "q4" in w else (w["q8"], w["scale"])


def _slab_bytes(w: dict) -> int:
    return sum(t.numel() * t.element_size() for t in _planes(w))


def _aligned16(t: torch.Tensor) -> bool:
    """16-byte aligned start and rows (a K6 prefetch is whole 16-byte
    pieces)."""
    rows_ok = t.dim() < 2 or (t.stride(0) * t.element_size()) % 16 == 0
    return t.data_ptr() % 16 == 0 and rows_ok


def prefetch_ok(w: dict, w_next: Optional[dict]) -> bool:
    """Whether the next layer's slab can ride ``w``'s call (K6): the same
    kind and plane shapes (one layer body serves every layer, so the
    stacked slabs always match), a slab within ``PREFETCH_L2_BUDGET``,
    and planes the kernel can prefetch (16-byte aligned rows).
    Anything else drops the prefetch; it is never an error."""
    if w_next is None:
        return False
    kind = "q8" if "q8" in w else "q4"
    if kind not in w_next:
        return False
    for a, b in zip(_planes(w), _planes(w_next)):
        if a.shape != b.shape or a.dtype != b.dtype:
            return False
    if _slab_bytes(w_next) > PREFETCH_L2_BUDGET:
        return False
    return all(_aligned16(t) for t in _planes(w_next))


_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


@functools.cache
def _kernel():
    return build.bind("quant_matmul", "kaito_quant_matmul", _ARGS)


@functools.cache
def _kernel_pf():
    return build.bind("quant_matmul", "kaito_quant_matmul_pf",
                      _ARGS[:3] + [ctypes.c_void_p, ctypes.c_void_p] + _ARGS[3:])


@functools.cache
def _workspace_floats(rows: int, K: int, N: int, groups: int, int4: int,
                      dtype: int) -> int:
    fn = build.load_library("quant_matmul").kaito_quant_matmul_workspace_floats
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_longlong
    return int(fn(rows, K, N, groups, int4, dtype))


def _check_weight(w: dict, K: int, device: torch.device) -> tuple:
    """(codes, scale, N, groups) of a QTensor that fits x [.., K]; raises
    on what the kernel does not take.  Planes may be column chunks of
    wider planes: last dim contiguous, rows any distance apart."""
    int4 = "q4" in w
    codes, scale = _planes(w)
    if codes.dtype != torch.int8 or codes.dim() != 2:
        raise ValueError(f"quantized weight codes must be 2-D int8, got "
                         f"{codes.dtype} {tuple(codes.shape)}")
    N = codes.shape[1]
    if codes.shape[0] != (K // 2 if int4 else K) or (int4 and K % 2):
        raise ValueError(f"x [.., {K}] does not match the codes "
                         f"{tuple(codes.shape)} ({'int4' if int4 else 'int8'})")
    groups = scale.shape[0] if int4 else 1
    want = (groups, N) if int4 else (N,)
    if scale.dtype != torch.float32 or tuple(scale.shape) != want \
            or K % groups or (int4 and (K // groups) % 2):
        raise ValueError(f"scale must be float32 {want} over whole groups, got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    for name, t in (("codes", codes), ("scale", scale)):
        if t.device != device or t.stride(-1) != 1 \
                or (t.dim() == 2 and t.stride(0) < t.shape[1]):
            raise ValueError(f"{name} must lie on {device} with a contiguous "
                             f"last dim, got strides {t.stride()}")
    return codes, scale, N, groups


def quant_matmul_cuda(x: torch.Tensor, w: dict,
                      w_next: Optional[dict] = None) -> torch.Tensor:
    """``x [rows, K] @ w -> [rows, N]`` (contract of
    :func:`quant_matmul_plain`).  On the card it launches K4/K5, or K6
    when ``w_next`` (the next layer's slab, which the caller has passed
    through :func:`prefetch_ok`) is given; on the CPU it is the plain
    version, ``w_next`` only checked for its shapes."""
    if w_next is not None and not prefetch_ok(w, w_next):
        raise ValueError("w_next does not fit w's kind, shapes, alignment or "
                         "the L2 budget; gate it with prefetch_ok")
    if x.device.type == "cpu":
        return quant_matmul_plain(x, w)
    int4 = "q4" in w
    if x.dtype not in _DTYPES:
        raise ValueError(f"quant matmul kernel takes float32 or bfloat16 x, "
                         f"got {x.dtype}")
    if x.dim() != 2 or not 1 <= x.shape[0] <= MAX_ROWS:
        raise ValueError(f"quant matmul kernel takes x [rows <= {MAX_ROWS}, K], "
                         f"got {tuple(x.shape)}")
    rows, K = x.shape
    codes, scale, N, groups = _check_weight(w, K, x.device)
    ldw = codes.stride(0)
    lds = scale.stride(0) if int4 else N
    x = x.contiguous()
    out = torch.empty((rows, N), dtype=x.dtype, device=x.device)
    n_work = _workspace_floats(rows, K, N, groups, int(int4), _DTYPES[x.dtype])
    work = torch.empty((max(n_work, 1),), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    tail = (_ptr(out), _ptr(work), rows, K, N, groups, int(int4), _DTYPES[x.dtype],
            ldw, lds, stream)
    if w_next is None:
        build.check(build.launch(x.device, _kernel(), _ptr(x), _ptr(codes),
                                 _ptr(scale), *tail), "kaito_quant_matmul")
        counter = "launches_int4" if int4 else "launches_int8"
    else:
        n_codes, n_scale = _check_weight(w_next, K, x.device)[:2]
        if n_codes.stride() != codes.stride() or n_scale.stride() != scale.stride():
            raise ValueError("w_next must have w's strides")
        build.check(build.launch(x.device, _kernel_pf(), _ptr(x), _ptr(codes),
                                 _ptr(scale), _ptr(n_codes), _ptr(n_scale), *tail),
                    "kaito_quant_matmul_pf")
        counter = "launches_int4_pf" if int4 else "launches_int8_pf"
    setattr(quant_matmul_cuda, counter, getattr(quant_matmul_cuda, counter) + 1)
    return out


# launches of K4 (int8 weights), K5 (int4 weights) and K6 (either, with
# the next layer's slab prefetched)
quant_matmul_cuda.launches_int8 = 0
quant_matmul_cuda.launches_int4 = 0
quant_matmul_cuda.launches_int8_pf = 0
quant_matmul_cuda.launches_int4_pf = 0


def quant_linear(x: torch.Tensor, w: dict,
                 prefetch: Optional[dict] = None) -> torch.Tensor:
    """``x [.., K] @ w`` for a QTensor ``w`` (2-D planes: the model has
    already sliced the layer out of its stack).  Rows are the product of
    the leading dims: up to ``MAX_ROWS`` take the kernel (the plain
    version on the CPU), more take :func:`dequant_matmul`.  ``prefetch``
    (the next layer's slab) engages K6 where :func:`prefetch_ok` holds
    and is dropped everywhere else, never changing the output."""
    lead, K = x.shape[:-1], x.shape[-1]
    rows = math.prod(lead)
    if rows < 1 or rows > MAX_ROWS:
        return dequant_matmul(x, w)
    x2 = x.reshape(rows, K)
    out = (quant_matmul_cuda(x2, w, prefetch) if prefetch_ok(w, prefetch)
           else quant_matmul_cuda(x2, w))
    return out.reshape(*lead, out.shape[-1])
