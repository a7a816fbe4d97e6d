"""Fused dequant matmul for quantized weights: the CUDA kernels and their
plain version.

Counterpart of ``kaito_tpu.engine.ops.quant_matmul``.  One CUDA source
(``kaito_tpu_torch/csrc/quant_matmul.cu``) holds both kernels, with the
scheme as a template parameter; they replace the Pallas TPU kernel
``quant_matmul`` (``_int8_kernel``, K4, and ``_int4_kernel``, K5): a
decode-shaped ``x [rows, K] @ W`` against an int8 or packed-int4 QTensor
(``engine.quant``) whose device-memory stream is the quantized bytes.
The source's header note says what bounds it on the H100 and how it is
laid out.

:func:`quant_linear` is the ``nn.linear`` entry point.  Routing follows
the JAX package: a call whose leading dims hold at most ``MAX_ROWS``
rows goes to :func:`quant_matmul_cuda`, which launches the kernel for
tensors on the card and runs :func:`quant_matmul_plain` for tensors on
the CPU; a wider (prefill-shaped) call dequantizes and multiplies with
``torch.matmul`` (:func:`dequant_matmul`), as the JAX package leaves
such calls to XLA outside any Pallas kernel.  ``launches_int8`` and
``launches_int4`` on the wrapper count the launches of K4 and K5.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from kaito_tpu_torch.engine.quant import dequant_weight, unpack_int4
from kaito_tpu_torch.ops import build

# decode batches are skinny (max_num_seqs rows); anything wider is
# prefill-shaped and goes through the plain dot
MAX_ROWS = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


@functools.cache
def _kernel():
    return build.bind("quant_matmul", "kaito_quant_matmul", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


@functools.cache
def _workspace_floats(rows: int, K: int, N: int, groups: int, int4: int,
                      dtype: int) -> int:
    fn = build.load_library("quant_matmul").kaito_quant_matmul_workspace_floats
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_longlong
    return int(fn(rows, K, N, groups, int4, dtype))


def quant_matmul_cuda(x: torch.Tensor, w: dict) -> torch.Tensor:
    """``x [rows, K] @ w -> [rows, N]`` (contract of
    :func:`quant_matmul_plain`).  On the card it launches the CUDA
    kernel; on the CPU it is the plain version."""
    if x.device.type == "cpu":
        return quant_matmul_plain(x, w)
    int4 = "q4" in w
    codes, scale = (w["q4"], w["scale"]) if int4 else (w["q8"], w["scale"])
    if x.dtype not in _DTYPES:
        raise ValueError(f"quant matmul kernel takes float32 or bfloat16 x, "
                         f"got {x.dtype}")
    if x.dim() != 2 or not 1 <= x.shape[0] <= MAX_ROWS:
        raise ValueError(f"quant matmul kernel takes x [rows <= {MAX_ROWS}, K], "
                         f"got {tuple(x.shape)}")
    rows, K = x.shape
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
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name} must be contiguous on {x.device}")
    x = x.contiguous()
    out = torch.empty((rows, N), dtype=x.dtype, device=x.device)
    n_work = _workspace_floats(rows, K, N, groups, int(int4), _DTYPES[x.dtype])
    work = torch.empty((max(n_work, 1),), dtype=torch.float32, device=x.device)
    rc = _kernel()(
        _ptr(x), _ptr(codes), _ptr(scale), _ptr(out), _ptr(work), rows, K, N,
        groups, int(int4), _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "kaito_quant_matmul")
    if int4:
        quant_matmul_cuda.launches_int4 += 1
    else:
        quant_matmul_cuda.launches_int8 += 1
    return out


# launches of K4 (int8 weights) and of K5 (int4 weights)
quant_matmul_cuda.launches_int8 = 0
quant_matmul_cuda.launches_int4 = 0


def quant_linear(x: torch.Tensor, w: dict) -> torch.Tensor:
    """``x [.., K] @ w`` for a QTensor ``w`` (2-D planes: the model has
    already sliced the layer out of its stack).  Rows are the product of
    the leading dims: up to ``MAX_ROWS`` take the kernel (the plain
    version on the CPU), more take :func:`dequant_matmul`."""
    lead, K = x.shape[:-1], x.shape[-1]
    rows = math.prod(lead)
    if rows < 1 or rows > MAX_ROWS:
        return dequant_matmul(x, w)
    out = quant_matmul_cuda(x.reshape(rows, K), w)
    return out.reshape(*lead, out.shape[-1])
