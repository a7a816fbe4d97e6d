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
tensors on the card (bf16 calls of 17 rows or more on its wide,
prefill-row path) and runs :func:`quant_matmul_plain` for tensors on
the CPU; a wider call (over ``MAX_ROWS`` rows) dequantizes and
multiplies with ``torch.matmul`` (:func:`dequant_matmul`), as the JAX
package leaves such calls to XLA outside any Pallas kernel.  ``prefetch=`` (the next
layer's slab, threaded by the tensor-parallel decode ring) routes to K6
when :func:`prefetch_ok` holds, else it is dropped.  The weight planes
may be column chunks of wider planes (last dim contiguous, rows any
distance apart): the kernels read them in place.  ``launches_int8``,
``launches_int4``, ``launches_int8_pf`` and ``launches_int4_pf`` on the
wrapper count the launches of K4, K5 and K6 (one launch a call on
every path up to 16 bf16 rows); ``launches_int8_wide`` and
``launches_int4_wide`` count the K4/K5 launches that take the wide
(prefill-row) path, whose launch plan :func:`wide_plan` mirrors.

Calls of at most 16 bf16 rows (decode steps and the ring's chunks) take
the decode-row path, whose plan :func:`decode_plan` mirrors: a grid
fixed by N, K and the card's SM count, the last warp of each split
column block merging the slices.  Its partials and merge counters live
in one workspace per card (:func:`decode_workspace`), sized once at
:func:`decode_workspace_bounds` and never replaced, so a CUDA graph that
captures a call keeps valid pointers after larger calls; the counters
are zeroed once and every call leaves them at zero.  Run one call on a
card before capturing any (the workspace is allocated then; a first call
under capture raises), and do not run calls on one card concurrently on
two streams.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

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


# The launch plans of csrc/quant_matmul.cu, mirrored (the card tests hold
# each against the C functions of the same names).
SMS = 132                  # the H100's SMs
STAGE = 64                 # in-rows per pipeline stage of the tensor-core paths
DECODE_ROWS = 16           # bf16 calls up to this many rows take the decode-row path
DECODE_TN = 128            # columns per CTA of the decode-row path
DECODE_CROWS = 64          # code rows of one of its stages (int8 rows, packed int4 rows)
DECODE_CTAS_PER_SM = 3     # its grid: one wave of up to this many CTAs an SM
DECODE_MIN_STAGES = 4      # stages of its K slices in a wave of several CTAs an SM
_QM = dict(lanes=8, tn=256, target=264, x_max=1024)   # the CUDA-core path
WIDE_TN = 128              # columns per CTA of the wide path
WIDE_SCALE_GROUPS = 64     # int4 scale rows a wide CTA stages in shared memory


class WidePlan(NamedTuple):
    """The wide path's launch: ``nt`` rows of x per CTA (the wgmma N),
    ``row_blocks`` CTAs per 128-column tile, K cut into ``n_split``
    slices of ``kc`` in-rows; a grid of ``(N // 128 * row_blocks,
    n_split)`` CTAs, the row blocks of a column tile side by side."""
    nt: int
    row_blocks: int
    n_split: int
    kc: int


def tc_fits(K: int, N: int, gk: int) -> bool:
    """bf16 x on whole stages and 128-column tiles, int4 groups of whole
    stages: both tensor-core paths (``tc_fits``)."""
    return K % STAGE == 0 and N % WIDE_TN == 0 and gk % STAGE == 0


def decode_stage(int4: bool) -> int:
    """In-rows of one decode-row stage (``dq_stage``): 64 code rows, two
    in-rows each for int4."""
    return 2 * DECODE_CROWS if int4 else DECODE_CROWS


def decode_fits(K: int, N: int, gk: int, int4: bool) -> bool:
    """The decode-row path's shapes (``decode_fits``): whole stages, whole
    128-column tiles, int4 groups of whole stages."""
    ks = decode_stage(int4)
    return K % ks == 0 and N % DECODE_TN == 0 and gk % ks == 0


def wide_plan(rows: int, K: int, N: int, groups: int, int4: bool) -> WidePlan:
    """``wide_plan``: all rows in one CTA per 128-column tile (int4, whose
    group fold keeps a second accumulator, at most 128 rows a CTA); K is
    split, on stages (int4: whole groups, at most ``WIDE_SCALE_GROUPS`` a
    slice), only as far as one wave of CTAs still fits on the SMs (two
    CTAs an SM for int8 up to 128 rows and int4 up to 64, else one)."""
    gk = K // groups
    nt = 64 if rows <= 64 else 128 if rows <= 128 or int4 else 256
    row_blocks = -(-rows // nt)
    unit = gk if int4 else STAGE
    n_units = K // unit
    tiles = N // WIDE_TN * row_blocks
    slots = SMS * (2 if nt <= (64 if int4 else 128) else 1)
    split = 1 if tiles >= SMS else max(1, min(n_units, slots // tiles))
    if int4:
        split = max(split, -(-n_units // WIDE_SCALE_GROUPS))
    kc = -(-n_units // split) * unit
    return WidePlan(nt, row_blocks, -(-K // kc), kc)


class DecodePlan(NamedTuple):
    """The decode-row path's launch: ``nt`` n8 tiles of rows (1 up to 8
    rows, else 2) and K cut into ``n_split`` slices of ``kc`` in-rows; a
    grid of ``(N // 128, n_split)`` CTAs."""
    nt: int
    n_split: int
    kc: int


def decode_plan(rows: int, K: int, N: int, groups: int, int4: bool,
                sms: int) -> DecodePlan:
    """``decode_plan``: one CTA per 128-column tile and K slice; K split
    (on stages of 64 code rows; int4 on whole groups) into the larger of
    two: one CTA an SM with slices of at least 2 stages, and one wave of
    ``DECODE_CTAS_PER_SM`` CTAs an SM (one fewer for 9-16 rows) with
    slices of at least ``DECODE_MIN_STAGES`` stages; unsplit where the
    tiles fill that wave.  A function of N, K, the SM count and whether
    the rows take one n8 tile or two."""
    nt = 1 if rows <= 8 else 2
    gk = K // groups
    ks = decode_stage(int4)
    unit = gk if int4 else ks
    n_units = K // unit
    tiles = N // DECODE_TN
    sms = max(sms, 1)
    slots = (DECODE_CTAS_PER_SM if nt == 1 else DECODE_CTAS_PER_SM - 1) * sms
    per_sm = min(sms // tiles, K // (ks * 2))
    wave = 1 if tiles >= slots else min(slots // tiles, K // (ks * DECODE_MIN_STAGES))
    split = max(1, min(max(per_sm, wave), n_units))
    kc = -(-n_units // split) * unit
    return DecodePlan(nt, -(-K // kc), kc)


def decode_workspace_bounds(sms: int) -> tuple[int, int]:
    """(fp32 partials, int32 merge counters) that hold every split
    decode-row call on a card of ``sms`` SMs: a split plan has at most
    one wave of CTAs, each 128 columns of at most 16 rows, one counter
    per 32 columns."""
    slots = DECODE_CTAS_PER_SM * max(sms, 1)
    return slots * DECODE_TN * DECODE_ROWS, slots * DECODE_TN // 32


def _qm_split(rows: int, K: int, N: int, int4: bool) -> int:
    rt = 1 if rows <= 1 else 4 if rows <= 4 else 8
    ks = K // 2 if int4 else K
    tiles = -(-rows // rt) * -(-N // _QM["tn"])
    split = min(-(-_QM["target"] // tiles), max(1, ks // _QM["lanes"]))
    split = max(split, -(-(ks * (2 if int4 else 1)) // _QM["x_max"]))
    kc = -(-ks // split)
    kc = -(-kc // _QM["lanes"]) * _QM["lanes"]
    return -(-ks // kc)


def workspace_floats(rows: int, K: int, N: int, groups: int, int4: bool,
                     bf16: bool) -> int:
    """``kaito_quant_matmul_workspace_floats``: the fp32 partial outputs
    of the largest split a path off the decode-row one may take for this
    call (the decode-row path uses the card's workspace)."""
    n_split = _qm_split(rows, K, N, int4)
    if bf16 and groups >= 1 and tc_fits(K, N, K // groups) \
            and DECODE_ROWS < rows <= MAX_ROWS:
        n_split = max(n_split, wide_plan(rows, K, N, groups, int4).n_split)
    return n_split * rows * N if n_split > 1 else 0


def _tensor_core_path(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                      groups: int) -> bool:
    """bf16 x on the tensor-core shapes with 16-byte aligned x and code
    rows and 8-byte aligned scale rows (``pick_path``)."""
    K, N = x.shape[1], codes.shape[1]
    lds = scale.stride(0) if scale.dim() == 2 else N
    return (x.dtype == torch.bfloat16 and tc_fits(K, N, K // groups)
            and x.data_ptr() % 16 == 0 and codes.data_ptr() % 16 == 0
            and codes.stride(0) % 16 == 0 and scale.data_ptr() % 8 == 0
            and lds % 2 == 0)


def takes_wide(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
               groups: int) -> bool:
    """Whether the kernel runs this call on the wide path (``pick_path``):
    17..MAX_ROWS rows on the tensor-core path."""
    return DECODE_ROWS < x.shape[0] <= MAX_ROWS and \
        _tensor_core_path(x, codes, scale, groups)


def takes_decode(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                 groups: int, int4: bool) -> bool:
    """Whether the kernel runs this call on the decode-row path
    (``pick_path``): 1..DECODE_ROWS rows on the tensor-core path, in
    whole decode-row stages."""
    K, N = x.shape[1], codes.shape[1]
    return 1 <= x.shape[0] <= DECODE_ROWS and decode_fits(K, N, K // groups, int4) \
        and _tensor_core_path(x, codes, scale, groups)


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


# x, w, scale, out, work, work_floats, counters, rows, K, N, groups, int4,
# dtype, ldw, lds, sms, stream
_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p] + [ctypes.c_int] * 9 \
    + [ctypes.c_void_p]


@functools.cache
def _kernel():
    return build.bind("quant_matmul", "kaito_quant_matmul", _ARGS)


@functools.cache
def _kernel_pf():
    return build.bind("quant_matmul", "kaito_quant_matmul_pf",
                      _ARGS[:3] + [ctypes.c_void_p, ctypes.c_void_p] + _ARGS[3:])


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


class _DecodeWorkspace:
    """One card's decode-row partials and merge counters, allocated at
    :func:`decode_workspace_bounds` and kept for the process.  The
    counters are zeroed once; every call leaves them at zero."""

    def __init__(self, device: torch.device, sms: int):
        floats, counters = decode_workspace_bounds(sms)
        # fresh segments: kept for the process, these carved out of a
        # freed larger block would pin its whole segment
        torch.cuda.empty_cache()
        self.part = torch.empty(floats, dtype=torch.float32, device=device)
        self.counters = torch.zeros(counters, dtype=torch.int32, device=device)


_DECODE_WORKSPACES: dict[int, _DecodeWorkspace] = {}


def decode_workspace(device: torch.device) -> _DecodeWorkspace:
    """The decode-row path's workspace on ``device`` (a card), allocated
    at its first use.  A first use inside CUDA graph capture raises: the
    buffers would come from the graph's private pool, which outlives
    neither the graph nor the process's later calls."""
    ws = _DECODE_WORKSPACES.get(device.index)
    if ws is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"the quant matmul's decode-row workspace on {device} "
                               f"is allocated by the first call, which must run "
                               f"outside CUDA graph capture")
        ws = _DECODE_WORKSPACES[device.index] = _DecodeWorkspace(device,
                                                                 _sms(device.index))
    return ws


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
    if takes_decode(x, codes, scale, groups, int4):
        ws = decode_workspace(x.device)
        work, counters = ws.part, _ptr(ws.counters)
    else:
        n_work = _workspace_floats(rows, K, N, groups, int(int4), _DTYPES[x.dtype])
        work = torch.empty((max(n_work, 1),), dtype=torch.float32, device=x.device)
        counters = None
    stream = torch.cuda.current_stream(x.device).cuda_stream
    tail = (_ptr(out), _ptr(work), work.numel(), counters, rows, K, N, groups,
            int(int4), _DTYPES[x.dtype], ldw, lds, _sms(x.device.index), stream)
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
    if w_next is None and takes_wide(x, codes, scale, groups):
        counter += "_wide"
        setattr(quant_matmul_cuda, counter, getattr(quant_matmul_cuda, counter) + 1)
    return out


# launches of K4 (int8 weights), K5 (int4 weights) and K6 (either, with
# the next layer's slab prefetched)
quant_matmul_cuda.launches_int8 = 0
quant_matmul_cuda.launches_int4 = 0
quant_matmul_cuda.launches_int8_pf = 0
quant_matmul_cuda.launches_int4_pf = 0
# of those K4/K5 launches, the ones on the wide (prefill-row) path
quant_matmul_cuda.launches_int8_wide = 0
quant_matmul_cuda.launches_int4_wide = 0


class QuantMatmulFn(torch.autograd.Function):
    """:func:`quant_matmul_cuda` under autograd: the forward launches
    K4/K5 (K6 with ``w_next``) on the card and runs the plain version on
    the CPU; the backward returns ``dx = g @ dequant(w)ᵀ`` in g's dtype.
    The codes and scales are frozen and get no gradient.  The kernel
    fills a fresh tensor that autograd cannot follow, so every call
    whose ``x`` needs a gradient (a QLoRA step whose rows fit the kernel)
    goes through here."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: dict, w_next: Optional[dict]):
        ctx.w = w
        return quant_matmul_cuda(x, w, w_next)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g @ dequant_weight(ctx.w, g.dtype).t(), None, None


def quant_linear(x: torch.Tensor, w: dict,
                 prefetch: Optional[dict] = None) -> torch.Tensor:
    """``x [.., K] @ w`` for a QTensor ``w`` (2-D planes: the model has
    already sliced the layer out of its stack).  Rows are the product of
    the leading dims: up to ``MAX_ROWS`` take the kernel (the plain
    version on the CPU), more take :func:`dequant_matmul`.  ``prefetch``
    (the next layer's slab) engages K6 where :func:`prefetch_ok` holds
    and is dropped everywhere else, never changing the output.  A kernel
    call whose ``x`` needs a gradient goes through
    :class:`QuantMatmulFn`; serving and graph capture call the kernel
    directly."""
    lead, K = x.shape[:-1], x.shape[-1]
    rows = math.prod(lead)
    if rows < 1 or rows > MAX_ROWS:
        return dequant_matmul(x, w)
    x2 = x.reshape(rows, K)
    if x.requires_grad and torch.is_grad_enabled():
        out = QuantMatmulFn.apply(x2, w, prefetch if prefetch_ok(w, prefetch) else None)
    else:
        out = (quant_matmul_cuda(x2, w, prefetch) if prefetch_ok(w, prefetch)
               else quant_matmul_cuda(x2, w))
    return out.reshape(*lead, out.shape[-1])
