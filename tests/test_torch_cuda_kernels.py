"""The port's CUDA kernels against their plain versions on the card.

These need an NVIDIA Hopper card and ``nvcc``; without one they skip.
On the card (no JAX there, so without the suite's conftest):
``python -m pytest --noconftest tests/test_torch_cuda_kernels.py``.
Tolerances: fp32 atol 1e-4 (another summation order than the plain
versions), bf16 atol 2e-2 (P is rounded to bf16 before the PV product,
relative to a different running max); for K1q, K4 and K5 relative to the
output's largest magnitude, since their outputs are not bounded by 1."""

import pytest
import torch

BIG = 1 << 30
ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return gen


def _rand(gen, *shape, dtype):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,Hkv,G,ps", [(32, 4, 2, 16), (64, 2, 4, 64),
                                        (128, 8, 4, 64), (64, 1, 8, 32),
                                        (128, 4, 1, 16)])
@pytest.mark.parametrize("window,softcap", [(BIG, None), (19, None), (270, None),
                                            (BIG, 30.0)])
def test_decode_kernel(card, dtype, D, Hkv, G, ps, window, softcap):
    from kaito_tpu_torch.engine.ops.decode_attention import (
        paged_decode_attention_cuda, paged_decode_attention_plain)

    B, pmax, P = 6, 40, 250           # up to 1280 tokens: several splits
    q = _rand(card, B, Hkv * G, D, dtype=dtype)
    ck = _rand(card, 3, P, ps, Hkv, D, dtype=dtype)
    cv = _rand(card, 3, P, ps, Hkv, D, dtype=dtype)
    pt = (torch.randperm(P - 1, generator=card, device="cuda")[:B * pmax] + 1
          ).reshape(B, pmax).to(torch.int32)
    # length 0: an inactive engine row, which attends over nothing
    lens = torch.tensor([0, 1, ps, ps + 3, pmax * ps, 300],
                        dtype=torch.int32, device="cuda")
    kw = dict(scale=D ** -0.5, softcap=softcap, layer=2)
    before = paged_decode_attention_cuda.launches
    out = paged_decode_attention_cuda(q, ck, cv, pt, lens, window, **kw)
    ref = paged_decode_attention_plain(q, ck, cv, pt, lens, window, **kw)
    torch.cuda.synchronize()
    assert paged_decode_attention_cuda.launches == before + 1
    assert (out.float() - ref.float()).abs().max().item() <= ATOL[dtype]


def _packed(T, seg_lens, B=2):
    segs = torch.full((B, T), -1, dtype=torch.int32)
    poss = torch.zeros((B, T), dtype=torch.int32)
    off = 0
    for si, n in enumerate(seg_lens):
        segs[:, off:off + n] = si
        poss[:, off:off + n] = torch.arange(n, dtype=torch.int32)
        off += n
    return segs.cuda(), poss.cuda(), off


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,D,Hkv,G", [(64, 32, 2, 2), (200, 64, 1, 4),
                                       (256, 128, 8, 4), (1, 128, 8, 4),
                                       (63, 64, 2, 8), (65, 32, 4, 1),
                                       (512, 128, 8, 4), (1000, 64, 1, 8),
                                       (200, 32, 2, 8), (130, 128, 4, 1)])
@pytest.mark.parametrize("window,softcap", [(BIG, None), (9, None), (BIG, 25.0),
                                            (40, None)])
def test_flash_kernels(card, dtype, T, D, Hkv, G, window, softcap):
    from kaito_tpu_torch.engine.ops.flash_prefill import (
        flash_prefill_attention_cuda, flash_prefill_attention_plain,
        flash_prefill_packed_cuda, flash_prefill_packed_plain)

    q = _rand(card, 2, T, Hkv * G, D, dtype=dtype)
    k = _rand(card, 2, T, Hkv, D, dtype=dtype)
    v = _rand(card, 2, T, Hkv, D, dtype=dtype)
    tl = torch.tensor([T, T // 2 + 3], dtype=torch.int32, device="cuda")
    kw = dict(scale=D ** -0.5, softcap=softcap)
    before = (flash_prefill_attention_cuda.launches,
              flash_prefill_packed_cuda.launches)
    out = flash_prefill_attention_cuda(q, k, v, tl, window, **kw)
    ref = flash_prefill_attention_plain(q, k, v, tl, window, **kw)
    for b in range(2):
        n = min(int(tl[b]), T)
        assert (out[b, :n].float() - ref[b, :n].float()).abs().max().item() \
            <= ATOL[dtype]
    segs, poss, off = _packed(T, (max(T // 3, 1), T // 4, T // 5))
    out = flash_prefill_packed_cuda(q, k, v, segs, poss, window, **kw)
    ref = flash_prefill_packed_plain(q, k, v, segs, poss, window, **kw)
    torch.cuda.synchronize()
    assert (flash_prefill_attention_cuda.launches,
            flash_prefill_packed_cuda.launches) == (before[0] + 1, before[1] + 1)
    assert torch.isfinite(out.float()).all()
    assert (out[:, :off].float() - ref[:, :off].float()).abs().max().item() \
        <= ATOL[dtype]


# many 1-3-token segments, then one spanning three 64-key tiles, then pads
SHORT_SEGMENTS = (1, 2, 3, 1, 1, 3, 2, 2) * 5 + (150,) + (1, 3, 2) * 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,Hkv,G", [(32, 2, 4), (64, 1, 8), (128, 8, 4)])
@pytest.mark.parametrize("window,softcap", [(BIG, None), (2, None), (50, 30.0)])
def test_flash_packed_short_segments(card, dtype, D, Hkv, G, window, softcap):
    """Pad rows stay finite; every valid row matches the plain version."""
    from kaito_tpu_torch.engine.ops.flash_prefill import (
        flash_prefill_packed_cuda, flash_prefill_packed_plain)

    T = 300
    segs, poss, off = _packed(T, SHORT_SEGMENTS)
    q = _rand(card, 2, T, Hkv * G, D, dtype=dtype)
    k = _rand(card, 2, T, Hkv, D, dtype=dtype)
    v = _rand(card, 2, T, Hkv, D, dtype=dtype)
    kw = dict(scale=D ** -0.5, softcap=softcap)
    before = flash_prefill_packed_cuda.launches
    out = flash_prefill_packed_cuda(q, k, v, segs, poss, window, **kw)
    ref = flash_prefill_packed_plain(q, k, v, segs, poss, window, **kw)
    torch.cuda.synchronize()
    assert flash_prefill_packed_cuda.launches == before + 1
    assert torch.isfinite(out.float()).all()
    assert (out[:, :off].float() - ref[:, :off].float()).abs().max().item() \
        <= ATOL[dtype]


def _quantized_pool(gen, L, P, ps, Hkv, D):
    """Random pages as int8 codes with per-(page, head) fp32 scales."""
    x = torch.randn(L, P, ps, Hkv, D, generator=gen, device="cuda")
    scale = x.abs().amax(dim=(2, 4)) / 127.0
    codes = torch.round(x / scale[:, :, None, :, None]).clamp(-127, 127)
    return codes.to(torch.int8), scale.contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,Hkv,G,ps", [(32, 4, 2, 16), (64, 2, 4, 64),
                                        (128, 8, 4, 64)])
@pytest.mark.parametrize("window,softcap", [(BIG, None), (270, None), (BIG, 30.0)])
def test_quantized_decode_kernel(card, dtype, D, Hkv, G, ps, window, softcap):
    """K1q: int8 pages with scales against its plain version."""
    from kaito_tpu_torch.engine.ops.decode_attention import (
        paged_decode_attention_cuda, paged_decode_attention_plain)

    B, pmax, P = 6, 40, 250
    q = _rand(card, B, Hkv * G, D, dtype=dtype)
    ck, ks = _quantized_pool(card, 3, P, ps, Hkv, D)
    cv, vs = _quantized_pool(card, 3, P, ps, Hkv, D)
    pt = (torch.randperm(P - 1, generator=card, device="cuda")[:B * pmax] + 1
          ).reshape(B, pmax).to(torch.int32)
    lens = torch.tensor([0, 1, ps, ps + 3, pmax * ps, 300],
                        dtype=torch.int32, device="cuda")
    kw = dict(scale=D ** -0.5, softcap=softcap, layer=2, k_scale=ks, v_scale=vs)
    before = (paged_decode_attention_cuda.launches,
              paged_decode_attention_cuda.launches_q)
    out = paged_decode_attention_cuda(q, ck, cv, pt, lens, window, **kw)
    ref = paged_decode_attention_plain(q, ck, cv, pt, lens, window, **kw)
    torch.cuda.synchronize()
    assert (paged_decode_attention_cuda.launches,
            paged_decode_attention_cuda.launches_q) == (before[0], before[1] + 1)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= ATOL[dtype] * max(1.0, ref.float().abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scheme", ["int8", "int4"])
@pytest.mark.parametrize("rows,K,N", [(1, 4096, 1024), (3, 256, 50), (8, 512, 264),
                                      (17, 192, 128), (64, 1024, 384),
                                      (200, 384, 256), (256, 100, 16)])
def test_quant_matmul_kernel(card, dtype, scheme, rows, K, N):
    """K4/K5 against their plain version: the CUDA-core path (fp32 x, or
    shapes off the tensor-core tiles: ragged K and N, every row tiling)
    and the tensor-core path (bf16 x, K a multiple of 64, N of 128; one
    or four m16 tiles per CTA, int4 groups of 128 or of the whole K)."""
    from kaito_tpu_torch.engine.ops.quant_matmul import (quant_matmul_cuda,
                                                         quant_matmul_plain)
    from kaito_tpu_torch.engine.quant import quantize_weight

    x = _rand(card, rows, K, dtype=dtype)
    w = quantize_weight(torch.randn(K, N, generator=card, device="cuda"), scheme)
    counter = "launches_" + scheme
    before = getattr(quant_matmul_cuda, counter)
    out = quant_matmul_cuda(x, w)
    ref = quant_matmul_plain(x, w)
    torch.cuda.synchronize()
    assert getattr(quant_matmul_cuda, counter) == before + 1
    assert out.dtype == dtype and out.shape == (rows, N)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= ATOL[dtype] * ref.float().abs().max().item()


def test_wrappers_reject_what_the_kernels_do_not_take(card):
    from kaito_tpu_torch.engine.ops.flash_prefill import flash_prefill_attention_cuda

    q = _rand(card, 1, 16, 4, 48, dtype=torch.float32)     # D=48 unsupported
    tl = torch.tensor([16], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        flash_prefill_attention_cuda(q, q[:, :, :2], q[:, :, :2], tl, BIG, scale=1.0)
    q = _rand(card, 1, 16, 4, 64, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_prefill_attention_cuda(q, q[:, :, :2], q[:, :, :2], tl, BIG, scale=1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scheme", ["int8", "int4"])
@pytest.mark.parametrize("rows,K,N,n", [(1, 2048, 4096, 2), (8, 1024, 1024, 2),
                                        (200, 512, 512, 4), (3, 256, 384, 2),
                                        (200, 2048, 4096, 2)])
def test_prefetch_kernel_is_bitwise_the_plain_kernel(card, dtype, scheme, rows, K,
                                                     N, n):
    """K6 on every column chunk of a plane (the ring's strided views),
    with the next layer's chunk prefetched: bitwise K4/K5's output on the
    same views, and within their tolerance of the plain version."""
    from kaito_tpu_torch.engine.ops.overlap_collectives import _slice_out
    from kaito_tpu_torch.engine.ops.quant_matmul import (
        prefetch_ok, quant_matmul_cuda, quant_matmul_plain)
    from kaito_tpu_torch.engine.quant import quantize_weight

    w = quantize_weight(torch.randn(K, N, generator=card, device="cuda"), scheme)
    w_next = quantize_weight(torch.randn(K, N, generator=card, device="cuda"), scheme)
    x = _rand(card, rows, K, dtype=dtype)
    nc = N // n
    counter = f"launches_{scheme}_pf"
    for c in range(n):
        wc, pc = _slice_out(w, c * nc, nc), _slice_out(w_next, c * nc, nc)
        assert prefetch_ok(wc, pc)
        before = getattr(quant_matmul_cuda, counter)
        out = quant_matmul_cuda(x, wc, pc)
        base = quant_matmul_cuda(x, wc)
        ref = quant_matmul_plain(x, wc)
        torch.cuda.synchronize()
        assert getattr(quant_matmul_cuda, counter) == before + 1
        assert torch.equal(out, base)
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= ATOL[dtype] * ref.float().abs().max().item()


def test_prefetch_kernel_takes_the_ring_path(card):
    """quant_linear with a next-layer slab launches K6, without one K4."""
    from kaito_tpu_torch.engine.ops.quant_matmul import (quant_linear,
                                                         quant_matmul_cuda)
    from kaito_tpu_torch.engine.quant import quantize_weight

    w = quantize_weight(torch.randn(512, 256, generator=card, device="cuda"), "int8")
    x = _rand(card, 2, 512, dtype=torch.bfloat16)
    before = (quant_matmul_cuda.launches_int8, quant_matmul_cuda.launches_int8_pf)
    a = quant_linear(x, w, prefetch=w)
    b = quant_linear(x, w)
    torch.cuda.synchronize()
    assert (quant_matmul_cuda.launches_int8,
            quant_matmul_cuda.launches_int8_pf) == (before[0] + 1, before[1] + 1)
    assert torch.equal(a, b)


def _int4_one_group(gen, K: int, N: int) -> dict:
    """An int4 QTensor whose one scale group spans the whole K (the
    quantizer makes one only where K % 128 != 0): random codes."""
    q4 = torch.randint(-128, 128, (K // 2, N), generator=gen, device="cuda",
                       dtype=torch.int8)
    return {"q4": q4, "scale": torch.rand(1, N, generator=gen, device="cuda") / 64}


# (scheme, int4 group: 128 or 0 for one whole-K group, K, N, columns of a
# strided chunk of the N-column plane or None)
WIDE_CASES = [("int8", None, 1024, 128, None), ("int8", None, 192, 1024, None),
              ("int8", None, 512, 1024, 384), ("int8", None, 4096, 1024, None),
              ("int4", 128, 1024, 128, None), ("int4", 128, 512, 1024, 384),
              ("int4", 128, 4096, 1024, None), ("int4", 0, 192, 1024, None),
              ("int4", 0, 1024, 128, None), ("int4", 0, 512, 1024, 384)]


@pytest.mark.parametrize("scheme,group,K,N,chunk", WIDE_CASES)
@pytest.mark.parametrize("rows", [17, 64, 65, 200, 256])
def test_quant_matmul_wide_path(card, scheme, group, K, N, chunk, rows):
    """K4/K5's wide path (bf16 x, 17-256 rows) against the plain version:
    int4 groups of 128 in-rows or of the whole K, one and two 64-row
    slices per warpgroup, split and unsplit K, and strided column chunks
    of a wider plane (ldw > N); the wide counter grows by one per call."""
    from kaito_tpu_torch.engine.ops.quant_matmul import (quant_matmul_cuda,
                                                         quant_matmul_plain)
    from kaito_tpu_torch.engine.quant import quantize_weight

    if group == 0 and K % 128 == 0:
        w = _int4_one_group(card, K, N)
    else:
        w = quantize_weight(torch.randn(K, N, generator=card, device="cuda"), scheme)
    if chunk is not None:
        w = {k: t[..., :chunk] for k, t in w.items()}
    x = _rand(card, rows, K, dtype=torch.bfloat16)
    counters = ("launches_" + scheme, f"launches_{scheme}_wide")
    before = [getattr(quant_matmul_cuda, c) for c in counters]
    out = quant_matmul_cuda(x, w)
    ref = quant_matmul_plain(x, w)
    torch.cuda.synchronize()
    assert [getattr(quant_matmul_cuda, c) for c in counters] == [b + 1 for b in before]
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= ATOL[torch.bfloat16] * ref.float().abs().max().item()


def test_quant_matmul_plans_mirror_the_kernel(card):
    """wide_plan and workspace_floats (engine/ops/quant_matmul.py) equal
    the C functions they mirror, over the Llama-3.1-8B projections, their
    TP=2 chunks, int4 groups of 128 and of the whole K, rows 1-300."""
    import ctypes

    from kaito_tpu_torch.engine.ops import quant_matmul as qm
    from kaito_tpu_torch.ops import build

    lib = build.load_library("quant_matmul")
    c_plan = lib.kaito_quant_matmul_wide_plan
    c_plan.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    c_plan.restype = ctypes.c_int
    c_work = lib.kaito_quant_matmul_workspace_floats
    c_work.argtypes = [ctypes.c_int] * 6
    c_work.restype = ctypes.c_longlong
    shapes = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
              (2048, 4096), (4096, 7168), (7168, 2048), (4096, 512), (192, 1024)]
    plan = (ctypes.c_int * 4)()
    for K, N in shapes:
        for int4 in (0, 1):
            for groups in ((1, K // 128) if int4 and K % 128 == 0 else (1,)):
                for rows in (1, 8, 16, 17, 63, 64, 65, 128, 129, 200, 256, 257, 300):
                    fits = c_plan(rows, K, N, groups, int4, plan)
                    want = 16 < rows <= 256 and qm.tc_fits(K, N, K // groups)
                    assert bool(fits) == want, (rows, K, N, groups, int4)
                    if fits:
                        assert tuple(plan) == tuple(qm.wide_plan(
                            rows, K, N, groups, bool(int4))), (rows, K, N, groups)
                    for dtype in (0, 1):
                        assert c_work(rows, K, N, groups, int4, dtype) == \
                            qm.workspace_floats(rows, K, N, groups, bool(int4),
                                                dtype == 1), (rows, K, N, groups)
