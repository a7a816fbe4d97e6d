"""The port's CUDA kernels against their plain versions on the card.

These need an NVIDIA Hopper card and ``nvcc``; without one they skip.
On the card (no JAX there, so without the suite's conftest):
``python -m pytest --noconftest tests/test_torch_cuda_kernels.py``.
Head dims 80, 96 and 256 (phi-2, phi-3, gemma-3) run beside 32, 64 and
128.  Tolerances: fp32 atol 1e-4 (another summation order than the plain
versions), bf16 atol 2e-2 (P is rounded to bf16 before the PV product,
relative to a different running max); for K4 and K5 relative to the
output's largest magnitude, since their outputs are not bounded by 1.
K1 and K1q are also held relative to each sequence's largest magnitude
(K1q only so): a sequence of thousands of tokens comes out far smaller
than one of a few, and a batch-wide scale would hide a wrong long one."""

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
                                        (128, 4, 1, 16), (80, 4, 1, 64),
                                        (96, 4, 1, 16), (96, 2, 4, 64),
                                        (256, 2, 2, 64), (256, 1, 8, 16)])
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
    assert _decode_err(out, ref, False) <= ATOL[dtype]


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
                                       (200, 32, 2, 8), (130, 128, 4, 1),
                                       (200, 80, 4, 1), (513, 96, 4, 1),
                                       (65, 96, 2, 4), (300, 256, 2, 2),
                                       (1, 256, 4, 1)])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1024, 4096])
def test_flash_kernel_at_scoring_lengths(card, dtype, T):
    """K2 as prompt scoring launches it: one fresh [1, T] row, T a
    multiple of 128 past the prefill buckets, the prompt T - 37 long."""
    from kaito_tpu_torch.engine.ops.flash_prefill import (
        flash_prefill_attention_cuda, flash_prefill_attention_plain)

    q = _rand(card, 1, T, 32, 128, dtype=dtype)
    k = _rand(card, 1, T, 8, 128, dtype=dtype)
    v = _rand(card, 1, T, 8, 128, dtype=dtype)
    tl = torch.tensor([T - 37], dtype=torch.int32, device="cuda")
    out = flash_prefill_attention_cuda(q, k, v, tl, BIG, scale=128 ** -0.5)
    ref = flash_prefill_attention_plain(q, k, v, tl, BIG, scale=128 ** -0.5)
    torch.cuda.synchronize()
    assert (out[:, :T - 37].float() - ref[:, :T - 37].float()).abs().max().item() \
        <= ATOL[dtype]


# many 1-3-token segments, then one spanning three 64-key tiles, then pads
SHORT_SEGMENTS = (1, 2, 3, 1, 1, 3, 2, 2) * 5 + (150,) + (1, 3, 2) * 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,Hkv,G", [(32, 2, 4), (64, 1, 8), (128, 8, 4), (80, 4, 1),
                                     (96, 4, 1), (256, 2, 2)])
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
                                        (128, 8, 4, 64), (80, 4, 1, 64),
                                        (96, 4, 1, 16), (96, 2, 4, 64),
                                        (256, 2, 2, 64), (256, 1, 8, 16)])
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
    assert _decode_err(out, ref, True) <= ATOL[dtype]


def _decode_inputs(gen, dtype, quant, lengths, pmax, D=128, Hkv=8, G=4, ps=64, P=None):
    """q and a two-layer pool (int8 codes + scales when ``quant``) with a
    page table of width ``pmax`` over scattered pages."""
    B = len(lengths)
    P = P or B * pmax + 9
    q = _rand(gen, B, Hkv * G, D, dtype=dtype)
    if quant:
        ck, ks = _quantized_pool(gen, 2, P, ps, Hkv, D)
        cv, vs = _quantized_pool(gen, 2, P, ps, Hkv, D)
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        ck = _rand(gen, 2, P, ps, Hkv, D, dtype=dtype)
        cv = _rand(gen, 2, P, ps, Hkv, D, dtype=dtype)
        scales = {}
    pt = (torch.randperm(P - 1, generator=gen, device="cuda")[:B * pmax] + 1
          ).reshape(B, pmax).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return (q, ck, cv, pt, lens), dict(scale=D ** -0.5, layer=1, **scales)


def _decode_err(out, ref, quant):
    """K1q: the worst error of a sequence relative to that sequence's
    largest magnitude; K1: the larger of that and the absolute error."""
    diff = (out.float() - ref.float()).abs().flatten(1).amax(dim=1)
    rel = (diff / ref.float().abs().flatten(1).amax(dim=1).clamp_min(1e-30)).max().item()
    return rel if quant else max(rel, diff.max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True], ids=["K1", "K1q"])
def test_decode_table_width_does_not_change_the_output(card, dtype, quant):
    """The same lengths and pages through a table of the live width and one
    of 128 columns (the extra columns point anywhere): the grid does not
    see the width, so the outputs are equal bit for bit."""
    from kaito_tpu_torch.engine.ops.decode_attention import (
        paged_decode_attention_cuda, paged_decode_attention_plain)

    lengths = [2048, 1, 37, 511, 1000, 1536, 64, 1999]
    (q, ck, cv, pt, lens), kw = _decode_inputs(card, dtype, quant, lengths, 128)
    narrow = pt[:, :32].contiguous()
    out_wide = paged_decode_attention_cuda(q, ck, cv, pt, lens, BIG, **kw)
    out_narrow = paged_decode_attention_cuda(q, ck, cv, narrow, lens, BIG, **kw)
    ref = paged_decode_attention_plain(q, ck, cv, narrow, lens, BIG, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out_wide, out_narrow)
    assert _decode_err(out_wide, ref, quant) <= ATOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True], ids=["K1", "K1q"])
@pytest.mark.parametrize("window", [BIG, 100])
def test_decode_single_live_sequence_among_idle_rows(card, dtype, quant, window):
    """One 230-token sequence beside seven rows of length 0: the idle rows
    come out zero, the live one matches the plain version, and the merge
    counters read zero after the call."""
    from kaito_tpu_torch.engine.ops import decode_attention as dec

    lengths = [0, 0, 0, 230, 0, 0, 0, 0]
    (q, ck, cv, pt, lens), kw = _decode_inputs(card, dtype, quant, lengths, 128)
    out = dec.paged_decode_attention_cuda(q, ck, cv, pt, lens, window, **kw)
    ref = dec.paged_decode_attention_plain(q, ck, cv, pt, lens, window, **kw)
    torch.cuda.synchronize()
    assert not out[[0, 1, 2, 4, 5, 6, 7]].float().any()
    assert _decode_err(out, ref, quant) <= ATOL[dtype]
    assert not dec.workspace(q.device).counters.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True], ids=["K1", "K1q"])
@pytest.mark.parametrize("D,Hkv,G,ps", [(128, 8, 4, 64), (64, 2, 8, 16), (96, 32, 1, 64),
                                        (256, 4, 2, 64),
                                        (32, 1, 16, 32), (128, 4, 1, 16)])
def test_decode_merge_counters_read_zero_after_a_call(card, dtype, quant, D, Hkv, G, ps):
    """Several splits per sequence (the last split merges) at every head
    dim, G = 1, 8 and 16 (two head blocks): the counters are back at zero
    after each call, and two calls give equal outputs (the merge runs in
    split order, whichever CTA finishes last)."""
    from kaito_tpu_torch.engine.ops import decode_attention as dec

    lengths = [900, 3, 0, 640, 129]
    (q, ck, cv, pt, lens), kw = _decode_inputs(card, dtype, quant, lengths, 60, D=D,
                                               Hkv=Hkv, G=G, ps=ps)
    plan = dec.decode_plan(len(lengths), Hkv * G, Hkv, D,
                           torch.cuda.get_device_properties(0).multi_processor_count)
    assert plan.n_split > 1
    first = dec.paged_decode_attention_cuda(q, ck, cv, pt, lens, BIG, **kw)
    torch.cuda.synchronize()
    assert not dec.workspace(q.device).counters.any()
    second = dec.paged_decode_attention_cuda(q, ck, cv, pt, lens, BIG, **kw)
    ref = dec.paged_decode_attention_plain(q, ck, cv, pt, lens, BIG, **kw)
    torch.cuda.synchronize()
    assert not dec.workspace(q.device).counters.any()
    assert torch.equal(first, second)
    assert _decode_err(first, ref, quant) <= ATOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True], ids=["K1", "K1q"])
def test_decode_kernel_replays_in_a_cuda_graph(card, dtype, quant):
    """One call captured in a CUDA graph, replayed after new lengths and
    page-table contents are copied into its static inputs: each replay
    matches the plain version on the new inputs."""
    from kaito_tpu_torch.engine.ops.decode_attention import (
        paged_decode_attention_cuda, paged_decode_attention_plain)

    (q, ck, cv, pt, lens), kw = _decode_inputs(
        card, dtype, quant, [700, 1, 0, 1999, 64, 300, 1024, 5], 40)
    run = lambda: paged_decode_attention_cuda(q, ck, cv, pt, lens, 1500, **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()                      # warm up: build, scratch, counters
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    P = ck.shape[1]
    for new_lengths in ([2500, 2, 17, 0, 640, 64, 1, 2555], [0] * 7 + [33],
                        [1280] * 8):
        lens.copy_(torch.tensor(new_lengths, dtype=torch.int32))
        pt.copy_((torch.randperm(P - 1, generator=card, device="cuda")[:pt.numel()] + 1
                  ).reshape(pt.shape).to(torch.int32))
        graph.replay()
        ref = paged_decode_attention_plain(q, ck, cv, pt, lens, 1500, **kw)
        torch.cuda.synchronize()
        assert _decode_err(out, ref, quant) <= ATOL[dtype], new_lengths


@pytest.mark.parametrize("quant", [False, True], ids=["K1", "K1q"])
def test_decode_graph_replays_after_a_larger_call(card, quant):
    """A call captured at a small batch, then an eager call at a batch
    whose plan needs more scratch and counters, then the replay: the
    workspace was not replaced under the graph, and both match the plain
    version."""
    from kaito_tpu_torch.engine.ops import decode_attention as dec

    small = [700, 1, 0, 1999]
    (q, ck, cv, pt, lens), kw = _decode_inputs(card, torch.bfloat16, quant, small, 40)
    run = lambda: dec.paged_decode_attention_cuda(q, ck, cv, pt, lens, BIG, **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    ws = dec.workspace(q.device)
    ptrs = (ws.part.data_ptr(), ws.counters.data_ptr())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    big = [300 + 37 * i for i in range(24)]
    plans = [dec.decode_plan(len(n), 32, 8, 128, sms) for n in (small, big)]
    assert plans[0].n_split > 1 and plans[1].n_split > 1
    assert plans[1].scratch_floats > plans[0].scratch_floats
    assert plans[1].counters > plans[0].counters
    args, kw_big = _decode_inputs(card, torch.bfloat16, quant, big, 20)
    eager = dec.paged_decode_attention_cuda(*args, BIG, **kw_big)
    assert _decode_err(eager, dec.paged_decode_attention_plain(*args, BIG, **kw_big),
                       quant) <= ATOL[torch.bfloat16]
    assert (ws.part.data_ptr(), ws.counters.data_ptr()) == ptrs
    lens.copy_(torch.tensor([64, 2047, 5, 900], dtype=torch.int32))
    graph.replay()
    ref = dec.paged_decode_attention_plain(q, ck, cv, pt, lens, BIG, **kw)
    torch.cuda.synchronize()
    assert _decode_err(out, ref, quant) <= ATOL[torch.bfloat16]
    assert not ws.counters.any()


def test_decode_plans_mirror_the_kernel(card):
    """decode_plan and decode_split (engine/ops/decode_attention.py) equal
    the source's dec_n_split, dec_scratch_floats and dec_split."""
    import ctypes

    from kaito_tpu_torch.engine.ops import decode_attention as dec
    from kaito_tpu_torch.ops import build

    lib = build.load_library("decode_attention")
    lib.kaito_decode_plan.argtypes = [ctypes.c_int] * 4
    lib.kaito_decode_plan.restype = ctypes.c_int
    lib.kaito_decode_workspace_floats.argtypes = [ctypes.c_int] * 5
    lib.kaito_decode_workspace_floats.restype = ctypes.c_longlong
    lib.kaito_decode_counters.argtypes = [ctypes.c_int] * 3
    lib.kaito_decode_counters.restype = ctypes.c_longlong
    lib.kaito_decode_split.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    lib.kaito_decode_split.restype = None
    for B in (1, 2, 5, 8, 64, 256):
        for Hkv, G in ((8, 4), (1, 8), (2, 16), (4, 1), (4, 7)):
            for sms in (1, 78, 132):
                plan = dec.decode_plan(B, Hkv * G, Hkv, 128, sms)
                assert plan.n_split == lib.kaito_decode_plan(B, Hkv * G, Hkv, sms)
                assert plan.scratch_floats == lib.kaito_decode_workspace_floats(
                    B, Hkv * G, Hkv, 128, sms)
                assert plan.counters == lib.kaito_decode_counters(B, Hkv * G, Hkv)
    got = (ctypes.c_int * 4)()
    for length in (0, 1, 15, 16, 63, 64, 65, 230, 1000, 2048, 8191):
        for window in (BIG, 1, 30, 100, 1024):
            for ps in (16, 32, 64):
                for n_split in (1, 3, 9, 64):
                    for split in (0, 1, n_split - 1):
                        lib.kaito_decode_split(length, window, ps, n_split, split, got)
                        assert tuple(got) == dec.decode_split(length, window, ps,
                                                              n_split, split)


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


# decode-row cases: (scheme, int4 group: 128 or 0 for one whole-K group, K,
# N, columns of a strided chunk of the N-column plane or None)
DECODE_CASES = [("int8", None, 4096, 1024, None), ("int8", None, 4096, 14336, None),
                ("int8", None, 7168, 4096, 2048), ("int8", None, 192, 384, None),
                ("int4", 128, 4096, 1024, None), ("int4", 128, 4096, 14336, None),
                ("int4", 128, 7168, 4096, 2048), ("int4", 0, 512, 1024, None),
                ("int4", 0, 1024, 128, None)]


@pytest.mark.parametrize("scheme,group,K,N,chunk", DECODE_CASES)
@pytest.mark.parametrize("rows", [1, 5, 8, 9, 16])
def test_quant_matmul_decode_rows(card, scheme, group, K, N, chunk, rows):
    """K4/K5's decode-row path (bf16 x, 1-16 rows) against the plain
    version: split and unsplit K, int4 groups of 128 in-rows or of the
    whole K, one and two n8 tiles, strided column chunks of a wider plane.
    One launch a call (the counter grows by one, the wide one not), two
    calls bitwise equal, and every merge counter back at zero."""
    from kaito_tpu_torch.engine.ops import quant_matmul as qm
    from kaito_tpu_torch.engine.quant import quantize_weight

    if group == 0 and K % 128 == 0:
        w = _int4_one_group(card, K, N)
    else:
        w = quantize_weight(torch.randn(K, N, generator=card, device="cuda"), scheme)
    if chunk is not None:
        w = {k: t[..., :chunk] for k, t in w.items()}
    x = _rand(card, rows, K, dtype=torch.bfloat16)
    codes, scale = (w["q4"], w["scale"]) if "q4" in w else (w["q8"], w["scale"])
    assert qm.takes_decode(x, codes, scale, scale.shape[0] if "q4" in w else 1, "q4" in w)
    counters = ("launches_" + scheme, f"launches_{scheme}_wide")
    before = [getattr(qm.quant_matmul_cuda, c) for c in counters]
    out = qm.quant_matmul_cuda(x, w)
    again = qm.quant_matmul_cuda(x, w)
    ref = qm.quant_matmul_plain(x, w)
    torch.cuda.synchronize()
    assert [getattr(qm.quant_matmul_cuda, c) for c in counters] == [before[0] + 2,
                                                                     before[1]]
    assert torch.equal(out, again)
    assert not qm.decode_workspace(x.device).counters.any()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= ATOL[torch.bfloat16] * ref.float().abs().max().item()


@pytest.mark.parametrize("scheme", ["int8", "int4"])
@pytest.mark.parametrize("rows", [1, 8, 16])
def test_prefetch_decode_rows_are_bitwise_the_plain_kernel(card, scheme, rows):
    """K6 on the TP=2 down ring's chunks ([7168, 2048 of 4096], strided
    views) at decode rows: bitwise K4/K5's output on the same views, and
    the merge counters back at zero."""
    from kaito_tpu_torch.engine.ops import quant_matmul as qm
    from kaito_tpu_torch.engine.ops.overlap_collectives import _slice_out
    from kaito_tpu_torch.engine.quant import quantize_weight

    K, N = 7168, 4096
    w = quantize_weight(torch.randn(K, N, generator=card, device="cuda"), scheme)
    w_next = quantize_weight(torch.randn(K, N, generator=card, device="cuda"), scheme)
    x = _rand(card, rows, K, dtype=torch.bfloat16)
    for c in range(2):
        wc, pc = _slice_out(w, c * N // 2, N // 2), _slice_out(w_next, c * N // 2, N // 2)
        assert qm.prefetch_ok(wc, pc)
        out = qm.quant_matmul_cuda(x, wc, pc)
        base = qm.quant_matmul_cuda(x, wc)
        torch.cuda.synchronize()
        assert torch.equal(out, base)
        assert not qm.decode_workspace(x.device).counters.any()


@pytest.mark.parametrize("pf", [False, True], ids=["K5", "K6"])
def test_quant_matmul_decode_replays_in_a_cuda_graph(card, pf):
    """One K5 (or K6) call at 8 rows captured in a CUDA graph; replayed
    after new x is copied into its input, and again after an eager call
    with more rows and a wider N (whose plan needs more partials): the
    card's workspace did not move under the graph, and every replay
    matches the plain version and the eager kernel bitwise."""
    from kaito_tpu_torch.engine.ops import quant_matmul as qm
    from kaito_tpu_torch.engine.ops.overlap_collectives import _slice_out
    from kaito_tpu_torch.engine.quant import quantize_weight

    K, N = 4096, 4096
    w = quantize_weight(torch.randn(K, N, generator=card, device="cuda"), "int4")
    w_next = quantize_weight(torch.randn(K, N, generator=card, device="cuda"), "int4")
    wc, pc = _slice_out(w, 0, N // 2), _slice_out(w_next, 0, N // 2)
    x = _rand(card, 8, K, dtype=torch.bfloat16)
    run = lambda: qm.quant_matmul_cuda(x, wc, pc if pf else None)   # noqa: E731
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()                      # warm up: build, workspace
    torch.cuda.current_stream().wait_stream(side)
    ws = qm.decode_workspace(x.device)
    ptrs = (ws.part.data_ptr(), ws.counters.data_ptr())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    small = qm.decode_plan(8, K, N // 2, K // 128, True, sms)
    big = qm.decode_plan(16, K, N, K // 128, True, sms)
    assert small.n_split > 1 and big.n_split > 1
    assert 16 * N * big.n_split > 8 * (N // 2) * small.n_split

    def replay_and_check():
        x.copy_(_rand(card, 8, K, dtype=torch.bfloat16))
        graph.replay()
        eager = qm.quant_matmul_cuda(x, wc)
        ref = qm.quant_matmul_plain(x, wc)
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= ATOL[torch.bfloat16] * ref.float().abs().max().item()
        assert not ws.counters.any()

    replay_and_check()
    replay_and_check()
    x16 = _rand(card, 16, K, dtype=torch.bfloat16)
    wide = qm.quant_matmul_cuda(x16, w)
    ref = qm.quant_matmul_plain(x16, w)
    torch.cuda.synchronize()
    assert (wide.float() - ref.float()).abs().max().item() <= \
        ATOL[torch.bfloat16] * ref.float().abs().max().item()
    assert (ws.part.data_ptr(), ws.counters.data_ptr()) == ptrs
    replay_and_check()


@pytest.mark.parametrize("kernel", ["K1", "K5"])
def test_workspace_first_use_under_capture_raises(card, monkeypatch, kernel):
    """A card's first decode-attention or decode-row quant matmul call
    inside CUDA graph capture raises instead of allocating the per-card
    workspace from the graph's private pool (which a later eager call
    would go on writing after the graph is freed); an eager call after it
    allocates the workspace as usual."""
    from kaito_tpu_torch.engine.ops import decode_attention as dec
    from kaito_tpu_torch.engine.ops import quant_matmul as qm
    from kaito_tpu_torch.engine.quant import quantize_weight

    if kernel == "K1":
        (q, ck, cv, pt, lens), kw = _decode_inputs(card, torch.bfloat16, False,
                                                   [700, 1, 0, 1999], 40)
        args = (q, ck, cv, pt, lens, BIG)
        call, mod, table = dec.paged_decode_attention_cuda, dec, "_WORKSPACES"
    else:
        w = quantize_weight(torch.randn(4096, 1024, generator=card, device="cuda"), "int4")
        args, kw = (_rand(card, 8, 4096, dtype=torch.bfloat16), w), {}
        call, mod, table = qm.quant_matmul_cuda, qm, "_DECODE_WORKSPACES"

    def run():
        return call(*args, **kw)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()                      # warm up: build and bind the kernel
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    monkeypatch.setattr(mod, table, {})
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="outside CUDA graph capture"):
        with torch.cuda.graph(graph):
            run()
    del graph
    run()
    torch.cuda.synchronize()
    (ws,) = getattr(mod, table).values()
    assert ws.part is not None and not ws.counters.any()


def test_quant_matmul_decode_plans_mirror_the_kernel(card):
    """decode_plan and decode_workspace_bounds (engine/ops/quant_matmul.py)
    equal the C functions they mirror, over the Llama-3.1-8B projections,
    their TP=2 chunks, int4 groups of 128 and of the whole K, rows 1-17
    and several SM counts."""
    import ctypes

    from kaito_tpu_torch.engine.ops import quant_matmul as qm
    from kaito_tpu_torch.ops import build

    lib = build.load_library("quant_matmul")
    c_plan = lib.kaito_quant_matmul_decode_plan
    c_plan.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    c_plan.restype = ctypes.c_int
    c_ws = lib.kaito_quant_matmul_decode_workspace
    c_ws.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
    c_ws.restype = None
    shapes = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
              (2048, 4096), (4096, 7168), (7168, 2048), (4096, 512), (192, 1024),
              (1024, 128)]
    plan = (ctypes.c_int * 3)()
    sizes = (ctypes.c_longlong * 2)()
    for sms in (1, 8, 78, 114, 132):
        c_ws(sms, sizes)
        assert tuple(sizes) == qm.decode_workspace_bounds(sms)
        for K, N in shapes:
            for int4 in (0, 1):
                for groups in ((1, K // 128) if int4 and K % 128 == 0 else (1,)):
                    for rows in (1, 7, 8, 9, 16, 17):
                        fits = c_plan(rows, K, N, groups, int4, sms, plan)
                        assert bool(fits) == (rows <= 16 and qm.tc_fits(K, N, K // groups)
                                              and qm.decode_fits(K, N, K // groups, bool(int4)))
                        if fits:
                            assert tuple(plan) == tuple(qm.decode_plan(
                                rows, K, N, groups, bool(int4), sms)), (rows, K, N, groups)
