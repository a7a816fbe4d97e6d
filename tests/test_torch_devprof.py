"""The port's device-time attribution (``kaito_tpu_torch/engine/devprof.py``)
against the JAX package's (``kaito_tpu/engine/devprof.py``) on the CPU.

- ``classify`` buckets every needle of the JAX rule table and every name
  of ``tests/test_devprof.py`` as the JAX function does, and the port's
  kernel, GEMM, NCCL, copy and aten names as the table of its docstring
  says, also inside an ``attention`` range.
- ``summarize_window`` and ``_empty_summary`` equal the JAX functions
  (every field but ``ts``) on seeded slices: nested, overlapping,
  multi-track and empty; ``parse_trace_events`` equals the JAX reader on
  the JAX fixtures.
- The torch profiler's own trace: a committed synthetic trace in its GPU
  layout (``tests/testdata/torch_trace_gpu.json``: a graph replay's
  kernels correlated to their ``cudaGraphLaunch`` inside ``kaito/decode``,
  a memcpy on a second stream, an eager flash kernel inside
  ``kaito/prefill/attention``, a GEMM from ``cuLaunchKernel``, a kernel whose
  launch is missing, a memset) read into slices, buckets and phases; the
  CPU layout (host operators under host ranges).
- The roofline rates against the H100 peaks, the accessors before and
  after the first window, a window skipped under a manual trace, a parse
  error counted, a window folded in a child process as in this one, and
  a real detached window over CPU work.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

import kaito_tpu.engine.devprof as jdp
from kaito_tpu_torch.engine import devprof as tdp
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.test_devprof import _meta

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GPU_TRACE = os.path.join(REPO, "tests", "testdata", "torch_trace_gpu.json")

# every name tests/test_devprof.py classifies, as (op_name, name)
JAX_TEST_NAMES = [
    ("", "fusion.3.dot_general"), ("jit(f)/transformer/einsum", ""),
    ("", "all-reduce.17"), ("", "reduce-scatter.2"), ("", "collective-permute.1"),
    ("", "copy.4"), ("", "infeed.0"), ("jit(step)/attention/mul", "fusion.9"),
    ("", "flash_decode_kernel"), ("", "broadcast.1"), ("", "fused-all-reduce-dot.1"),
    ("", "dot.1 copy-start"), ("", "ALL-REDUCE.9"), ("", "fusion.all-reduce.3"),
    ("", "fusion.reduce-scatter.dot.1"), ("", "loop_all-gather_fusion.7"),
    ("", "fusion.collective-permute.2"), ("", "ppermute_dynamic-update-slice_fusion"),
    ("jit(step)/comm_overlap_ring/fusion", "all-reduce.dot.4"), ("", "fusion.dot.5"),
    ("", "fusion.8"), ("", "while.12"),
    ("jit(decode_multi)/kaito/decode/while/body/dot", "fusion.3"),
    ("jit(f)/kaito/decode/dot_general", "dot.1"),
    ("jit(f)/kaito/prefill/dot_general", "dot.2"), ("", "ThunkExecutor::run"),
]

# the port's own names and the bucket each lands in
PORT_NAMES = [
    ("", "void decode_tc_kernel<__nv_bfloat16, 128, 8>(DecodeArgs)", "attention"),
    ("", "void decode_fp32_kernel<128>(DecodeArgs)", "attention"),
    ("", "void flash_kernel<128, true>(FlashArgs)", "attention"),
    ("", "void flash_tc_kernel<128, false>(FlashArgs)", "attention"),
    ("", "void quant_matmul_int8_decode<16>(QArgs)", "matmul"),
    ("", "quant_matmul_int4_wide_kernel", "matmul"),
    ("", "nvjet_tst_128x64_64x4_1x2_h_bz_coopA_NTN", "matmul"),
    ("", "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_"
         "warpgroupsize1x1x1_execute_segment_k_off_kernel__5x_cublas", "matmul"),
    ("", "cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_64x64_64x4>",
     "matmul"),
    ("", "void cublasLt::splitKreduce_kernel<32, 16, int, float>(Params)", "matmul"),
    ("", "aten::mm", "matmul"), ("", "aten::bmm", "matmul"), ("", "aten::addmm", "matmul"),
    ("", "aten::linear", "matmul"),
    ("", "ncclDevKernel_AllReduce_Sum_bf16_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
     "collective"),
    ("", "ncclDevKernel_Broadcast_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
     "collective"),
    ("", "Memcpy DtoH (Device -> Pinned)", "copy"), ("", "Memcpy HtoD (Pinned -> Device)",
                                                    "copy"),
    ("", "Memset (Device)", "copy"),
    ("", "void at::native::vectorized_elementwise_kernel<4, FillFunctor<float>>", "other"),
    # a GEMM launched inside an attention range is attention, as a dot
    # under the JAX package's attention scope is
    ("kaito/prefill/attention", "nvjet_tst_64x8_64x16_4x1_v_bz_TNT", "attention"),
    ("kaito/decode/attention", "aten::bmm", "attention"),
    ("kaito/decode", "nvjet_tst_64x8_64x16_4x1_v_bz_TNT", "matmul"),
]


def _no_ts(summary):
    return {k: v for k, v in summary.items() if k != "ts"}


def _pair(slices):
    """The same slices as the port's and as the JAX package's records."""
    return ([tdp.Slice(s.name, s.op_name, s.t0_us, s.dur_us, s.track, s.device)
             for s in slices],
            [jdp.Slice(s.name, s.op_name, s.t0_us, s.dur_us, s.track, s.device)
             for s in slices])


# ---------------------------------------------------------------------------
# classifier
# ---------------------------------------------------------------------------

def test_rule_table_is_the_jax_table():
    assert tdp.OP_RULES == jdp.OP_RULES
    assert tdp.BUCKETS == jdp.BUCKETS and tdp.PHASES == jdp.PHASES


@pytest.mark.parametrize("bucket,needle", [(b, n) for b, ns in jdp.OP_RULES for n in ns])
def test_classify_matches_jax_on_every_needle(bucket, needle):
    for op_name, name in ((needle, ""), ("", needle), ("", f"fusion.{needle}.7"),
                          ("", needle.upper())):
        assert tdp.classify(op_name, name) == jdp.classify(op_name, name) == bucket


@pytest.mark.parametrize("op_name,name", JAX_TEST_NAMES)
def test_classify_matches_jax_on_its_test_names(op_name, name):
    assert tdp.classify(op_name, name) == jdp.classify(op_name, name)


@pytest.mark.parametrize("op_name,name,bucket", PORT_NAMES)
def test_classify_port_names(op_name, name, bucket):
    assert tdp.classify(op_name, name) == bucket


def test_phase_of_matches_jax():
    for op in ("jit(step)/kaito/decode/dot_general", "a/kaito/prefill_packed/b",
               "kaito/kv_import", "jit(step)/decode/dot", "kaito/unknown_phase", "",
               "kaito/verify/attention", "kaito/draft"):
        assert tdp.phase_of(op) == jdp.phase_of(op)


# ---------------------------------------------------------------------------
# window summary against the JAX function
# ---------------------------------------------------------------------------

NAMES = ("dot.1", "all-reduce.2", "copy.3", "fusion.4", "flash_decode_kernel",
         "softmax.5", "broadcast.6", "einsum.7", "ppermute.8", "while.9")
OPS = ("", "jit(f)/kaito/decode/dot", "jit(f)/kaito/prefill/attention/x",
       "jit(f)/kaito/prefill_packed/y", "kaito/verify/z", "kaito/draft/w",
       "jit(f)/kaito/kv_import/u", "jit(f)/other/v")


def _seeded(seed, tracks, n, nested):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t0 = float(rng.uniform(0, 200))
        dur = float(rng.uniform(0.5, 40))
        track = f"t{rng.integers(tracks)}"
        out.append(jdp.Slice(NAMES[rng.integers(len(NAMES))], OPS[rng.integers(len(OPS))],
                             t0, dur, track))
        if nested and rng.random() < 0.5:
            # a child inside it, and one straddling its end
            c0 = t0 + dur * float(rng.uniform(0, 0.5))
            out.append(jdp.Slice(NAMES[rng.integers(len(NAMES))],
                                 OPS[rng.integers(len(OPS))], c0,
                                 dur * float(rng.uniform(0.05, 0.4)), track))
            out.append(jdp.Slice(NAMES[rng.integers(len(NAMES))], "", t0 + dur * 0.9,
                                 dur * 0.5, track))
    return out


@pytest.mark.parametrize("seed,tracks,n,nested", [
    (0, 1, 12, True), (1, 1, 40, False), (2, 3, 30, True), (3, 4, 60, True),
    (4, 2, 1, False), (5, 8, 80, True)])
def test_summarize_window_matches_jax(seed, tracks, n, nested):
    ours, theirs = _pair(_seeded(seed, tracks, n, nested))
    roof = {"params": 8e9, "bytes_per_tok": 16e9, "peak_flops": 989.4e12,
            "peak_bytes_s": 3.35e12}
    got = tdp.summarize_window(ours, roofline=roof, window_tokens=300.0, capture_s=0.25)
    want = jdp.summarize_window(theirs, roofline=roof, window_tokens=300.0,
                                capture_s=0.25)
    assert _no_ts(got) == _no_ts(want)
    assert sum(got["bucket_pct"].values()) == pytest.approx(100.0, abs=0.01)


def test_empty_summary_matches_jax():
    assert _no_ts(tdp.summarize_window([])) == _no_ts(jdp.summarize_window([]))
    assert _no_ts(tdp._empty_summary(0.3)) == _no_ts(jdp._empty_summary(0.3))


def test_leaf_pieces_and_merged_match_jax():
    ours, theirs = _pair(_seeded(9, 1, 30, True))
    got = [(a, b, s.name) for a, b, s in tdp._leaf_pieces(ours)]
    want = [(a, b, s.name) for a, b, s in jdp._leaf_pieces(theirs)]
    assert got == want
    iv = [(float(a), float(a + d)) for a, d in
          np.random.default_rng(3).uniform(0, 50, (20, 2))]
    assert tdp._merged(list(iv)) == jdp._merged(list(iv))


# ---------------------------------------------------------------------------
# the JAX trace format
# ---------------------------------------------------------------------------

JAX_DOCS = [
    {"traceEvents": [
        _meta("process_name", 1, label="/device:TPU:0"),
        _meta("thread_name", 1, 1, label="XLA Ops"),
        _meta("process_name", 2, label="python"),
        {"ph": "X", "pid": 1, "tid": 1, "ts": 0, "dur": 4,
         "name": "dot.1", "args": {"op_name": "jit(f)/kaito/decode/dot"}},
        {"ph": "X", "pid": 1, "tid": 1, "ts": 4, "dur": 4,
         "name": "all-reduce.1", "args": {}},
        {"ph": "X", "pid": 2, "tid": 7, "ts": 0, "dur": 100, "name": "HostWork",
         "args": {}},
        {"ph": "X", "pid": 1, "tid": 1, "ts": 8, "dur": 0, "name": "marker"},
        {"ph": "X", "pid": 1, "tid": 1, "ts": 8, "dur": 2, "name": "ThunkExecutor::run"},
    ]},
    {"traceEvents": [
        _meta("process_name", 1, label="kaito host"),
        _meta("thread_name", 1, 3, label="tf_XLATfrtCpuClient/271"),
        _meta("thread_name", 1, 4, label="MainThread"),
        {"ph": "X", "pid": 1, "tid": 3, "ts": 0, "dur": 6, "name": "fusion.1",
         "args": {"phase": "prefill"}},
        {"ph": "X", "pid": 1, "tid": 3, "ts": 6, "dur": 2, "name": "$traced_fn"},
        {"ph": "X", "pid": 1, "tid": 4, "ts": 0, "dur": 50, "name": "dispatch"},
    ]},
    {"traceEvents": [
        _meta("process_name", 1, label="/device:TPU:0"),
        {"ph": "X", "pid": 1, "tid": 1, "ts": 0, "dur": 5, "name": "dot.9"},
        {"ph": "X", "pid": 1, "tid": 2, "ts": 1, "dur": 5, "name": "x",
         "args": {"long_name": "jit(g)/kaito/verify/attention/x"}},
    ]},
]


@pytest.mark.parametrize("i", range(len(JAX_DOCS)))
def test_parse_trace_events_matches_jax(i):
    doc = JAX_DOCS[i]
    got = tdp.parse_trace_events(copy.deepcopy(doc))
    want = jdp.parse_trace_events(copy.deepcopy(doc))
    assert [vars(s) for s in got] == [vars(s) for s in want]
    assert got
    ours, theirs = _pair(got)
    assert _no_ts(tdp.summarize_window(ours)) == _no_ts(jdp.summarize_window(theirs))


# ---------------------------------------------------------------------------
# the torch profiler's trace
# ---------------------------------------------------------------------------

def test_gpu_trace_slices_scopes_and_tracks():
    slices = tdp.parse_torch_trace(tdp.read_trace(GPU_TRACE))
    by = {s.name.split("(")[0].split("<")[0]: s for s in slices}
    assert len(slices) == 8 and all(s.device for s in slices)
    # one track per card: stream 13's copy shares stream 7's track
    assert {s.track for s in slices} == {"cuda:0"}
    assert by["nvjet_tst_128x64_64x4_1x2_h_bz_coopA_NTN"].op_name == "kaito/decode"
    assert by["void decode_tc_kernel"].op_name == "kaito/decode"
    assert by["Memcpy DtoH "].op_name == "kaito/decode"
    assert by["void flash_tc_kernel"].op_name == "kaito/prefill/attention"
    gemm = next(s for s in slices if "xmma_gemm" in s.name)
    assert gemm.op_name == "kaito/prefill"
    assert by["void at::native::reduce_kernel"].op_name == ""
    assert by["Memset "].op_name == ""


def test_gpu_trace_summary():
    s = tdp.summarize_window(tdp.parse_torch_trace(tdp.read_trace(GPU_TRACE)))
    span = 1317.0 - 1020.0
    assert s["n_tracks"] == 1 and s["n_slices"] == 8
    assert s["wall_us"] == pytest.approx(span)
    assert s["busy_us"] == pytest.approx(121.0)
    want = {"matmul": 70.0, "attention": 30.0, "copy": 6.0, "other": 15.0,
            "collective": 0.0, "idle": span - 121.0}
    for b, us in want.items():
        assert s["bucket_pct"][b] == pytest.approx(100.0 * us / span, abs=1e-3), b
    assert sum(s["bucket_pct"].values()) == pytest.approx(100.0, abs=0.01)
    assert s["phase_pct"]["decode"] == pytest.approx(100.0 * 49.0 / span, abs=1e-3)
    assert s["phase_pct"]["prefill"] == pytest.approx(100.0 * 60.0 / span, abs=1e-3)
    assert s["phase_attributed_pct"] == pytest.approx(100.0 * 109.0 / 121.0, abs=1e-3)
    assert s["comm_compute_overlap_pct"] == 0.0 and s["copy_overlap_pct"] == 0.0


def test_two_cards_are_two_tracks():
    doc = tdp.read_trace(GPU_TRACE)
    extra = copy.deepcopy(next(e for e in doc["traceEvents"]
                               if "decode_tc_kernel" in e.get("name", "")))
    extra["pid"], extra["args"]["device"] = 1, 1
    doc["traceEvents"].append(extra)
    s = tdp.summarize_window(tdp.parse_torch_trace(doc))
    assert s["n_tracks"] == 2
    assert s["wall_us"] == pytest.approx(2 * (1317.0 - 1020.0))


def test_cpu_trace_takes_the_host_operators():
    H, T = 7, 9
    ev = [{"ph": "X", "cat": c, "name": n, "pid": H, "tid": T, "ts": t, "dur": d}
          for c, n, t, d in (
              ("user_annotation", "kaito/decode", 0.0, 100.0),
              ("user_annotation", "attention", 10.0, 30.0),
              ("cpu_op", "aten::bmm", 12.0, 20.0),
              ("cpu_op", "aten::linear", 50.0, 40.0),
              ("cpu_op", "aten::matmul", 52.0, 36.0),
              ("cpu_op", "aten::mm", 53.0, 34.0),
              ("cpu_op", "aten::add", 95.0, 4.0),
              ("cpu_op", "aten::copy_", 120.0, 5.0))]
    ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": H, "tid": 99,
               "ts": 0.0, "dur": 3.0})
    slices = tdp.parse_torch_trace({"traceEvents": ev})
    assert len(slices) == 7 and not any(s.device for s in slices)
    assert {s.track for s in slices} == {f"host/{T}", "host/99"}
    ops = {(s.name, s.t0_us): s.op_name for s in slices}
    assert ops[("aten::bmm", 12.0)] == "kaito/decode/attention"
    assert ops[("aten::mm", 53.0)] == "kaito/decode"
    assert ops[("aten::copy_", 120.0)] == ""
    s = tdp.summarize_window([x for x in slices if x.track == f"host/{T}"])
    # leaves win: bmm 20 attention, mm 34 + matmul/linear edges 6 matmul,
    # add 4 other, copy_ 5 copy over a span of 113
    assert s["bucket_pct"]["attention"] == pytest.approx(100 * 20 / 113, abs=1e-3)
    assert s["bucket_pct"]["matmul"] == pytest.approx(100 * 40 / 113, abs=1e-3)
    assert s["bucket_pct"]["copy"] == pytest.approx(100 * 5 / 113, abs=1e-3)
    assert s["phase_pct"]["decode"] == pytest.approx(100 * 64 / 113, abs=1e-3)


# ---------------------------------------------------------------------------
# roofline, the sampler, its accessors
# ---------------------------------------------------------------------------

def test_roofline_with_the_h100_peaks():
    n = 8_030_261_248
    bf16 = tdp.roofline("NVIDIA H100 80GB HBM3", "", n)
    assert bf16 == {"params": float(n), "bytes_per_tok": 2.0 * n,
                    "peak_flops": 989.4e12, "peak_bytes_s": 3.35e12}
    assert tdp.roofline("NVIDIA H100 80GB HBM3", "int8", n)["peak_flops"] == 1978.9e12
    int4 = tdp.roofline("NVIDIA H100 80GB HBM3", "int4", n)
    assert int4["peak_flops"] == 989.4e12 and int4["bytes_per_tok"] == 0.53125 * n
    # a card the table lacks (or the CPU) reads 0, never a guess
    for card in ("NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB", ""):
        r = tdp.roofline(card, "", n)
        assert r["peak_flops"] == 0.0 and r["peak_bytes_s"] == 0.0
    s = tdp.summarize_window([tdp.Slice("dot.1", "", 0.0, 10.0, "t0")], roofline=bf16,
                             window_tokens=100.0, capture_s=0.25)
    tok_s = 400.0
    assert s["matmul_pct_of_peak_flops"] == pytest.approx(
        100.0 * tok_s * 2.0 * n / 989.4e12, abs=1e-3)
    assert s["hbm_pct_of_peak"] == pytest.approx(100.0 * tok_s * 2.0 * n / 3.35e12,
                                                 abs=1e-3)
    zero = tdp.summarize_window([tdp.Slice("dot.1", "", 0.0, 10.0, "t0")],
                                roofline=tdp.roofline("", "", n), window_tokens=100.0,
                                capture_s=0.25)
    assert zero["matmul_pct_of_peak_flops"] == 0.0 and zero["hbm_pct_of_peak"] == 0.0


def test_accessors_before_and_after_the_first_window():
    prof = tdp.DeviceProfiler(interval_s=60.0)
    assert prof.comm_pct() == 0.0 and prof.idle_pct() == 0.0
    assert prof.bucket_pct() == {(b,): 0.0 for b in tdp.BUCKETS}
    assert prof.phase_pct() == {(p,): 0.0 for p in tdp.PHASES}
    assert prof.snapshot()["last"] is None
    summary = tdp.summarize_window([
        tdp.Slice("all-reduce.1", "", 0.0, 1.0, "A"),
        tdp.Slice("dot.1", "kaito/decode", 0.0, 1.0, "B"),
    ])
    prof.windows.append(summary)
    assert prof.comm_pct() == pytest.approx(50.0)
    assert prof.overlap_pct() == pytest.approx(100.0)
    assert prof.copy_overlap_pct() == 0.0
    assert prof.bucket_pct()[("collective",)] == pytest.approx(50.0)
    assert prof.phase_pct()[("decode",)] == pytest.approx(50.0)
    snap = prof.snapshot()
    assert snap["last"] == summary and snap["ring"] == [summary]
    assert set(snap) == {"interval_s", "window_s", "windows_total", "windows_skipped",
                         "parse_errors", "last", "ring"}


def test_detached_window_over_host_work():
    prof = tdp.DeviceProfiler(interval_s=60.0, window_s=0.05)
    x = torch.randn(128, 128)
    win = prof._open()
    for _ in range(20):
        with torch.profiler.record_function("kaito/prefill"):
            torch.mm(x, x)
    got = prof._close(win)
    assert got is not None and not tdp.PROFILE_LOCK.locked()
    # the same window through sample_window's parse
    prof2 = tdp.DeviceProfiler(interval_s=60.0, window_s=0.0)
    s = prof2.sample_window()
    assert s is not None and prof2.windows_total == 1
    assert sum(s["bucket_pct"].values()) in (0.0, pytest.approx(100.0, abs=0.01))


def test_window_is_skipped_under_a_manual_trace(tmp_path):
    prof = tdp.DeviceProfiler(interval_s=60.0, window_s=0.01)
    trace = tdp.ManualTrace(lambda fn: fn(), cuda=False)
    trace.start()
    try:
        assert trace.active and tdp.PROFILE_LOCK.locked()
        assert prof.sample_window() is None
        assert prof.windows_skipped == 1 and prof.windows_total == 0
    finally:
        path = trace.stop(str(tmp_path))
    assert os.path.exists(path) and not trace.active
    assert not tdp.PROFILE_LOCK.locked()
    assert prof.sample_window() is not None and prof.windows_total == 1


def test_window_over_a_graph_capture_is_skipped():
    captures = [0]
    prof = tdp.DeviceProfiler(interval_s=60.0, window_s=0.0,
                              captures_fn=lambda: captures[0])
    win = prof._open()
    captures[0] += 1                    # the engine captured a graph meanwhile
    assert prof._close(win) is None
    assert prof.windows_skipped == 1 and not tdp.PROFILE_LOCK.locked()
    assert prof.sample_window() is not None and prof.windows_total == 1


class _Garbage:
    """A profile whose trace is not JSON."""

    def start(self):
        pass

    def stop(self):
        pass

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            f.write("not a trace")


def test_parse_error_is_counted(monkeypatch):
    monkeypatch.setattr(tdp, "_profile", lambda cuda: _Garbage())
    prof = tdp.DeviceProfiler(interval_s=60.0, window_s=0.0)
    assert prof.sample_window() is None
    assert prof.parse_errors == 1 and prof.windows_total == 0
    assert not tdp.PROFILE_LOCK.locked()
    with pytest.raises(json.JSONDecodeError):
        tdp.read_trace(os.path.join(REPO, "tests", "test_torch_devprof.py"))


def test_a_window_is_folded_in_a_child_process():
    roof = tdp.roofline("NVIDIA H100 80GB HBM3", "", 10**9)
    got = tdp._summarize_elsewhere(GPU_TRACE, roof, 40.0, 0.25)
    want = tdp.summarize_trace(GPU_TRACE, roofline=roof, window_tokens=40.0,
                               capture_s=0.25)
    assert _no_ts(got) == _no_ts(want) and want["n_slices"] == 8
