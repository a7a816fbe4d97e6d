"""The port's engine serving an MLA model on the CPU, against the JAX engine.

``tests/test_mla.py``'s tiny DeepSeek-V3-shaped config (MLA with q_lora,
one dense layer then two MoE layers with a shared expert) and a q-direct
variant, one set of synthetic weights from the JAX engine
(``metadata=`` as ``tests/test_mla.py`` passes it), fp32: greedy tokens
equal to the JAX engine's and logprobs within atol 2e-3 (as the goldens
hold them) for a single prompt, a batch of fresh prompts that the
scheduler batches per bucket (MLA never segment-packs), a prompt
chunked by ``max_prefill_tokens``, the decode window at
``decode_run_ahead`` > 1 (equal to the eager loop's too), and the async
loop.  A tensor-parallel MLA engine raises with its ROADMAP item; the
server takes ``--model deepseek-v3-0324``.
"""

import dataclasses

import jax
import numpy as np
import pytest

from kaito_tpu.engine.config import EngineConfig as JaxConfig
from kaito_tpu.engine.engine import InferenceEngine as JaxEngine
from kaito_tpu.engine.engine import SamplingParams as JaxParams
from kaito_tpu.models.autogen import metadata_from_hf_config as j_metadata
from kaito_tpu_torch.engine import server as tserver
from kaito_tpu_torch.engine.config import EngineConfig
from kaito_tpu_torch.engine.engine import InferenceEngine, SamplingParams
from kaito_tpu_torch.engine.model import params_from_jax
from kaito_tpu_torch.models.autogen import metadata_from_hf_config
from kaito_tpu_torch.parallel.mesh import build_mesh
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_mla import CONFIGS

BASE = dict(model="tiny-mla-test", max_model_len=128, page_size=16, max_num_seqs=4,
            dtype="float32", kv_dtype="float32", prefill_buckets=(16, 32, 64),
            enable_prefix_caching=False, seed=0)
# (name, prompts submitted together, engine config changes)
CASES = {
    "single": ([[(3 * i) % 500 + 2 for i in range(11)]], {}),
    # two 20-30-token prompts share the 32 bucket, one takes the 16
    "fresh_batch": ([[(5 * i) % 500 + 2 for i in range(21)],
                     [(7 * i) % 500 + 2 for i in range(29)],
                     [(11 * i) % 500 + 2 for i in range(9)]], {}),
    # 40 tokens in chunks of 16: later chunks attend over the paged latent
    "chunked": ([[(13 * i) % 480 + 3 for i in range(40)]],
                {"max_prefill_tokens": 16}),
}
N_TOKENS = 7


def _md(pkg_metadata, name):
    return pkg_metadata(f"test/{name}", CONFIGS[name], name="tiny-mla-test")


def _greedy(p_cls):
    return p_cls(max_tokens=N_TOKENS, temperature=0.0, ignore_eos=True, logprobs=True)


def _drive(eng, prompts, p_cls, max_steps=2000):
    reqs = [eng.submit(list(p), _greedy(p_cls)) for p in prompts]
    for _ in range(max_steps):
        eng.step()
        if all(r.finish_reason for r in reqs):
            break
    assert all(r.finish_reason == "length" for r in reqs)
    return [list(r.output_tokens) for r in reqs], [list(r.output_logprobs)
                                                   for r in reqs]


_JAX: dict = {}


def _jax_run(name, case):
    """The JAX engine's tokens and logprobs (and its weights), once per
    config and case."""
    key = (name, case)
    if key not in _JAX:
        prompts, extra = CASES[case]
        jeng = JaxEngine(JaxConfig(**{**BASE, **extra}), metadata=_md(j_metadata, name))
        toks, lps = _drive(jeng, prompts, JaxParams)
        _JAX[key] = (toks, lps, jax.tree.map(np.asarray, jeng.params))
    return _JAX[key]


def _port(name, params, **kw):
    extra = {k: kw.pop(k) for k in list(kw) if k in EngineConfig.__dataclass_fields__}
    md = _md(metadata_from_hf_config, name)
    return InferenceEngine(EngineConfig(**{**BASE, **extra}), metadata=md,
                           params=params_from_jax(params, md.arch), device="cpu", **kw)


def _same(got, want):
    assert got[0] == want[0]
    for a, b in zip(got[1], want[1]):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-3)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_matches_the_jax_engine(name, case):
    toks, lps, params = _jax_run(name, case)
    prompts, extra = CASES[case]
    eng = _port(name, params, **extra)
    assert eng.model.is_mla and eng.cache.v.numel() == 0
    _same(_drive(eng, prompts, SamplingParams), (toks, lps))
    c = eng.counters
    assert c["prefill_packed_steps_total"] == 0
    if case == "fresh_batch":
        # one dispatch for the 32 bucket's two prompts, one for the 16's
        assert c["prefill_steps_total"] == 2
    if case == "chunked":
        assert c["prefill_steps_total"] == 3


@pytest.mark.parametrize("run_ahead", [2, 4])
def test_decode_window_equals_the_eager_loop_and_jax(run_ahead):
    """Fused windows of 2 and 4 steps (a window of K, its static buffers
    and carry) give the eager reference loop's tokens, logprobs exact,
    and the JAX engine's."""
    toks, lps, params = _jax_run("q_lora", "fresh_batch")
    prompts, _ = CASES["fresh_batch"]
    win = _port("q_lora", params, decode_run_ahead=run_ahead)
    got = _drive(win, prompts, SamplingParams)
    assert win.counters["decode_windows_total"] < win.counters["decode_steps_total"]
    ref = _port("q_lora", params, decode_run_ahead=run_ahead, _eager_decode=True)
    assert ref.window is None
    assert got == _drive(ref, prompts, SamplingParams)
    _same(got, (toks, lps))


def test_async_loop_matches_the_jax_engine():
    toks, lps, params = _jax_run("q_lora", "fresh_batch")
    prompts, _ = CASES["fresh_batch"]
    eng = _port("q_lora", params, async_dispatch=True, decode_run_ahead=4)
    assert eng.async_dispatch
    _same(_drive(eng, prompts, SamplingParams), (toks, lps))


def test_started_engine_streams_the_jax_tokens():
    """The engine's own thread (``start``/``stream``), as the server
    drives it."""
    toks, _, params = _jax_run("q_lora", "single")
    eng = _port("q_lora", params)
    eng.start()
    try:
        got = list(eng.submit(CASES["single"][0][0], _greedy(SamplingParams)).stream())
    finally:
        eng.stop()
    assert got == toks[0]


def test_tensor_parallel_mla_raises():
    md = _md(metadata_from_hf_config, "q_lora")
    cfg = EngineConfig(**BASE, tensor_parallel=2)
    with pytest.raises(NotImplementedError, match="item 40"):
        InferenceEngine(cfg, metadata=md, device="cpu",
                        mesh=build_mesh(tensor=2, devices=["cpu", "cpu"]))


def test_server_takes_deepseek_v3(monkeypatch):
    """``--model deepseek-v3-0324`` reaches the engine config with no new
    flag (the engine itself is built on the card, cut in depth, by
    ``chip_smoke.py``; ``main`` builds it before ``make_server``, so the
    engine is what stops here)."""
    seen = {}

    class Stop(Exception):
        pass

    def fake_engine(cfg, device="cuda"):
        seen["cfg"] = cfg
        raise Stop

    monkeypatch.setattr(tserver, "InferenceEngine", fake_engine)
    with pytest.raises(Stop):
        tserver.main(["--model", "deepseek-v3-0324", "--device", "cpu",
                      "--quantization", "int8", "--kv-cache-dtype", "int8"])
    cfg = seen["cfg"]
    assert (cfg.model, cfg.quantization, cfg.kv_dtype) == ("deepseek-v3-0324", "int8",
                                                           "int8")


def test_cut_deepseek_v3_builds_its_latent_pool():
    """The phase 8 configuration's shapes on the CPU at a toy pool size:
    DeepSeek-V3's widths cut in depth only (3 dense + 2 MoE layers);
    weights are not drawn."""
    from kaito_tpu_torch.engine.kv_cache import create_kv_cache, kv_bytes
    from kaito_tpu_torch.engine.model import TransformerLM
    from kaito_tpu_torch.models import get_model_by_name

    md = get_model_by_name("deepseek-v3-0324")
    arch = dataclasses.replace(md.arch, num_layers=5)
    m = TransformerLM(arch, device="cpu")
    assert [(g.name, g.count) for g in m.groups] == [("dense", 3), ("moe", 2)]
    c = create_kv_cache(arch, 4, 16, device="cpu")
    assert tuple(c.k.shape) == (5, 4, 16, 1, 576)
    assert kv_bytes(c) == arch.kv_bytes_per_token(2) * 16 * 4 == 5 * 576 * 2 * 64
