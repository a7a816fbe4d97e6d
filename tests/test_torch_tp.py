"""The port's tensor-parallel engine on the CPU against the JAX package.

- ``parallel.mesh.build_mesh``: explicit devices (repeats allowed), and
  without them the first n cards, which raises here (no card).
- ``qtensor_logical_axes`` and ``param_logical_axes`` equal the JAX
  package's; ``shard_params`` cuts a full tree, plain or quantized, by
  SERVE_RULES, and its shards reassemble the tree.
- One decode step of the port at TP=2 with the comm-overlap ring on
  (int8 and int4 weights) against the JAX ``TransformerLM`` with
  ``model.overlap = (mesh2, "tensor")`` on the same ``params_from_jax``
  tree: logits within 1e-4 (four layers of fp32 sums in each
  framework's own order; the observed differences are ~1e-6).
- The engine at TP=2 on a ``["cpu", "cpu"]`` mesh replays every golden
  section of ``tiny-llama-real`` with the ring off and on (greedy
  tokens exact, logprobs within 2e-3, as the single-device engine);
  TP=4 replays ``fp32``, ``int8`` and ``kv_int8``, and refuses int4.
- TP=2 with the ring on serves the same greedy tokens as TP=1 on the
  same synthetic weights, and each decode step hands the next layer's
  o/down slab to the ring's quantized matmuls.
- The gates: ``tensor_parallel=2`` without a mesh raises on a machine
  without cards; pipeline, data, sequence and expert parallelism still
  raise NotImplementedError; the server takes
  ``--tensor-parallel-size`` and ``--comm-overlap``.
"""

import json
import os
import urllib.request
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from kaito_tpu.engine.kv_cache import create_kv_cache as j_cache
from kaito_tpu.engine.model import TransformerLM as JaxLM
from kaito_tpu.engine.quant import qtensor_logical_axes as j_qaxes
from kaito_tpu.engine.quant import quantize_params as j_quantize_params
from kaito_tpu.models import get_model_by_name as jax_model
from kaito_tpu_torch.engine import server as tserver
from kaito_tpu_torch.engine.config import EngineConfig
from kaito_tpu_torch.engine.engine import InferenceEngine, SamplingParams
from kaito_tpu_torch.engine.model import (TensorParallelLM, TransformerLM,
                                          params_from_jax, shard_params)
from kaito_tpu_torch.engine.kv_cache import create_sharded_kv_cache
from kaito_tpu_torch.engine.ops import overlap_collectives as tov
from kaito_tpu_torch.engine.quant import qtensor_logical_axes, quantize_params
from kaito_tpu_torch.models import get_model_by_name
from kaito_tpu_torch.parallel.mesh import Mesh, build_mesh
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(REPO, "tests", "testdata", "goldens_tiny-llama-real.json")
PRESET = "tiny-llama-test"
PS, P, PMAX = 16, 40, 6
MODES = {"fp32": ("", "float32"), "int8": ("int8", "float32"),
         "weight_int4": ("int4", "float32"), "kv_int8": ("", "int8")}


def _cpu_mesh(n):
    return build_mesh(tensor=n, devices=["cpu"] * n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _greedy(n, **kw):
    return SamplingParams(max_tokens=n, temperature=0.0, ignore_eos=True, **kw)


def _drive(eng, reqs, max_steps=3000):
    for _ in range(max_steps):
        eng.step()
        if all(r.finish_reason for r in reqs):
            break
    assert all(r.finish_reason for r in reqs)
    return [list(r.output_tokens) for r in reqs]


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------


def test_build_mesh_with_explicit_devices():
    mesh = build_mesh(tensor=2, devices=["cpu", "cpu"])
    assert mesh.shape == {"tensor": 2} and mesh.size("tensor") == 2
    assert mesh.size("data") == 1
    assert mesh.devices == [torch.device("cpu")] * 2 and mesh.shared
    with pytest.raises(ValueError, match="needs 2 devices"):
        build_mesh(tensor=2, devices=["cpu"])
    with pytest.raises(ValueError, match=">= 1"):
        build_mesh(tensor=0, devices=[])
    with pytest.raises(ValueError, match="want 4 devices"):
        Mesh([torch.device("cpu")] * 2, (("tensor", 4),))


def test_build_mesh_without_devices_needs_cards():
    with pytest.raises(ValueError, match="only 0 CUDA devices"):
        build_mesh(tensor=2)


# ---------------------------------------------------------------------------
# logical axes and sharding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme", ["int8", "int4"])
@pytest.mark.parametrize("ax", [("layers", "embed", "heads"),
                                ("layers", "heads", "embed"),
                                ("embed", "intermediate")])
def test_qtensor_logical_axes_match_jax(scheme, ax):
    assert qtensor_logical_axes(ax, scheme) == j_qaxes(ax, scheme)


def test_param_logical_axes_match_jax():
    arch = get_model_by_name(PRESET).arch
    got = TransformerLM(arch, torch.float32, "cpu").param_logical_axes()
    want = JaxLM(jax_model(PRESET).arch, dtype=jnp.float32).param_logical_axes()
    assert got == want


@pytest.mark.parametrize("scheme", ["", "int8", "int4"])
def test_shard_params_cuts_by_serve_rules(scheme):
    arch = get_model_by_name(PRESET).arch
    full = TransformerLM(arch, torch.float32, "cpu")
    full.init_params(seed=1)
    tree = full.param_tree()
    if scheme:
        tree = quantize_params(tree, scheme)
    shards = shard_params(tree, _cpu_mesh(2))
    d = tree["dense"]
    a, b = shards[0]["dense"], shards[1]["dense"]
    # the embedding is replicated; lm_head rows split on vocab
    assert torch.equal(shards[1]["embed"], tree["embed"])
    assert torch.equal(torch.cat([shards[0]["lm_head"], shards[1]["lm_head"]]),
                       tree["lm_head"])
    assert torch.equal(a["attn_norm"], d["attn_norm"])
    if not scheme:
        assert torch.equal(torch.cat([a["q"], b["q"]], dim=-1), d["q"])
        assert torch.equal(torch.cat([a["o"], b["o"]], dim=1), d["o"])
        assert torch.equal(torch.cat([a["down"], b["down"]], dim=1), d["down"])
        return
    codes = "q8" if scheme == "int8" else "q4"
    assert torch.equal(torch.cat([a["k"][codes], b["k"][codes]], dim=-1),
                       d["k"][codes])
    assert torch.equal(torch.cat([a["k"]["scale"], b["k"]["scale"]], dim=-1),
                       d["k"]["scale"])
    assert torch.equal(torch.cat([a["down"][codes], b["down"][codes]], dim=1),
                       d["down"][codes])
    if scheme == "int8":     # per-out-channel scale of a row-parallel weight
        assert torch.equal(a["down"]["scale"], d["down"]["scale"])
    else:                    # group rows follow their in-rows
        assert torch.equal(torch.cat([a["down"]["scale"], b["down"]["scale"]],
                                     dim=1), d["down"]["scale"])
    # each shard installs into a TransformerLM over the local arch
    tp = TensorParallelLM(arch, _cpu_mesh(2), torch.float32)
    tp.load_params(tree)
    for shard, want in zip(tp.shards, shards):
        got = shard.param_tree()["dense"]
        assert torch.equal(got["down"][codes], want["dense"]["down"][codes])


def test_sharded_kv_pools_hold_their_heads():
    arch = get_model_by_name(PRESET).arch
    pools = create_sharded_kv_cache(arch, _cpu_mesh(2).devices, 9, 16, torch.int8)
    assert len(pools) == 2
    for c in pools:
        assert c.k.shape == (arch.num_layers, 9, 16, arch.num_kv_heads // 2,
                             arch.head_dim)
        assert c.k_scale.shape == (arch.num_layers, 9, arch.num_kv_heads // 2)


# ---------------------------------------------------------------------------
# one decode step against the JAX model on its TP mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme", ["int8", "int4"])
def test_tp2_decode_step_matches_jax(cpu_devices, scheme):
    jm = JaxLM(jax_model(PRESET).arch, dtype=jnp.float32)
    jp = j_quantize_params(jm.init_params(jax.random.PRNGKey(0)), scheme)
    arch = get_model_by_name(PRESET).arch
    tm = TensorParallelLM(arch, _cpu_mesh(2), torch.float32)
    tm.load_params(params_from_jax(jax.tree.map(np.asarray, jp), arch))
    rng = np.random.RandomState(0)
    B, T = 2, 16
    toks = rng.randint(0, arch.vocab_size, size=(B, T)).astype(np.int32)
    tl = np.array([16, 11], np.int32)
    pt = np.stack([np.arange(1 + b * PMAX, 1 + (b + 1) * PMAX) for b in range(B)]
                  ).astype(np.int32)
    jc = j_cache(jm.arch, P, PS, jnp.float32)
    tc = create_sharded_kv_cache(arch, tm.mesh.devices, P, PS, torch.float32)
    jc, jl, _ = jm.prefill(jp, jc, jnp.asarray(toks), jnp.asarray(tl),
                           jnp.asarray(pt))
    tc, tlg, _ = tm.prefill(tc, _t(toks), _t(tl), _t(pt))
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    nxt = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
    jm.overlap = (JaxMesh(np.array(jax.devices()[:2]), ("tensor",)), "tensor")
    tm.overlap = True
    jc, jl = jm.decode(jp, jc, jnp.asarray(nxt), jnp.asarray(tl), jnp.asarray(pt))
    tc, tlg = tm.decode(tc, _t(nxt), _t(tl), _t(pt))
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _real_engine(section, tp, overlap):
    quant, kv_dtype = MODES[section]
    cfg = EngineConfig(model="tiny-llama-real",
                       weights_dir=os.path.join(REPO, "checkpoints",
                                                "tiny-llama-real"),
                       dtype="float32", kv_dtype=kv_dtype, max_model_len=512,
                       max_num_seqs=2, prefill_buckets=(64, 128),
                       enable_prefix_caching=False, quantization=quant, seed=0,
                       tensor_parallel=tp, comm_overlap=overlap)
    return InferenceEngine(cfg, device="cpu", mesh=_cpu_mesh(tp))


@pytest.mark.parametrize("overlap", [False, True], ids=["ring-off", "ring-on"])
@pytest.mark.parametrize("tp,section", [(2, "fp32"), (2, "int8"),
                                        (2, "weight_int4"), (2, "kv_int8"),
                                        (4, "fp32"), (4, "int8"), (4, "kv_int8")])
def test_tp_engine_replays_goldens(tp, section, overlap):
    eng = _real_engine(section, tp, overlap)
    assert eng.comm_overlap is overlap
    assert len(eng.cache) == tp
    golden = json.load(open(GOLDENS))
    for p in golden["prompts"]:
        want = p[section]
        req = eng.submit(list(p["prompt_tokens"]),
                         _greedy(len(want["greedy_tokens"]), logprobs=True))
        assert _drive(eng, [req])[0] == want["greedy_tokens"], p["text"]
        np.testing.assert_allclose(req.output_logprobs, want["logprobs"],
                                   rtol=0, atol=2e-3, err_msg=p["text"])


def test_tp4_int4_is_refused():
    with pytest.raises(ValueError, match="whole groups of 128"):
        _real_engine("weight_int4", 4, True)


BASE = dict(model=PRESET, max_model_len=256, page_size=16, max_num_seqs=3,
            kv_dtype="float32",
            dtype="float32", prefill_buckets=(32, 64, 128), seed=0,
            enable_prefix_caching=False)
PROMPTS = [[(3 * i) % 1900 + 2 for i in range(9)],
           [(5 * i) % 1900 + 2 for i in range(21)],
           [(7 * i) % 1900 + 2 for i in range(40)]]


@pytest.mark.parametrize("quant,kv_dtype", [("", "float32"), ("int8", "int8"),
                                            ("int4", "float32")])
def test_tp2_ring_serves_the_single_device_tokens(monkeypatch, quant, kv_dtype):
    """The same synthetic weights (TP cuts the single-device draw) and
    concurrent traffic: TP=2 with the ring on gives TP=1's greedy tokens,
    and every decode-step o/down matmul of a quantized model carries the
    next layer's slab."""
    cfg = dict(BASE, quantization=quant, kv_dtype=kv_dtype)
    one = InferenceEngine(EngineConfig(**cfg), device="cpu")
    want = _drive(one, [one.submit(p, _greedy(10)) for p in PROMPTS])
    calls = []
    real = tov.quant_linear

    def spy(x, w, prefetch=None):
        calls.append(prefetch is not None)
        return real(x, w, prefetch=prefetch)

    monkeypatch.setattr(tov, "quant_linear", spy)
    eng = InferenceEngine(EngineConfig(**cfg, tensor_parallel=2, comm_overlap=True),
                          device="cpu", mesh=_cpu_mesh(2))
    assert eng.comm_overlap and eng.model.overlap
    got = _drive(eng, [eng.submit(p, _greedy(10)) for p in PROMPTS])
    assert got == want
    if quant:
        steps = eng.counters["decode_steps_total"]
        L = eng.md.arch.num_layers
        # decode: 2 ring steps x (o, down) x L layers x 2 shards, each
        # with a slab; prefill: the psum's (o, down) x L x 2 shards, none
        assert calls.count(True) == steps * 2 * 2 * L * 2
        assert calls.count(False) == eng.counters["prefill_steps_total"] * 2 * L * 2
    else:
        assert calls == []


def test_comm_overlap_gate(monkeypatch):
    mk = lambda **kw: InferenceEngine(EngineConfig(**BASE, **kw), device="cpu",  # noqa: E731
                                      mesh=_cpu_mesh(kw.get("tensor_parallel", 1)))
    off = mk(tensor_parallel=2, comm_overlap=False)
    assert off.comm_overlap is False and off.model.overlap is False
    monkeypatch.setenv("KAITO_COMM_OVERLAP", "1")
    assert mk(tensor_parallel=2).comm_overlap is True
    assert mk(tensor_parallel=2, comm_overlap=False).comm_overlap is False
    monkeypatch.setenv("KAITO_COMM_OVERLAP", "off")
    assert mk(tensor_parallel=2).comm_overlap is False
    # one device: no collective to hide, the gate stays off
    single = InferenceEngine(EngineConfig(**BASE, comm_overlap=True), device="cpu")
    assert single.comm_overlap is False


def test_tensor_parallel_without_a_mesh_raises():
    cfg = EngineConfig(**BASE, tensor_parallel=2)
    with pytest.raises(ValueError, match="only 0 CUDA devices"):
        InferenceEngine(cfg)
    with pytest.raises(NotImplementedError, match="explicit mesh"):
        InferenceEngine(cfg, device="cpu")
    with pytest.raises(ValueError, match="tensor axis has 4"):
        InferenceEngine(cfg, device="cpu", mesh=_cpu_mesh(4))


@pytest.mark.parametrize("field", ["pipeline_parallel", "data_parallel",
                                   "sequence_parallel", "expert_parallel"])
def test_other_parallelism_still_raises(field):
    with pytest.raises(NotImplementedError, match="M19"):
        InferenceEngine(EngineConfig(**BASE, **{field: 2}), device="cpu")


def test_server_takes_tensor_parallel_flags():
    cfg, _ = tserver.parse_args(["--tensor-parallel-size", "2", "--comm-overlap"])
    assert cfg.tensor_parallel == 2 and cfg.comm_overlap is True
    cfg, _ = tserver.parse_args([])
    assert cfg.tensor_parallel == 1 and cfg.comm_overlap is None
    with pytest.raises(ValueError, match="only 0 CUDA devices"):
        tserver.main(["--model", PRESET, "--tensor-parallel-size", "2",
                      "--port", "0"])


def test_server_over_a_tp_engine():
    """An engine built on an explicit mesh, handed to make_server."""
    cfg = EngineConfig(**BASE, tensor_parallel=2, comm_overlap=True)
    eng = InferenceEngine(cfg, device="cpu", mesh=_cpu_mesh(2))
    eng.start()
    server = tserver.make_server(eng, cfg, host="127.0.0.1", port=0, device="cpu")
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/v1/completions",
            data=json.dumps({"prompt": "hello", "max_tokens": 5,
                             "temperature": 0.0, "ignore_eos": True}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.loads(r.read())
        assert body["usage"]["completion_tokens"] == 5
    finally:
        server.shutdown()
        server.server_close()
        eng.stop()
