"""The port's LoRA artifact IO against the JAX package's.

- ``utils.msgpack``: what ``flax.serialization.to_bytes`` writes, the
  port reads (fp32, bf16, int8, nested maps, a chunked leaf forced past
  a lowered threshold), and what the port writes, flax restores; the
  two write the same bytes for the same tree.
- ``tuning.lora``: an artifact the JAX ``save_adapter`` wrote loads in
  the port, one the port wrote loads in the JAX package, both exactly;
  ``merge_lora`` equals the JAX one (fp32 base, int8 base: rtol 1e-6 /
  atol 1e-6, one einsum's float order apart), and refuses an int4 base
  where the JAX one raises a KeyError.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization as fs

from kaito_tpu.engine.model import TransformerLM as JaxLM
from kaito_tpu.engine.quant import quantize_params as jax_quantize
from kaito_tpu.tuning import lora as jlora
from kaito_tpu_torch.engine.model import TransformerLM, params_from_jax
from kaito_tpu_torch.engine.quant import quantize_weight
from kaito_tpu_torch.models import get_model_by_name
from kaito_tpu_torch.tuning import lora as tlora
from kaito_tpu_torch.utils import msgpack as mp
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = get_model_by_name("tiny-llama-test").arch


def _bits(x):
    """Raw bits of a tensor or array, for exact comparison."""
    if isinstance(x, torch.Tensor):
        t = x.contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy().view(np.uint8)
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    return a.view(np.uint8)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "dense/q_lora_a": rng.standard_normal((2, 8, 4)).astype(np.float32),
        "dense/q_lora_b": np.asarray(jnp.asarray(rng.standard_normal((2, 4, 8)),
                                                 jnp.bfloat16)),
        "codes": rng.integers(-128, 127, (3, 70)).astype(np.int8),
        "meta": {"n": 3, "neg": -40, "big": 2 ** 40, "x": 1.5, "s": "a" * 40,
                 "flag": True, "none": None, "list": [1, 2, 3]},
    }


@pytest.mark.parametrize("chunk", [None, 64], ids=["whole", "chunked"])
def test_codec_matches_flax_both_ways(monkeypatch, chunk):
    if chunk is not None:
        monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", chunk)
        monkeypatch.setattr(mp, "MAX_CHUNK_SIZE", chunk)
    tree = _tree()
    ours, theirs = mp.to_bytes(tree), fs.to_bytes(tree)
    assert ours == theirs
    if chunk is not None:
        assert b"__msgpack_chunked_array__" in ours
    got = mp.restore(theirs)
    for k in ("dense/q_lora_a", "dense/q_lora_b", "codes"):
        assert isinstance(got[k], torch.Tensor)
        np.testing.assert_array_equal(_bits(got[k]), _bits(tree[k]))
    assert got["dense/q_lora_b"].dtype == torch.bfloat16
    assert got["codes"].dtype == torch.int8
    assert got["meta"]["big"] == 2 ** 40 and got["meta"]["neg"] == -40
    assert got["meta"]["list"] == {"0": 1, "1": 2, "2": 3}   # flax's state dict
    # tensors written by the port restore in flax
    back = fs.msgpack_restore(mp.to_bytes(got))
    for k in ("dense/q_lora_a", "dense/q_lora_b", "codes"):
        np.testing.assert_array_equal(_bits(back[k]), _bits(tree[k]))
    assert back["meta"]["s"] == "a" * 40


def test_codec_int_and_length_forms():
    """Every int width and length header round-trips and matches msgpack."""
    import msgpack as ref

    vals = [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32, -33, -128, -129,
            -2 ** 15 - 1, -2 ** 31 - 1, "x" * 31, "x" * 32, "x" * 300, "x" * 70000,
            b"y" * 3, b"y" * 300, list(range(15)), list(range(16)), list(range(70000)),
            {str(i): i for i in range(20)}, 0.25, None, False]
    for v in vals:
        packed = mp.packb(v)
        assert packed == ref.packb(v, use_bin_type=True), repr(v)[:40]
        assert mp.unpackb(packed) == v
    with pytest.raises(ValueError):
        mp.unpackb(mp.packb([1, 2]) + b"\x00")


def _jax_lora_params(seed, r=4, targets=jlora.ALL_TARGETS, scale=0.5):
    model = JaxLM(TINY, dtype=jnp.float32)
    params = jlora.add_lora_params(model, model.init_params(jax.random.PRNGKey(0)),
                                   jlora.LoraConfig(r=r, targets=targets),
                                   jax.random.PRNGKey(seed))
    for t in targets:
        k = f"{t}_lora_b"
        params["dense"][k] = scale * jax.random.normal(
            jax.random.PRNGKey(seed + 100 + len(t)), params["dense"][k].shape)
    return model, params


def test_jax_artifact_loads_in_the_port(tmp_path):
    _, params = _jax_lora_params(1, r=4)
    cfg = jlora.LoraConfig(r=4, alpha=6, targets=jlora.ALL_TARGETS)
    jlora.save_adapter(str(tmp_path / "a"), params, cfg, "tiny-llama-test")
    adapter, tcfg, base = tlora.load_adapter(str(tmp_path / "a"))
    want, _, _ = jlora.load_adapter(str(tmp_path / "a"))
    assert base == "tiny-llama-test"
    assert (tcfg.r, tcfg.alpha, tcfg.targets) == (4, 6, jlora.ALL_TARGETS)
    assert tcfg.scaling == 1.5
    assert sorted(adapter) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(_bits(adapter[k]), _bits(want[k]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_artifact_loads_in_jax(tmp_path, dtype):
    _, params = _jax_lora_params(2, r=8, targets=("q", "v"))
    tparams = {"dense": {k: torch.from_numpy(np.array(v)).to(getattr(torch, dtype))
                         for k, v in params["dense"].items() if "lora" in k}}
    cfg = tlora.LoraConfig(r=8, alpha=16, targets=("q", "v"))
    tlora.save_adapter(str(tmp_path / "b"), tparams, cfg, "tiny-llama-test")
    adapter, jcfg, base = jlora.load_adapter(str(tmp_path / "b"))
    assert base == "tiny-llama-test" and jcfg.r == 8 and jcfg.targets == ("q", "v")
    assert sorted(adapter) == sorted(tlora.extract_adapter(tparams))
    for k, v in tlora.extract_adapter(tparams).items():
        assert str(np.asarray(adapter[k]).dtype) == dtype
        np.testing.assert_array_equal(_bits(adapter[k]), _bits(v))
    # the same leaves saved by JAX give the same bytes
    jtree = {"dense": {k.split("/")[1]: adapter[k] for k in adapter}}
    jlora.save_adapter(str(tmp_path / "c"), jtree, jcfg, "tiny-llama-test")
    assert (tmp_path / "b" / "adapter.msgpack").read_bytes() == \
        (tmp_path / "c" / "adapter.msgpack").read_bytes()
    assert json.loads((tmp_path / "b" / "adapter_config.json").read_text()) == \
        json.loads((tmp_path / "c" / "adapter_config.json").read_text())


def _merge_both(quant):
    jm, params = _jax_lora_params(3, r=4)
    jm.lora_scaling = 1.5
    base = jax_quantize(params, quant) if quant else params
    want = jlora.merge_lora(jm, base)
    tm = TransformerLM(TINY, dtype=torch.float32, device="cpu")
    tm.lora_scaling = 1.5
    tree = params_from_jax(jax.tree.map(np.asarray, base), TINY)
    got = tlora.merge_lora(tm, tree)
    return got, want


@pytest.mark.parametrize("quant", ["", "int8"], ids=["fp32", "int8"])
def test_merge_lora_matches_jax(quant):
    got, want = _merge_both(quant)
    for t in jlora.ALL_TARGETS:
        assert f"{t}_lora_a" not in got["dense"]
        g, w = got["dense"][t], np.asarray(want["dense"][t])
        assert not isinstance(g, dict)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6)


def test_merge_lora_refuses_int4():
    jm, params = _jax_lora_params(4, r=4, targets=("q",))
    jm.lora_scaling = 2.0
    q4 = jax_quantize(params, "int4")
    with pytest.raises(KeyError):
        jlora.merge_lora(jm, q4)          # the reference's fault: base["q8"]
    tm = TransformerLM(TINY, dtype=torch.float32, device="cpu")
    tm.lora_scaling = 2.0
    tree = params_from_jax(jax.tree.map(np.asarray, params), TINY)
    tree["dense"]["q"] = quantize_weight(tree["dense"]["q"], "int4")
    with pytest.raises(ValueError, match="int4"):
        tlora.merge_lora(tm, tree)


def test_extract_and_apply_adapter_round_trip():
    _, params = _jax_lora_params(5, r=2, targets=("o",))
    tree = params_from_jax(jax.tree.map(np.asarray, params), TINY)
    ad = tlora.extract_adapter(tree)
    assert sorted(ad) == ["dense/o_lora_a", "dense/o_lora_b"]
    want = jlora.extract_adapter(params)
    assert list(ad) == list(want)                 # JAX's sorted key order
    stripped = {k: ({n: v for n, v in g.items() if "lora" not in n}
                    if isinstance(g, dict) else g) for k, g in tree.items()}
    back = tlora.apply_adapter(stripped, ad)
    assert "lora" not in "".join(stripped["dense"])        # fresh containers
    for k, v in ad.items():
        g, n = k.split("/")
        assert torch.equal(back[g][n], v)
