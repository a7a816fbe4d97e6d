"""The port's HF transformers fallback runtime
(``kaito_tpu_torch/runtime/hf_fallback.py``) against the JAX package's,
on ``tests/test_hf_fallback.py``'s tiny random GPT-2 checkpoint.

- The four cases of ``tests/test_hf_fallback.py``: the port's autogen
  sends the long-tail architecture to the fallback with the same
  metadata; the port's operator renders the JAX command for a TPU plan
  and the port's fallback on one card (``--device cuda``) for a GPU
  plan; the OpenAI surface (health, completion, chat, ``/metrics``)
  and SSE answer as the JAX fallback's: equal greedy tokens and text,
  equal frames with ids aside.
- ``--device cuda`` without a card raises before any model is loaded.
- A tokenizer that loads with an empty vocabulary (what transformers 5
  builds for a checkpoint without tokenizer files) is taken as missing:
  the byte-level tokenizer serves.
"""

import json
import threading
import urllib.error
import urllib.request

import pytest

from kaito_tpu.models.autogen import metadata_from_hf_config as jax_autogen
from kaito_tpu.runtime import hf_fallback as jax_fallback
from kaito_tpu_torch.models.autogen import metadata_from_hf_config
from kaito_tpu_torch.runtime import hf_fallback
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_operator_workspace import _plain

GPT2_CFG = {"architectures": ["GPT2LMHeadModel"], "model_type": "gpt2",
            "n_embd": 32, "n_layer": 2, "n_head": 2, "n_positions": 128,
            "vocab_size": 300}


@pytest.fixture(scope="module")
def tiny_gpt2(tmp_path_factory):
    import torch
    from transformers import GPT2Config, GPT2LMHeadModel

    path = tmp_path_factory.mktemp("gpt2")
    cfg = GPT2Config(n_embd=32, n_layer=2, n_head=2, n_positions=128, vocab_size=300)
    torch.manual_seed(0)
    GPT2LMHeadModel(cfg).save_pretrained(str(path))
    return str(path)


@pytest.fixture(scope="module")
def servers(tiny_gpt2):
    """The JAX fallback and the port's (``device="cpu"``) on the same
    checkpoint, each on a loopback port."""
    out = {}
    for name, state in (("jax", jax_fallback.FallbackState(tiny_gpt2, max_model_len=128)),
                        ("port", hf_fallback.FallbackState(tiny_gpt2, max_model_len=128,
                                                           device="cpu"))):
        mod = jax_fallback if name == "jax" else hf_fallback
        srv = mod.make_fallback_server(state, host="127.0.0.1", port=0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        out[name] = (state, srv, f"http://127.0.0.1:{srv.server_address[1]}")
    yield out
    for _, srv, _ in out.values():
        srv.shutdown()
        srv.server_close()


def _post(base, path, body):
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=120).read().decode()


def _no_id(obj):
    return {k: v for k, v in obj.items() if k != "id"}


def test_autogen_routes_long_tail_to_fallback_runtime():
    md = metadata_from_hf_config("openai-community/gpt2", GPT2_CFG, name="gpt2-test")
    assert md.runtime == "transformers" and "fallback-runtime" in md.tags
    assert md.arch.num_layers == 2 and md.arch.hidden_size == 32
    want = jax_autogen("openai-community/gpt2", GPT2_CFG, name="gpt2-test")
    assert _plain(md) == _plain(want)


@pytest.mark.parametrize("where", ["tpu", "gpu"])
def test_workload_renders_fallback_command(where):
    """A TPU plan renders what the JAX operator renders (the JAX package's
    fallback on the CPU); a GPU plan the port's on one card."""
    import kaito_tpu.api as japi
    from kaito_tpu.manifests.inference import generate_inference_workload as jax_render
    from kaito_tpu.parallel.plan import plan_parallelism as jax_plan
    from kaito_tpu.sku.catalog import CHIP_CATALOG as JAX_CHIPS
    from kaito_tpu_torch import api
    from kaito_tpu_torch.manifests.inference import generate_inference_workload
    from kaito_tpu_torch.parallel.plan import plan_parallelism
    from kaito_tpu_torch.sku.catalog import CHIP_CATALOG, GPU_CATALOG

    md = metadata_from_hf_config("openai-community/gpt2", GPT2_CFG, name="gpt2-test")
    instance = "ct5lp-hightpu-1t" if where == "tpu" else "a3-highgpu-1g"
    chip = CHIP_CATALOG["v5e"] if where == "tpu" else GPU_CATALOG["h100-80gb"]
    ws = api.Workspace(api.ObjectMeta(name="lt"),
                       resource=api.ResourceSpec(instance_type=instance),
                       inference=api.InferenceSpec(preset="gpt2-test"))
    plan = plan_parallelism(md, chip, workload="serve", max_model_len=128)
    objs = generate_inference_workload(ws, md, plan, {"k": "v"})
    c = objs[2].spec["template"]["spec"]["containers"][0]
    if where == "tpu":
        jmd = jax_autogen("openai-community/gpt2", GPT2_CFG, name="gpt2-test")
        jws = japi.Workspace(japi.ObjectMeta(name="lt"),
                             resource=japi.ResourceSpec(instance_type=instance),
                             inference=japi.InferenceSpec(preset="gpt2-test"))
        jplan = jax_plan(jmd, JAX_CHIPS["v5e"], workload="serve", max_model_len=128)
        assert _plain(objs) == _plain(jax_render(jws, jmd, jplan, {"k": "v"}))
        assert c["command"][:3] == ["python", "-m", "kaito_tpu.runtime.hf_fallback"]
        assert c["resources"] == {"requests": {"cpu": "4", "memory": "16Gi"}}
    else:
        assert c["command"][:3] == ["python", "-m", "kaito_tpu_torch.runtime.hf_fallback"]
        assert c["command"][-2:] == ["--device", "cuda"]
        assert c["resources"] == {"requests": {"nvidia.com/gpu": "1"},
                                  "limits": {"nvidia.com/gpu": "1"}}
    assert c["command"][c["command"].index("--model") + 1] == "openai-community/gpt2"
    assert "httpGet" in c["startupProbe"]


def test_fallback_serves_openai_surface(servers):
    answers = {}
    for name, (state, _, base) in servers.items():
        health = json.loads(urllib.request.urlopen(base + "/health", timeout=10).read())
        done = json.loads(_post(base, "/v1/completions", {
            "prompt": "hello", "max_tokens": 6, "temperature": 0.0, "ignore_eos": True}))
        again = json.loads(_post(base, "/v1/completions", {
            "prompt": "hello", "max_tokens": 6, "temperature": 0.0, "ignore_eos": True}))
        chat = json.loads(_post(base, "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "hi"}], "max_tokens": 4,
            "temperature": 0.0, "ignore_eos": True}))
        toks, finish = state.generate(state.tokenizer.encode("hello"), 6, 0.0,
                                      ignore_eos=True)
        assert done["usage"]["completion_tokens"] == 6 and done == {**again, "id": done["id"]}
        assert chat["choices"][0]["message"]["role"] == "assistant"
        models = json.loads(urllib.request.urlopen(base + "/v1/models", timeout=10).read())
        too_long = urllib.request.Request(base + "/v1/completions", data=json.dumps(
            {"prompt": "x", "max_tokens": 500}).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(too_long, timeout=30)
        metrics = urllib.request.urlopen(base + "/metrics", timeout=10).read().decode()
        answers[name] = dict(health={k: v for k, v in health.items() if k != "device"},
                             done=_no_id(done), chat=_no_id(chat), tokens=toks,
                             finish=finish, models=models, refused=e.value.code,
                             metrics=sorted(ln.split(" ")[0] for ln in metrics.splitlines()))
    assert answers["port"] == answers["jax"]
    assert servers["port"][0].device.type == "cpu"
    health = json.loads(urllib.request.urlopen(servers["port"][2] + "/health",
                                               timeout=10).read())
    assert health == {"status": "ok", "runtime": "transformers-fallback", "device": "cpu"}


def _frames(base, body):
    raw = _post(base, "/v1/completions" if "prompt" in body else "/v1/chat/completions",
                {**body, "stream": True})
    assert raw.strip().endswith("data: [DONE]")
    return [_no_id(json.loads(ln[len("data: "):])) for ln in raw.splitlines()
            if ln.startswith("data: ") and ln != "data: [DONE]"]


@pytest.mark.parametrize("kind", ["completion", "chat"])
def test_fallback_streams_sse(servers, kind):
    body = {"max_tokens": 4, "temperature": 0.0, "ignore_eos": True}
    body.update({"prompt": "hi"} if kind == "completion"
                else {"messages": [{"role": "user", "content": "hi"}]})
    got = _frames(servers["port"][2], body)
    assert got == _frames(servers["jax"][2], body)
    assert len(got) == (5 if kind == "completion" else 6)
    assert got[-1]["choices"][0]["finish_reason"] == "length"
    assert all(e["choices"][0]["finish_reason"] is None for e in got[:-1])
    if kind == "completion":
        flat = json.loads(_post(servers["port"][2], "/v1/completions", body))
        assert "".join(e["choices"][0]["text"] for e in got) == \
            flat["choices"][0]["text"]


def test_cuda_without_a_card_raises(tiny_gpt2, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        hf_fallback.FallbackState(tiny_gpt2)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        hf_fallback.main(["--model", tiny_gpt2, "--device", "cuda"])


def test_an_empty_tokenizer_falls_back_to_bytes(tiny_gpt2, monkeypatch):
    import transformers

    from kaito_tpu_torch.engine.tokenizer import ByteTokenizer

    class Empty:
        eos_token_id = 0

        def encode(self, text):
            return []

    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        classmethod(lambda cls, *a, **kw: Empty()))
    state = hf_fallback.FallbackState(tiny_gpt2, max_model_len=128, device="cpu")
    assert isinstance(state.tokenizer, ByteTokenizer)
    toks, finish = state.generate(state.tokenizer.encode("hi"), 3, 0.0, ignore_eos=True)
    assert len(toks) == 3 and finish == "length"
