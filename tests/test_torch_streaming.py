"""The port's streaming weight load against its disk loader and the JAX
package's streaming load (``tests/test_streaming.py``'s cases).

Checkpoints served by a local HTTP server that answers ``Range``: the
committed ``tiny-llama-real`` and ``tiny-moe-real`` (one file each, so
the index's 404 falls back to ``model.safetensors``), the first split
over two shards with an index, and copies of it in bf16, fp32 and fp16.
The streamed tree equals the port's disk loader's bit for bit, and the JAX
``stream_safetensors_params`` tree as numpy; every shard read is
ranged; the credential registry routes each scheme.
"""

import json
import os
import threading
import urllib.error
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kaito_tpu.engine.streaming as jax_streaming
import kaito_tpu_torch.engine.streaming as streaming
from kaito_tpu.engine.model import TransformerLM as JaxTransformerLM
from kaito_tpu.models import get_model_by_name as jax_model
from kaito_tpu_torch.engine.model import TransformerLM
from kaito_tpu_torch.engine.streaming import (HTTPRangeReader, SafetensorsStream,
                                              make_reader, stream_safetensors_params)
from kaito_tpu_torch.engine.weights import (load_safetensors_params, read_safetensors,
                                            write_safetensors)
from kaito_tpu_torch.models import get_model_by_name
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints")


class _RangeHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    root = ""
    log: list = []
    fail: list = []            # statuses answered first, one a request
    honor_range = True

    def log_message(self, *a):
        pass

    def do_GET(self):
        cls = type(self)
        rng = self.headers.get("Range")
        cls.log.append((self.path, rng, self.headers.get("Authorization")))
        if cls.fail:
            self._reply(cls.fail.pop(0), b"")
            return
        path = os.path.join(cls.root, self.path.lstrip("/"))
        if not os.path.isfile(path):
            self._reply(404, b"")
            return
        with open(path, "rb") as f:
            data = f.read()
        if rng and cls.honor_range:
            a, _, b = rng.split("=")[1].partition("-")
            start, end = int(a), int(b) + 1
            self._reply(206, data[start:end],
                        {"Content-Range": f"bytes {start}-{end - 1}/{len(data)}"})
        else:
            self._reply(200, data)

    def _reply(self, code, body, headers=None):
        self.send_response(code)
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


@pytest.fixture
def serve():
    """serve(root, **handler attrs) -> (url, handler class)."""
    servers = []

    def start(root, **attrs):
        handler = type("H", (_RangeHandler,), {"root": root, "log": [], "fail": [],
                                               **attrs})
        srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        servers.append((srv, th))
        return f"http://127.0.0.1:{srv.server_address[1]}", handler

    yield start
    for srv, th in servers:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=10)


def _port_model(name):
    return TransformerLM(get_model_by_name(name).arch, dtype=torch.float32, device="cpu")


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _assert_bitwise(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert set(g) == set(w)
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        assert torch.equal(g[k], w[k]), k


def _assert_jax_equal(got, jax_tree):
    g = dict(_leaves(got))
    w = {".".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf, np.float32)
         for path, leaf in jax.tree_util.tree_leaves_with_path(jax_tree)}
    assert set(g) == set(w)
    for k in w:
        np.testing.assert_array_equal(g[k].float().numpy(), w[k], err_msg=k)


@pytest.mark.parametrize("name", ["tiny-llama-real", "tiny-moe-real"])
def test_streamed_tree_is_the_disk_loaders(serve, name):
    root = os.path.join(CKPT, name)
    url, handler = serve(root)
    model = _port_model(name)
    streamed = stream_safetensors_params(model, url)
    _assert_bitwise(streamed, load_safetensors_params(model, root))
    jmodel = JaxTransformerLM(jax_model(name).arch, dtype=jnp.float32)
    _assert_jax_equal(streamed, jax_streaming.stream_safetensors_params(jmodel, url))
    # no index: one 404, then the single file
    assert handler.log[0][0] == "/" + streaming.INDEX_FILE


@pytest.mark.parametrize("name", ["tiny-llama-real", "tiny-moe-real"])
def test_every_shard_read_is_ranged(serve, name):
    url, handler = serve(os.path.join(CKPT, name))
    stream_safetensors_params(_port_model(name), url)
    shard_reads = [(p, r) for p, r, _ in handler.log if p.endswith(".safetensors")]
    assert len(shard_reads) > 2
    assert all(r is not None for _, r in shard_reads)


def _two_shards(root, tensors):
    names = sorted(tensors)
    shards = {"model-00001-of-00002.safetensors": names[:len(names) // 2],
              "model-00002-of-00002.safetensors": names[len(names) // 2:]}
    weight_map = {}
    for fname, keys in shards.items():
        write_safetensors(os.path.join(root, fname), {k: tensors[k] for k in keys})
        weight_map.update({k: fname for k in keys})
    with open(os.path.join(root, streaming.INDEX_FILE), "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)
    return shards


def test_index_over_two_shards(serve, tmp_path):
    src = os.path.join(CKPT, "tiny-llama-real")
    shards = _two_shards(str(tmp_path), read_safetensors(
        os.path.join(src, "model.safetensors")))
    url, handler = serve(str(tmp_path))
    model = _port_model("tiny-llama-real")
    streamed = stream_safetensors_params(model, url)
    _assert_bitwise(streamed, load_safetensors_params(model, src))
    files = {p.lstrip("/") for p, _, _ in handler.log}
    assert set(shards) | {streaming.INDEX_FILE} == files
    jmodel = JaxTransformerLM(jax_model("tiny-llama-real").arch, dtype=jnp.float32)
    _assert_jax_equal(streamed, jax_streaming.stream_safetensors_params(jmodel, url))


def test_single_file_fallback(serve):
    url, handler = serve(os.path.join(CKPT, "tiny-llama-real"))
    stream = SafetensorsStream(HTTPRangeReader(url))
    jstream = jax_streaming.SafetensorsStream(jax_streaming.HTTPRangeReader(url))
    assert "model.embed_tokens.weight" in stream.keys()
    assert stream.keys() == jstream.keys()
    assert stream.index == jstream.index
    t = stream.read_tensor("model.embed_tokens.weight")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        t.float().numpy(),
        np.asarray(jstream.read_tensor("model.embed_tokens.weight"), np.float32))
    assert stream.read_tensor("no.such.tensor") is None


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
def test_checkpoint_dtypes(serve, tmp_path, dtype):
    """The committed checkpoints are bf16; the same tensors written by
    the port's writer in bf16, fp32 and fp16."""
    src = read_safetensors(os.path.join(CKPT, "tiny-llama-real", "model.safetensors"))
    write_safetensors(str(tmp_path / "model.safetensors"),
                      {k: v.to(dtype) for k, v in src.items()})
    url, _ = serve(str(tmp_path))
    model = _port_model("tiny-llama-real")
    streamed = stream_safetensors_params(model, url)
    assert dict(_leaves(streamed))["embed"].dtype == dtype
    _assert_bitwise(streamed, load_safetensors_params(model, str(tmp_path)))
    jmodel = JaxTransformerLM(jax_model("tiny-llama-real").arch, dtype=jnp.float32)
    _assert_jax_equal(streamed, jax_streaming.stream_safetensors_params(jmodel, url))


def test_stream_result_line(serve, capsys):
    url, _ = serve(os.path.join(CKPT, "tiny-llama-real"))
    reader = HTTPRangeReader(url)
    stream_safetensors_params(_port_model("tiny-llama-real"), url, reader=reader)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("KAITO_WEIGHTS_STREAM_RESULT ")]
    assert len(lines) == 1
    rec = json.loads(lines[0].split(" ", 1)[1])
    assert rec["location"] == url
    assert (rec["bytes"], rec["requests"]) == (reader.bytes_read, reader.requests)
    size = os.path.getsize(os.path.join(CKPT, "tiny-llama-real", "model.safetensors"))
    assert 0.99 * size < rec["bytes"] <= size


def test_transient_errors_are_retried(serve):
    url, handler = serve(os.path.join(CKPT, "tiny-llama-real"), fail=[503, 500])
    head = HTTPRangeReader(url).read("model.safetensors", 0, 8)
    assert len(head) == 8 and len(handler.log) == 3


def test_missing_and_ignored_ranges_raise(serve):
    url, _ = serve(os.path.join(CKPT, "tiny-llama-real"))
    with pytest.raises(urllib.error.HTTPError):
        HTTPRangeReader(url).read("model-00009.safetensors", 0, 8)
    url, _ = serve(os.path.join(CKPT, "tiny-llama-real"), honor_range=False)
    with pytest.raises(RuntimeError, match="ignored Range"):
        HTTPRangeReader(url).read("model.safetensors", 0, 8)
    with pytest.raises(RuntimeError, match="ignored Range"):
        stream_safetensors_params(_port_model("tiny-llama-real"), url)


@pytest.mark.parametrize("location,base,token", [
    ("gs://bucket/models/llama", "https://storage.googleapis.com/bucket/models/llama",
     "gcp_metadata_token"),
    ("gs://bucket", "https://storage.googleapis.com/bucket", "gcp_metadata_token"),
    ("https+token://blobs.example/m/", "https://blobs.example/m", "env_token"),
    ("http+token://10.0.0.1:8080/m", "http://10.0.0.1:8080/m", "env_token"),
    ("https://mirror.example/m/", "https://mirror.example/m", None),
    ("http://127.0.0.1:9/m", "http://127.0.0.1:9/m", None),
])
def test_credential_registry_routes_each_scheme(location, base, token):
    r, jr = make_reader(location), jax_streaming.make_reader(location)
    assert r.base_url == jr.base_url == base
    want = getattr(streaming, token) if token else None
    assert r.token_provider is want
    assert (jr.token_provider is None) == (token is None)


def test_registered_scheme_and_env_token(serve, monkeypatch):
    root = os.path.join(CKPT, "tiny-llama-real")
    url, handler = serve(root)
    monkeypatch.setitem(streaming.CREDENTIAL_PROVIDERS, "acme",
                        (lambda loc: url + "/" + loc.split("://", 1)[1],
                         lambda: "acme-token"))
    assert make_reader("acme://").base_url == url
    make_reader("acme://").read("model.safetensors", 0, 8)
    assert handler.log[-1][2] == "Bearer acme-token"
    monkeypatch.delenv("KAITO_STREAM_TOKEN", raising=False)
    tok_reader = make_reader("http+token://" + url.split("://", 1)[1])
    with pytest.raises(RuntimeError, match="KAITO_STREAM_TOKEN"):
        tok_reader.read("model.safetensors", 0, 8)
    monkeypatch.setenv("KAITO_STREAM_TOKEN", "s3cret")
    tok_reader.read("model.safetensors", 0, 8)
    assert handler.log[-1][2] == "Bearer s3cret"
    streaming.register_credential_provider("acme2", lambda loc: url, None)
    try:
        assert make_reader("acme2://x").token_provider is None
    finally:
        del streaming.CREDENTIAL_PROVIDERS["acme2"]


@pytest.mark.parametrize("location,streams", [
    ("gs://bucket/m", True), ("http://h/m", True), ("https://h/m", True),
    ("https+token://h/m", True), ("http+token://h/m", True),
    ("/models/llama", False), ("checkpoints/tiny-llama-real", False), ("", False),
    ("s3://bucket/m", False), ("file:///models/x", False)])
def test_which_locations_stream(location, streams):
    assert streaming.is_stream_location(location) is streams


def test_engine_streams_a_token_location(serve, monkeypatch):
    """A ``http+token://`` weights location streams with the token (the
    JAX engine's gate sends it to its disk loader instead), and the
    engine decodes what an engine on the directory decodes."""
    from kaito_tpu_torch.engine.config import EngineConfig
    from kaito_tpu_torch.engine.engine import InferenceEngine, SamplingParams

    url, handler = serve(os.path.join(CKPT, "tiny-llama-real"))
    monkeypatch.setenv("KAITO_STREAM_TOKEN", "tok")
    outs = []
    for wd in ("http+token://" + url.split("://", 1)[1] + "/",
               os.path.join(CKPT, "tiny-llama-real")):
        cfg = EngineConfig(model="tiny-llama-real", weights_dir=wd, dtype="float32",
                           kv_dtype="float32", max_model_len=128, page_size=16,
                           max_num_seqs=2, prefill_buckets=(32,),
                           enable_prefix_caching=False)
        eng = InferenceEngine(cfg, device="cpu")
        req = eng.submit([256, 84, 104, 105, 115], SamplingParams(
            max_tokens=6, temperature=0.0, ignore_eos=True))
        for _ in range(200):
            eng.step()
            if req.finish_reason:
                break
        outs.append(list(req.output_tokens))
    assert outs[0] == outs[1] and len(outs[0]) == 6
    assert handler.log and all(a == "Bearer tok" for _, _, a in handler.log)
