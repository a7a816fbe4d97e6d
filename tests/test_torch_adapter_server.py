"""The port's multi-LoRA HTTP surface against the JAX server's answers
(``tiny-llama-real``, its checkpoint in both, fp32, greedy; the same
adapter artifacts; ``--adapter-slots 2`` with a host tier).

- ``/v1/adapters``: GET's snapshot, POST's hot-load (200 with the slot),
  its refusals (400 for a missing field, a bad name, an unknown scheme
  or a missing directory; 403 for a remote source outside the
  allowlist; 422 ``adapter_load_error`` for a rank over rmax or another
  base; 409 while in-flight work pins the adapter) and DELETE (200,
  404 for an unknown name); the same status and error type on both.
- Completions: the ``model`` field selects an adapter (the same
  choices as the JAX server's), an unknown model answers 404, the
  ``X-Kaito-Tenant`` header selects the QoS document's adapter for the
  tenant (503 ``adapter_unavailable`` while it is not loaded).
- ``/v1/models`` lists the base and the adapters resident or in the
  host tier; every ``kaito:adapter_*`` line equals the JAX server's.
- With the cache off: GET/POST/DELETE ``/v1/adapters`` answer 403, and
  ``/metrics`` has no ``kaito:adapter_*`` line.
- ``hub://`` passes the allowlist, then answers 502 naming the failed
  pull when the hub has no such snapshot (an offline, empty cache); the
  six ``--adapter*`` flags reach the config.
"""

import json
import os
import pathlib
import threading
import urllib.error
import urllib.request

import pytest

from kaito_tpu.engine.config import EngineConfig as JaxConfig
from kaito_tpu.engine.engine import InferenceEngine as JaxEngine
from kaito_tpu.engine.server import make_server as jax_make_server
from kaito_tpu.models import get_model_by_name as jax_model
from kaito_tpu_torch.engine.config import EngineConfig
from kaito_tpu_torch.engine.engine import InferenceEngine
from kaito_tpu_torch.engine.server import make_server, parse_args
from tests.helpers.hub_cache import offline_hub
from tests.helpers.lora_adapters import make_adapter
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QOS = json.dumps({"classes": {"std": {}},
                  "adapters": {"acme": "style-a", "globex": "style-z"}})
CFG = dict(model="tiny-llama-real",
           weights_dir=os.path.join(REPO, "checkpoints", "tiny-llama-real"),
           max_model_len=256, page_size=16, max_num_seqs=4, dtype="float32",
           kv_dtype="float32", prefill_buckets=(32, 64, 128), seed=0,
           enable_prefix_caching=False, adapter_slots=2, adapter_rmax=8,
           adapter_host_bytes=64 << 20, adapter_source_allowlist="hub://acme/",
           qos_config=QOS)
GREEDY = dict(prompt="the cat sat on the", max_tokens=12, temperature=0.0)


def _call(url, body=None, method=None, headers=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


class _Served:
    def __init__(self, server, engine):
        self.server, self.engine = server, engine
        self.base = f"http://127.0.0.1:{server.server_address[1]}"
        self.thread = threading.Thread(target=server.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.engine.stop()
        self.thread.join(timeout=10)


def _pair(cfg):
    jeng = JaxEngine(JaxConfig(**cfg))
    jeng.start()
    teng = InferenceEngine(EngineConfig(**cfg), device="cpu")
    teng.start()
    return (_Served(jax_make_server(jeng, JaxConfig(**cfg), host="127.0.0.1", port=0),
                    jeng),
            _Served(make_server(teng, EngineConfig(**cfg), host="127.0.0.1", port=0,
                                device="cpu"), teng))


def _answer(status, raw):
    body = json.loads(raw)
    if status != 200:
        return status, body["error"]["type"]
    if "choices" in body:
        return status, [c["text"] for c in body["choices"]], body["model"]
    return status, body


def _adapter_lines(text):
    return sorted(ln for ln in text.splitlines() if "kaito:adapter_" in ln)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    arch = jax_model("tiny-llama-real").arch
    root = tmp_path_factory.mktemp("lora")
    make_adapter(root / "a", arch, seed=31, r=4, alpha=6, base="tiny-llama-real",
                 scale=4.0)
    make_adapter(root / "b", arch, seed=32, r=8, alpha=8, base="tiny-llama-real",
                 scale=4.0)
    make_adapter(root / "c", arch, seed=33, r=2, alpha=4, base="tiny-llama-real",
                 targets=("q", "v"), scale=4.0)
    make_adapter(root / "wide", arch, seed=34, r=16, base="tiny-llama-real")
    make_adapter(root / "other", arch, seed=35, r=4, base="tiny-llama-test")
    return root


def _script(root):
    """(name, method, path, body, headers), run in order on both servers."""
    post = "/v1/adapters"
    cmpl = "/v1/completions"
    return [
        ("get-empty", "GET", post, None, None),
        ("models-empty", "GET", "/v1/models", None, None),
        ("tenant-unloaded", "POST", cmpl, GREEDY, {"X-Kaito-Tenant": "acme"}),
        ("load-a", "POST", post, {"name": "style-a", "source": str(root / "a")}, None),
        ("load-b", "POST", post, {"name": "style-b", "source": f"path://{root / 'b'}"},
         None),
        ("no-source", "POST", post, {"name": "x"}, None),
        ("bad-name", "POST", post, {"name": "bad name!", "source": str(root / "a")}, None),
        ("bad-scheme", "POST", post, {"name": "x", "source": "s3://bucket/x"}, None),
        ("missing-dir", "POST", post, {"name": "x", "source": str(root / "nope")}, None),
        ("not-allowlisted", "POST", post, {"name": "x", "source": "oras://reg/x:1"},
         None),
        ("rank-overflow", "POST", post, {"name": "wide", "source": str(root / "wide")},
         None),
        ("base-mismatch", "POST", post, {"name": "other", "source": str(root / "other")},
         None),
        ("base", "POST", cmpl, GREEDY, None),
        ("base-named", "POST", cmpl, dict(GREEDY, model="tiny-llama-real"), None),
        ("model-a", "POST", cmpl, dict(GREEDY, model="style-a"), None),
        ("model-b", "POST", cmpl, dict(GREEDY, model="style-b"), None),
        ("unknown-model", "POST", cmpl, dict(GREEDY, model="style-q"), None),
        ("tenant-a", "POST", cmpl, GREEDY, {"X-Kaito-Tenant": "acme"}),
        ("tenant-missing", "POST", cmpl, GREEDY, {"X-Kaito-Tenant": "globex"}),
        ("model-wins", "POST", cmpl, dict(GREEDY, model="style-b"),
         {"X-Kaito-Tenant": "acme"}),
        # a third adapter evicts style-a (least recent) to the host tier
        ("load-c", "POST", post, {"name": "style-c", "source": str(root / "c")}, None),
        ("models-three", "GET", "/v1/models", None, None),
        ("get-three", "GET", post, None, None),
        ("fault-a", "POST", cmpl, dict(GREEDY, model="style-a"), None),
        ("busy", "DELETE", f"{post}/style-c", None, None),
        ("delete-c", "DELETE", f"{post}/style-c", None, None),
        ("delete-again", "DELETE", f"{post}/style-c", None, None),
        ("deleted-model", "POST", cmpl, dict(GREEDY, model="style-c"), None),
        ("get-end", "GET", post, None, None),
    ]


def _run(srv, root):
    out = {}
    for name, method, path, body, headers in _script(root):
        pin = name == "busy"
        if pin:
            srv.engine.adapter_cache.busy_fn = lambda n: True
        try:
            out[name] = _answer(*_call(srv.base + path, body, method, headers))
        finally:
            if pin:
                srv.engine.adapter_cache.busy_fn = srv.engine._adapter_busy
    out["metrics"] = _adapter_lines(_call(srv.base + "/metrics")[1])
    return out


@pytest.fixture(scope="module")
def answers(artifacts):
    jsrv, tsrv = _pair(CFG)
    try:
        return {"jax": _run(jsrv, artifacts), "torch": _run(tsrv, artifacts)}
    finally:
        jsrv.close()
        tsrv.close()


@pytest.mark.parametrize("name", [s[0] for s in _script(pathlib.Path(REPO))])
def test_same_answers_as_jax(answers, name):
    assert answers["torch"][name] == answers["jax"][name]


def test_statuses_and_routing(answers):
    got = answers["torch"]
    codes = {k: v[0] for k, v in got.items() if k != "metrics"}
    assert codes["load-a"] == codes["load-b"] == codes["load-c"] == 200
    assert codes["no-source"] == codes["bad-name"] == codes["bad-scheme"] == 400
    assert codes["missing-dir"] == 400 and codes["not-allowlisted"] == 403
    assert got["rank-overflow"] == (422, "adapter_load_error")
    assert got["base-mismatch"] == (422, "adapter_load_error")
    assert got["tenant-unloaded"] == (503, "adapter_unavailable")
    assert got["tenant-missing"] == (503, "adapter_unavailable")
    assert codes["unknown-model"] == codes["delete-again"] == 404
    assert codes["deleted-model"] == 404 and codes["busy"] == 409
    assert codes["delete-c"] == 200
    # the adapters change the text; the tenant's is the model field's
    assert got["model-a"][1] != got["base"][1] != got["model-b"][1]
    assert got["base-named"][1] == got["base"][1]
    assert got["tenant-a"][1] == got["model-a"][1] == got["fault-a"][1]
    assert got["model-wins"][1] == got["model-b"][1]
    ids = [m["id"] for m in got["models-three"][1]["data"]]
    assert ids == ["tiny-llama-real", "style-a", "style-b", "style-c"]
    snap = got["get-three"][1]
    assert [e["name"] for e in snap["resident"]] == ["style-c", "style-b"]
    assert snap["host_tier"] == ["style-a"]
    assert got["get-end"][1]["load_failures"] == {"rank_overflow": 1,
                                                  "base_mismatch": 1}
    assert any(ln.startswith("kaito:adapter_faults_total 1") for ln in got["metrics"])


def test_cache_off_answers_403(artifacts):
    cfg = {**CFG, "adapter_slots": 0, "qos_config": ""}
    eng = InferenceEngine(EngineConfig(**cfg), device="cpu")
    eng.start()
    srv = _Served(make_server(eng, EngineConfig(**cfg), host="127.0.0.1", port=0,
                              device="cpu"), eng)
    try:
        assert _call(srv.base + "/v1/adapters")[0] == 403
        assert _call(srv.base + "/v1/adapters", {"name": "a", "source": str(
            artifacts / "a")})[0] == 403
        assert _call(srv.base + "/v1/adapters/a", method="DELETE")[0] == 403
        assert _adapter_lines(_call(srv.base + "/metrics")[1]) == []
        assert [m["id"] for m in json.loads(_call(srv.base + "/v1/models")[1])["data"]] \
            == ["tiny-llama-real"]
    finally:
        srv.close()


def test_hub_source_names_its_queue_item(artifacts, monkeypatch, tmp_path):
    offline_hub(monkeypatch, tmp_path / "hub")
    eng = InferenceEngine(EngineConfig(**{**CFG, "qos_config": ""}), device="cpu")
    eng.start()
    srv = _Served(make_server(eng, EngineConfig(**{**CFG, "qos_config": ""}),
                              host="127.0.0.1", port=0, device="cpu"), eng)
    try:
        status, raw = _call(srv.base + "/v1/adapters",
                            {"name": "h", "source": "hub://acme/lora"})
        assert status == 502 and "adapter pull from hub://acme/lora failed" in raw
        assert _call(srv.base + "/v1/adapters",
                     {"name": "h", "source": "hub://other/lora"})[0] == 403
    finally:
        srv.close()


def test_adapter_flags_reach_the_config():
    cfg, _ = parse_args(["--kaito-adapters-dir", "/ad", "--adapter-slots", "3",
                         "--adapter-rmax", "32", "--adapter-host-bytes", "1024",
                         "--adapter-allow-base-mismatch",
                         "--adapter-source-allowlist", "hub://a/,oras://r/"])
    assert (cfg.adapters_dir, cfg.adapter_slots, cfg.adapter_rmax,
            cfg.adapter_host_bytes, cfg.adapter_allow_base_mismatch,
            cfg.adapter_source_allowlist) == ("/ad", 3, 32, 1024, True,
                                              "hub://a/,oras://r/")
    cfg, _ = parse_args([])
    assert cfg.adapter_slots == 0 and cfg.adapters_dir == ""
