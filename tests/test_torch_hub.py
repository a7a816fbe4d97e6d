"""The port's hub fetcher and catalog against the JAX package's.

Each id of the committed catalog resolves, through the port's registry
after ``install_default_fetcher``, to the metadata the JAX registry
gives it with the JAX fetcher, field by field.  ``fetch_hf_config`` runs
against a local HTTP server (``HUB_URL`` pointed at it): the token
header, 401/403/404 answered with one request, 5xx retried,
``HF_HUB_OFFLINE``, and ``default_config_fetcher``'s negative cache.
No test here touches the network.
"""

import dataclasses
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

import kaito_tpu.models.hub as jax_hub
import kaito_tpu.models.registry as jax_registry
import kaito_tpu_torch.models.hub as hub
import kaito_tpu_torch.models.registry as port_registry
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CATALOG_IDS = ("TinyLlama/TinyLlama-1.1B-Chat-v1.0", "Qwen/Qwen2.5-0.5B-Instruct",
               "Qwen/Qwen2.5-1.5B-Instruct", "mistralai/Mixtral-8x7B-Instruct-v0.1")
CONFIG = {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
          "vocab_size": 1000, "hidden_size": 256, "intermediate_size": 512,
          "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
          "max_position_embeddings": 1024, "rms_norm_eps": 1e-5}


@pytest.fixture(autouse=True)
def _offline_and_own_state(monkeypatch):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    for var in ("HF_TOKEN", "HUGGING_FACE_HUB_TOKEN"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(port_registry, "_config_fetcher", port_registry._config_fetcher)
    monkeypatch.setattr(jax_registry, "_config_fetcher", jax_registry._config_fetcher)
    monkeypatch.setattr(hub, "_neg_cache", {})
    monkeypatch.setattr(jax_hub, "_neg_cache", {})
    monkeypatch.setattr(hub.time, "sleep", lambda s: None)


def test_the_catalog_is_the_jax_packages():
    with open(hub._CATALOG_PATH) as f, open(jax_hub._CATALOG_PATH) as g:
        assert json.load(f) == json.load(g)
    assert set(CATALOG_IDS) == {k for k in json.load(open(hub._CATALOG_PATH))
                                if not k.startswith("_")}


@pytest.mark.parametrize("hf_id", CATALOG_IDS)
def test_catalog_ids_resolve_to_the_jax_metadata(hf_id):
    hub.install_default_fetcher()
    jax_hub.install_default_fetcher()
    got = dataclasses.asdict(port_registry.get_model_by_name(hf_id))
    want = dataclasses.asdict(jax_registry.get_model_by_name(hf_id))
    assert set(got) == set(want)
    for name in want:
        assert got[name] == want[name], name
    assert got["name"] == hf_id
    # the lookup is case-insensitive, as the JAX catalog's
    assert hub.catalog_config(hf_id.upper()) == jax_hub.catalog_config(hf_id)


def test_without_the_fetcher_an_org_model_id_is_unknown():
    port_registry.set_config_fetcher(None)
    with pytest.raises(KeyError, match="no config fetcher"):
        port_registry.get_model_by_name("acme/not-in-the-catalog")


class _Hub(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    statuses: list = []        # answered in order; 200 once they run out
    seen: list = []            # (path, Authorization header)

    def log_message(self, *a):
        pass

    def do_GET(self):
        type(self).seen.append((self.path, self.headers.get("Authorization")))
        code = type(self).statuses.pop(0) if type(self).statuses else 200
        body = json.dumps(CONFIG if code == 200 else {"error": code}).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


@pytest.fixture
def local_hub(monkeypatch):
    handler = type("Hub", (_Hub,), {"statuses": [], "seen": []})
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/{{hf_id}}/resolve/main/config.json"
    monkeypatch.setattr(hub, "HUB_URL", url)
    monkeypatch.setattr(jax_hub, "HUB_URL", url)
    monkeypatch.delenv("HF_HUB_OFFLINE")
    yield handler
    srv.shutdown()
    srv.server_close()
    th.join(timeout=10)


@pytest.mark.parametrize("var", ["HF_TOKEN", "HUGGING_FACE_HUB_TOKEN", None])
def test_fetch_sends_the_token(local_hub, monkeypatch, var):
    if var:
        monkeypatch.setenv(var, "secret-" + var)
    assert hub.fetch_hf_config("acme/m") == CONFIG
    assert jax_hub.fetch_hf_config("acme/m") == CONFIG
    (p1, a1), (p2, a2) = local_hub.seen
    assert p1 == p2 == "/acme/m/resolve/main/config.json"
    assert a1 == a2 == (f"Bearer secret-{var}" if var else None)


def test_hf_token_wins_over_the_older_name(local_hub, monkeypatch):
    monkeypatch.setenv("HF_TOKEN", "new")
    monkeypatch.setenv("HUGGING_FACE_HUB_TOKEN", "old")
    hub.fetch_hf_config("acme/m")
    assert local_hub.seen[0][1] == "Bearer new"


@pytest.mark.parametrize("code", [401, 403, 404])
def test_auth_and_missing_are_final(local_hub, code):
    local_hub.statuses[:] = [code, code, code]
    assert hub.fetch_hf_config("acme/m") is None
    assert len(local_hub.seen) == 1


@pytest.mark.parametrize("fails", [1, 2])
def test_server_errors_are_retried(local_hub, fails):
    local_hub.statuses[:] = [503] * fails
    assert hub.fetch_hf_config("acme/m") == CONFIG
    assert len(local_hub.seen) == fails + 1


def test_retries_are_bounded(local_hub):
    local_hub.statuses[:] = [500] * 10
    assert hub.fetch_hf_config("acme/m", retries=3) is None
    assert len(local_hub.seen) == 3
    local_hub.statuses[:] = [500] * 10
    local_hub.seen.clear()
    assert jax_hub.fetch_hf_config("acme/m", retries=3) is None
    assert len(local_hub.seen) == 3


@pytest.mark.parametrize("value,fetches", [("1", False), ("true", False), ("0", True)])
def test_offline_fetches_nothing(local_hub, monkeypatch, value, fetches):
    monkeypatch.setenv("HF_HUB_OFFLINE", value)
    got = hub.fetch_hf_config("acme/m")
    assert got == (CONFIG if fetches else None)
    assert got == jax_hub.fetch_hf_config("acme/m")
    assert len(local_hub.seen) == (2 if fetches else 0)


def test_catalog_ids_never_reach_the_hub(local_hub):
    for hf_id in CATALOG_IDS:
        assert hub.default_config_fetcher(hf_id) == hub.catalog_config(hf_id)
    assert local_hub.seen == []


def test_negative_cache(local_hub, monkeypatch):
    now = [1000.0]
    monkeypatch.setattr(hub.time, "monotonic", lambda: now[0])
    local_hub.statuses[:] = [404, 404]
    assert hub.default_config_fetcher("acme/typo") is None
    assert hub.default_config_fetcher("ACME/Typo") is None   # cached, any case
    assert len(local_hub.seen) == 1
    now[0] += hub._NEG_TTL_S - 1
    assert hub.default_config_fetcher("acme/typo") is None
    assert len(local_hub.seen) == 1
    now[0] += 2                                                # past the TTL
    assert hub.default_config_fetcher("acme/typo") is None
    assert len(local_hub.seen) == 2
    # a success is not cached as a failure
    assert hub.default_config_fetcher("acme/other") == CONFIG
    assert hub.default_config_fetcher("acme/other") == CONFIG
    assert len(local_hub.seen) == 4


def test_fetched_config_becomes_a_preset(local_hub):
    hub.install_default_fetcher()
    jax_hub.install_default_fetcher()
    got = dataclasses.asdict(port_registry.get_model_by_name("acme/small-llama"))
    want = dataclasses.asdict(jax_registry.get_model_by_name("acme/small-llama"))
    assert got == want
    assert got["arch"]["num_layers"] == 2
