"""The port's endpoint picker (``kaito_tpu_torch/runtime/epp.py``) against
the JAX package's, on the CPU.

- Every scenario of ``tests/test_epp.py``'s scoring chain (block size
  from the override, the scrape and the default; affinity owner first
  and a cooling-down backend last; saturation and a tripped breaker
  earning no affinity; the PD filter and KV locality; the index and
  counters fed by responses; the exposition) and of the flag-gated
  scorers (the KV pool's holder score and fetch hints, adapter
  residency, session pins, tenant stickiness and priority) runs through
  both packages: equal candidate orders, scores, counters, headers and
  ``/metrics`` text.
- The operator's side: a TPU InferenceSet's and MRI's pool, picker
  Deployment and Service equal the JAX operator's; a GPU set's pool
  names a picker that runs ``kaito_tpu_torch.runtime.epp`` from the GPU
  image with arguments its ``main`` takes.
- Over two in-process port servers on ``tiny-llama-real``: the
  picker's KV-pool and adapter scrapers read the servers' own
  ``/debug/kv_pool`` and ``/v1/adapters``, and the same repeated-prefix
  load through the round-robin front and through the picker gives the
  picker strictly more prefix-cache hits (every warm request hits).
"""

import importlib
import json
import os
import threading
import types
import urllib.request

import pytest

from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_operator_workspace import (  # noqa: F401 (autouse fixture)
    _offline_fetchers,
    _plain,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pkg(root):
    mods = {"epp": "runtime.epp", "routing": "runtime.routing", "dp": "runtime.dp_router",
            "mric": "controllers.multiroleinference", "manager": "controllers.manager",
            "api": "api", "iset": "api.inferenceset", "mri": "api.multiroleinference",
            "prov": "provision"}
    return types.SimpleNamespace(root=root, **{
        k: importlib.import_module(f"{root}.{m}") for k, m in mods.items()})


JAX, PORT = _pkg("kaito_tpu"), _pkg("kaito_tpu_torch")


def _body(prompt, **extra):
    return json.dumps({"prompt": prompt, **extra}).encode()


def _order(p, picker, ctx, path="/v1/completions"):
    return [b.url for b in picker.candidates("POST", path, ctx)]


# ---------------------------------------------------------------------------
# the scoring chain (tests/test_epp.py:135-267) and the gated scorers
# ---------------------------------------------------------------------------

def e_block_chars(p):
    out = [p.epp.EndpointPicker(["http://a:1", "http://b:1"], block_chars=32).block_chars]
    picker = p.epp.EndpointPicker(["http://a:1", "http://b:1"])
    out.append(picker.block_chars)
    assert out == [32, p.epp.DEFAULT_BLOCK_CHARS]
    picker.backends[0].load.page_size = 64         # the port's default page
    out.append(picker.block_chars)
    assert out[-1] == 256
    return out


def e_affinity_then_dead_last(p):
    picker = p.epp.EndpointPicker(["http://a:1", "http://b:1"], block_chars=8)
    prompt = "affinity-prompt " * 4
    picker.index.record(p.routing.prefix_blocks(prompt, 8), "http://b:1")
    ctx = picker.make_ctx("POST", "/v1/completions", _body(prompt))
    out = [dict(ctx.matched), _order(p, picker, ctx)]
    assert out[-1][0] == "http://b:1"
    picker.backends[1].down_until = 1e18
    ctx = picker.make_ctx("POST", "/v1/completions", _body(prompt))
    out.append(_order(p, picker, ctx))
    assert out[-1] == ["http://a:1", "http://b:1"]
    return out


def e_saturated_or_tripped(p):
    picker = p.epp.EndpointPicker(["http://a:1", "http://b:1"], block_chars=8)
    prompt = "hot shared prefix! " * 4
    picker.index.record(p.routing.prefix_blocks(prompt, 8), "http://a:1")
    ctx = picker.make_ctx("POST", "/v1/completions", _body(prompt))
    a, b = picker.backends
    scores = [(picker._score(a, ctx), picker._score(b, ctx))]
    a.saturated = True
    scores.append((picker._score(a, ctx), picker._score(b, ctx)))
    a.saturated = False
    a.failures = p.routing.BREAKER_THRESHOLD
    scores.append((picker._score(a, ctx), picker._score(b, ctx)))
    a.failures = 0
    assert scores[0][0] > scores[0][1]
    assert scores[1][0] == pytest.approx(scores[1][1]) == scores[2][0]
    a.load.occupancy = 0.95
    p.routing.update_saturation(a)
    ctx = picker.make_ctx("POST", "/v1/completions", _body(prompt))
    order = _order(p, picker, ctx)
    assert order[0] == "http://b:1"
    return scores, order


def e_pd_filter(p):
    picker = p.epp.EndpointPicker(
        [p.routing.Backend("http://p0:1", role="prefill", group="g0"),
         p.routing.Backend("http://d0:1", role="decode", group="g0"),
         p.routing.Backend("http://d1:1", role="decode", group="g1")],
        plugins_config=p.mric.default_pd_plugins_config())
    out = [[t for t, _ in picker.plugins]]
    assert out[0] == ["pd-filter", "kv-locality-scorer", "queue-depth-scorer"]
    ctx = picker.make_ctx("POST", "/v1/completions",
                          _body("x", kv_transfer={"source_url": "http://p0:1/"}))
    out += [(ctx.want_role, ctx.kv_source), _order(p, picker, ctx)]
    assert out[-1] == ["http://d0:1", "http://d1:1"]
    picker.note_response(picker.backends[1], ctx, 200)
    picker.note_response(picker.backends[1], ctx, 200)      # counted once
    out.append(picker.m_pd_steered.value())
    assert out[-1] == 1.0
    ctx = picker.make_ctx("POST", "/pd/prefill", _body("x"))
    out.append(_order(p, picker, ctx, "/pd/prefill"))
    assert out[-1] == ["http://p0:1"]
    return out


def e_note_response(p):
    picker = p.epp.EndpointPicker(["http://a:1", "http://b:1"], block_chars=8)
    prompt = "learned prefix 0123" * 2
    ctx = picker.make_ctx("POST", "/v1/completions", _body(prompt))
    assert ctx.matched == {}
    picker.note_response(picker.backends[0], ctx, 200)
    ctx = picker.make_ctx("POST", "/v1/completions", _body(prompt))
    assert ctx.matched.get("http://a:1") == len(ctx.blocks) > 0
    picker.note_response(picker.backends[0], ctx, 200)
    other = "other prompt ..!" * 2
    picker.note_response(picker.backends[1],
                         picker.make_ctx("POST", "/v1/completions", _body(other)), 500)
    cold = picker.make_ctx("POST", "/v1/completions", _body(other))
    assert cold.matched == {}
    # a draining backend serves but claims no affinity
    picker.set_draining("http://b:1")
    picker.note_response(picker.backends[1], cold, 200)
    drained = picker.make_ctx("POST", "/v1/completions", _body(other))
    return (picker.m_affinity_hits.value(), picker.m_affinity_misses.value(),
            picker.m_picks.value(backend="http://a:1"), drained.matched,
            _order(p, picker, drained), len(picker.index))


def e_exposition(p):
    from kaito_tpu_torch.utils.promtext import check_histograms, parse_exposition

    picker = p.epp.EndpointPicker(["http://a:1", "http://b:1"], block_chars=8)
    picker.note_response(picker.backends[0],
                         picker.make_ctx("POST", "/v1/completions",
                                         _body("expose me " * 3)), 200)
    picker.upstream_latency.observe(0.01, backend="http://a:1")
    picker.m_forwarded.inc(backend="http://a:1")
    text = picker.registry.expose()
    samples = parse_exposition(text)
    check_histograms(samples)
    names = {n for n, _, _ in samples}
    assert {"kaito:epp_picks_total", "kaito:epp_affinity_misses_total",
            "kaito:epp_backend_saturated", "kaito:epp_affinity_index_size",
            "kaito:router_requests_forwarded_total",
            "kaito:router_backend_breaker_state"} <= names
    assert "kv_pool" not in text and "adapter" not in text
    return text


def _pool_advert(blocks, block_chars):
    return {"enabled": True, "page_size": block_chars // 4, "block_chars": block_chars,
            "entries": [{"key": f"k{len(b)}", "n_tokens": len(b) * 16,
                         "blocks": [f"{h:016x}" for h in b]} for b in blocks]}


def e_kv_pool(p):
    a, b = "http://a:1", "http://b:1"
    picker = p.epp.EndpointPicker([a, b], kv_pool=True)
    text = "steering prompt " * 32
    blocks = p.routing.prefix_blocks(text, picker.block_chars)
    picker.pool_index.update(a, _pool_advert([blocks, blocks[:3]], picker.block_chars))
    ctx = picker.make_ctx("POST", "/v1/completions", _body(text))
    ba, bb = picker.backends
    out = [dict(ctx.pool_match), (picker._score(ba, ctx), picker._score(bb, ctx)),
           picker.request_headers(ctx, ba), picker.request_headers(ctx, bb)]
    assert out[-1]["X-Kaito-KV-Fetch"] == a
    ba.saturated = True
    picker.note_response(bb, ctx, 200)
    picker.note_response(ba, ctx, 200)
    out.append((picker.m_pool_fetch.value(), picker.m_pool_route.value()))
    ba.mark_down()
    out.append(picker.request_headers(ctx, bb))
    assert out[-1] == {}
    picker.pool_index.update(a, {"enabled": True, "capped": True,
                                 "block_chars": picker.block_chars, "entries": []})
    out.append(len(picker.pool_index))
    return out + [picker.registry.expose().count("kv_pool")]


def e_adapter_and_session(p):
    a, b = "http://a:1", "http://b:1"
    picker = p.epp.EndpointPicker([a, b], kv_pool=True, adapter_affinity=True,
                                  block_chars=16)
    picker.adapter_index.update(a, {"enabled": True, "resident": [{"name": "style-a"}],
                                    "host_tier": ["style-z"]})
    picker.adapter_index.update(b, {"enabled": True, "resident": [],
                                    "host_tier": ["style-a"]})
    body = json.dumps({"model": "style-a", "prompt": "adapter prompt " * 4}).encode()
    ctx = picker.make_ctx("POST", "/v1/completions", body,
                          headers={"X-Kaito-Session": "conv-1"})
    out = [ctx.adapter, dict(ctx.adapter_residency), ctx.blocks[:2],
           _order(p, picker, ctx)]
    assert ctx.adapter == "style-a" and out[-1][0] == a
    assert ctx.blocks != p.routing.prefix_blocks("adapter prompt " * 4, 16)
    picker.note_response(picker.backends[1], ctx, 200)       # pins conv-1 to b
    ctx2 = picker.make_ctx("POST", "/v1/completions", body,
                           headers={"X-Kaito-Session": "conv-1"})
    out.append(_order(p, picker, ctx2))
    assert out[-1][0] == b
    picker.note_response(picker.backends[1], ctx2, 200)
    out.append((picker.m_adapter_hits.value(), picker.m_adapter_misses.value(),
                picker.m_session_pin_routed.value(), picker.m_session_pin_misses.value()))
    unknown = picker.make_ctx("POST", "/v1/completions",
                              json.dumps({"model": "nope", "prompt": "x" * 32}).encode())
    out.append((unknown.adapter, unknown.blocks == p.routing.prefix_blocks("x" * 32, 16)))
    return out


def e_tenant_priority(p):
    urls = ["http://a:1", "http://b:1", "http://c:1"]
    picker = p.epp.EndpointPicker(urls)
    for b, occ in zip(picker.backends, (0.5, 0.1, 0.3)):
        b.load.occupancy = occ
    out = []
    for tenant, prio in (("acme", ""), ("globex", ""), ("", "guaranteed"), ("", ""),
                         ("acme", "best-effort")):
        hdrs = {"X-Kaito-Tenant": tenant, "X-Kaito-Priority": prio}
        ctx = picker.make_ctx("POST", "/v1/completions", _body("q"), headers=hdrs)
        out.append((ctx.tenant, ctx.priority,
                    [round(picker._score(b, ctx), 12) for b in picker.backends],
                    _order(p, picker, ctx)))
    ctx = picker.make_ctx("POST", "/v1/completions",
                          _body("q", tenant="initech", priority="guaranteed"))
    out.append((ctx.tenant, ctx.priority, _order(p, picker, ctx)))
    return out


SCENARIOS = {"block_chars": e_block_chars, "affinity_then_dead_last": e_affinity_then_dead_last,
             "saturated_or_tripped": e_saturated_or_tripped, "pd_filter": e_pd_filter,
             "note_response": e_note_response, "exposition": e_exposition,
             "kv_pool": e_kv_pool, "adapter_and_session": e_adapter_and_session,
             "tenant_priority": e_tenant_priority}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_picker_scenarios_match_jax(name):
    assert SCENARIOS[name](PORT) == SCENARIOS[name](JAX)


# ---------------------------------------------------------------------------
# the operator renders the picker the pool's extensionRef names
# ---------------------------------------------------------------------------

def _drive(mgr, cloud, n=10):
    for _ in range(n):
        mgr.resync()
        cloud.tick()


def _rendered(store, base):
    pool = store.get("InferencePool", "default", f"{base}-pool")
    ref = pool.spec["extensionRef"]["name"]
    return {"pool": _plain(pool), "deployment": _plain(store.get("Deployment", "default", ref)),
            "service": _plain(store.get("Service", "default", ref))}


def _tpu_set(p, instance="ct5lp-hightpu-1t", preset="phi-4-mini-instruct", replicas=2):
    mgr = p.manager.Manager(feature_gates="gatewayAPIInferenceExtension=true")
    cloud = p.prov.FakeCloud(mgr.store)
    mgr.store.create(p.api.InferenceSet(p.api.ObjectMeta(name="fleet"), p.api.InferenceSetSpec(
        replicas=replicas, template=p.iset.WorkspaceTemplate(
            resource=p.api.ResourceSpec(instance_type=instance),
            inference=p.api.InferenceSpec(preset=preset)))))
    _drive(mgr, cloud)
    return mgr


def _tpu_mri(p):
    mgr = p.manager.Manager(feature_gates="enableMultiRoleInferenceController=true,"
                                          "gatewayAPIInferenceExtension=true")
    cloud = p.prov.FakeCloud(mgr.store)
    mgr.store.create(p.api.MultiRoleInference(p.api.ObjectMeta(name="pd"),
                                              p.mri.MultiRoleInferenceSpec(
        model=p.mri.MRIModelSpec(name="phi-4-mini-instruct"),
        roles=[p.mri.RoleSpec(type="prefill", replicas=1, instance_type="ct5lp-hightpu-1t"),
               p.mri.RoleSpec(type="decode", replicas=2,
                              instance_type="ct5lp-hightpu-1t")])))
    _drive(mgr, cloud, 12)
    return mgr


@pytest.mark.parametrize("kind", ["inferenceset", "mri"])
def test_tpu_extension_ref_renders_the_jax_picker(kind):
    build, base = (_tpu_set, "fleet") if kind == "inferenceset" else (_tpu_mri, "pd")
    want, got = _rendered(build(JAX).store, base), _rendered(build(PORT).store, base)
    assert got == want
    cmd = got["deployment"]["spec"]["template"]["spec"]["containers"][0]["command"]
    assert cmd[:3] == ["python", "-m", "kaito_tpu.runtime.epp"]
    assert cmd.count("--backend") == (2 if kind == "inferenceset" else 3)


def test_gpu_extension_ref_resolves_to_the_ports_picker(monkeypatch):
    """A GPU set's pool names ``<set>-epp``; that Deployment runs the
    port's picker from the GPU image, and its command, handed to the
    port's ``epp.main``, builds a picker over the set's replicas."""
    from kaito_tpu_torch.runtime import epp

    mgr = _tpu_set(PORT, "a3-highgpu-1g", "llama-3.1-8b-instruct", replicas=2)
    got = _rendered(mgr.store, "fleet")
    assert got["pool"]["spec"]["extensionRef"]["name"] == "fleet-epp"
    c = got["deployment"]["spec"]["template"]["spec"]["containers"][0]
    assert c["command"][:3] == ["python", "-m", "kaito_tpu_torch.runtime.epp"]
    assert c["image"] == "ghcr.io/kaito-tpu/engine-cuda:latest"
    assert got["service"]["spec"]["ports"][0]["port"] == 5000
    seen = {}

    def fake_server(core, host, port, **kw):
        seen.update(picker=core, port=port, **kw)
        return types.SimpleNamespace(serve_forever=lambda: None, server_address=(host, port))

    monkeypatch.setattr(epp, "make_routing_server", fake_server)
    monkeypatch.setattr(epp.signal, "signal", lambda *a: None)
    epp.main(c["command"][3:])
    assert [b.url for b in seen["picker"].backends] == ["http://fleet-0:5000",
                                                        "http://fleet-1:5000"]
    assert seen["port"] == 5000 and seen["probe_interval_s"] == 2.0


# ---------------------------------------------------------------------------
# two in-process port servers on tiny-llama-real
# ---------------------------------------------------------------------------

def _post(url, path, body, headers=None):
    req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    return json.loads(urllib.request.urlopen(req, timeout=240).read())


def _counter(url, name):
    text = urllib.request.urlopen(url + "/metrics", timeout=30).read().decode()
    return sum(float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
               if ln.startswith(name + " ") or ln.startswith(name + "{"))


@pytest.fixture(scope="module")
def replicas(tmp_path_factory):
    from kaito_tpu.models import get_model_by_name as jax_model
    from kaito_tpu_torch.engine.config import EngineConfig
    from kaito_tpu_torch.engine.engine import InferenceEngine
    from kaito_tpu_torch.engine.server import make_server
    from tests.helpers.lora_adapters import make_adapter

    art = tmp_path_factory.mktemp("lora")
    make_adapter(art / "style-a", jax_model("tiny-llama-real").arch, seed=31, r=4,
                 base="tiny-llama-real")
    cfg = EngineConfig(model="tiny-llama-real",
                       weights_dir=os.path.join(REPO, "checkpoints", "tiny-llama-real"),
                       max_model_len=512, page_size=16, max_num_seqs=2, dtype="float32",
                       kv_dtype="float32", prefill_buckets=(64, 128, 256, 512), seed=0,
                       kv_pool_enabled=True, adapter_slots=1, adapter_rmax=4)
    served = []
    for _ in range(2):
        eng = InferenceEngine(cfg, device="cpu")
        eng.start()
        srv = make_server(eng, cfg, host="127.0.0.1", port=0, device="cpu")
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        served.append((eng, srv, f"http://127.0.0.1:{srv.server_address[1]}"))
    yield [u for _, _, u in served], str(art / "style-a")
    for eng, srv, _ in served:
        srv.shutdown()
        srv.server_close()
        eng.stop()


def test_scrapers_read_the_port_servers_adverts(replicas):
    """The KV-pool and adapter scrapers on the servers' own routes: a
    published prefix and a loaded adapter land in the picker's indices,
    and steer a request to the holder."""
    urls, adapter = replicas
    picker = PORT.epp.EndpointPicker(urls, kv_pool=True, adapter_affinity=True)
    prompt = "".join(chr(97 + (i * 5) % 26) for i in range(300))
    _post(urls[0], "/v1/completions", {"prompt": prompt, "max_tokens": 1,
                                       "temperature": 0.0})
    _post(urls[1], "/v1/adapters", {"name": "style-a", "source": adapter})
    load = PORT.routing.MetricsScraper(picker)
    pools = PORT.epp.KVPoolScraper(picker)
    adapters = PORT.epp.AdapterScraper(picker)
    for b in picker.backends:
        load.poll_one(b)
        pools.poll_one(b)
        adapters.poll_one(b)
    assert picker.block_chars == 16 * PORT.epp.CHARS_PER_TOKEN
    assert len(picker.pool_index) > 0
    ctx = picker.make_ctx("POST", "/v1/completions", _body(prompt + " more"))
    assert urls[0] in ctx.pool_match and urls[1] not in ctx.pool_match
    assert picker.request_headers(ctx, picker.backends[1])["X-Kaito-KV-Fetch"] == urls[0]
    assert picker.adapter_index.residency("style-a") == {urls[1]: 1.0}
    ctx = picker.make_ctx("POST", "/v1/completions",
                          json.dumps({"model": "style-a", "prompt": "hi"}).encode())
    assert [b.url for b in picker.candidates("POST", "/v1/completions", ctx)][0] == urls[1]


def _prefix(seed, chars):
    import random

    rng = random.Random(seed)
    return "".join(rng.choice("abcdefghijklmnopqrstuvwxyz ") for _ in range(chars))


def _leg(front, urls, seed_base, groups=4):
    """``groups`` prefix groups of a cold then a warm request; the
    prefix-cache hits across both replicas."""
    hits0 = sum(_counter(u, "kaito:prefix_cache_hits_total") for u in urls)
    for g in range(groups):
        # 384 chars = 24 pages of 16 tokens = 6 blocks of 64 chars
        prefix = _prefix(seed_base + g, 384)
        for tail in ("cold", "warm"):
            _post(front, "/v1/completions", {"prompt": f"{prefix} {tail} tail {g}",
                                             "max_tokens": 2, "temperature": 0.0})
    return sum(_counter(u, "kaito:prefix_cache_hits_total") for u in urls) - hits0


def test_picker_beats_round_robin_on_prefix_hits(replicas):
    """The same repeated-prefix load over the same two replicas: round
    robin sends each group's warm request to the other replica (a
    miss), the picker to the one holding the prefix (a hit)."""
    urls, _ = replicas
    rr = PORT.dp.DPRouter(urls)
    srv = PORT.routing.make_routing_server(rr, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        rr_hits = _leg(f"http://127.0.0.1:{srv.server_address[1]}", urls, 1000)
    finally:
        srv.shutdown()
        srv.server_close()
    picker = PORT.epp.EndpointPicker(urls)
    srv = PORT.routing.make_routing_server(picker, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        epp_hits = _leg(f"http://127.0.0.1:{srv.server_address[1]}", urls, 2000)
    finally:
        srv.shutdown()
        srv.server_close()
    assert rr_hits == 0 and epp_hits == 4, (rr_hits, epp_hits)
    assert picker.m_affinity_hits.value() == 4 and picker.m_affinity_misses.value() == 4
