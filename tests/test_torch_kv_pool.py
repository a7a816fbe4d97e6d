"""The port's cluster KV pool (``kaito_tpu_torch.engine.kv_pool``,
``runtime/routing.py``) against the JAX package's.

The hashes: the chained FNV-1a prefix blocks, their adapter seed and the
prompt text they are taken over equal the JAX functions' bit for bit,
and so do ``prompt_pool_blocks`` and ``pool_key`` over page sizes; the
store's LRU, ``common_prefix_pages`` and ``HostExport``'s chunks equal
the JAX ones.  Served on the CPU (``tiny-llama-real`` in fp32): a
prompt a JAX server published is fetched by the port's server through
the router's ``X-Kaito-KV-Fetch`` headers, and one the port published
by another port server, both giving the publisher's greedy tokens
(the JAX engine's); a fetch from a dead holder recomputes; with the
pool off the server is invisible (403s and no new ``/metrics`` lines
against the JAX server's families).
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from kaito_tpu.engine import kv_pool as jkp
from kaito_tpu.engine.config import EngineConfig as JaxConfig
from kaito_tpu.engine.engine import InferenceEngine as JaxEngine
from kaito_tpu.engine.server import make_server as jax_make_server
from kaito_tpu.runtime import routing as jrouting
from kaito_tpu_torch.engine import kv_pool as kp
from kaito_tpu_torch.engine.config import EngineConfig
from kaito_tpu_torch.engine.engine import InferenceEngine
from kaito_tpu_torch.engine.server import make_server
from kaito_tpu_torch.runtime import routing
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REAL = dict(model="tiny-llama-real", weights_dir="checkpoints/tiny-llama-real",
            max_model_len=256, page_size=16, max_num_seqs=2, dtype="float32",
            kv_dtype="float32", prefill_buckets=(64, 128), seed=0)
TEXTS = ["", "a", "hello world " * 40, "ünïcödé ✓ " * 30,
         "x" * 255 + "y" * 257, "the pool hashes whole blocks only" * 9]


@pytest.mark.parametrize("text", TEXTS)
@pytest.mark.parametrize("page_size", [1, 8, 16, 64, 128])
@pytest.mark.parametrize("adapter", ["", "tenant-lora"])
def test_prompt_pool_blocks_equal_the_jax_function(text, page_size, adapter):
    got = kp.prompt_pool_blocks(text, page_size, adapter=adapter)
    assert got == jkp.prompt_pool_blocks(text, page_size, adapter=adapter)
    if got:
        assert kp.pool_key(got) == jkp.pool_key(got)
    assert routing.prefix_blocks(text, 7, seed=3) == jrouting.prefix_blocks(text, 7, seed=3)


@pytest.mark.parametrize("body", [
    {"prompt": "plain"}, {"messages": [{"role": "user", "content": "hi"},
                                       {"role": "assistant", "content": "yo"}]},
    {"messages": ["bad", {"role": "system"}]}, {}, "not a dict"])
def test_extract_prompt_text_equals_the_jax_function(body):
    assert routing.extract_prompt_text(body) == jrouting.extract_prompt_text(body)
    assert routing.adapter_seed("a") == jrouting.adapter_seed("a")


@pytest.mark.parametrize("req,entry,ps", [
    (list(range(40)), list(range(40)), 16), (list(range(40)), list(range(32)), 16),
    (list(range(33)), list(range(48)), 16), ([1, 2, 3, 9], [1, 2, 3, 4], 2),
    ([], [1], 4), (list(range(64)), list(range(64)), 64)])
def test_common_prefix_pages_equal_the_jax_function(req, entry, ps):
    assert kp.common_prefix_pages(req, entry, ps) == jkp.common_prefix_pages(req, entry, ps)


def test_host_export_chunks_equal_the_jax_writer():
    rng = np.random.default_rng(3)
    shape = (3, 5, 16, 2, 8)
    k = rng.integers(-127, 128, shape, np.int8)
    v = rng.integers(-127, 128, shape, np.int8)
    ks, vs = rng.random((3, 5, 2), np.float32), rng.random((3, 5, 2), np.float32)
    toks = list(range(80))
    want = jkp.HostExport(k, v, ks, vs, n_tokens=80, model="m", prompt_tokens=toks)
    got = kp.HostExport(*(torch.from_numpy(a) for a in (k, v, ks, vs)), n_tokens=80,
                        model="m", prompt_tokens=toks)
    assert got.meta == want.meta and got.n_chunks == want.n_chunks
    assert all(got.get_chunk(i) == want.get_chunk(i) for i in range(got.n_chunks))
    assert kp.meta_nbytes(got.meta) == jkp.meta_nbytes(want.meta)


def test_store_lru_matches_the_jax_store():
    def entry(mod, key, nbytes):
        return mod.PoolEntry(key=key, blocks=[1], n_tokens=4, n_pages=1, export=None,
                             nbytes=nbytes)

    stores = [kp.PrefixPageStore(100), jkp.PrefixPageStore(100)]
    evicted = [[], []]
    for s, ev in zip(stores, evicted):
        s.on_evict = lambda e, ev=ev: ev.append(e.key)
    for mod, s in zip((kp, jkp), stores):
        for key, n in (("a", 40), ("b", 40), ("c", 30), ("d", 50), ("e", 200)):
            s.put(entry(mod, key, n))
        s.get("c")
        s.put(entry(mod, "f", 60))
        s.get("zz")
    a, b = stores
    assert list(a._entries) == list(b._entries) and evicted[0] == evicted[1]
    assert (a.used_bytes, a.hits_total, a.misses_total, a.evictions_total,
            a.published_total) == (b.used_bytes, b.hits_total, b.misses_total,
                                   b.evictions_total, b.published_total)
    assert a.advert() == b.advert() and a.advert(1) == b.advert(1)


# ---------------------------------------------------------------------------
# served
# ---------------------------------------------------------------------------

class _Served:
    def __init__(self, engine, server):
        self.engine, self.server = engine, server
        self.base = f"http://127.0.0.1:{server.server_address[1]}"
        threading.Thread(target=server.serve_forever, daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.engine.stop()


def _port(**kw):
    cfg = EngineConfig(**{**REAL, **kw})
    eng = InferenceEngine(cfg, device="cpu")
    eng.start()
    return _Served(eng, make_server(eng, cfg, host="127.0.0.1", port=0, device="cpu"))


def _jax(**kw):
    cfg = JaxConfig(**{**REAL, **kw})
    eng = JaxEngine(cfg)
    eng.start()
    return _Served(eng, jax_make_server(eng, cfg, host="127.0.0.1", port=0))


def _call(url, body=None, headers=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _complete(srv, prompt, n=6, headers=None):
    status, raw = _call(srv.base + "/v1/completions", dict(
        prompt=prompt, max_tokens=n, temperature=0.0, ignore_eos=True), headers)
    assert status == 200, raw
    return json.loads(raw)["choices"][0]["text"]


@pytest.fixture(scope="module")
def pools():
    j, a, b = _jax(kv_pool_enabled=True), _port(kv_pool_enabled=True), \
        _port(kv_pool_enabled=True)
    yield j, a, b
    for s in (j, a, b):
        s.close()


@pytest.mark.parametrize("publisher", ["jax", "port"])
def test_publish_fetch_import_gives_the_publishers_tokens(pools, publisher):
    """The publisher computes the prompt; the fetcher imports its whole
    pages over the chunked wire, prefills the rest and gives the same
    greedy text, then holds the prefix in its own store."""
    j, a, b = pools
    src = j if publisher == "jax" else a
    prompt = f"cluster pool parity from the {publisher} publisher " * 5
    want = _complete(src, prompt)
    status, raw = _call(src.base + "/debug/kv_pool")
    adv = json.loads(raw)
    assert status == 200 and adv["enabled"] and adv["page_size"] == 16
    key = kp.pool_key(kp.prompt_pool_blocks(prompt, 16))
    assert key in [e["key"] for e in adv["entries"]]
    c = b.engine.counters
    before = (c["kv_pool_fetches_total"], c["kv_pool_fetched_tokens_total"])
    got = _complete(b, prompt, headers={"X-Kaito-KV-Fetch": src.base,
                                        "X-Kaito-KV-Fetch-Key": key})
    assert got == want
    assert c["kv_pool_fetches_total"] == before[0] + 1
    fetched = c["kv_pool_fetched_tokens_total"] - before[1]
    assert fetched > 0 and fetched % 16 == 0
    assert b.engine.kv_pool.has(key)
    # a second fetcher takes it from the port's replica (the pool heals)
    status, raw = _call(f"{b.base}/kv_pool/{key}/meta")
    assert status == 200 and json.loads(raw)["prompt_tokens"][:5] == \
        b.engine.tokenizer.encode(prompt)[:5]


def test_fetch_failure_falls_back_to_local_recompute(pools):
    _, a, b = pools
    prompt = "a dead holder named by the router " * 5
    want = _complete(a, prompt)
    c = b.engine.counters
    f0 = c["kv_pool_fetches_total"]
    got = _complete(b, prompt, headers={"X-Kaito-KV-Fetch": "http://127.0.0.1:9",
                                        "X-Kaito-KV-Fetch-Key": "feedfacefeedface"})
    assert got == want and c["kv_pool_fetches_total"] == f0
    # a fetch whose chunk pull fails mid-way recomputes too
    key = kp.pool_key(kp.prompt_pool_blocks(prompt, 16))
    a.engine.kv_pool.get(key).export.get_chunk = None     # the holder breaks
    fail0 = c["kv_pool_fetch_failures_total"]
    prompt2 = prompt
    got = _complete(b, prompt2, headers={"X-Kaito-KV-Fetch": a.base,
                                         "X-Kaito-KV-Fetch-Key": key})
    assert got == want
    assert c["kv_pool_fetch_failures_total"] == fail0 + 1
    assert _call(f"{a.base}/kv_pool/0123456789abcdef/meta")[0] == 404
    assert _call(f"{a.base}/kv_pool/0123456789abcdef/chunk/0")[0] == 410


def test_pool_off_is_invisible():
    """With the pool off: 403 on every pool route, no store, and the
    ``/metrics`` families are the JAX server's with the pool off (no
    ``kaito:kv_pool_*`` or ``kaito:kv_tier_*`` line)."""
    from kaito_tpu.utils.promtext import parse_exposition

    j, t = _jax(), _port()
    try:
        assert t.engine.kv_pool is None and t.engine.kv_tier is None
        _complete(t, "gate probe", 2)
        _complete(j, "gate probe", 2)
        fams = []
        for srv in (j, t):
            status, raw = _call(srv.base + "/metrics")
            assert status == 200
            text = raw.decode()
            assert "kv_pool" not in text and "kv_tier" not in text
            fams.append({n for n, _, _ in parse_exposition(text)})
            for path in ("/debug/kv_pool", "/kv_pool/abc/meta", "/kv_pool/abc/chunk/0"):
                assert _call(srv.base + path)[0] == 403
        assert fams[0] == fams[1]
    finally:
        j.close()
        t.close()


def test_pool_on_families_match_the_jax_server(pools):
    from kaito_tpu.utils.promtext import parse_exposition

    j, a, _ = pools
    fams = []
    for srv in (j, a):
        text = _call(srv.base + "/metrics")[1].decode()
        fams.append({n for n, _, _ in parse_exposition(text) if "kv_pool" in n})
    assert fams[0] == fams[1] and "kaito:kv_pool_entries" in fams[1]
