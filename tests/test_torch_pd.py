"""The port's P/D hand-off (``kaito_tpu_torch.engine.pd``) against the
JAX package's.

The wire: a chunk the port writes is the JAX writer's bytes (fp32,
bf16, int8 with its fp32 scale slabs, MLA's zero-size V) and each reads
the other's; the chunk plans are equal; the same pages exported from a
JAX cache and from the port's pool (one pool, or two tensor-parallel
shards) give the same bytes.  Over HTTP on the CPU, ``tiny-llama-real``
in fp32: a JAX server's ``/pd/prefill`` hands off to the port's server
and the port's to the JAX server's (greedy tokens exact and logprobs
within 2e-3 of the goldens; int8 KV codes and scales equal the staged
slab; a seeded sampled request gives the JAX pair's tokens); port to
port over the HTTP wire and the colocated device path leaves the pool
tensors where they were.  Then the serving contract: the break-even
recompute (greedy only), 404 after a consume and 410 on a second chunk
pull, the allowlist (403), an adapter mismatch (409), dtype and int8
mismatches refused, a failed pull recomputing locally and a bad chunk
failing alone with a 502, TP=2 to TP=1 and back, an import beside a
decoding window of the async loop, draft speculation on the decode role,
and an import inside a CPU profile landing under ``kv_import``.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import ml_dtypes
import numpy as np
import pytest
import torch

from kaito_tpu.engine import pd as jpd
from kaito_tpu.engine.config import EngineConfig as JaxConfig
from kaito_tpu.engine.engine import InferenceEngine as JaxEngine
from kaito_tpu.engine.server import make_server as jax_make_server
from kaito_tpu_torch.engine import pd
from kaito_tpu_torch.engine.config import EngineConfig
from kaito_tpu_torch.engine.engine import InferenceEngine, SamplingParams
from kaito_tpu_torch.engine.kv_cache import KVCache
from kaito_tpu_torch.engine.server import make_server
from kaito_tpu_torch.parallel.mesh import build_mesh
from kaito_tpu_torch.utils.failpoints import failpoint
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REAL = dict(model="tiny-llama-real", weights_dir="checkpoints/tiny-llama-real",
            max_model_len=256, page_size=16, max_num_seqs=2, dtype="float32",
            kv_dtype="float32", prefill_buckets=(64, 128), seed=0, pd_enabled=True)
GOLDENS = json.load(open("tests/testdata/goldens_tiny-llama-real.json"))


def _call(url, body=None, method=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _json(url, body=None, method=None):
    status, raw = _call(url, body, method)
    assert status == 200, raw
    return json.loads(raw)


class _Served:
    def __init__(self, engine, server):
        self.engine, self.server = engine, server
        self.base = f"http://127.0.0.1:{server.server_address[1]}"
        threading.Thread(target=server.serve_forever, daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.engine.stop()


def _port(mesh=None, **kw):
    cfg = EngineConfig(**{**REAL, **kw})
    eng = InferenceEngine(cfg, device="cpu", mesh=mesh)
    eng.start()
    return _Served(eng, make_server(eng, cfg, host="127.0.0.1", port=0, device="cpu"))


def _jax(**kw):
    cfg = JaxConfig(**{**REAL, **kw})
    eng = JaxEngine(cfg)
    eng.start()
    return _Served(eng, jax_make_server(eng, cfg, host="127.0.0.1", port=0))


def _prefill(srv, text, **kw):
    return _json(srv.base + "/pd/prefill", {"prompt": text, "temperature": 0.0, **kw})


def _decode(srv, src, hs, n, wire="http", force=True, **kw):
    """A completion continuing ``hs`` (a /pd/prefill answer of ``src``):
    (status, body)."""
    body = {"prompt": "x", "max_tokens": n, "temperature": 0.0, "ignore_eos": True,
            "logprobs": 1, **kw}
    body["kv_transfer"] = dict(source_url=src.base, req_id=hs["req_id"],
                               prompt_tokens=hs["prompt_tokens"],
                               first_token=hs["first_token"], wire=wire, force=force)
    status, raw = _call(srv.base + "/v1/completions", body)
    return status, json.loads(raw)


def _finished(engine) -> list:
    """Requests the engine finishes, appended as they finish."""
    done, trace = [], engine._finish_trace

    def keep(req):
        done.append(req)
        trace(req)
    engine._finish_trace = keep
    return done


@pytest.fixture(scope="module")
def pair():
    a, b = _port(), _port()
    b.finished = _finished(b.engine)
    yield a, b
    a.close()
    b.close()


@pytest.fixture(scope="module")
def jax_srv():
    j = _jax()
    j.finished = _finished(j.engine)
    yield j
    j.close()


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------

def _slab(kind, seed=0):
    """(numpy k, v, ks, vs) and the torch tensors of the same bytes."""
    rng = np.random.default_rng(seed)
    L, n, ps, H, D = 3, 4, 16, 2, 8
    ks = vs = None
    if kind == "fp32":
        k = rng.standard_normal((L, n, ps, H, D), np.float32)
        v = rng.standard_normal((L, n, ps, H, D), np.float32)
    elif kind == "bf16":
        k = rng.integers(0, 1 << 16, (L, n, ps, H, D), np.uint16).view(ml_dtypes.bfloat16)
        v = rng.integers(0, 1 << 16, (L, n, ps, H, D), np.uint16).view(ml_dtypes.bfloat16)
        # NaN payloads aside, any 16 bits are a bf16 value
        k[np.isnan(k.astype(np.float32))] = 0
        v[np.isnan(v.astype(np.float32))] = 0
    elif kind == "int8":
        k = rng.integers(-127, 128, (L, n, ps, H, D), np.int8)
        v = rng.integers(-127, 128, (L, n, ps, H, D), np.int8)
        ks = rng.random((L, n, H), np.float32)
        vs = rng.random((L, n, H), np.float32)
    else:   # MLA: the latent in k, a zero-size v
        k = rng.standard_normal((L, n, ps, 1, 576), np.float32)
        v = np.zeros((L, n, ps, 1, 0), np.float32)

    def t(a):
        if a is None:
            return None
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(a.copy())
    return (k, v, ks, vs), tuple(t(a) for a in (k, v, ks, vs))


def _np(t):
    if t is None:
        return None
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8", "mla"])
def test_chunk_bytes_equal_the_jax_writer(kind):
    arrays, tensors = _slab(kind)
    want = jpd.serialize_chunk(*arrays)
    got = pd.serialize_chunk(*tensors)
    assert got == want
    # each reads the other's
    for a, b in zip(pd.deserialize_chunk(want), arrays):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.shape == b.shape and _np(a).tobytes() == b.tobytes()
    for a, b in zip(jpd.deserialize_chunk(got), tensors):
        if a is not None:
            assert a.shape == tuple(b.shape) and a.tobytes() == _np(b).tobytes()


def test_chunk_length_mismatch_is_refused():
    _, tensors = _slab("int8")
    data = pd.serialize_chunk(*tensors)
    with pytest.raises(ValueError, match="chunk body"):
        pd.deserialize_chunk(data[:-1])
    with pytest.raises(ValueError, match="wire dtype"):
        pd.deserialize_chunk(data.replace(b'"int8"', b'"int4"', 1))


@pytest.mark.parametrize("args", [(32, 24, 1 << 20), (32, 47, 8 << 20), (2, 3, 1024),
                                  (4, 100, 1 << 16, 1 << 20), (61, 1, 37), (1, 1, 1)])
def test_plan_chunks_equal_the_jax_plans(args):
    assert [p.to_json() for p in pd.plan_chunks(*args)] == \
        [p.to_json() for p in jpd.plan_chunks(*args)]


@pytest.mark.parametrize("kind,tp", [("fp32", 1), ("int8", 1), ("fp32", 2), ("int8", 2)])
def test_export_from_a_jax_cache_equals_the_port_pool(kind, tp):
    """The same pool contents exported by each package give the same meta
    and bytes; a tensor-parallel pool's two shards (each half the KV
    heads) export the canonical slab, and an import into a fresh pool of
    either layout puts every page back."""
    import jax.numpy as jnp

    from kaito_tpu.engine.kv_cache import KVCache as JaxCache

    rng = np.random.default_rng(7)
    L, P, ps, H, D = 2, 9, 16, 4, 8
    if kind == "int8":
        k = rng.integers(-127, 128, (L, P, ps, H, D), np.int8)
        v = rng.integers(-127, 128, (L, P, ps, H, D), np.int8)
        ks, vs = rng.random((L, P, H), np.float32), rng.random((L, P, H), np.float32)
    else:
        k = rng.standard_normal((L, P, ps, H, D), np.float32)
        v = rng.standard_normal((L, P, ps, H, D), np.float32)
        ks = vs = None
    jcache = JaxCache(k=jnp.asarray(k), v=jnp.asarray(v),
                      k_scale=None if ks is None else jnp.asarray(ks),
                      v_scale=None if vs is None else jnp.asarray(vs))

    def port_cache(k, v, ks, vs):
        def t(a, lo, hi, dim):
            return None if a is None else torch.from_numpy(
                np.ascontiguousarray(np.take(a, range(lo, hi), axis=dim)))
        step = H // tp
        return [KVCache(k=t(k, r * step, (r + 1) * step, 3), v=t(v, r * step, (r + 1) * step, 3),
                        k_scale=t(ks, r * step, (r + 1) * step, 2),
                        v_scale=t(vs, r * step, (r + 1) * step, 2)) for r in range(tp)]

    pages = [5, 2, 7]
    cache = port_cache(k, v, ks, vs)
    jmeta, jpayload = jpd.export_kv(jcache, pages)
    meta, payload = pd.export_kv(cache if tp > 1 else cache[0], pages)
    assert meta == jmeta and payload == jpayload
    fresh = port_cache(np.zeros_like(k), np.zeros_like(v),
                       None if ks is None else np.zeros_like(ks),
                       None if vs is None else np.zeros_like(vs))
    ptrs = [c.k.data_ptr() for c in fresh]
    pd.import_kv(fresh if tp > 1 else fresh[0], pages, jpayload, jmeta)
    assert [c.k.data_ptr() for c in fresh] == ptrs
    assert pd.export_kv(fresh if tp > 1 else fresh[0], pages)[1] == jpayload


def test_import_checks_shapes_and_quantization():
    _, (k, v, ks, vs) = _slab("int8")
    pool = KVCache(k=torch.zeros((3, 9, 16, 2, 8), dtype=torch.int8),
                   v=torch.zeros((3, 9, 16, 2, 8), dtype=torch.int8),
                   k_scale=torch.zeros((3, 9, 2)), v_scale=torch.zeros((3, 9, 2)))
    with pytest.raises(ValueError, match="shape mismatch"):
        pd.import_arrays(pool, [1, 2, 3], k, v, ks, vs)
    with pytest.raises(ValueError, match="quantization mismatch"):
        pd.import_arrays(pool, [1, 2, 3, 4], k, v)
    plain = KVCache(k=torch.zeros((3, 9, 16, 2, 8)), v=torch.zeros((3, 9, 16, 2, 8)))
    with pytest.raises(ValueError, match="quantization mismatch"):
        pd.import_arrays(plain, [1, 2, 3, 4], k.float(), v.float(), ks, vs)
    with pytest.raises(ValueError, match="scale shape"):
        pd.import_arrays(pool, [1, 2, 3, 4], k, v, ks[:, :, :1], vs[:, :, :1])
    staged = KVCache(k=torch.zeros((2, 2, 9, 16, 2, 8)), v=torch.zeros((2, 2, 9, 16, 2, 8)))
    with pytest.raises(NotImplementedError, match="pipeline"):
        pd.import_arrays(staged, [1], k, v)


# ---------------------------------------------------------------------------
# the JAX server and the port's, over HTTP
# ---------------------------------------------------------------------------

def _golden_check(finished, sec="fp32"):
    for p, req in zip(GOLDENS["prompts"], finished):
        g = p[sec]
        assert list(req.output_tokens) == g["greedy_tokens"]
        # the first token's log p lives on the prefill role
        assert req.output_logprobs[0] is None
        np.testing.assert_allclose(req.output_logprobs[1:], g["logprobs"][1:], atol=2e-3)


def test_jax_prefill_hands_off_to_the_port(pair, jax_srv):
    _, b = pair
    n0 = len(b.finished)
    for p in GOLDENS["prompts"]:
        hs = _prefill(jax_srv, p["text"])
        assert hs["prompt_tokens"] == p["prompt_tokens"]
        status, body = _decode(b, jax_srv, hs, len(p["fp32"]["greedy_tokens"]))
        assert status == 200, body
    _golden_check(b.finished[n0:])


def test_port_prefill_hands_off_to_jax(pair, jax_srv):
    a, _ = pair
    n0 = len(jax_srv.finished)
    for p in GOLDENS["prompts"]:
        hs = _prefill(a, p["text"])
        assert hs["prompt_tokens"] == p["prompt_tokens"]
        status, body = _decode(jax_srv, a, hs, len(p["fp32"]["greedy_tokens"]))
        assert status == 200, body
    _golden_check(jax_srv.finished[n0:])


def test_int8_kv_codes_and_scales_arrive_as_staged():
    """int8 KV from a JAX prefill role lands in the port's pool as the
    staged codes and scales, and back."""
    j, t = _jax(kv_dtype="int8"), _port(kv_dtype="int8")
    try:
        for src, dst in ((j, t), (t, j)):
            p = GOLDENS["prompts"][1]
            hs = _prefill(src, p["text"])
            staged = src.engine.kv_exports.get(hs["req_id"])
            slabs = [np.asarray(x) if not isinstance(x, torch.Tensor) else x.numpy()
                     for x in staged.device_slabs()]
            assert len(slabs) == 4
            got = {}
            if dst is t:
                inner = pd.import_arrays

                def spy(cache, pages, *arrs, **kw):
                    inner(cache, pages, *arrs, **kw)
                    got["slab"] = [x.numpy() for x in pd._gather_canonical(cache, pages)]
                import kaito_tpu_torch.engine.engine as em
                em.import_arrays, orig = spy, em.import_arrays
            else:
                import kaito_tpu.engine.pd as jm
                inner = jm.import_arrays

                def spy(cache, pages, *arrs, **kw):
                    out = inner(cache, pages, *arrs, **kw)
                    got["slab"] = [np.asarray(x) for x in jm._gather_canonical(out, pages)]
                    return out
                em, orig = jm, jm.import_arrays
                jm.import_arrays = spy
            try:
                status, body = _decode(dst, src, hs, 4)
            finally:
                em.import_arrays = orig
            assert status == 200, body
            for a, b in zip(got["slab"], slabs):
                np.testing.assert_array_equal(a, b)
    finally:
        j.close()
        t.close()


def test_seeded_sampled_request_gives_the_jax_pairs_tokens(pair, jax_srv):
    """A seeded sampled request prefilled on the JAX server draws the same
    tokens decoded by the port as by the JAX server itself."""
    _, b = pair
    out = {}
    for name, dst in (("jax", jax_srv), ("port", b)):
        hs = _prefill(jax_srv, "seeded sampling across the hand-off", temperature=0.8,
                      seed=7)
        status, body = _decode(dst, jax_srv, hs, 10, temperature=0.8, seed=7)
        assert status == 200, body
        out[name] = dst.finished[-1].output_tokens
    assert out["port"] == out["jax"]


# ---------------------------------------------------------------------------
# port to port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wire", ["http", "auto"])
def test_port_handoff_matches_monolithic(pair, wire):
    a, b = pair
    text = "the decode role continues from the prefill role's pages"
    mono = _json(b.base + "/v1/completions", dict(prompt=text, max_tokens=8,
                                                  temperature=0.0, ignore_eos=True))
    ptrs = (b.engine.cache.k.data_ptr(), b.engine.cache.v.data_ptr())
    c = b.engine.counters
    before = (c["prefill_steps_total"], c["pd_device_handoffs_total"])
    hs = _prefill(a, text)
    status, out = _decode(b, a, hs, 8, wire=wire)
    assert status == 200, out
    assert out["choices"][0]["text"] == mono["choices"][0]["text"]
    assert c["prefill_steps_total"] == before[0]
    assert c["pd_device_handoffs_total"] == before[1] + (wire == "auto")
    assert (b.engine.cache.k.data_ptr(), b.engine.cache.v.data_ptr()) == ptrs
    assert len(a.engine.kv_exports) == 0
    if wire == "http":
        assert b.engine.pd_costs.snapshot()["transfer_samples"] >= 1


def test_break_even_recomputes_greedy_requests_only(pair, monkeypatch):
    """Below the break-even (the static priors: no measured rate yet) a
    greedy request prefills locally and releases the staged export; a
    sampled one still takes the transfer (the prefill's first token
    stands)."""
    a, b = pair
    monkeypatch.setattr(b.engine, "pd_costs", pd.TransferCostModel())
    c = b.engine.counters
    hs = _prefill(a, "short prompts recompute")
    p0 = c["prefill_steps_total"]
    status, _ = _decode(b, a, hs, 4, force=False)
    assert status == 200 and c["prefill_steps_total"] == p0 + 1
    for _ in range(100):        # the release is off the request path
        if a.engine.kv_exports.get(hs["req_id"]) is None:
            break
        time.sleep(0.05)
    assert a.engine.kv_exports.get(hs["req_id"]) is None
    hs = _prefill(a, "short prompts recompute", temperature=0.9, seed=3)
    p0 = c["prefill_steps_total"]
    status, _ = _decode(b, a, hs, 4, force=False, temperature=0.9, seed=3)
    assert status == 200 and c["prefill_steps_total"] == p0
    assert b.finished[-1].output_tokens[0] == hs["first_token"]


def test_consumed_exports_answer_404_and_a_second_chunk_pull_410(pair, monkeypatch):
    a, _ = pair
    monkeypatch.setattr(pd, "CHUNK_TARGET_BYTES", 1 << 12)
    hs = _prefill(a, "a prompt long enough for several chunks of a small target")
    url = f"{a.base}/pd/kv/{hs['req_id']}"
    meta = _json(url + "/meta")
    assert meta["n_chunks"] > 1
    assert _call(url + "/chunk/0")[0] == 200
    assert _call(url + "/chunk/0")[0] == 410
    assert _call(url + f"/chunk/{meta['n_chunks']}")[0] == 400
    for i in range(1, meta["n_chunks"]):
        assert _call(url + f"/chunk/{i}")[0] == 200
    assert _call(url + "/meta")[0] == 404
    hs = _prefill(a, "the whole slab at once")
    status, blob = _call(f"{a.base}/pd/kv/{hs['req_id']}")
    assert status == 200
    head, payload = pd.unpack_transfer(blob)
    assert pd.deserialize_chunk(payload)[0].shape == tuple(head["shape"])
    assert _call(f"{a.base}/pd/kv/{hs['req_id']}")[0] == 404
    hs = _prefill(a, "released by the decode role")
    assert _call(f"{a.base}/pd/kv/{hs['req_id']}", method="DELETE")[0] == 200
    assert _call(f"{a.base}/pd/kv/{hs['req_id']}", method="DELETE")[0] == 404


def test_allowlist_adapter_and_dtype_refusals(pair, monkeypatch):
    a, b = pair
    hs = _prefill(a, "trust boundaries")
    monkeypatch.setattr(b.server.state.cfg, "pd_source_allowlist", "http://elsewhere:1")
    assert _decode(b, a, hs, 2)[0] == 403
    monkeypatch.setattr(b.server.state.cfg, "pd_source_allowlist", a.base)
    a.engine.kv_exports.get(hs["req_id"]).meta["adapter"] = "someone-else"
    for wire in ("http", "auto"):
        status, body = _decode(b, a, hs, 2, wire=wire)
        assert status == 409 and "adapter mismatch" in body["error"]["message"]
    # an int8 prefill role's pages never land in an fp32 pool
    monkeypatch.setattr(b.server.state.cfg, "pd_source_allowlist", "")
    q = _port(kv_dtype="int8")
    try:
        hs = _prefill(q, "trust boundaries")
        status, body = _decode(b, q, hs, 2)
        assert status == 400 and "dtype mismatch" in body["error"]["message"]
    finally:
        q.close()
    plans = pd.plan_chunks(4, 1, 1024)
    meta = dict(shape=[4, 1, 16, 4, 32], dtype="bfloat16", model="tiny-llama-real",
                chunks=[p.to_json() for p in plans])
    with pytest.raises(ValueError, match="dtype mismatch"):
        b.engine.submit_with_kv_chunked([1, 2, 3], 5, meta, plans,
                                        SamplingParams(max_tokens=2))
    with pytest.raises(ValueError, match="token mismatch"):
        b.engine.submit_with_kv_chunked([1, 2, 3], 5, dict(meta, dtype="float32",
                                                          n_tokens=4), plans,
                                        SamplingParams(max_tokens=2))
    off = _port(pd_enabled=False)
    try:
        assert _call(off.base + "/pd/prefill", {"prompt": "x"})[0] == 403
        assert _call(off.base + "/pd/kv/x/meta")[0] == 403
        assert _decode(off, a, hs, 2)[0] == 403
    finally:
        off.close()


def test_failed_pull_recomputes_and_a_bad_chunk_fails_alone(pair):
    """A pull that fails (the prefill role's drain dies) is transient: the
    decode role recomputes the prompt and the request succeeds; bytes
    that do not assemble fail that request alone with a 502."""
    a, b = pair
    text = "the drain dies and the decode role recomputes"
    mono = _json(b.base + "/v1/completions", dict(prompt=text, max_tokens=6,
                                                  temperature=0.0, ignore_eos=True))
    c = b.engine.counters
    r0 = c["kv_import_retries_total"]
    hs = _prefill(a, text)
    with failpoint("pd.export_drain"):
        status, out = _decode(b, a, hs, 6)
    assert status == 200 and c["kv_import_retries_total"] == r0 + 1
    assert out["choices"][0]["text"] == mono["choices"][0]["text"]
    hs = _prefill(a, text)
    with failpoint("engine.kv_import"):
        status, out = _decode(b, a, hs, 6)
    assert status == 502 and out["error"]["type"] == "kv_transfer_failed"
    # a truncated chunk, fed by hand
    exp_hs = _prefill(a, text)
    exp = a.engine.kv_exports.pop(exp_hs["req_id"])
    req = b.engine.submit_with_kv_chunked(exp_hs["prompt_tokens"], exp_hs["first_token"],
                                          exp.meta, exp.plans,
                                          SamplingParams(max_tokens=4, temperature=0.0))
    req.kv_chunked.feed(0, exp.get_chunk(0)[:-3])
    b.engine._wake.set()
    assert list(req.stream()) == [] and req.error["status"] == 502
    assert len(list(b.engine.submit([3, 4, 5], SamplingParams(max_tokens=3)).stream())) == 3


def test_stalled_chunks_fail_the_request_and_free_its_slot():
    eng = InferenceEngine(EngineConfig(**{**REAL, "max_num_seqs": 1}), device="cpu")
    eng.start()
    try:
        plans = pd.plan_chunks(4, 1, 1024)
        meta = dict(shape=[4, 1, 16, 4, 32], dtype="float32", model="tiny-llama-real",
                    chunks=[p.to_json() for p in plans])
        req = eng.submit_with_kv_chunked([1, 2, 3], 5, meta, plans,
                                         SamplingParams(max_tokens=4, temperature=0.0),
                                         deadline_s=0.5)
        assert list(req.stream()) == [] and req.finish_reason == "error"
        ok = eng.submit([4, 5, 6], SamplingParams(max_tokens=4, temperature=0.0,
                                                  ignore_eos=True))
        assert len(list(ok.stream())) == 4
    finally:
        eng.stop()


def test_tensor_parallel_handoffs_both_ways(pair):
    """TP=2 (two CPU shards, each half the KV heads) to TP=1 and back:
    the wire is canonical, so either side splits or joins the heads."""
    _, b = pair
    tp = _port(mesh=build_mesh(tensor=2, devices=["cpu", "cpu"]))
    try:
        text = "tensor parallel shards on the wire"
        mono = _json(b.base + "/v1/completions", dict(prompt=text, max_tokens=6,
                                                      temperature=0.0, ignore_eos=True))
        for src, dst in ((tp, b), (b, tp)):
            for wire in ("http", "auto"):
                hs = _prefill(src, text)
                status, out = _decode(dst, src, hs, 6, wire=wire)
                assert status == 200, out
                assert out["choices"][0]["text"] == mono["choices"][0]["text"]
    finally:
        tp.close()


def test_async_loop_imports_beside_a_decoding_window(pair):
    """On the async loop, a transfer lands while another sequence keeps
    decoding in windows; both match their monolithic runs."""
    a, _ = pair
    d = _port(async_dispatch=True)
    try:
        long_text, text = "a long decode beside the import", "the import lands"
        mono = {t: _json(d.base + "/v1/completions", dict(
            prompt=t, max_tokens=n, temperature=0.0, ignore_eos=True))["choices"][0]["text"]
            for t, n in ((long_text, 40), (text, 8))}
        got = {}

        def long_run():
            got[long_text] = _json(d.base + "/v1/completions", dict(
                prompt=long_text, max_tokens=40, temperature=0.0,
                ignore_eos=True))["choices"][0]["text"]
        th = threading.Thread(target=long_run)
        w0 = d.engine.counters["decode_windows_total"]
        th.start()
        deadline = time.monotonic() + 60
        while d.engine.counters["decode_windows_total"] < w0 + 3:
            assert time.monotonic() < deadline, "the long decode never started"
            time.sleep(0.001)
        hs = _prefill(a, text)
        status, out = _decode(d, a, hs, 8)
        th.join()
        assert status == 200
        got[text] = out["choices"][0]["text"]
        assert got == mono
        assert d.engine.counters["h2d_uploads_total"] > 0
    finally:
        d.close()


def test_draft_speculation_on_the_decode_role(pair):
    """The decode role speculates with the checkpoint as its own draft: an
    imported slot has no draft KV and catches up from position 0; the
    greedy tokens are the plain decode's."""
    a, b = pair
    d = _port(speculative_draft="tiny-llama-real", speculative_draft_k=3,
              speculative_draft_weights_dir=REAL["weights_dir"])
    try:
        text = "speculation continues an imported prompt"
        mono = _json(b.base + "/v1/completions", dict(prompt=text, max_tokens=12,
                                                      temperature=0.0, ignore_eos=True))
        hs = _prefill(a, text)
        status, out = _decode(d, a, hs, 12)
        assert status == 200, out
        assert out["choices"][0]["text"] == mono["choices"][0]["text"]
        assert d.engine.counters["spec_draft_steps_total"] > 0
    finally:
        d.close()


def test_an_import_inside_a_cpu_profile_lands_under_kv_import():
    from torch.profiler import ProfilerActivity, profile

    from kaito_tpu_torch.engine.devprof import parse_torch_trace, read_trace, summarize_window

    _, (k, v, _, _) = _slab("fp32")
    pool = KVCache(k=torch.zeros((3, 9, 16, 2, 8)), v=torch.zeros((3, 9, 16, 2, 8)))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pd.import_arrays(pool, [1, 2, 3, 4], k, v)
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "t.json")
        prof.export_chrome_trace(path)
        summary = summarize_window(parse_torch_trace(read_trace(path)))
    assert summary["phase_pct"]["kv_import"] > 0
    assert torch.equal(pool.k[:, 1:5], k)


@pytest.mark.parametrize("field,value", [("pd_enabled", True),
                                         ("kv_pool_enabled", True),
                                         ("kv_pool_disk_bytes", 1 << 20)])
def test_kv_movement_gates_build(field, value, tmp_path):
    extra = {"kv_pool_disk_dir": str(tmp_path)} if field == "kv_pool_disk_bytes" else {}
    if field == "kv_pool_disk_bytes":
        extra["kv_pool_enabled"] = True
    eng = InferenceEngine(EngineConfig(model="tiny-llama-test", max_model_len=128,
                                       **{field: value}, **extra), device="cpu")
    assert (eng.kv_pool is not None) == (field != "pd_enabled")
    assert (eng.kv_tier is not None) == (field == "kv_pool_disk_bytes")
    eng.stop()
