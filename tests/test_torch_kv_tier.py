"""The port's disk tier under the KV pool (``kv_pool.DiskPageStore``)
against the JAX package's.

A slab directory is interchangeable: the port spills the JAX writer's
files byte for byte (``<key>.slab`` + ``<key>.json``), and a directory
written by either package is read by the other, chunk for chunk.  The
restart scan re-indexes complete entries and deletes an interrupted
spill's debris; hostile keys are refused; the byte budget prunes the
oldest-touched entry; a corrupt meta or a truncated slab drops the
entry.  Served on the CPU (``tiny-llama-real`` in fp32): a prefix the
host store evicted lands on disk, and a replay imports it from there
with the JAX engine's greedy text; a truncated slab recomputes; with the
disk tier off its families stay off ``/metrics``.
"""

import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from kaito_tpu.engine import kv_pool as jkp
from kaito_tpu.engine.config import EngineConfig as JaxConfig
from kaito_tpu.engine.engine import InferenceEngine as JaxEngine
from kaito_tpu.engine.server import make_server as jax_make_server
from kaito_tpu_torch.engine import kv_pool as kp
from kaito_tpu_torch.engine import pd
from kaito_tpu_torch.engine.config import EngineConfig
from kaito_tpu_torch.engine.engine import InferenceEngine
from kaito_tpu_torch.engine.server import make_server
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REAL = dict(model="tiny-llama-real", weights_dir="checkpoints/tiny-llama-real",
            max_model_len=256, page_size=16, max_num_seqs=2, dtype="float32",
            kv_dtype="float32", prefill_buckets=(64, 128), seed=0,
            kv_pool_enabled=True)


def _arrays(seed=0, n_pages=4, quant=True):
    rng = np.random.default_rng(seed)
    shape = (2, n_pages, 4, 2, 8)
    if quant:
        return (rng.integers(-127, 128, shape, np.int8),
                rng.integers(-127, 128, shape, np.int8),
                rng.random((2, n_pages, 2), np.float32),
                rng.random((2, n_pages, 2), np.float32))
    return (rng.standard_normal(shape, np.float32),
            rng.standard_normal(shape, np.float32), None, None)


def _entry(mod, blocks, seed=0, n_pages=4, quant=True):
    arrs = _arrays(seed, n_pages, quant)
    if mod is kp:
        arrs = tuple(None if a is None else torch.from_numpy(a) for a in arrs)
    exp = mod.HostExport(*arrs, n_tokens=n_pages * 4, model="m",
                         prompt_tokens=list(range(100, 100 + n_pages * 4)))
    nbytes = sum(len(exp.get_chunk(i)) for i in range(len(exp.plans)))
    return mod.PoolEntry(key=mod.pool_key(blocks), blocks=list(blocks),
                         n_tokens=n_pages * 4, n_pages=len(blocks), export=exp,
                         nbytes=nbytes)


@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("writer,reader", [(kp, jkp), (jkp, kp)])
def test_a_slab_directory_reads_in_either_package(tmp_path, writer, reader, quant):
    blocks = [0x1111, 0x2222, 0x3333]
    w = writer.DiskPageStore(str(tmp_path / "w"), max_bytes=1 << 20)
    assert w.spill(_entry(writer, blocks, quant=quant))
    # the other package writes the same files
    other = jkp if writer is kp else kp
    o = other.DiskPageStore(str(tmp_path / "o"), max_bytes=1 << 20)
    assert o.spill(_entry(other, blocks, quant=quant))
    key = kp.pool_key(blocks)
    for suffix in (".slab", ".json"):
        assert (tmp_path / "w" / (key + suffix)).read_bytes() == \
            (tmp_path / "o" / (key + suffix)).read_bytes()
    r = reader.DiskPageStore(str(tmp_path / "w"), max_bytes=1 << 20)
    hit = r.lookup_longest(blocks + [0x4444])
    assert hit is not None and hit[0] == key
    meta = hit[1]
    want = _entry(writer, blocks, quant=quant).export
    for i in range(len(want.plans)):
        data = r.read_chunk(key, i, meta)
        assert data == want.get_chunk(i)
        k, v, ks, vs = pd.deserialize_chunk(data)
        assert (ks is not None) == quant and k.shape[0] == 2


def test_restart_scan_and_orphan_cleanup(tmp_path):
    store = kp.DiskPageStore(str(tmp_path), max_bytes=1 << 20)
    blocks = [0xaaaa, 0xbbbb]
    assert store.spill(_entry(kp, blocks, seed=1))
    (tmp_path / ("f" * 16 + ".slab")).write_bytes(b"orphan")
    (tmp_path / ("e" * 16 + ".slab.tmp")).write_bytes(b"partial")
    (tmp_path / ("d" * 16 + ".json")).write_bytes(b"{}")      # meta without slab
    store2 = kp.DiskPageStore(str(tmp_path), max_bytes=1 << 20)
    assert len(store2) == 1 and store2.used_bytes == store.used_bytes
    assert store2.lookup_longest(blocks)[0] == kp.pool_key(blocks)
    for name in ("f" * 16 + ".slab", "e" * 16 + ".slab.tmp", "d" * 16 + ".json"):
        assert not (tmp_path / name).exists()


def test_hostile_keys_are_refused(tmp_path):
    store = kp.DiskPageStore(str(tmp_path), max_bytes=1 << 20)
    for bad in ("../../etc/passwd", "ABCDEF0123456789", "0123", "z" * 16,
                "0123456789abcdef0"):
        with pytest.raises(ValueError):
            store._paths(bad)
    store._paths("0123456789abcdef")


def test_budget_prunes_the_oldest_touched(tmp_path):
    store = kp.DiskPageStore(str(tmp_path), max_bytes=1 << 20)
    a, b = [0x0a0a], [0x0b0b]
    assert store.spill(_entry(kp, a, seed=2, n_pages=2))
    one = store.used_bytes
    assert store.spill(_entry(kp, b, seed=3, n_pages=2))
    os.utime(tmp_path / (kp.pool_key(a) + ".json"), (1.0, 1.0))
    os.utime(tmp_path / (kp.pool_key(b) + ".json"), (2.0, 2.0))
    assert store.lookup_longest(a) is not None      # touches a
    store.max_bytes = 2 * one + 1
    assert store.spill(_entry(kp, [0x0c0c], seed=4, n_pages=2))
    assert store.lookup_longest(a) is not None and store.lookup_longest(b) is None
    assert store.evictions_total >= 1
    store.max_bytes = 8
    assert not store.spill(_entry(kp, [0x0d0d], seed=5))


def test_corruption_drops_the_entry(tmp_path):
    store = kp.DiskPageStore(str(tmp_path), max_bytes=1 << 20)
    blocks = [0x5a5a, 0x6b6b]
    assert store.spill(_entry(kp, blocks, seed=6))
    key = kp.pool_key(blocks)
    (tmp_path / (key + ".json")).write_bytes(b"{not json")
    assert store.lookup_longest(blocks) is None
    assert store.errors_total == 1 and len(store) == 0
    assert store.spill(_entry(kp, blocks, seed=6))
    key, meta = store.lookup_longest(blocks)
    (tmp_path / (key + ".slab")).write_bytes(b"x")
    with pytest.raises(ValueError, match="truncated"):
        store.read_chunk(key, 0, meta)
    assert len(store) == 0 and store.errors_total == 2


@pytest.mark.parametrize("disk_s,prefill_s,want", [
    (None, None, True), (1e9, None, True), (None, 100.0, True),
    (1e9, 100.0, True), (1e3, 1e6, False)])
def test_should_import_from_disk_vetoes_on_measured_rates_only(disk_s, prefill_s, want):
    from kaito_tpu.engine import pd as jpd

    got = []
    for mod in (pd, jpd):
        m = mod.TransferCostModel()
        if disk_s:
            m.note_disk_read(int(disk_s), 1.0)
        if prefill_s:
            m.note_prefill(int(prefill_s), 1.0)
        got.append(mod.should_import_from_disk(1 << 20, 64, m))
    assert got == [want, want]


# ---------------------------------------------------------------------------
# served
# ---------------------------------------------------------------------------

def _boot(**kw):
    cfg = EngineConfig(**{**REAL, **kw})
    eng = InferenceEngine(cfg, device="cpu")
    eng.start()
    srv = make_server(eng, cfg, host="127.0.0.1", port=0, device="cpu")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return eng, srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _stop(eng, srv):
    srv.shutdown()
    srv.server_close()
    eng.stop()


def _complete(url, prompt, n=6):
    req = urllib.request.Request(url + "/v1/completions", data=json.dumps(dict(
        prompt=prompt, max_tokens=n, temperature=0.0, ignore_eos=True)).encode(),
        headers={"Content-Type": "application/json"})
    return json.loads(urllib.request.urlopen(req, timeout=120).read())["choices"][0]["text"]


def _force_spill(eng, url, prompt, evictor):
    """Publish ``prompt``, shrink the store so publishing ``evictor``
    evicts it, wait for the spill worker; the reference text."""
    ref = _complete(url, prompt)
    assert eng.kv_pool.used_bytes > 0
    eng.kv_pool.max_bytes = eng.kv_pool.used_bytes * 3 // 2
    _complete(url, evictor)
    key = kp.pool_key(kp.prompt_pool_blocks(prompt, REAL["page_size"]))
    deadline = time.monotonic() + 30
    while not eng.kv_tier.has(key) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert eng.kv_tier.has(key) and not eng.kv_pool.has(key)
    return ref, key


def test_replay_imports_from_disk_with_the_jax_engines_text(tmp_path):
    prompt = "conversation turn one about tensors " * 6
    evictor = "unrelated second conversation filler " * 6
    jcfg = JaxConfig(**{**REAL, "kv_pool_enabled": False})
    jeng = JaxEngine(jcfg)
    jeng.start()
    jsrv = jax_make_server(jeng, jcfg, host="127.0.0.1", port=0)
    threading.Thread(target=jsrv.serve_forever, daemon=True).start()
    eng, srv, url = _boot(kv_pool_disk_bytes=1 << 30, kv_pool_disk_dir=str(tmp_path))
    try:
        want = _complete(f"http://127.0.0.1:{jsrv.server_address[1]}", prompt)
        ref, key = _force_spill(eng, url, prompt, evictor)
        assert ref == want
        assert _complete(url, prompt) == want
        c = eng.counters
        assert c["kv_tier_disk_hits_total"] == 1 and c["kv_tier_import_tokens_total"] > 0
        assert c["kv_pool_fetch_failures_total"] == 0
        body = urllib.request.urlopen(url + "/metrics", timeout=30).read().decode()
        assert 'kaito:kv_tier_hits_total{tier="disk"} 1' in body
        assert "kaito:kv_tier_spills_total" in body
        assert eng.pd_costs.snapshot()["disk_samples"] >= 1
        # the host store hit: the replay replicated the prefix back
        assert _complete(url, prompt) == want and c["kv_tier_host_hits_total"] == 1
    finally:
        _stop(eng, srv)
        jsrv.shutdown()
        jeng.stop()
    # the JAX package reads the directory the port wrote (the demoted
    # prompt's entry, and the evictor's, spilled by the replay)
    jstore = jkp.DiskPageStore(str(tmp_path), max_bytes=1 << 30)
    assert jstore.has(key)


def test_a_truncated_slab_falls_back_to_recompute(tmp_path):
    prompt = "replayed conversation with a damaged " * 6
    evictor = "other talk pushing the first one out " * 6
    eng, srv, url = _boot(kv_pool_disk_bytes=1 << 30, kv_pool_disk_dir=str(tmp_path))
    try:
        ref, key = _force_spill(eng, url, prompt, evictor)
        (tmp_path / (key + ".slab")).write_bytes(b"x")
        assert _complete(url, prompt) == ref
        c = eng.counters
        assert c["kv_tier_disk_hits_total"] == 1
        assert c["kv_pool_fetch_failures_total"] == 1
        assert eng.kv_tier.errors_total >= 1 and not eng.kv_tier.has(key)
    finally:
        _stop(eng, srv)


def test_disk_tier_off_is_invisible():
    eng, srv, url = _boot()
    try:
        assert eng.kv_tier is None and eng._spill_thread is None
        assert eng.kv_pool.on_evict is None
        _complete(url, "gate probe", 2)
        body = urllib.request.urlopen(url + "/metrics", timeout=30).read().decode()
        assert "kv_tier" not in body and "kaito:kv_pool_entries" in body
    finally:
        _stop(eng, srv)
