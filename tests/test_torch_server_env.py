"""The port server's ``KAITO_*`` environment defaults against the JAX
server's, and the engine's ``KAITO_PREFILL_PACK`` fallback.

The JAX server builds its ``EngineConfig`` inside ``main``: the test
runs that ``main`` with ``EngineConfig`` replaced by a recorder that
stops it there, so both packages parse the same command line under the
same environment and the configs' fields are compared one by one.
"""

import os

import pytest

import kaito_tpu.engine.server as jax_server
from kaito_tpu_torch.engine.config import EngineConfig
from kaito_tpu_torch.engine.engine import InferenceEngine, check_ported
from kaito_tpu_torch.engine.server import parse_args
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

# variable -> (value, the config field it sets, the value there)
ENV = {
    "KAITO_TENSOR_PARALLEL": ("2", "tensor_parallel", 2),
    "KAITO_PIPELINE_PARALLEL": ("3", "pipeline_parallel", 3),
    "KAITO_EXPERT_PARALLEL": ("4", "expert_parallel", 4),
    "KAITO_DATA_PARALLEL": ("2", "data_parallel", 2),
    "KAITO_SEQUENCE_PARALLEL": ("2", "sequence_parallel", 2),
    "KAITO_KV_CACHE_DTYPE": ("int8", "kv_dtype", "int8"),
    "KAITO_QUANTIZATION": ("int4", "quantization", "int4"),
    "KAITO_WEIGHTS_DIR": ("/models/x", "weights_dir", "/models/x"),
    "KAITO_PREFILL_PACK": ("3", "prefill_pack", 3),
    "KAITO_DEVPROF_INTERVAL_S": ("2.5", "devprof_interval_s", 2.5),
    "KAITO_DEVPROF_WINDOW_S": ("0.125", "devprof_window_s", 0.125),
    "KAITO_KV_CPU_MEM_UTIL": ("0.25", "host_kv_offload_bytes",
                              int(0.25 * os.sysconf("SC_PAGE_SIZE")
                                  * os.sysconf("SC_PHYS_PAGES"))),
    # the P/D and KV pool flags (the operator sets the first two on a
    # P/D pod)
    "KAITO_PD_ENABLED": ("true", "pd_enabled", True),
    "KAITO_PD_ALLOWLIST": ("http://prefill-0:5000,http://prefill-1:5000",
                           "pd_source_allowlist",
                           "http://prefill-0:5000,http://prefill-1:5000"),
    "KAITO_KV_POOL": ("true", "kv_pool_enabled", True),
    "KAITO_KV_POOL_BYTES": ("123456789", "kv_pool_bytes", 123456789),
    "KAITO_KV_POOL_DISK_BYTES": ("987654321", "kv_pool_disk_bytes", 987654321),
    "KAITO_KV_POOL_DISK_DIR": ("/var/kaito/slabs", "kv_pool_disk_dir",
                               "/var/kaito/slabs"),
    "KAITO_KV_POOL_ADVERT_MAX": ("7", "kv_pool_advert_max", 7),
}
FIELDS = ("tensor_parallel", "pipeline_parallel", "expert_parallel", "data_parallel",
          "sequence_parallel", "kv_dtype", "quantization", "weights_dir",
          "prefill_pack", "dtype", "devprof_interval_s", "devprof_window_s",
          "host_kv_offload_bytes", "pd_enabled", "pd_source_allowlist",
          "kv_pool_enabled", "kv_pool_bytes", "kv_pool_disk_bytes", "kv_pool_disk_dir",
          "kv_pool_advert_max")
ARGV = ["--model", "tiny-llama-test", "--dtype", "float32"]


class _Parsed(Exception):
    pass


def _jax_config(monkeypatch, argv):
    """The EngineConfig kwargs the JAX server's ``main`` builds for
    ``argv`` under the current environment."""
    def record(**kw):
        raise _Parsed(kw)

    monkeypatch.setattr(jax_server, "EngineConfig", record)
    with pytest.raises(_Parsed) as got:
        jax_server.main(argv)
    return got.value.args[0]


@pytest.fixture(autouse=True)
def _no_kaito_env(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)


@pytest.mark.parametrize("var", list(ENV))
def test_env_default_matches_the_jax_server(monkeypatch, var):
    value, field, want = ENV[var]
    monkeypatch.setenv(var, value)
    cfg, _ = parse_args(ARGV)
    jax_kw = _jax_config(monkeypatch, ARGV)
    assert getattr(cfg, field) == want
    for name in FIELDS:
        assert getattr(cfg, name) == jax_kw[name], name


def test_no_env_matches_the_jax_server(monkeypatch):
    cfg, _ = parse_args(ARGV)
    jax_kw = _jax_config(monkeypatch, ARGV)
    for name in FIELDS:
        assert getattr(cfg, name) == jax_kw[name], name
    assert (cfg.tensor_parallel, cfg.kv_dtype, cfg.prefill_pack) == (1, "float32", 0)


def test_flags_win_over_the_environment(monkeypatch):
    monkeypatch.setenv("KAITO_QUANTIZATION", "int4")
    monkeypatch.setenv("KAITO_KV_CACHE_DTYPE", "int8")
    argv = ARGV + ["--quantization", "int8", "--kv-cache-dtype", "auto"]
    cfg, _ = parse_args(argv)
    jax_kw = _jax_config(monkeypatch, argv)
    assert (cfg.quantization, cfg.kv_dtype) == ("int8", "float32")
    assert (jax_kw["quantization"], jax_kw["kv_dtype"]) == ("int8", "float32")


@pytest.mark.parametrize("argv", [
    ["--pd-enabled", "--pd-source-allowlist", "http://p:1"],
    ["--kv-pool", "--kv-pool-bytes", "1048576", "--kv-pool-disk-bytes", "2097152",
     "--kv-pool-disk-dir", "/srv/slabs", "--kv-pool-advert-max", "3"],
    ["--pd-enabled", "--kv-pool"]])
def test_kv_movement_flags_match_the_jax_server(monkeypatch, argv):
    monkeypatch.setenv("KAITO_KV_POOL_BYTES", "5")
    cfg, _ = parse_args(ARGV + argv)
    jax_kw = _jax_config(monkeypatch, ARGV + argv)
    for name in FIELDS:
        assert getattr(cfg, name) == jax_kw[name], name
    check_ported(cfg)


@pytest.mark.parametrize("field", ["pipeline_parallel", "expert_parallel",
                                   "data_parallel", "sequence_parallel"])
def test_degrees_above_one_raise(monkeypatch, field):
    var = next(v for v, (_, f, _) in ENV.items() if f == field)
    monkeypatch.setenv(var, "2")
    cfg, _ = parse_args(ARGV)
    with pytest.raises(NotImplementedError, match="M19"):
        check_ported(cfg)


@pytest.mark.parametrize("pack,env,want", [(0, "3", 3), (0, "", 4), (2, "3", 2),
                                           (0, "1", 1)])
def test_engine_prefill_pack_falls_back_to_the_environment(monkeypatch, pack, env,
                                                            want):
    """``prefill_pack`` 0 reads KAITO_PREFILL_PACK, then ``max_num_seqs``
    (the JAX engine's ``_advance_prefills``)."""
    monkeypatch.setenv("KAITO_PREFILL_PACK", env)
    eng = InferenceEngine(EngineConfig(model="tiny-llama-test", max_model_len=128,
                                       max_num_seqs=4, dtype="float32",
                                       kv_dtype="float32", prefill_pack=pack,
                                       enable_prefix_caching=False), device="cpu")
    seen = []
    monkeypatch.setattr(eng, "_advance_prefill_pack", lambda n: seen.append(n) or True)
    monkeypatch.setattr(eng, "_advance_prefill_single", lambda: seen.append(1) or True)
    eng._advance_prefills()
    assert seen == [want]
