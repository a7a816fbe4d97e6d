"""The port server's start-up surface against the JAX server's.

- ``--kv-import-retries`` and ``--inference-role`` (with its
  ``KAITO_INFERENCE_ROLE`` default) land in the fields the JAX ``main``
  gives them.
- Every command line the JAX operator's ``build_engine_command``
  renders for a Workspace (a built-in preset, and the catalog's
  ``org/model`` id, under each annotation that renders flags, with a
  config file and an adapters dir) parses in the port's ``parse_args``
  into the config the JAX ``main`` builds, the config file merged on
  both sides.
- ``load_config_file`` merges a YAML file as the JAX one does: a
  ``vllm:`` section, an ``engine:`` section or the top level, both key
  spellings, null values and unknown keys ignored.

No test here touches the network: ``HF_HUB_OFFLINE`` is set, and both
registries' config fetchers are put back after each test.
"""

import dataclasses
import json

import pytest

import kaito_tpu.models.registry as jax_registry
import kaito_tpu_torch.models.registry as port_registry
from kaito_tpu.engine.config import EngineConfig as JaxEngineConfig
from kaito_tpu.engine.server import load_config_file as jax_load_config_file
from kaito_tpu_torch.engine.config import EngineConfig
from kaito_tpu_torch.engine.engine import resolve_async_dispatch
from kaito_tpu_torch.engine.server import load_config_file, parse_args
from tests.helpers.jax_server_argv import jax_main_config
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARGV = ["--model", "tiny-llama-test", "--dtype", "float32"]
TINYLLAMA = "TinyLlama/TinyLlama-1.1B-Chat-v1.0"
FIELDS = [f.name for f in dataclasses.fields(EngineConfig)]


@pytest.fixture(autouse=True)
def _no_network_and_own_fetchers(monkeypatch):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    for var in ("KAITO_INFERENCE_ROLE", "KAITO_COMM_OVERLAP", "KAITO_ASYNC_DISPATCH"):
        monkeypatch.delenv(var, raising=False)
    # parse_args installs the port's fetcher for an org/model id; the
    # JAX side installs its own to plan such a Workspace
    monkeypatch.setattr(port_registry, "_config_fetcher", port_registry._config_fetcher)
    monkeypatch.setattr(jax_registry, "_config_fetcher", jax_registry._config_fetcher)


def _resolved(cfg) -> dict:
    """Every field of ``cfg``; the two gates that the port leaves None
    to follow the environment resolved as the port's engine resolves
    them."""
    out = {name: getattr(cfg, name) for name in FIELDS}
    out["async_dispatch"] = resolve_async_dispatch(cfg)
    if cfg.comm_overlap is None:
        out["comm_overlap"] = False      # KAITO_COMM_OVERLAP is unset here
    return out


def _assert_same(port_cfg, jax_cfg):
    got, want = _resolved(port_cfg), _resolved(jax_cfg)
    diff = {k: (got[k], want[k]) for k in FIELDS if got[k] != want[k]}
    assert not diff, diff


# ---------------------------------------------------------------------------
# --kv-import-retries and --inference-role
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra,env", [
    ([], None),
    (["--kv-import-retries", "3"], None),
    (["--kv-import-retries", "0"], None),
    (["--inference-role", "decode"], None),
    ([], "prefill"),
    (["--inference-role", "decode"], "prefill"),
], ids=["defaults", "retries-3", "retries-0", "role-flag", "role-env", "flag-over-env"])
def test_kv_import_retries_and_role_match_the_jax_server(monkeypatch, extra, env):
    if env is not None:
        monkeypatch.setenv("KAITO_INFERENCE_ROLE", env)
    cfg, _ = parse_args(ARGV + extra)
    jax_kw = jax_main_config(monkeypatch, ARGV + extra)
    assert cfg.kv_import_retries == jax_kw["kv_import_retries"]
    assert cfg.role == jax_kw["role"]
    want_role = "decode" if "--inference-role" in extra else (env or "")
    assert cfg.role == want_role
    assert cfg.kv_import_retries == (int(extra[1]) if "--kv-import-retries" in extra
                                     else 1)


def test_item59_command_line_no_longer_exits():
    """The JAX server's command line with both flags: the port took
    neither before and exited 2."""
    cfg, _ = parse_args(ARGV + ["--kv-import-retries", "2", "--inference-role",
                                "prefill"])
    assert (cfg.kv_import_retries, cfg.role) == (2, "prefill")


# ---------------------------------------------------------------------------
# The operator's command line
# ---------------------------------------------------------------------------

QOS = json.dumps({"classes": {"guaranteed": {"priority": 100, "weight": 8},
                              "best-effort": {"priority": 0, "weight": 1,
                                              "max_queue_len": 4}},
                  "tenants": {"acme": "guaranteed"}, "default_class": "best-effort"})
# each annotation that renders flags into the engine command
ANNOTATIONS = {
    "kv-cache-dtype": {"kaito-tpu.io/kv-cache-dtype": "int8"},
    "quantization": {"kaito-tpu.io/quantization": "int4"},
    "qos": {"kaito-tpu.io/qos": QOS},
    "prefill-pack": {"kaito-tpu.io/prefill-pack": "3"},
    "kv-pool": {"kaito-tpu.io/kv-pool": "true", "kaito-tpu.io/kv-pool-bytes": "1048576",
                "kaito-tpu.io/kv-pool-disk": "20Gi"},
    "speculative-draft": {"kaito-tpu.io/speculative-draft": "auto"},
    "adapters": {"kaito-tpu.io/adapters": json.dumps(
        {"slots": 4, "rmax": 16, "host_bytes": 268435456, "allow_base_mismatch": True,
         "allowlist": ["oras://ghcr.io/acme/"]})},
    "structured-output": {"kaito-tpu.io/structured-output": json.dumps(
        {"enabled": False, "cache_entries": 128, "max_states": 1024})},
    "devprof": {"kaito-tpu.io/devprof": "2.5"},
    "comm-overlap": {"kaito-tpu.io/comm-overlap": "true"},
    "itl": {"kaito-tpu.io/itl": "true"},
    "flight": {"kaito-tpu.io/flight-dir": "/var/flight",
               "kaito-tpu.io/flight-max-bundles": "5"},
}
# a flag each annotation renders
RENDERS = {"kv-cache-dtype": "--kv-cache-dtype", "quantization": "--quantization",
           "qos": "--qos-config", "prefill-pack": "--prefill-pack",
           "kv-pool": "--kv-pool-disk-bytes", "speculative-draft": "--speculative-draft",
           "adapters": "--adapter-allow-base-mismatch",
           "structured-output": "--no-structured-output",
           "devprof": "--devprof-interval-s", "comm-overlap": "--comm-overlap",
           "itl": "--itl", "flight": "--flight-max-bundles"}
# (model, instance type, annotations, with a config file and adapters dir)
CASES = {
    "preset": ("qwen3-32b", "ct5lp-hightpu-8t", (), False),
    **{f"preset-{name}": ("qwen3-32b", "ct5lp-hightpu-8t", (name,), False)
       for name in ANNOTATIONS},
    "preset-all-config-file": ("qwen3-32b", "ct5lp-hightpu-8t", tuple(ANNOTATIONS), True),
    "catalog-id": (TINYLLAMA, "ct5lp-hightpu-1t", (), False),
    "catalog-id-config-file": (TINYLLAMA, "ct5lp-hightpu-1t", (), True),
    "catalog-id-all": (TINYLLAMA, "ct5lp-hightpu-1t", tuple(ANNOTATIONS), True),
}
CONFIG_YAML = ("vllm:\n  max-num-seqs: 4\n  served-model-name: tiny-chat\n"
               "  quantization: int8\n  page-size: 32\n  gpu-memory-utilization: 0.9\n")


def _render(model, instance, annotations, config_file, adapters_dir):
    from kaito_tpu.api import InferenceSpec, ObjectMeta, ResourceSpec, Workspace
    from kaito_tpu.controllers.runtime import Store
    from kaito_tpu.controllers.workspace import plan_workspace
    from kaito_tpu.manifests.inference import build_engine_command
    from kaito_tpu.models.hub import install_default_fetcher

    install_default_fetcher()
    ws = Workspace(ObjectMeta(name="ws"),
                   resource=ResourceSpec(instance_type=instance),
                   inference=InferenceSpec(preset=model))
    for name in annotations:
        ws.metadata.annotations.update(ANNOTATIONS[name])
    md, plan, _ = plan_workspace(Store(), ws)
    return build_engine_command(ws, md, plan, config_file=config_file,
                                adapters_dir=adapters_dir)


@pytest.mark.parametrize("case", list(CASES))
def test_operator_command_line_parses_as_the_jax_server(monkeypatch, tmp_path, case):
    model, instance, annotations, with_files = CASES[case]
    config_file = adapters_dir = ""
    if with_files:
        config_file = str(tmp_path / "inference_config.yaml")
        with open(config_file, "w") as f:
            f.write(CONFIG_YAML)
        adapters_dir = str(tmp_path / "adapters")
    cmd = _render(model, instance, annotations, config_file, adapters_dir)
    assert cmd[:3] == ["python", "-m", "kaito_tpu.engine.server"]
    argv = cmd[3:]
    assert argv[argv.index("--model") + 1] == model
    # TinyLlama has no curated draft: "auto" renders nothing for it
    assert {RENDERS[a] for a in annotations
            if (a, model) != ("speculative-draft", TINYLLAMA)} <= set(argv)
    cfg, args = parse_args(argv + ["--device", "cpu"])
    if config_file:
        assert args.kaito_config_file == config_file
        cfg = load_config_file(cfg, args.kaito_config_file)
    jax_cfg = JaxEngineConfig(**jax_main_config(monkeypatch, argv, accelerator=True))
    if config_file:
        jax_cfg = jax_load_config_file(jax_cfg, config_file)
        assert (cfg.max_num_seqs, cfg.served_model_name, cfg.quantization,
                cfg.page_size) == (4, "tiny-chat", "int8", 32)
    _assert_same(cfg, jax_cfg)
    assert cfg.model == model


def test_catalog_id_resolves_after_parse_args():
    """parse_args installs the port's fetcher for an org/model id, so
    the engine's lookup of the rendered id resolves from the catalog."""
    parse_args(["--model", TINYLLAMA, "--device", "cpu"])
    md = port_registry.get_model_by_name(TINYLLAMA)
    a = md.arch
    assert (a.num_layers, a.num_heads, a.num_kv_heads, a.head_dim, a.vocab_size,
            a.hidden_size, a.intermediate_size) == (22, 32, 4, 64, 32000, 2048, 5632)


# ---------------------------------------------------------------------------
# load_config_file
# ---------------------------------------------------------------------------

CONFIG_FILES = {
    "vllm-hyphens": (
        "vllm:\n  max-model-len: 1024\n  max-num-seqs: 6\n  served-model-name: m\n"
        "  tensor-parallel-size: 2\n  pipeline-parallel-size: 1\n"
        "  data-parallel-size: 1\n  sequence-parallel-size: 1\n  page-size: 32\n"
        "  dtype: float32\n  kv-cache-dtype: int8\n  quantization: int4\n  seed: 9\n"
        "  port: 6000\n  structured-output: false\n  grammar-cache-entries: 7\n"
        "  grammar-max-states: 99\n"),
    "engine-underscores": (
        "engine:\n  max_model_len: 512\n  max_num_seqs: 3\n  served_model_name: e\n"
        "  tensor_parallel_size: 4\n  pipeline_parallel_size: 2\n"
        "  data_parallel_size: 2\n  sequence_parallel_size: 2\n  page_size: 16\n"
        "  structured_output: true\n  grammar_cache_entries: 5\n"
        "  grammar_max_states: 64\n"),
    "top-level": "max-num-seqs: 2\nquantization: int8\nserved_model_name: top\n",
    "vllm-over-engine": "vllm:\n  max-num-seqs: 5\nengine:\n  max-num-seqs: 9\n",
    "nulls-and-unknown-keys": (
        "vllm:\n  max-num-seqs: null\n  served-model-name: ~\n  quantization: int8\n"
        "  gpu-memory-utilization: 0.9\n  enforce-eager: true\n  model: other/model\n"),
    "empty": "",
    "empty-vllm-section": "vllm: {}\nmax-num-seqs: 3\n",
}


@pytest.mark.parametrize("name", list(CONFIG_FILES))
def test_load_config_file_matches_the_jax_one(tmp_path, name):
    path = tmp_path / "config.yaml"
    path.write_text(CONFIG_FILES[name])
    base = dict(model="tiny-llama-test", max_num_seqs=8, served_model_name="flag",
                port=5000)
    got = load_config_file(EngineConfig(**base), str(path))
    want = jax_load_config_file(JaxEngineConfig(**base), str(path))
    _assert_same(got, want)
    if name == "nulls-and-unknown-keys":
        assert (got.max_num_seqs, got.served_model_name, got.quantization,
                got.model) == (8, "flag", "int8", "tiny-llama-test")
    if name == "vllm-over-engine":
        assert got.max_num_seqs == 5
