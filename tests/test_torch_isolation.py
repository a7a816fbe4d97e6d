"""The port stands alone: no module of kaito_tpu_torch, and not
chip_smoke.py, imports jax, flax, msgpack, ml_dtypes or anything of
kaito_tpu (the card machine has none of them: the adapter artifact's
msgpack is read by the port's own codec, ``utils/msgpack.py``, and the
KV wire's bfloat16 bytes move through torch, ``engine/pd.py``); every
module imports on a machine without a card; and a CUDA request without a
usable card raises instead of falling back to the CPU."""

import ast
import importlib
import pathlib

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "kaito_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "kaito_tpu", "flax", "msgpack", "ml_dtypes")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name):
    root = name.split(".")[0]
    return root in FORBIDDEN


def test_sources_found():
    assert len(SOURCES) > 15
    assert (PKG / "csrc" / "decode_attention.cu").exists()
    assert (PKG / "csrc" / "flash_prefill.cu").exists()
    assert (PKG / "csrc" / "quant_matmul.cu").exists()
    assert PKG / "engine" / "quant.py" in SOURCES
    assert PKG / "engine" / "ops" / "quant_matmul.py" in SOURCES
    for mod in ("engine/prefix_cache.py", "engine/metrics.py", "engine/qos.py",
                "engine/rate_limit.py", "engine/spec.py", "engine/grammar.py",
                "engine/parsers.py", "runtime/slo.py", "utils/tracing.py",
                "utils/promtext.py", "utils/flightrec.py", "utils/msgpack.py",
                "tuning/lora.py", "engine/adapters.py", "engine/adapter_cache.py",
                "engine/devprof.py", "engine/host_offload.py", "engine/pd.py",
                "engine/kv_pool.py", "runtime/routing.py", "utils/failpoints.py",
                "tuning/quant.py", "tuning/optim.py", "tuning/train_step.py",
                "tuning/dataset.py", "tuning/trainer.py", "tuning/cli.py",
                "tuning/metrics_server.py", "engine/streaming.py", "models/hub.py",
                "ui/__init__.py", "ui/__main__.py", "featuregates.py",
                "utils/quantity.py", "api/meta.py", "api/workspace.py",
                "api/conversion.py", "sku/catalog.py", "estimator/estimator.py",
                "parallel/plan.py", "controllers/objects.py", "controllers/runtime.py",
                "controllers/workspace.py", "k8s/events.py", "provision/karpenter.py",
                "provision/fake.py", "manifests/inference.py",
                "manifests/tuning_job.py"):
        assert PKG / mod in SOURCES, mod


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_and_no_kaito_tpu_imports(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_every_module_imports_without_a_card():
    for path in sorted(PKG.rglob("*.py")):
        mod = ".".join(path.relative_to(REPO).with_suffix("").parts)
        importlib.import_module(mod.removesuffix(".__init__"))


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_cuda_request_without_a_card_raises(no_cuda):
    from kaito_tpu_torch.device import resolve_device
    from kaito_tpu_torch.engine.config import EngineConfig
    from kaito_tpu_torch.engine.engine import InferenceEngine
    from kaito_tpu_torch.engine.model import TransformerLM
    from kaito_tpu_torch.engine.server import main, make_server
    from kaito_tpu_torch.models import get_model_by_name

    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    cfg = EngineConfig(model="tiny-llama-test", max_model_len=64)
    with pytest.raises(RuntimeError, match="cuda"):
        InferenceEngine(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        TransformerLM(get_model_by_name("tiny-llama-test").arch)
    with pytest.raises(RuntimeError, match="cuda"):
        make_server(None, cfg, port=0)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--model", "tiny-llama-test", "--port", "0"])


def test_helpers_default_to_the_card(no_cuda):
    from kaito_tpu_torch.engine.kv_cache import create_kv_cache
    from kaito_tpu_torch.engine.nn import rope_frequencies
    from kaito_tpu_torch.engine.sampler import SamplingState
    from kaito_tpu_torch.models import get_model_by_name

    arch = get_model_by_name("tiny-llama-test").arch
    with pytest.raises(RuntimeError, match="cuda"):
        create_kv_cache(arch, 4, 16)
    with pytest.raises(RuntimeError, match="cuda"):
        rope_frequencies(arch)
    with pytest.raises(RuntimeError, match="cuda"):
        SamplingState.create(2)
    assert create_kv_cache(arch, 4, 16, device="cpu").k.device.type == "cpu"
    assert rope_frequencies(arch, "cpu").device.type == "cpu"
    assert SamplingState.create(2, device="cpu").device.type == "cpu"


def test_cpu_is_taken_only_when_asked():
    from kaito_tpu_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_build_key_covers_the_kernel_sources():
    from kaito_tpu_torch.ops import build

    assert build.source_key() == build.source_key()
    assert build.build_dir().parent.name == "kernels"
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
