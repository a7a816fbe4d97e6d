"""The port's accelerator catalog, estimator and planner against the
JAX package's, and their GPU half, on the CPU.

- TPU numbers: the chip catalog, machine types, topology parsing, the
  BYO label lookup and default machine types equal the JAX package's;
  ``estimate_slice`` and ``plan_parallelism`` equal the JAX package's for
  every catalog model x TPU generation (serve and train, bf16 and int8
  weights, bf16 and int8 KV), errors included.
- GPU entries: the A3 machine types, peaks from the engine's one table
  (``engine.devprof.CARD_PEAKS``), the BYO lookup from GPU feature
  discovery's labels (product, count, memory within 1%).
- The GPU estimator: a card's budget follows the engine's own reserve
  (the same objects, imported); its weight bytes equal
  ``param_bytes()`` of the port's model, loaded whole and at TP=2 on a
  CPU mesh (each shard), for dense, MoE and MLA models in bf16, int8 and
  int4; a preset's mxfp4 is counted as the bf16 the engine loads, while
  the TPU half keeps the JAX count; int8 pages carry their scales.
"""

import dataclasses
import math

import pytest
import torch

from kaito_tpu.estimator import estimator as jest
from kaito_tpu.models.registry import get_model_by_name as jax_model
from kaito_tpu.models.registry import list_presets
from kaito_tpu.parallel import plan as jplan
from kaito_tpu.sku import catalog as jcat
from kaito_tpu_torch.engine import devprof
from kaito_tpu_torch.engine import engine as teng
from kaito_tpu_torch.engine.model import TensorParallelLM, TransformerLM
from kaito_tpu_torch.estimator import estimator as port_est
from kaito_tpu_torch.models.registry import get_model_by_name as port_model
from kaito_tpu_torch.parallel import plan as tplan
from kaito_tpu_torch.parallel.mesh import build_mesh
from kaito_tpu_torch.sku import catalog as tcat
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

JAX_CHIP_FIELDS = [f.name for f in dataclasses.fields(jcat.TPUChipSpec)]
PRESETS = list_presets()
GENERATIONS = sorted(jcat.CHIP_CATALOG)


def _chip(c) -> dict:
    return {name: getattr(c, name) for name in JAX_CHIP_FIELDS}


# ---------------------------------------------------------------------------
# The TPU catalog
# ---------------------------------------------------------------------------

def test_tpu_catalog_and_machine_types_equal_the_jax_ones():
    assert sorted(tcat.CHIP_CATALOG) == sorted(jcat.CHIP_CATALOG)
    for gen in jcat.CHIP_CATALOG:
        assert _chip(tcat.CHIP_CATALOG[gen]) == _chip(jcat.CHIP_CATALOG[gen])
        assert tcat.CHIP_CATALOG[gen].resource == "google.com/tpu"
    assert dict(tcat.MACHINE_TYPES) == dict(jcat.MACHINE_TYPES)
    assert (tcat.LABEL_TPU_ACCELERATOR, tcat.LABEL_TPU_TOPOLOGY, tcat.LABEL_TPU_MACHINE) \
        == (jcat.LABEL_TPU_ACCELERATOR, jcat.LABEL_TPU_TOPOLOGY, jcat.LABEL_TPU_MACHINE)


@pytest.mark.parametrize("topology", ["2x4", "4x4x8", "1x1", "16x16x16", "8", "4xx4",
                                      "0x2", "", "axb"])
def test_topology_parsing_equals_the_jax_one(topology):
    def run(cat):
        try:
            return cat.parse_topology(topology), cat.topology_chips(topology)
        except ValueError as e:
            return str(e)
    assert run(tcat) == run(jcat)


def test_sku_handler_and_byo_lookup_equal_the_jax_ones():
    th, jh = tcat.get_sku_handler("gke"), jcat.get_sku_handler("GKE")
    for gen in GENERATIONS:
        for topo in jcat.CHIP_CATALOG[gen].valid_topologies:
            assert th.default_machine_type(gen, topo) == jh.default_machine_type(gen, topo)
            for chips in (1, 3, 9, 300):
                assert tcat.CHIP_CATALOG[gen].topology_for_chips(chips) == \
                    jcat.CHIP_CATALOG[gen].topology_for_chips(chips)
    for mt in jcat.MACHINE_TYPES:
        tc, tn = th.get_chip_config_by_machine_type(mt)
        jc, jn = jh.get_chip_config_by_machine_type(mt)
        assert (_chip(tc), tn) == (_chip(jc), jn)
    with pytest.raises(ValueError):
        tcat.get_sku_handler("azure")
    for labels in ({jcat.LABEL_TPU_ACCELERATOR: "tpu-v5-lite-podslice",
                    jcat.LABEL_TPU_TOPOLOGY: "2x4", jcat.LABEL_TPU_MACHINE: "ct5lp-hightpu-8t"},
                   {jcat.LABEL_TPU_ACCELERATOR: "tpu-v6e-slice", jcat.LABEL_TPU_TOPOLOGY: "4x4"},
                   {jcat.LABEL_TPU_ACCELERATOR: "nope", jcat.LABEL_TPU_TOPOLOGY: "2x2"},
                   {jcat.LABEL_TPU_TOPOLOGY: "2x2"}):
        t, j = tcat.get_tpu_config_from_node_labels(labels), \
            jcat.get_tpu_config_from_node_labels(labels)
        assert (t is None) == (j is None)
        if t is not None:
            assert (_chip(t.chip), t.topology, t.machine_type, t.node_selector()) == \
                (_chip(j.chip), j.topology, j.machine_type, j.node_selector())
            assert tcat.get_slice_config_from_node_labels(labels).chip == t.chip


# ---------------------------------------------------------------------------
# TPU numbers: every catalog model x generation
# ---------------------------------------------------------------------------

def _estimate(mod, md, chip, **kw):
    try:
        e = mod.estimate_slice(md, chip, **kw)
    except ValueError as err:
        return str(err)
    return {f.name: (_chip(e.chip) if f.name == "chip" else getattr(e, f.name))
            for f in dataclasses.fields(e)}


def _plan(mod, md, chip, **kw):
    try:
        p = mod.plan_parallelism(md, chip, **kw)
    except ValueError as err:
        return str(err)
    out = {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}
    out["chip"] = _chip(p.chip)
    out["estimate"] = {f.name: getattr(p.estimate, f.name)
                       for f in dataclasses.fields(p.estimate) if f.name != "chip"}
    out["mesh"] = p.mesh.axes
    return out | {"chips": p.total_chips, "hosts": p.num_hosts}


VARIANTS = [dict(), dict(quantization="int8"), dict(kv_dtype_bytes=1),
            dict(quantization="int4", kv_dtype_bytes=1, max_model_len=4096)]


@pytest.mark.parametrize("preset", PRESETS)
def test_tpu_estimate_and_plan_equal_the_jax_ones(preset):
    jmd, tmd = jax_model(preset), port_model(preset)
    for gen in GENERATIONS:
        jc, tc = jcat.CHIP_CATALOG[gen], tcat.CHIP_CATALOG[gen]
        for kw in VARIANTS:
            assert _estimate(port_est, tmd, tc, **kw) == _estimate(jest, jmd, jc, **kw)
            assert port_est.estimate_chip_count(tmd, tc, **kw) == \
                jest.estimate_chip_count(jmd, jc, **kw)
            q = kw.get("quantization")
            assert port_est.weight_bytes(tmd, q) == jest.weight_bytes(jmd, q)
            for n in (1, 4, 16):
                assert port_est.max_kv_tokens(tmd, tc, n, quantization=q) == \
                    jest.max_kv_tokens(jmd, jc, n, quantization=q)
        for kw in ({"workload": "serve"}, {"workload": "train"},
                   {"workload": "serve", "target_chips": 8},
                   {"workload": "serve", "cp_autocarve": True, "max_model_len": 65536},
                   {"workload": "serve", "quantization": "int8", "kv_dtype_bytes": 1}):
            assert _plan(tplan, tmd, tc, **kw) == _plan(jplan, jmd, jc, **kw), (gen, kw)


# ---------------------------------------------------------------------------
# The GPU catalog
# ---------------------------------------------------------------------------

def test_a3_machine_types_and_the_h100_entry():
    assert {mt: (card, n) for mt, (card, n) in tcat.GPU_MACHINE_TYPES.items()} == {
        "a3-highgpu-1g": ("h100-80gb", 1), "a3-highgpu-2g": ("h100-80gb", 2),
        "a3-highgpu-4g": ("h100-80gb", 4), "a3-highgpu-8g": ("h100-80gb", 8),
        "a3-megagpu-8g": ("h100-mega-80gb", 8)}
    card = tcat.GPU_CATALOG["h100-80gb"]
    bf16, int8, bytes_s = devprof.CARD_PEAKS[card.device_name]
    assert (card.bf16_tflops * 1e12, card.int8_tops * 1e12, card.hbm_gbps * 1e9) == \
        pytest.approx((bf16, int8, bytes_s), rel=1e-12)
    assert card.product == card.device_name.replace(" ", "-") == "NVIDIA-H100-80GB-HBM3"
    assert (card.resource, card.accelerator_key, card.topology_key, card.single_host) == (
        "nvidia.com/gpu", "cloud.google.com/gke-accelerator", "", True)
    assert tcat.GPU_CATALOG["h100-mega-80gb"].accelerator_label == "nvidia-h100-mega-80gb"
    one = tcat.machine_chip("a3-highgpu-2g")
    assert one.valid_topologies == ("1", "2") and one.chips_per_host == 2
    assert one.devices_per_pod(1) == 1 and one.devices_per_pod(2) == 2
    assert tcat.machine_chip("ct5lp-hightpu-4t") is tcat.CHIP_CATALOG["v5e"]
    assert tcat.CHIP_CATALOG["v5e"].devices_per_pod(1) == 8   # the JAX rule
    assert tcat.machine_chip("n2-standard-4") is None
    handler = tcat.get_sku_handler()
    assert handler.get_chip_config_by_machine_type("a3-megagpu-8g")[1] == 8
    assert "h100-80gb" in handler.get_supported_generations()


GFD = {"nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3", "nvidia.com/gpu.count": "8",
       "nvidia.com/gpu.memory": "81559"}


@pytest.mark.parametrize("labels,want", [
    (GFD, ("h100-80gb", "8")),
    (GFD | {"nvidia.com/gpu.count": "2"}, ("h100-80gb", "2")),
    (GFD | {"cloud.google.com/gke-accelerator": "nvidia-h100-mega-80gb"},
     ("h100-mega-80gb", "8")),
    ({k: v for k, v in GFD.items() if k != "nvidia.com/gpu.memory"}, ("h100-80gb", "8")),
    (GFD | {"nvidia.com/gpu.memory": "40960"}, None),        # not this card's memory
    (GFD | {"nvidia.com/gpu.product": "NVIDIA-A100-SXM4-80GB"}, None),
    (GFD | {"nvidia.com/gpu.count": "x"}, None),
    ({"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}, None),
], ids=["8-cards", "2-cards", "mega", "no-memory", "other-memory", "a100", "bad-count",
        "no-product"])
def test_gfd_labels_resolve_through_the_byo_lookup(labels, want):
    spec = tcat.get_gpu_config_from_node_labels(labels)
    assert (None if spec is None else (spec.chip.generation, spec.topology)) == want
    assert tcat.get_slice_config_from_node_labels(labels) == spec
    if spec is not None:
        assert spec.num_chips == int(want[1]) and spec.num_hosts == 1


# ---------------------------------------------------------------------------
# The GPU estimator
# ---------------------------------------------------------------------------

def test_gpu_budget_is_the_engines_sizing_rule():
    assert port_est._RESERVE_FRACTION is teng._RESERVE_FRACTION
    assert port_est._RESERVE_MIN_BYTES is teng._RESERVE_MIN_BYTES
    card = tcat.GPU_CATALOG["h100-80gb"]
    total = card.hbm_bytes
    assert port_est.gpu_card_budget(card) == total - max(
        int(total * teng._RESERVE_FRACTION), teng._RESERVE_MIN_BYTES) - \
        port_est.CUDA_CONTEXT_BYTES
    assert 0 < port_est.CUDA_CONTEXT_BYTES < 4 << 30


@pytest.mark.parametrize("name", ["tiny-llama-test", "tiny-moe-real", "llama-3.1-8b-instruct"])
@pytest.mark.parametrize("quant", ["", "int8", "int4"])
def test_engine_weight_bytes_equal_the_models_param_bytes(name, quant):
    md = port_model(name)
    if name == "llama-3.1-8b-instruct":
        # the loaded engines' param_bytes() on the card (chip_smoke.py
        # phases 4-5 sizing reports; NVIDIA H100 80GB HBM3, 700 W)
        want = {"": 16060522496, "int8": 9086705664, "int4": 5809643520}[quant]
    else:
        model = TransformerLM(md.arch, dtype=torch.bfloat16, device="cpu")
        model.init_params(0, quantization=quant)
        want = model.param_bytes()
    assert port_est.engine_weight_bytes(md, quant) == want


@pytest.mark.parametrize("quant", ["", "int8", "int4"])
def test_engine_weight_bytes_at_tp2_equal_each_shards(quant):
    md = port_model("tiny-llama-test")
    model = TensorParallelLM(md.arch, build_mesh(tensor=2, devices=["cpu", "cpu"]),
                             dtype=torch.bfloat16)
    model.init_params(0, quantization=quant)
    shards = [s.param_bytes() for s in model.shards]
    assert port_est.engine_weight_bytes(md, quant, 2) == max(shards)


def test_tiny_mla_weight_bytes_equal_the_models():
    from kaito_tpu_torch.models.autogen import metadata_from_hf_config
    from tests.test_torch_mla import MLA_CFG

    md = metadata_from_hf_config("test/tiny-mla", MLA_CFG, name="tiny-mla-test")
    for quant in ("", "int8"):
        model = TransformerLM(md.arch, dtype=torch.bfloat16, device="cpu")
        model.init_params(0, quantization=quant)
        assert port_est.engine_weight_bytes(md, quant) == model.param_bytes()


def test_mxfp4_preset_counts_the_bf16_the_engine_loads():
    """gpt-oss's preset says mxfp4; neither engine loads it.  The GPU
    half counts 2 bytes a parameter (so 120B needs several cards); the
    TPU half keeps the JAX count."""
    md = port_model("gpt-oss-120b")
    assert md.quantization == "mxfp4"
    params = md.arch.param_count()
    gpu = port_est.engine_weight_bytes(md, "")
    assert gpu >= 2 * params * 0.99
    assert port_est.weight_bytes(md) == jest.weight_bytes(jax_model("gpt-oss-120b"))
    assert port_est.weight_bytes(md) < gpu / 3
    est = port_est.estimate_slice(md, tcat.machine_chip("a3-highgpu-8g"))
    assert est.num_chips > 1


@pytest.mark.parametrize("kv", [2, 1])
def test_gpu_kv_tokens_are_whole_pages_of_the_engines_pool(kv):
    from kaito_tpu_torch.engine.config import EngineConfig
    from kaito_tpu_torch.engine.kv_cache import scale_bytes_per_page

    md = port_model("llama-3.1-8b-instruct")
    card = tcat.machine_chip("a3-highgpu-1g")
    page = md.kv_bytes_per_token(kv) * EngineConfig.page_size + (
        scale_bytes_per_page(md.arch) if kv == 1 else 0)
    room = port_est.gpu_card_budget(card) - port_est.engine_weight_bytes(md, "int8")
    got = port_est.max_kv_tokens(md, card, 1, kv_dtype_bytes=kv, quantization="int8")
    assert got == room // page * EngineConfig.page_size
    est = port_est.estimate_slice(md, card, kv_dtype_bytes=kv, quantization="int8")
    assert est.num_chips == 1 and est.max_kv_tokens == got
    assert est.weights_bytes == port_est.engine_weight_bytes(md, "int8")


@pytest.mark.parametrize("preset,machine,cards", [
    ("llama-3.1-8b-instruct", "a3-highgpu-1g", 1),
    ("llama-3.1-8b-instruct", "a3-highgpu-8g", 1),
    ("llama-3.3-70b-instruct", "a3-highgpu-8g", 4),
    ("qwen3-32b", "a3-highgpu-8g", 1),
    ("gpt-oss-20b", "a3-highgpu-1g", 1),
])
def test_gpu_plans_are_tensor_parallel_on_one_node(preset, machine, cards):
    md = port_model(preset)
    plan = tplan.plan_parallelism(md, tcat.machine_chip(machine))
    assert plan.total_chips == cards == plan.mesh.size("tensor")
    assert plan.mesh.num_devices == cards and plan.num_hosts == 1
    assert all(plan.mesh.size(a) == 1 for a in ("data", "pipeline", "sequence",
                                                "expert", "fsdp"))
    per_card = port_est.engine_weight_bytes(md, "", cards)
    ctx_pages = math.ceil(md.max_model_len / 64) * port_est.gpu_page_bytes(md)
    assert per_card + ctx_pages / cards <= port_est.gpu_card_budget(plan.chip)


def test_gpu_plan_refusals_name_their_roadmap_item():
    card8 = tcat.machine_chip("a3-highgpu-8g")
    with pytest.raises(ValueError, match="item 38"):
        tplan.plan_parallelism(port_model("gpt-oss-120b"), card8)
    with pytest.raises(ValueError, match="M19"):
        tplan.plan_parallelism(port_model("deepseek-v3-0324"), card8)
    with pytest.raises(ValueError, match="M19"):
        tplan.plan_parallelism(port_model("llama-3.3-70b-instruct"),
                               tcat.machine_chip("a3-highgpu-1g"))
    # a dense MLA model on two cards (asked for) meets item 40
    v3 = port_model("deepseek-v3-0324")
    dense_mla = v3.with_overrides(arch=dataclasses.replace(v3.arch, num_layers=2,
                                                           num_experts=0))
    with pytest.raises(ValueError, match="item 40"):
        tplan.plan_parallelism(dense_mla, card8, target_chips=2, max_model_len=4096)
    with pytest.raises(ValueError, match="trainer on a mesh"):
        tplan.plan_parallelism(port_model("llama-3.3-70b-instruct"), card8,
                               workload="train")
