"""The port's Workspace path (api, sku, estimator, plan, provision,
manifests, the Workspace reconciler) against the JAX package's, on the
CPU.

- TPU parity: the scenarios of ``tests/test_controllers.py`` (single
  chip, llama-70b multihost, provisioning delay, invalid Workspace,
  tuning, upgrade annotation, delete, revision history) and every case
  of ``tests/test_torch_startup.py::CASES`` run through both packages'
  ``Store`` + ``FakeCloud`` + Karpenter provisioner +
  ``WorkspaceReconciler``.  Every stored object (NodePools, Nodes,
  StatefulSets, Services, Jobs, ControllerRevisions, the Workspace with
  its conditions) and every event are equal as plain dicts, with
  timestamps and the measured provisioning seconds removed.
- GPU cases with stated expectations: Llama-3.1-8B on ``a3-highgpu-1g``
  is one card at TP=1; Llama-3.3-70B on ``a3-highgpu-8g`` requests as
  many ``nvidia.com/gpu`` as its tensor degree, data 1; a node labelled
  by GPU feature discovery resolves to the H100 entry; gpt-oss-120b
  (MoE over several cards) and DeepSeek-V3 (more than one node) fail
  their plan, naming their ROADMAP item; a tuning Workspace runs the
  port's trainer; a long-tail preset runs the port's HF fallback on one
  card.
- Every rendered GPU command line parses through the port's
  ``parse_args`` with the rendered env applied, into an ``EngineConfig``
  that ``check_ported`` and ``check_tensor_parallel`` accept.
"""

import dataclasses
import importlib
import json
import re
import types

import pytest

import kaito_tpu.models.registry as jax_registry
import kaito_tpu_torch.models.registry as port_registry
from kaito_tpu_torch.engine.engine import check_ported
from kaito_tpu_torch.engine.model import check_tensor_parallel
from kaito_tpu_torch.engine.server import load_config_file, parse_args
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_startup import ANNOTATIONS, CASES, CONFIG_YAML, TINYLLAMA

_TIMESTAMPS = {"creation_timestamp", "deletion_timestamp", "last_transition_time",
               "first_timestamp", "last_timestamp"}
# wall-clock readings: the NodePool's stamps and the seconds between them
_CLOCK_KEYS = {"kaito-tpu.io/provision-start", "kaito-tpu.io/ready-at",
               "provision_to_ready_seconds", "notReadySince"}
_SECONDS = re.compile(r"provisioned in [0-9.]+s")


@pytest.fixture(autouse=True)
def _offline_fetchers(monkeypatch):
    """Both registries' hub fetchers (the catalog ids need no network)
    put back after each test."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setattr(port_registry, "_config_fetcher", port_registry._config_fetcher)
    monkeypatch.setattr(jax_registry, "_config_fetcher", jax_registry._config_fetcher)
    for root in ("kaito_tpu", "kaito_tpu_torch"):
        importlib.import_module(f"{root}.models.hub").install_default_fetcher()


def _pkg(root: str) -> types.SimpleNamespace:
    """The operator's modules of one package."""
    mods = {name: importlib.import_module(f"{root}.{path}") for name, path in (
        ("api", "api"), ("ws", "api.workspace"), ("meta", "api.meta"),
        ("runtime", "controllers.runtime"), ("ctrl", "controllers.workspace"),
        ("prov", "provision"), ("inference", "manifests.inference"))}
    return types.SimpleNamespace(**mods)


JAX, PORT = _pkg("kaito_tpu"), _pkg("kaito_tpu_torch")


def _plain(x):
    """``x`` as plain data: dataclasses and objects as dicts of their
    fields, timestamps and clock readings dropped."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)
                if f.name not in _TIMESTAMPS}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items() if k not in _CLOCK_KEYS}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if hasattr(x, "__dict__"):
        return {k: _plain(v) for k, v in vars(x).items() if k not in _TIMESTAMPS}
    if isinstance(x, str):
        return _SECONDS.sub("provisioned in Xs", x)
    return x


def _snapshot(store) -> dict:
    objs = {kind: {f"{ns}/{name}": _plain(o) for (ns, name), o in sorted(by.items())}
            for kind, by in sorted(store._objects.items()) if by}
    events = [_plain(e) for e in store.events.events()]
    return {"objects": objs, "events": events}


def _env(p, delay=0):
    store = p.runtime.Store()
    cloud = p.prov.FakeCloud(store, provision_delay_ticks=delay)
    rec = p.ctrl.WorkspaceReconciler(store, p.prov.KarpenterTPUProvisioner(store))
    return store, cloud, rec


def _drive(store, cloud, rec, name, ticks=6):
    for _ in range(ticks):
        rec.reconcile_key("default", name)
        cloud.tick()


def _workspace(p, name, instance, preset, annotations=None, **inference):
    ws = p.api.Workspace(p.api.ObjectMeta(name=name),
                         resource=p.api.ResourceSpec(instance_type=instance),
                         inference=p.api.InferenceSpec(preset=preset, **inference))
    ws.metadata.annotations.update(annotations or {})
    return ws


# ---------------------------------------------------------------------------
# TPU parity: the scenarios of tests/test_controllers.py
# ---------------------------------------------------------------------------

def _single_chip(p):
    store, cloud, rec = _env(p)
    store.create(_workspace(p, "phi", "ct5lp-hightpu-1t", "phi-4-mini-instruct"))
    _drive(store, cloud, rec, "phi")
    return store


def _llama70b_multihost(p):
    store, cloud, rec = _env(p)
    store.create(_workspace(p, "llama70", "ct5lp-hightpu-8t", "llama-3.3-70b-instruct"))
    _drive(store, cloud, rec, "llama70", ticks=8)
    return store


def _provisioning_delay(p):
    store, cloud, rec = _env(p, delay=3)
    store.create(_workspace(p, "slow", "ct5lp-hightpu-1t", "phi-4-mini-instruct"))
    rec.reconcile_key("default", "slow")
    cloud.tick()
    _drive(store, cloud, rec, "slow")
    return store


def _invalid(p):
    store, cloud, rec = _env(p)
    store.create(p.api.Workspace(p.api.ObjectMeta(name="bad"),
                                 inference=p.api.InferenceSpec(preset="no-such-preset")))
    _drive(store, cloud, rec, "bad", ticks=2)
    return store


def _tuning(p):
    store, cloud, rec = _env(p)
    store.create(p.api.Workspace(
        p.api.ObjectMeta(name="tune"),
        resource=p.api.ResourceSpec(instance_type="ct5lp-hightpu-4t"),
        tuning=p.api.TuningSpec(preset="phi-4-mini-instruct", method="qlora",
                                input=p.ws.TuningInput(urls=["https://x/d.jsonl"]),
                                output=p.ws.TuningOutput(image="reg/out:v1"))))
    _drive(store, cloud, rec, "tune")
    return store


def _upgrade(p):
    store, cloud, rec = _env(p)
    store.create(_workspace(p, "up", "ct5lp-hightpu-1t", "phi-4-mini-instruct"))
    _drive(store, cloud, rec, "up")

    def annotate(o):
        o.metadata.annotations[p.ws.ANNOTATION_UPGRADE_TO] = "v9"
    p.runtime.update_with_retry(store, "Workspace", "default", "up", annotate)
    _drive(store, cloud, rec, "up", ticks=2)
    return store


def _delete(p):
    store, cloud, rec = _env(p)
    store.create(_workspace(p, "gone", "ct5lp-hightpu-1t", "phi-4-mini-instruct"))
    _drive(store, cloud, rec, "gone")
    store.delete("Workspace", "default", "gone")
    rec.reconcile_key("default", "gone")
    cloud.tick()
    return store


def _revisions(p):
    store = p.runtime.Store()
    ws = p.api.Workspace(p.api.ObjectMeta(name="r"),
                         inference=p.api.InferenceSpec(preset="phi-4"))
    store.create(ws)
    p.runtime.sync_controller_revision(store, ws, ws.revision_payload())
    p.runtime.sync_controller_revision(store, ws, ws.revision_payload())
    ws.resource.count = 2
    p.runtime.sync_controller_revision(store, ws, ws.revision_payload())
    return store


def _slo_verdict(p):
    store, cloud, rec = _env(p)
    store.create(_workspace(p, "slo", "ct5lp-hightpu-1t", "phi-4-mini-instruct"))
    _drive(store, cloud, rec, "slo")

    def attach(o):
        o.status["benchmark"] = {"total_tpm": 5000.0, "errors": 0, "slo": {
            "healthy": False, "alerts": {"ttft_p50": "page", "availability": "ok"}}}
    p.runtime.update_with_retry(store, "StatefulSet", "default", "slo", attach)
    _drive(store, cloud, rec, "slo", ticks=2)
    return store


SCENARIOS = {"single-chip": _single_chip, "llama70b-multihost": _llama70b_multihost,
             "provisioning-delay": _provisioning_delay, "invalid": _invalid,
             "tuning": _tuning, "upgrade-annotation": _upgrade, "delete": _delete,
             "revision-history": _revisions, "slo-verdict": _slo_verdict}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_tpu_scenario_matches_the_jax_operator(name):
    want = _snapshot(SCENARIOS[name](JAX))
    got = _snapshot(SCENARIOS[name](PORT))
    assert got == want
    # the scenario did what its name says (the JAX tests hold the rest)
    ws = got["objects"].get("Workspace", {})
    if name in ("single-chip", "llama70b-multihost", "provisioning-delay"):
        conds = {c["type"]: c["status"] for w in ws.values()
                 for c in w["status"]["conditions"]}
        assert conds["InferenceReady"] == "True"
    if name == "delete":
        assert not ws and "NodePool" not in got["objects"]
    if name == "invalid":
        assert any(e["type"] == "Warning" for e in got["events"])


@pytest.mark.parametrize("case", list(CASES))
def test_startup_case_matches_the_jax_operator(case):
    """Each Workspace of the start-up cases reconciled to ready by both
    packages: equal NodePools, StatefulSets (the engine command among
    them), Services, conditions and events."""
    model, instance, annotations, with_files = CASES[case]
    ann = {}
    for a in annotations:
        ann.update(ANNOTATIONS[a])

    def run(p):
        store, cloud, rec = _env(p)
        extra = ({"config": "inference-config",
                  "adapters": [p.ws.AdapterSpec(name="a", source_image="reg/a:v1")]}
                 if with_files else {})
        store.create(_workspace(p, "ws", instance, model, ann, **extra))
        _drive(store, cloud, rec, "ws")
        return store

    want, got = _snapshot(run(JAX)), _snapshot(run(PORT))
    assert got == want
    cmd = got["objects"]["StatefulSet"]["default/ws"]["spec"]["template"]["spec"][
        "containers"][0]["command"]
    assert cmd[:3] == ["python", "-m", "kaito_tpu.engine.server"]
    assert ("--kaito-config-file" in cmd) == with_files


# ---------------------------------------------------------------------------
# GPU cases
# ---------------------------------------------------------------------------

def _gpu_run(ws, ticks=6):
    store, cloud, rec = _env(PORT)
    store.create(ws)
    _drive(store, cloud, rec, ws.metadata.name, ticks)
    return store, store.get("Workspace", "default", ws.metadata.name)


def _conds(ws) -> dict:
    return {c.type: c for c in ws.status.conditions}


def _engine(store, name):
    ss = store.get("StatefulSet", "default", name)
    return ss, ss.spec["template"]["spec"]["containers"][0]


def _env_of(container) -> dict:
    return {e["name"]: e["value"] for e in container["env"] if "value" in e}


def test_llama_8b_on_a3_highgpu_1g_is_one_card_at_tp1():
    store, ws = _gpu_run(_workspace(PORT, "l8", "a3-highgpu-1g", "llama-3.1-8b-instruct"))
    assert _conds(ws)["InferenceReady"].status == "True"
    ss, c = _engine(store, "l8")
    assert c["command"][:3] == ["python", "-m", "kaito_tpu_torch.engine.server"]
    assert c["resources"] == {"requests": {"nvidia.com/gpu": "1"},
                              "limits": {"nvidia.com/gpu": "1"}}
    env = _env_of(c)
    assert env["KAITO_TENSOR_PARALLEL"] == "1" and env["KAITO_DATA_PARALLEL"] == "1"
    assert not any("TPU" in k or k in ("KAITO_MESH_SPEC", "KAITO_COORDINATOR")
                   for k in env)
    pod = ss.spec["template"]["spec"]
    assert pod["tolerations"] == [{"key": "nvidia.com/gpu", "operator": "Exists",
                                   "effect": "NoSchedule"}]
    assert c["image"] == "ghcr.io/kaito-tpu/engine-cuda:latest"
    # the self-benchmark startup probe is the port's; one host: HTTP liveness
    assert c["startupProbe"]["exec"]["command"] == [
        "python", "-m", "kaito_tpu_torch.runtime.benchmark_probe"]
    assert "exec" not in json.dumps(c["livenessProbe"])
    assert ss.spec["replicas"] == 1
    node = store.list("Node")[0]
    assert all(node.metadata.labels.get(k) == v for k, v in pod["nodeSelector"].items())
    pool = store.get("NodePool", "", "l8-slice-0").spec["template"]["spec"]
    assert {r["key"]: r["values"] for r in pool["requirements"]} == {
        "cloud.google.com/gke-accelerator": ["nvidia-h100-80gb"],
        "node.kubernetes.io/instance-type": ["a3-highgpu-1g"]}
    assert pool["taints"] == [{"key": "nvidia.com/gpu", "value": "present",
                               "effect": "NoSchedule"}]


def test_llama_70b_on_a3_highgpu_8g_takes_tp_equal_to_its_cards():
    store, ws = _gpu_run(_workspace(PORT, "l70", "a3-highgpu-8g",
                                    "llama-3.3-70b-instruct"))
    assert _conds(ws)["InferenceReady"].status == "True"
    _, c = _engine(store, "l70")
    env = _env_of(c)
    tp = int(env["KAITO_TENSOR_PARALLEL"])
    assert tp in (2, 4, 8)
    assert c["resources"]["requests"] == {"nvidia.com/gpu": str(tp)}
    assert c["resources"]["limits"] == {"nvidia.com/gpu": str(tp)}
    assert (env["KAITO_DATA_PARALLEL"], env["KAITO_PIPELINE_PARALLEL"],
            env["KAITO_SEQUENCE_PARALLEL"]) == ("1", "1", "1")
    _, plan, spec = PORT.ctrl.plan_workspace(store, store.get("Workspace", "default", "l70"))
    assert plan.mesh.size("tensor") == plan.total_chips == tp and plan.num_hosts == 1
    assert spec.topology == str(tp)


def test_gpu_capacity_is_read_from_the_entrys_resource():
    """A GPU node that advertises no ``nvidia.com/gpu`` (its device plugin
    not up) holds the Workspace back; its cards let it through."""
    store, cloud, rec = _env(PORT)
    store.create(_workspace(PORT, "cap", "a3-highgpu-1g", "llama-3.1-8b-instruct"))
    rec.reconcile_key("default", "cap")
    cloud.tick()

    def allocatable(n, count):
        def mutate(o):
            o.status["allocatable"] = {"nvidia.com/gpu": count, "google.com/tpu": "4"}
        PORT.runtime.update_with_retry(store, "Node", "", n, mutate)

    node = store.list("Node")[0].metadata.name
    allocatable(node, "0")
    _drive(store, cloud, rec, "cap", ticks=2)
    cond = _conds(store.get("Workspace", "default", "cap"))["NodeClaimReady"]
    assert cond.status == "False" and node in cond.message
    assert store.try_get("StatefulSet", "default", "cap") is None
    allocatable(node, "1")
    _drive(store, cloud, rec, "cap", ticks=2)
    assert _conds(store.get("Workspace", "default", "cap"))["InferenceReady"].status == "True"


def test_gfd_labelled_byo_node_resolves_to_the_h100_entry():
    from kaito_tpu_torch.controllers.objects import node
    from kaito_tpu_torch.sku.catalog import GPU_CATALOG

    store = PORT.runtime.Store()
    store.create(node("gpu-0", {"pool": "mine",
                                "nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3",
                                "nvidia.com/gpu.count": "8",
                                "nvidia.com/gpu.memory": "81559"}))
    ws = PORT.api.Workspace(
        PORT.api.ObjectMeta(name="byo"),
        resource=PORT.api.ResourceSpec(instance_type="", label_selector={"pool": "mine"}),
        inference=PORT.api.InferenceSpec(preset="llama-3.1-8b-instruct"))
    assert ws.validate() == []
    md, plan, spec = PORT.ctrl.plan_workspace(store, ws)
    assert plan.chip.generation == "h100-80gb" == GPU_CATALOG["h100-80gb"].generation
    assert plan.chip.chips_per_host == 8 and spec.topology == "1"
    assert plan.mesh.size("tensor") == 1


@pytest.mark.parametrize("preset,instance,item", [
    ("gpt-oss-120b", "a3-highgpu-8g", "item 38"),
    ("deepseek-v3-0324", "a3-megagpu-8g", "M19"),
], ids=["gpt-oss-120b", "deepseek-v3"])
def test_plans_the_port_would_refuse_fail_at_plan_time(preset, instance, item):
    store, ws = _gpu_run(_workspace(PORT, "no", instance, preset), ticks=2)
    cond = _conds(ws)["ResourceReady"]
    assert (cond.status, cond.reason) == ("False", "PlanFailed")
    assert "ROADMAP" in cond.message and item in cond.message
    assert store.list("NodePool") == [] and store.list("StatefulSet") == []
    assert store.events.events(name="no", reason="PlanFailed")


def test_tuning_workspace_runs_the_ports_trainer_on_a_card():
    ws = PORT.api.Workspace(
        PORT.api.ObjectMeta(name="tune"),
        resource=PORT.api.ResourceSpec(instance_type="a3-highgpu-1g"),
        tuning=PORT.api.TuningSpec(preset="llama-3.2-1b-instruct", method="lora",
                                   input=PORT.ws.TuningInput(urls=["https://x/d.jsonl"]),
                                   output=PORT.ws.TuningOutput(image="reg/out:v1")))
    store, ws = _gpu_run(ws)
    assert _conds(ws)["WorkspaceSucceeded"].status == "True"
    pod = store.get("Job", "default", "tune").spec["template"]["spec"]
    trainer = pod["containers"][0]
    assert trainer["command"][:3] == ["python", "-m", "kaito_tpu_torch.tuning.cli"]
    assert trainer["resources"]["limits"] == {"nvidia.com/gpu": "1"}
    assert pod["containers"][1]["command"][:3] == [
        "python", "-m", "kaito_tpu_torch.tuning.metrics_server"]
    assert pod["tolerations"][0]["key"] == "nvidia.com/gpu"


def test_hf_fallback_preset_fails_its_gpu_plan(monkeypatch):
    """A long-tail preset runs the HF fallback runtime: on a GPU node it
    plans, and its pod runs the port's fallback on one card with
    ``--device cuda``, a command line the fallback's own ``main`` takes."""
    from kaito_tpu_torch.runtime import hf_fallback

    md = port_registry.get_model_by_name("phi-4-mini-instruct").with_overrides(
        name="org/long-tail", runtime="transformers")
    monkeypatch.setattr(PORT.ctrl, "get_model_by_name",
                        lambda name: md if name == "org/long-tail"
                        else port_registry.get_model_by_name(name))
    store, ws = _gpu_run(_workspace(PORT, "hf", "a3-highgpu-8g", "org/long-tail"))
    assert _conds(ws)["ResourceReady"].status == "True"
    assert _conds(ws)["InferenceReady"].status == "True"
    _, c = _engine(store, "hf")
    cmd = c["command"]
    assert cmd[:3] == ["python", "-m", "kaito_tpu_torch.runtime.hf_fallback"]
    assert cmd[cmd.index("--device") + 1] == "cuda"
    assert cmd[cmd.index("--model") + 1] == md.hf_id
    assert c["resources"] == {"requests": {"nvidia.com/gpu": "1"},
                              "limits": {"nvidia.com/gpu": "1"}}
    assert c["startupProbe"]["httpGet"]["path"] == "/health"
    seen = {}

    class Recorder:
        def __init__(self, model, **kw):
            seen.update(kw, model=model)
            self.served_name = kw["served_name"]

    monkeypatch.setattr(hf_fallback, "FallbackState", Recorder)
    monkeypatch.setattr(hf_fallback, "make_fallback_server", lambda state, host, port:
                        types.SimpleNamespace(serve_forever=lambda: seen.update(port=port)))
    hf_fallback.main(cmd[3:])
    assert seen == {"model": md.hf_id, "max_model_len": int(cmd[cmd.index("--max-model-len") + 1]),
                    "served_name": "org/long-tail", "device": "cuda", "port": 5000}


# ---------------------------------------------------------------------------
# Every rendered GPU command line parses into a config the port serves
# ---------------------------------------------------------------------------

GPU_COMMANDS = {
    "llama-8b": ("llama-3.1-8b-instruct", "a3-highgpu-1g", (), False),
    "llama-70b": ("llama-3.3-70b-instruct", "a3-highgpu-8g", (), False),
    "qwen3-32b-all": ("qwen3-32b", "a3-highgpu-8g", tuple(ANNOTATIONS), True),
    "tinyllama-int8-config": (TINYLLAMA, "a3-highgpu-1g", ("quantization-int8",), True),
    "tinyllama-all": (TINYLLAMA, "a3-highgpu-1g", tuple(ANNOTATIONS), True),
}


@pytest.mark.parametrize("case", list(GPU_COMMANDS))
def test_rendered_gpu_command_parses_into_a_served_config(monkeypatch, tmp_path, case):
    model, instance, annotations, with_files = GPU_COMMANDS[case]
    ann = {"kaito-tpu.io/quantization": "int8"} if "quantization-int8" in annotations \
        else {}
    for a in annotations:
        ann.update(ANNOTATIONS.get(a, {}))
    extra = ({"config": "inference-config",
              "adapters": [PORT.ws.AdapterSpec(name="a", source_image="reg/a:v1")]}
             if with_files else {})
    store, ws = _gpu_run(_workspace(PORT, "g", instance, model, ann, **extra))
    assert _conds(ws)["InferenceReady"].status == "True", ws.status.conditions
    _, c = _engine(store, "g")
    cmd = c["command"]
    assert cmd[:3] == ["python", "-m", "kaito_tpu_torch.engine.server"]
    argv = cmd[3:]
    if with_files:
        conf = tmp_path / "inference_config.yaml"
        conf.write_text(CONFIG_YAML)
        i = argv.index("--kaito-config-file")
        assert argv[i + 1] == "/mnt/config/inference_config.yaml"
        argv[i + 1] = str(conf)
    for var in ("KAITO_TENSOR_PARALLEL", "KAITO_DATA_PARALLEL",
                "KAITO_PIPELINE_PARALLEL", "KAITO_SEQUENCE_PARALLEL"):
        monkeypatch.delenv(var, raising=False)
    for k, v in _env_of(c).items():
        monkeypatch.setenv(k, v)
    cfg, args = parse_args(argv)
    if with_files:
        cfg = load_config_file(cfg, args.kaito_config_file)
    assert cfg.model == model and args.device == "cuda"
    n = int(c["resources"]["limits"]["nvidia.com/gpu"])
    assert cfg.tensor_parallel == n
    check_ported(cfg)
    check_tensor_parallel(port_registry.get_model_by_name(model).arch,
                          cfg.tensor_parallel, cfg.quantization)
