"""The port's controllers beyond the Workspace (InferenceSet,
MultiRoleInference, RAGEngine, ModelMirror, drift, auto-upgrade), its
event sink and its manager against the JAX package's, on the CPU.

- TPU parity: every scenario of ``tests/test_controllers_extended.py``
  (gates, InferenceSet scaling, MRI, ModelMirror, RAGEngine, drift,
  auto-upgrade) runs through both packages' ``Manager`` over their
  in-memory ``Store`` and ``FakeCloud``; every stored object and event
  is equal as plain dicts (the normaliser of
  ``tests/test_torch_operator_workspace.py``: timestamps and measured
  seconds removed).  ``tests/test_controllers.py``'s ``KubeEventSink``
  cases and its manager metrics and reconcile-error cases run through
  both packages with equal calls, counters and ``/metrics`` families.
- GPU cases with stated expectations: an InferenceSet on
  ``a3-highgpu-1g`` renders the port's engine on one ``nvidia.com/gpu``
  a replica; a RAGEngine there runs the port's RAG app on the card, its
  env read by the port's ``RAGConfig``; under the Gateway API gate a
  GPU set renders its pool and the port's picker from the GPU image (a
  GPU MRI its PD-aware picker); each MRI role's rendered command, under
  its rendered env, parses into a config with that role that
  ``check_ported`` accepts.
"""

import importlib
import json
import threading
import types
import urllib.request
from datetime import datetime, timezone

import pytest

from kaito_tpu_torch.engine.engine import check_ported
from kaito_tpu_torch.engine.server import parse_args
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_operator_workspace import (  # noqa: F401 (autouse fixture)
    _offline_fetchers,
    _plain,
    _snapshot,
)


def _pkg(root: str) -> types.SimpleNamespace:
    mods = {name: importlib.import_module(f"{root}.{path}") for name, path in (
        ("api", "api"), ("ws", "api.workspace"), ("iset", "api.inferenceset"),
        ("mri", "api.multiroleinference"), ("rag", "api.ragengine"),
        ("mm", "api.modelmirror"), ("meta", "api.meta"),
        ("runtime", "controllers.runtime"), ("manager", "controllers.manager"),
        ("metrics", "controllers.metrics"), ("autoupgrade", "controllers.autoupgrade"),
        ("events", "k8s.events"), ("gates", "featuregates"), ("prov", "provision"))}
    return types.SimpleNamespace(**mods)


JAX, PORT = _pkg("kaito_tpu"), _pkg("kaito_tpu_torch")
GATES = ("enableMultiRoleInferenceController=true,modelMirror=true,"
         "gatewayAPIInferenceExtension=true")


def _mgr(p, gates=GATES):
    mgr = p.manager.Manager(feature_gates=gates)
    return mgr, p.prov.FakeCloud(mgr.store)


def _drive(mgr, cloud, n=8):
    for _ in range(n):
        mgr.resync()
        cloud.tick()


def _template(p, instance="ct5lp-hightpu-1t", preset="phi-4-mini-instruct", **kw):
    return p.iset.WorkspaceTemplate(
        resource=p.api.ResourceSpec(instance_type=instance),
        inference=p.api.InferenceSpec(preset=preset), **kw)


def _iset(p, name, replicas, **spec):
    return p.api.InferenceSet(p.api.ObjectMeta(name=name), p.api.InferenceSetSpec(
        replicas=replicas, template=spec.pop("template", None) or _template(p), **spec))


# ---------------------------------------------------------------------------
# TPU parity: the scenarios of tests/test_controllers_extended.py
# ---------------------------------------------------------------------------

def _scaling(p):
    mgr, cloud = _mgr(p)
    mgr.store.create(_iset(p, "fleet", 3))
    _drive(mgr, cloud, 10)

    def scale(o):
        o.spec.replicas = 1
    p.runtime.update_with_retry(mgr.store, "InferenceSet", "default", "fleet", scale)
    _drive(mgr, cloud, 10)
    return mgr.store


def _mri(p):
    mgr, cloud = _mgr(p)
    mgr.store.create(p.api.MultiRoleInference(
        p.api.ObjectMeta(name="pd"),
        p.mri.MultiRoleInferenceSpec(
            model=p.mri.MRIModelSpec(name="phi-4-mini-instruct"),
            roles=[p.mri.RoleSpec(type="prefill", replicas=1,
                                  instance_type="ct5lp-hightpu-1t"),
                   p.mri.RoleSpec(type="decode", replicas=2,
                                  instance_type="ct5lp-hightpu-1t")])))
    _drive(mgr, cloud, 12)
    return mgr.store


def _modelmirror(p):
    mgr, cloud = _mgr(p)
    mm = p.api.ModelMirror(p.api.ObjectMeta(name="llama-cache", namespace=""),
                           p.mm.ModelMirrorSpec(source=p.mm.MirrorSource(model_id="meta/l")))
    mm.spec.storage.bucket = "weights-bucket"
    mgr.store.create(mm)
    mgr.resync()
    cloud.tick()
    mgr.resync()
    return mgr.store


def _modelmirror_pvc(p):
    mgr, cloud = _mgr(p)
    mgr.store.create(p.api.ModelMirror(
        p.api.ObjectMeta(name="pvc-cache", namespace=""),
        p.mm.ModelMirrorSpec(source=p.mm.MirrorSource(model_id="meta/l"))))
    _drive(mgr, cloud, 3)
    return mgr.store


def _ragengine(p, instance="ct5lp-hightpu-4t"):
    mgr, cloud = _mgr(p)
    mgr.store.create(p.api.RAGEngine(p.api.ObjectMeta(name="rag"), p.api.RAGEngineSpec(
        compute=p.api.ResourceSpec(instance_type=instance),
        embedding=p.rag.EmbeddingSpec(local=p.rag.LocalEmbedding(model_id="bge-small")),
        inference_service=p.rag.InferenceServiceSpec(url="http://phi:5000/v1"),
        guardrails=p.rag.GuardrailsSpec(enabled=True, config_map_ref="policy"))))
    _drive(mgr, cloud, 4)
    return mgr.store


def _drift(p):
    mgr, cloud = _mgr(p)
    mgr.store.create(_iset(p, "fleet", 2))
    _drive(mgr, cloud, 10)
    cloud.mark_drifted(mgr.store.list("Node")[0].metadata.name)
    mgr.resync()
    return mgr.store


def _autoupgrade(p):
    mgr, cloud = _mgr(p)
    mgr.store.create(_iset(p, "fleet", 2, auto_upgrade=p.iset.AutoUpgradePolicy(
        enabled=True, maintenance_window=p.iset.MaintenanceWindow(cron="0 3 * * *"))))
    _drive(mgr, cloud, 10)
    runner = p.autoupgrade.AutoUpgradeRunner(mgr.store, "v2")
    inside = datetime(2026, 7, 28, 3, 10, tzinfo=timezone.utc)
    outside = datetime(2026, 7, 28, 12, 0, tzinfo=timezone.utc)
    ticks = [runner.tick(at=outside), runner.tick(at=inside)]

    def set_ready(status):
        def mutate(o):
            for c in o.status.conditions:
                if c.type == p.ws.COND_INFERENCE_READY:
                    c.status = status
        p.runtime.update_with_retry(mgr.store, "Workspace", "default", ticks[1], mutate)

    set_ready("False")
    ticks.append(runner.tick(at=inside))
    set_ready("True")
    ticks.append(runner.tick(at=inside))
    mgr.store.ticks = ticks
    return mgr.store


def _gates(p):
    """The gate table, and the errors two bad strings raise."""
    store = p.runtime.Store()
    store.gates = [p.gates.parse_feature_gates(g) for g in (
        "", "modelMirror=true, pallasAttention=false", GATES,
        "enableInferenceSetController=true,autoscaler=true")]
    store.errors = []
    for bad in ("nope=true", "modelMirror=maybe"):
        with pytest.raises(ValueError) as e:
            p.gates.parse_feature_gates(bad)
        store.errors.append(str(e.value))
    return store


SCENARIOS = {"gates": _gates, "inferenceset-scaling": _scaling, "mri-role-sets": _mri,
             "modelmirror": _modelmirror, "modelmirror-pvc": _modelmirror_pvc,
             "ragengine": _ragengine, "drift": _drift, "autoupgrade": _autoupgrade}


def _full(store) -> dict:
    snap = _snapshot(store)
    for extra in ("gates", "errors", "ticks"):
        if hasattr(store, extra):
            snap[extra] = getattr(store, extra)
    return snap


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_the_jax_operator(name):
    want = _full(SCENARIOS[name](JAX))
    got = _full(SCENARIOS[name](PORT))
    assert got == want
    objs = got["objects"]
    # the scenario did what its name says (the JAX tests hold the rest)
    if name == "inferenceset-scaling":
        assert objs["InferenceSet"]["default/fleet"]["status"]["replicas"] == 1
        assert len(objs["Workspace"]) == 1 and "default/fleet-pool" in objs["InferencePool"]
        assert "kaito_tpu.runtime.epp" in json.dumps(objs["Deployment"]["default/fleet-epp"])
    if name == "mri-role-sets":
        assert objs["MultiRoleInference"]["default/pd"]["status"]["role_ready"] == {
            "prefill": True, "decode": True}
    if name == "modelmirror":
        assert objs["ModelMirror"]["/llama-cache"]["status"]["phase"] == "Ready"
    if name == "ragengine":
        res = objs["Deployment"]["default/rag"]["spec"]["template"]["spec"]["containers"][0]
        assert res["resources"]["limits"] == {"google.com/tpu": "1"}
        assert res["command"][:3] == ["python", "-m", "kaito_tpu.rag.app"]
    if name == "drift":
        budgets = [p["spec"]["disruption"]["budgets"][0]["nodes"]
                   for p in objs["NodePool"].values()]
        assert budgets.count("1") == 1
    if name == "autoupgrade":
        t = got["ticks"]
        assert t[0] is None and t[1] and t[2] is None and t[3] not in (None, t[1])


# ---------------------------------------------------------------------------
# tests/test_controllers.py: KubeEventSink, manager metrics, reconcile errors
# ---------------------------------------------------------------------------

def _sink_calls(p):
    calls = []

    class FakeClient:
        def request_json(self, method, path, body=None, query=None):
            calls.append((method, path, _plain(body)))
            return body

    rec = p.events.EventRecorder(sink=p.events.KubeEventSink(FakeClient(), namespace="sys"))
    ws = p.api.Workspace(p.api.ObjectMeta(name="sink"),
                         inference=p.api.InferenceSpec(preset="phi-4"))
    rec.event(ws, "Normal", "RolloutComplete", "1/1 ready")
    rec.event(ws, "Normal", "RolloutComplete", "1/1 ready")
    return calls


def test_kube_event_sink_posts_then_puts_as_the_jax_one():
    clock = {"firstTimestamp", "lastTimestamp", "eventTime"}

    def strip(calls):
        return [(m, path, {k: v for k, v in body.items() if k not in clock})
                for m, path, body in calls]

    got, want = strip(_sink_calls(PORT)), strip(_sink_calls(JAX))
    assert got == want
    assert [(m, c["count"]) for m, _, c in got] == [("POST", 1), ("PUT", 2)]
    assert got[0][1] == "/api/v1/namespaces/default/events"
    assert got[1][1].startswith("/api/v1/namespaces/default/events/sink.")


@pytest.mark.parametrize("p", [JAX, PORT], ids=["jax", "port"])
def test_sink_failure_never_breaks_recording(p):
    class DeadClient:
        def request_json(self, *a, **kw):
            raise RuntimeError("api server down")

    rec = p.events.EventRecorder(sink=p.events.KubeEventSink(DeadClient()))
    rec.eventf("Workspace", "default", "x", "Normal", "R", "m")
    assert len(rec) == 1


def _manager_run(p):
    """test_manager_metrics_and_trace_endpoints through one package:
    (store snapshot, /metrics text, trace span names, /healthz)."""
    store = p.runtime.Store()
    cloud = p.prov.FakeCloud(store)
    mgr = p.manager.Manager(store=store, feature_gates="enableInferenceSetController=true")
    store.create(p.api.Workspace(
        p.api.ObjectMeta(name="m1"),
        resource=p.api.ResourceSpec(instance_type="ct5lp-hightpu-1t"),
        inference=p.api.InferenceSpec(preset="phi-4-mini-instruct")))
    for _ in range(5):
        mgr.resync()
        cloud.tick()
    mgr.resync()
    server = p.metrics.make_manager_server(mgr.metrics, host="127.0.0.1", port=0,
                                           fleet=mgr.fleet)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        def get(path):
            with urllib.request.urlopen(base + path, timeout=10) as r:
                return r.headers["Content-Type"], r.read().decode()

        ctype, text = get("/metrics")
        trace = json.loads(get("/debug/trace?trace_id=Workspace/default/m1")[1])
        health = json.loads(get("/healthz")[1])
        fleet = json.loads(get("/debug/fleet")[1])
    finally:
        server.shutdown()
        server.server_close()
    return store, ctype, text, trace, health, fleet


def _families(text) -> list:
    return sorted({ln.split()[2] for ln in text.splitlines() if ln.startswith("# TYPE")})


def _stable_lines(text) -> list:
    """Samples that hold no clock: counters and gauges, no durations."""
    return [ln for ln in text.splitlines() if not ln.startswith("#")
            and "duration_seconds" not in ln]


def test_manager_metrics_and_trace_endpoints_match_the_jax_manager():
    js, jct, jtext, jtrace, jhealth, jfleet = _manager_run(JAX)
    ps, pct, ptext, ptrace, phealth, pfleet = _manager_run(PORT)
    assert _snapshot(ps) == _snapshot(js)
    assert pct == jct and pct.startswith("text/plain")
    assert _families(ptext) == _families(jtext)
    assert _stable_lines(ptext) == _stable_lines(jtext)
    assert "kaito:controller_resync_total 6" in ptext
    assert 'kaito:workspace_condition{name="m1",type="InferenceReady"} 1' in ptext
    assert 'kaito:controller_events_total{type="Normal",reason="RolloutComplete"}' in ptext
    names = lambda t: sorted({e["name"] for e in t["traceEvents"] if e.get("ph") == "X"})
    assert names(ptrace) == names(jtrace) and "reconcile.Workspace" in names(ptrace)
    assert phealth == jhealth == {"status": "ok"}
    for snap in (pfleet, jfleet):
        for cr in snap["fleet"].values():
            cr["signal"].pop("since_s")
    assert pfleet == jfleet


@pytest.mark.parametrize("p", [JAX, PORT], ids=["jax", "port"])
def test_reconcile_error_counted_not_raised(p):
    store = p.runtime.Store()
    mgr = p.manager.Manager(store=store, feature_gates="enableInferenceSetController=true")

    class Boom:
        kind = "Workspace"

        def reconcile(self, obj):
            raise RuntimeError("injected")

    store.create(p.api.Workspace(p.api.ObjectMeta(name="boom"),
                                 inference=p.api.InferenceSpec(preset="phi-4")))
    mgr._reconcile_one(Boom(), store.get("Workspace", "default", "boom"))
    assert mgr.metrics.reconcile_total.value(controller="Boom", result="error") == 1


# ---------------------------------------------------------------------------
# GPU cases
# ---------------------------------------------------------------------------

def _conds(obj) -> dict:
    return {c.type: c for c in obj.status.conditions}


def _engine(store, name):
    return store.get("StatefulSet", "default", name).spec["template"]["spec"]


def _env_of(container) -> dict:
    return {e["name"]: e["value"] for e in container["env"] if "value" in e}


def test_inferenceset_on_a3_highgpu_1g_renders_one_card_a_replica():
    mgr, cloud = _mgr(PORT, "enableInferenceSetController=true")
    mgr.store.create(_iset(PORT, "l8", 2, template=_template(
        PORT, "a3-highgpu-1g", "llama-3.1-8b-instruct")))
    _drive(mgr, cloud, 10)
    live = mgr.store.get("InferenceSet", "default", "l8")
    assert (live.status.replicas, live.status.ready_replicas) == (2, 2)
    assert _conds(live)["InferenceSetReady"].status == "True"
    assert live.status.selector == f"{PORT.ws.LABEL_CREATED_BY_INFERENCESET}=l8"
    for child in ("l8-0", "l8-1"):
        pod = _engine(mgr.store, child)
        c = pod["containers"][0]
        assert c["command"][:3] == ["python", "-m", "kaito_tpu_torch.engine.server"]
        assert c["resources"]["limits"] == {"nvidia.com/gpu": "1"}
        assert pod["nodeSelector"]["cloud.google.com/gke-accelerator"] == "nvidia-h100-80gb"
        assert _env_of(c)["KAITO_TENSOR_PARALLEL"] == "1"
        pool = mgr.store.get("NodePool", "", f"{child}-slice-0").spec["template"]["spec"]
        assert {r["key"]: r["values"] for r in pool["requirements"]}[
            "node.kubernetes.io/instance-type"] == ["a3-highgpu-1g"]
    # the two replicas render one pod, names apart
    a, b = (json.dumps(_engine(mgr.store, n)).replace(n, "X") for n in ("l8-0", "l8-1"))
    assert a == b
    assert not mgr.store.list("InferencePool") and not mgr.store.list("Deployment")


def test_ragengine_on_a3_runs_the_ports_rag_app_on_a_card(monkeypatch):
    from kaito_tpu_torch.rag.config import RAGConfig

    store = _ragengine(PORT, "a3-highgpu-1g")
    pod = store.get("Deployment", "default", "rag").spec["template"]["spec"]
    c = pod["containers"][0]
    assert c["command"] == ["python", "-m", "kaito_tpu_torch.rag.app", "--port", "5000"]
    assert c["image"] == "ghcr.io/kaito-tpu/engine-cuda:latest"
    assert c["resources"] == {"requests": {"nvidia.com/gpu": "1"},
                              "limits": {"nvidia.com/gpu": "1"}}
    assert pod["nodeSelector"] == {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb",
                                   "node.kubernetes.io/instance-type": "a3-highgpu-1g"}
    assert pod["tolerations"] == [{"key": "nvidia.com/gpu", "operator": "Exists",
                                   "effect": "NoSchedule"}]
    # everything but the GPU half is the JAX operator's render
    jax = _ragengine(JAX, "a3-highgpu-1g")
    want = _plain(jax.get("Deployment", "default", "rag").spec)["template"]["spec"]
    got = _plain(store.get("Deployment", "default", "rag").spec)["template"]["spec"]
    for k in ("nodeSelector", "tolerations"):
        got.pop(k)
    for k in ("command", "image", "resources"):
        got["containers"][0].pop(k)
        want["containers"][0].pop(k)
    assert got == want
    for k, v in _env_of(c).items():
        monkeypatch.setenv(k, v)
    cfg = RAGConfig.from_env()
    assert (cfg.llm_inference_url, cfg.embedding_model_id) == ("http://phi:5000/v1",
                                                              "bge-small")
    assert cfg.guardrails_policy_file == "/mnt/guardrails/policy.yaml"
    # a remote embedder asks for no card
    remote = _ragengine_remote(PORT)
    assert remote["resources"] == {}
    assert remote["command"][2] == "kaito_tpu_torch.rag.app"


def _ragengine_remote(p):
    mgr, cloud = _mgr(p)
    mgr.store.create(p.api.RAGEngine(p.api.ObjectMeta(name="remote"), p.api.RAGEngineSpec(
        compute=p.api.ResourceSpec(instance_type="a3-highgpu-1g"),
        embedding=p.rag.EmbeddingSpec(remote=p.rag.RemoteEmbedding(url="http://emb:80")),
        inference_service=p.rag.InferenceServiceSpec(url="http://phi:5000/v1"))))
    _drive(mgr, cloud, 2)
    return mgr.store.get("Deployment", "default", "remote").spec["template"]["spec"][
        "containers"][0]


def test_gateway_gate_refuses_a_gpu_set_naming_the_roadmap_item():
    """Under the Gateway API gate a GPU set renders its children, its
    InferencePool and the port's picker (``kaito_tpu_torch.runtime.epp``
    from the GPU image, one ``--backend`` a replica): no
    ``EPPUnavailable``.  The TPU set beside it keeps the JAX render."""
    mgr, cloud = _mgr(PORT, "enableInferenceSetController=true,"
                            "gatewayAPIInferenceExtension=true")
    mgr.store.create(_iset(PORT, "gw", 2, template=_template(
        PORT, "a3-highgpu-1g", "llama-3.1-8b-instruct")))
    mgr.store.create(_iset(PORT, "tpu", 1))
    _drive(mgr, cloud, 6)
    cond = _conds(mgr.store.get("InferenceSet", "default", "gw"))["InferenceSetReady"]
    assert (cond.status, cond.reason) == ("True", "Ready")
    assert len(mgr.store.list("Workspace", labels={
        PORT.ws.LABEL_CREATED_BY_INFERENCESET: "gw"})) == 2
    pool = mgr.store.get("InferencePool", "default", "gw-pool")
    assert pool.spec["extensionRef"]["name"] == "gw-epp"
    c = mgr.store.get("Deployment", "default", "gw-epp").spec["template"]["spec"][
        "containers"][0]
    assert c["command"][:3] == ["python", "-m", "kaito_tpu_torch.runtime.epp"]
    assert c["image"] == "ghcr.io/kaito-tpu/engine-cuda:latest"
    assert [c["command"][i + 1] for i, a in enumerate(c["command"])
            if a == "--backend"] == ["http://gw-0:5000", "http://gw-1:5000"]
    assert mgr.store.get("Service", "default", "gw-epp")
    assert not mgr.store.events.events(name="gw", reason="EPPUnavailable")
    # the TPU set beside it keeps its pool and picker (the JAX render)
    assert mgr.store.try_get("InferencePool", "default", "tpu-pool") is not None
    tpu = mgr.store.get("Deployment", "default", "tpu-epp").spec["template"]["spec"][
        "containers"][0]
    assert tpu["command"][:3] == ["python", "-m", "kaito_tpu.runtime.epp"]
    assert tpu["image"] == "ghcr.io/kaito-tpu/engine:latest"


def _gpu_mri(p, gates):
    mgr, cloud = _mgr(p, gates)
    mgr.store.create(p.api.MultiRoleInference(
        p.api.ObjectMeta(name="pd"),
        p.mri.MultiRoleInferenceSpec(
            model=p.mri.MRIModelSpec(name="llama-3.1-8b-instruct"),
            roles=[p.mri.RoleSpec(type="prefill", replicas=1, instance_type="a3-highgpu-1g"),
                   p.mri.RoleSpec(type="decode", replicas=1,
                                  instance_type="a3-highgpu-1g")])))
    _drive(mgr, cloud, 12)
    return mgr.store


@pytest.mark.parametrize("role", ["prefill", "decode"])
def test_gpu_mri_roles_render_commands_the_port_serves(monkeypatch, role):
    store = _gpu_mri(PORT, "enableInferenceSetController=true,"
                           "enableMultiRoleInferenceController=true")
    mri = store.get("MultiRoleInference", "default", "pd")
    cond = _conds(mri)["MultiRoleInferenceReady"]
    assert (cond.status, cond.reason) == ("True", "Ready")
    assert mri.status.role_ready == {"prefill": True, "decode": True}
    # the pool and the port's PD-aware picker, from the GPU image
    pool = store.get("InferencePool", "default", "pd-pool")
    assert pool.spec["extensionRef"]["name"] == "pd-epp"
    epp = store.get("Deployment", "default", "pd-epp").spec["template"]["spec"][
        "containers"][0]
    assert epp["command"][:3] == ["python", "-m", "kaito_tpu_torch.runtime.epp"]
    assert epp["image"] == "ghcr.io/kaito-tpu/engine-cuda:latest"
    assert sorted(epp["command"][i + 1] for i, a in enumerate(epp["command"])
                  if a == "--backend") == ["http://pd-decode-0:5000=decode/pd-decode",
                                           "http://pd-prefill-0:5000=prefill/pd-prefill"]
    chain = json.loads(epp["command"][epp["command"].index("--plugins-config") + 1])
    assert chain == pool.spec["eppPluginsConfig"]
    c = _engine(store, f"pd-{role}-0")["containers"][0]
    cmd = c["command"]
    assert cmd[:3] == ["python", "-m", "kaito_tpu_torch.engine.server"]
    env = _env_of(c)
    assert env["KAITO_INFERENCE_ROLE"] == role and env["KAITO_PD_ENABLED"] == "true"
    for var in ("KAITO_TENSOR_PARALLEL", "KAITO_DATA_PARALLEL", "KAITO_PIPELINE_PARALLEL",
                "KAITO_SEQUENCE_PARALLEL", "KAITO_INFERENCE_ROLE", "KAITO_PD_ENABLED",
                "KAITO_PD_ALLOWLIST"):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg, args = parse_args(cmd[3:])
    # the role rides the env into --inference-role's default, as the JAX
    # operator renders it
    assert args.inference_role == role and cfg.role == role and cfg.pd_enabled
    assert cfg.model == "llama-3.1-8b-instruct" and args.device == "cuda"
    check_ported(cfg)
