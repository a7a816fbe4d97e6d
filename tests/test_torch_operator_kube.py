"""The port's Kubernetes client, codec and store, its admission webhook
and its manager against the JAX package's, on the CPU.

- ``tests/test_kube_store.py``'s cases through both packages'
  ``KubeStore`` over the fake API server (``tests/helpers/fake_kube_api``,
  which imports neither package): the wire JSON each package writes, the
  requests it sends and the typed objects it reads back are equal.
- ``tests/test_webhook.py``'s reviews (and the conversion review)
  through both ``make_server``s: equal responses.
- A ``Manager.resync`` scenario with every feature gate on, through
  both managers: equal stores and events, and the same ``/metrics``
  family names.
- ``main``'s parsed flags and defaults equal the JAX ``main``'s, its
  ``--help`` lists every flag, and ``python -m
  kaito_tpu_torch.controllers.manager --help`` runs.
"""

import argparse
import base64
import importlib
import json
import os
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

from tests.helpers.fake_kube_api import FakeKubeAPI, serve
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.test_api_conversion import _legacy_rag
from tests.test_torch_operator_workspace import (  # noqa: F401 (autouse fixture)
    _offline_fetchers,
    _plain,
    _snapshot,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pkg(root: str) -> types.SimpleNamespace:
    mods = {name: importlib.import_module(f"{root}.{path}") for name, path in (
        ("api", "api"), ("ws", "api.workspace"), ("iset", "api.inferenceset"),
        ("mri", "api.multiroleinference"), ("rag", "api.ragengine"),
        ("mm", "api.modelmirror"), ("runtime", "controllers.runtime"),
        ("manager", "controllers.manager"), ("webhook", "controllers.webhook"),
        ("k8s", "k8s"), ("codec", "k8s.codec"), ("gates", "featuregates"),
        ("prov", "provision"))}
    return types.SimpleNamespace(**mods)


JAX, PORT = _pkg("kaito_tpu"), _pkg("kaito_tpu_torch")
# wall-clock stamps on the wire
_WIRE_CLOCK = {"lastTransitionTime", "firstTimestamp", "lastTimestamp", "eventTime",
               "creationTimestamp", "deletionTimestamp",
               "kaito-tpu.io/provision-start", "kaito-tpu.io/ready-at",
               "provision_to_ready_seconds", "notReadySince"}


def _wire(x):
    """Wire JSON with its clock readings dropped."""
    if isinstance(x, dict):
        return {k: _wire(v) for k, v in x.items() if k not in _WIRE_CLOCK}
    if isinstance(x, list):
        return [_wire(v) for v in x]
    if isinstance(x, str):
        return _plain(x)
    return x


class _Kube:
    """One package's KubeStore over its own fake API server."""

    def __init__(self, p):
        self.p = p
        self.api = FakeKubeAPI()
        self.srv, url = serve(self.api)
        self.store = p.k8s.KubeStore(p.k8s.KubeClient(base_url=url))

    def close(self):
        self.store.stop_watching()
        self.srv.shutdown()
        self.srv.server_close()

    def wire(self) -> dict:
        return {f"{prefix}/{plural}": {f"{ns}/{name}": _wire(o)
                                       for (ns, name), o in sorted(coll.items())}
                for (prefix, plural), coll in sorted(self.api.objects.items()) if coll}


def _ws(p, name="ws1"):
    return p.api.Workspace(
        p.api.ObjectMeta(name=name, namespace="default", labels={"app": "kaito"}),
        resource=p.api.ResourceSpec(instance_type="ct5lp-hightpu-4t", count=2,
                                    tpu_topology="2x4"),
        inference=p.api.InferenceSpec(preset="phi-4-mini-instruct"))


def k_roundtrip(k):
    p, store = k.p, k.store
    store.create(_ws(p))
    back = store.get("Workspace", "default", "ws1")
    return dict(back=_plain(back), raw=k.api.raw("workspaces", "ws1"))


def k_conflict_and_status(k):
    p, store = k.p, k.store
    created = store.create(_ws(p))
    stale = created.deepcopy()
    fresh = store.get("Workspace", "default", "ws1")
    fresh.resource.count = 3
    store.update(fresh)
    stale.resource.count = 9
    with pytest.raises(p.runtime.ConflictError):
        store.update(stale)
    cur = store.get("Workspace", "default", "ws1")
    cur.status.target_node_count = 4
    store.update(cur)
    return dict(got=_plain(store.get("Workspace", "default", "ws1")))


def k_finalizer_delete(k):
    p, store = k.p, k.store
    ws = _ws(p)
    ws.metadata.finalizers = ["kaito-tpu.io/workspace"]
    store.create(ws)
    store.delete("Workspace", "default", "ws1")
    lingering = store.get("Workspace", "default", "ws1")
    lingering.metadata.finalizers = []
    store.update(lingering)
    with pytest.raises(p.runtime.NotFoundError):
        store.delete("Workspace", "default", "ws1")
    return dict(lingering=_plain(lingering),
                gone=store.try_get("Workspace", "default", "ws1"))


def k_label_selector(k):
    p, store = k.p, k.store
    store.create(_ws(p, "a"))
    other = _ws(p, "b")
    other.metadata.labels = {"app": "other"}
    store.create(other)
    return dict(names=[o.metadata.name for o in store.list(
        "Workspace", "default", labels={"app": "kaito"})])


def k_every_kind(k):
    """Each typed kind, an Unstructured and a ControllerRevision through
    create, update (spec and status) and list."""
    p, store = k.p, k.store
    objs = [
        p.api.InferenceSet(p.api.ObjectMeta(name="set"), p.api.InferenceSetSpec(
            replicas=2, autoscale=p.iset.AutoscalePolicy(enabled=True, max_replicas=3),
            template=p.iset.WorkspaceTemplate(
                resource=p.api.ResourceSpec(instance_type="a3-highgpu-1g"),
                inference=p.api.InferenceSpec(preset="llama-3.1-8b-instruct"),
                annotations={"kaito-tpu.io/quantization": "int8"}))),
        p.api.RAGEngine(p.api.ObjectMeta(name="rag"), p.api.RAGEngineSpec(
            embedding=p.rag.EmbeddingSpec(local=p.rag.LocalEmbedding(model_id="bge")),
            inference_service=p.rag.InferenceServiceSpec(url="http://x:5000"))),
        p.api.MultiRoleInference(p.api.ObjectMeta(name="pd"), p.mri.MultiRoleInferenceSpec(
            model=p.mri.MRIModelSpec(name="phi-4-mini-instruct"),
            roles=[p.mri.RoleSpec(type="prefill", replicas=1,
                                  instance_type="ct5lp-hightpu-1t")])),
        p.api.ModelMirror(p.api.ObjectMeta(name="mm", namespace=""), p.mm.ModelMirrorSpec(
            source=p.mm.MirrorSource(model_id="meta/l"))),
    ]
    for o in objs:
        store.create(o)
    live = store.get("InferenceSet", "default", "set")
    live.status.replicas, live.status.scaling_signal = 2, "pressure"
    store.update(live)
    ws = store.create(_ws(p))
    rev = p.runtime.sync_controller_revision(store, ws, ws.revision_payload())
    return dict(listed={kind: [_plain(o) for o in store.list(kind)] for kind in (
        "InferenceSet", "RAGEngine", "MultiRoleInference", "ModelMirror",
        "ControllerRevision")}, rev=_plain(rev),
        codec=[p.codec.to_wire(o) for o in objs])


def k_manager_through_the_wire(k):
    p, store = k.p, k.store
    mgr = p.manager.Manager(store=store, node_provisioner="karpenter")
    store.create(_ws(p))
    for _ in range(8):
        mgr.resync()
    return {}


KUBE_SCENARIOS = {"roundtrip": k_roundtrip, "conflict-and-status": k_conflict_and_status,
                  "finalizer-delete": k_finalizer_delete, "label-selector": k_label_selector,
                  "every-kind": k_every_kind,
                  "manager-through-the-wire": k_manager_through_the_wire}


def _kube_run(p, scenario):
    k = _Kube(p)
    try:
        out = scenario(k)
        return dict(out=json.loads(json.dumps(_wire(out), default=str)),
                    wire=k.wire(), requests=k.api.requests,
                    events=[_plain(e) for e in k.store.events.events()])
    finally:
        k.close()


@pytest.mark.parametrize("name", list(KUBE_SCENARIOS))
def test_kube_store_scenario_matches_the_jax_store(name):
    want = _kube_run(JAX, KUBE_SCENARIOS[name])
    got = _kube_run(PORT, KUBE_SCENARIOS[name])
    assert got == want
    if name == "roundtrip":
        raw = got["out"]["raw"]
        assert raw["apiVersion"] == "kaito-tpu.io/v1"
        assert raw["resource"]["instanceType"] == "ct5lp-hightpu-4t"
        assert "instance_type" not in json.dumps(raw)
    if name == "conflict-and-status":
        ws = got["wire"]["apis/kaito-tpu.io/v1/workspaces"]["default/ws1"]
        assert ws["status"]["targetNodeCount"] == 4 and ws["resource"]["count"] == 3
    if name == "label-selector":
        assert got["out"]["names"] == ["a"]
        assert any("labelSelector" in path for _, path in got["requests"])
    if name == "manager-through-the-wire":
        ws = got["wire"]["apis/kaito-tpu.io/v1/workspaces"]["default/ws1"]
        assert ws["status"]["conditions"]
        assert got["wire"]["apis/karpenter.sh/v1/nodepools"]
        # events went to the API server as v1.Events
        assert got["wire"]["api/v1/events"]


@pytest.mark.parametrize("p", [JAX, PORT], ids=["jax", "port"])
def test_watch_events_fan_in_and_restarts_are_counted(p):
    k = _Kube(p)
    mgr = p.manager.Manager(store=k.store)
    events = []
    try:
        k.store.watch(lambda evt, kind, obj: events.append((evt, kind, obj.metadata.name)))
        k.store.start_watching(["Workspace"])
        time.sleep(0.3)
        k.store.create(_ws(p, "w1"))
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not events:
            time.sleep(0.05)
        assert ("ADDED", "Workspace", "w1") in events
        assert [t.name for t in k.store._watch_threads] == ["watch-Workspace"]
        # the manager counts a reconnect through the store's hook
        k.store.on_watch_restart("Workspace")
        assert mgr.metrics.watch_restarts.value(kind="Workspace") == 1
    finally:
        k.close()


def test_codec_tables_match():
    assert sorted(PORT.codec.TYPED_KINDS) == sorted(JAX.codec.TYPED_KINDS)
    assert PORT.codec.RESOURCES == JAX.codec.RESOURCES
    assert PORT.codec.STATUS_SUBRESOURCE == JAX.codec.STATUS_SUBRESOURCE
    for kind in JAX.codec.RESOURCES:
        for args in ((kind,), (kind, "ns"), (kind, "ns", "n"), (kind, "ns", "n", "status")):
            assert PORT.codec.resource_path(*args) == JAX.codec.resource_path(*args)
    for s in ("model_id", "instance_type", "tpu_topology", "x"):
        assert PORT.codec.camel(s) == JAX.codec.camel(s)
    legacy = _legacy_rag()
    assert _plain(PORT.codec.from_wire(legacy)) == _plain(JAX.codec.from_wire(legacy))


def test_client_reads_the_in_cluster_service_account(monkeypatch, tmp_path):
    for p in (JAX, PORT):
        client = importlib.import_module(f"{p.k8s.__name__}.client")
        monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
        with pytest.raises(RuntimeError, match="in-cluster"):
            client.KubeClient()
        (tmp_path / "token").write_text("tok\n")
        monkeypatch.setattr(client, "SA_DIR", str(tmp_path))
        monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "10.0.0.1")
        monkeypatch.setenv("KUBERNETES_SERVICE_PORT", "6443")
        c = client.KubeClient()
        assert (c.base_url, c.token) == ("https://10.0.0.1:6443", "tok")
        assert client.ApiError(409, "x").status == 409


# ---------------------------------------------------------------------------
# the admission webhook
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def webhooks():
    urls = {}
    servers = []
    for name, p in (("jax", JAX), ("port", PORT)):
        srv = p.webhook.make_server(host="127.0.0.1", port=0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        servers.append(srv)
        urls[name] = f"http://127.0.0.1:{srv.server_address[1]}"
    yield urls
    for srv in servers:
        srv.shutdown()
        srv.server_close()


def _review(kind, obj, uid="u1"):
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": {"uid": uid, "kind": {"kind": kind}, "object": obj}}


REVIEWS = {
    "validate-good": ("/validate", _review("Workspace", {
        "metadata": {"name": "ok"}, "resource": {"instanceType": "ct5lp-hightpu-4t"},
        "inference": {"preset": "phi-4-mini-instruct"}})),
    "validate-bad": ("/validate", _review("Workspace", {
        "metadata": {"name": "bad"}, "inference": {"preset": "nope-model"}})),
    "validate-tuning": ("/validate", _review("Workspace", {
        "metadata": {"name": "t"}, "resource": {"instanceType": "ct5lp-hightpu-4t"},
        "tuning": {"preset": "phi-4-mini-instruct", "method": "qlora",
                   "input": {"urls": ["https://x/d.jsonl"]},
                   "output": {"image": "reg/out:v1"}}})),
    "default-count": ("/default", _review("Workspace", {
        "metadata": {"name": "d"}, "resource": {"instanceType": "ct5lp-hightpu-1t",
                                                "count": 0},
        "inference": {"preset": "phi-4"}})),
    "default-no-resource": ("/default", _review("Workspace", {
        "metadata": {"name": "d"}, "inference": {"preset": "phi-4"}})),
    "unknown-kind": ("/validate", _review("ConfigMap", {"metadata": {}})),
    "convert": ("/convert", {
        "apiVersion": "apiextensions.k8s.io/v1", "kind": "ConversionReview",
        "request": {"uid": "u2", "desiredAPIVersion": "kaito-tpu.io/v1",
                    "objects": [_legacy_rag()]}}),
}


def _post(url, body):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.mark.parametrize("case", list(REVIEWS) + ["malformed"])
def test_webhook_review_matches_the_jax_webhook(webhooks, case):
    path, review = REVIEWS.get(case, ("/validate", None))
    body = b"{not json" if review is None else json.dumps(review).encode()
    want = _post(webhooks["jax"] + path, body)
    got = _post(webhooks["port"] + path, body)
    assert got == want
    status, out = got
    if case == "malformed":
        assert status == 400
        return
    resp = out["response"]
    if case == "validate-bad":
        assert resp["allowed"] is False and "preset" in resp["status"]["message"]
    if case in ("validate-good", "unknown-kind"):
        assert resp["allowed"] is True
    if case == "default-count":
        patch = json.loads(base64.b64decode(resp["patch"]))
        assert patch == [{"op": "replace", "path": "/resource/count", "value": 1}]
    if case == "convert":
        assert resp["convertedObjects"][0]["apiVersion"] == "kaito-tpu.io/v1"


def test_webhook_admits_a_gpu_workspace_the_jax_one_refuses(webhooks):
    """The GPU half: the port's catalog knows A3; the JAX operator's
    does not, and says so."""
    body = json.dumps(_review("Workspace", {
        "metadata": {"name": "g"}, "resource": {"instanceType": "a3-highgpu-1g"},
        "inference": {"preset": "llama-3.1-8b-instruct"}})).encode()
    _, got = _post(webhooks["port"] + "/validate", body)
    _, want = _post(webhooks["jax"] + "/validate", body)
    assert got["response"] == {"uid": "u1", "allowed": True}
    assert want["response"]["allowed"] is False
    assert "a3-highgpu-1g" in want["response"]["status"]["message"]


def test_webhook_main_flags_match():
    def parsed(p, argv):
        seen = {}
        real = argparse.ArgumentParser.parse_args

        def capture(self, args=None, namespace=None):
            seen["ns"] = vars(real(self, args, namespace))
            raise _Parsed()
        argparse.ArgumentParser.parse_args = capture
        try:
            with pytest.raises(_Parsed):
                p.webhook.main(argv)
        finally:
            argparse.ArgumentParser.parse_args = real
        return seen["ns"]

    for argv in ([], ["--port", "8443", "--tls-cert", "c.pem", "--tls-key", "k.pem"]):
        assert parsed(PORT, argv) == parsed(JAX, argv)


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------

ALL_GATES = ",".join(f"{g}=true" for g in sorted(
    JAX.gates.parse_feature_gates("")) if g != "disableNodeAutoProvisioning")


def _everything(p):
    """Every kind under every gate (but BYO provisioning), resynced to
    steady state."""
    mgr = p.manager.Manager(feature_gates=ALL_GATES)
    store = mgr.store
    cloud = p.prov.FakeCloud(store)
    store.create(p.api.Workspace(
        p.api.ObjectMeta(name="solo"),
        resource=p.api.ResourceSpec(instance_type="ct5lp-hightpu-1t"),
        inference=p.api.InferenceSpec(preset="phi-4-mini-instruct")))
    store.create(p.api.InferenceSet(p.api.ObjectMeta(name="set"), p.api.InferenceSetSpec(
        replicas=2, autoscale=p.iset.AutoscalePolicy(enabled=True, max_replicas=3),
        auto_upgrade=p.iset.AutoUpgradePolicy(
            enabled=True, maintenance_window=p.iset.MaintenanceWindow(cron="0 3 * * *")),
        template=p.iset.WorkspaceTemplate(
            resource=p.api.ResourceSpec(instance_type="ct5lp-hightpu-1t"),
            inference=p.api.InferenceSpec(preset="phi-4-mini-instruct"),
            annotations={"kaito-tpu.io/kv-pool": "true"}))))
    store.create(p.api.MultiRoleInference(p.api.ObjectMeta(name="pd"),
                                          p.mri.MultiRoleInferenceSpec(
        model=p.mri.MRIModelSpec(name="phi-4-mini-instruct"),
        roles=[p.mri.RoleSpec(type="prefill", replicas=1, instance_type="ct5lp-hightpu-1t"),
               p.mri.RoleSpec(type="decode", replicas=1,
                              instance_type="ct5lp-hightpu-1t")])))
    store.create(p.api.RAGEngine(p.api.ObjectMeta(name="rag"), p.api.RAGEngineSpec(
        embedding=p.rag.EmbeddingSpec(local=p.rag.LocalEmbedding(model_id="bge")),
        inference_service=p.rag.InferenceServiceSpec(url="http://set-0:5000"))))
    store.create(p.api.ModelMirror(p.api.ObjectMeta(name="mm", namespace=""),
                                   p.mm.ModelMirrorSpec(
                                       source=p.mm.MirrorSource(model_id="meta/l"))))
    for _ in range(12):
        mgr.resync()
        cloud.tick()
    return mgr


def test_resync_with_every_gate_matches_the_jax_manager():
    jm, pm = _everything(JAX), _everything(PORT)
    assert pm.gates == jm.gates and all(v for k, v in pm.gates.items()
                                        if k != "disableNodeAutoProvisioning")
    assert [type(r).__name__ for r in pm.reconcilers] == [
        type(r).__name__ for r in jm.reconcilers]
    assert _snapshot(pm.store) == _snapshot(jm.store)
    objs = _snapshot(pm.store)["objects"]
    assert {"default/set-pool", "default/pd-pool"} <= set(objs["InferencePool"])
    assert objs["ModelMirror"]["/mm"]["status"]["phase"] == "Ready"

    def families(m):
        return sorted({ln.split()[2] for ln in m.metrics.registry.expose().splitlines()
                       if ln.startswith("# TYPE")})

    assert families(pm) == families(jm)
    assert "kaito:autoscaler_desired_replicas" in families(pm)
    counts = {}
    for ln in pm.metrics.registry.expose().splitlines():
        if ln.startswith("kaito:controller_reconcile_total{"):
            counts[ln.split("{")[1].split("}")[0]] = float(ln.rsplit(" ", 1)[1])
    assert not any('result="error"' in k for k in counts)


class _Parsed(Exception):
    pass


def _main_args(p, argv, monkeypatch) -> dict:
    """The namespace ``main(argv)`` parses, and what it builds the
    Manager with (stopped there)."""
    seen = {}

    class Stop(Exception):
        pass

    def manager(**kw):
        seen["manager"] = {k: v for k, v in kw.items() if k != "store"}
        seen["store"] = type(kw.get("store")).__name__
        raise Stop()

    real = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        ns = real(self, args, namespace)
        seen["args"] = vars(ns)
        seen["flags"] = sorted(self._option_string_actions)
        return ns

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    monkeypatch.setattr(p.manager, "Manager", manager)
    with pytest.raises(Stop):
        p.manager.main(argv)
    return seen


@pytest.mark.parametrize("argv", [
    ["--disable-preset-autogen"],
    ["--disable-preset-autogen", "--in-memory-store", "--node-provisioner", "byo",
     "--feature-gates", "autoscaler=true", "--base-image-version", "v2",
     "--resync-seconds", "3", "--namespace", "kaito", "--metrics-port", "0"],
    ["--disable-preset-autogen", "--kube-api-url", "http://127.0.0.1:1",
     "--metrics-port", "0"],
], ids=["defaults", "every-flag", "kube-api-url"])
def test_manager_main_parses_as_the_jax_main(monkeypatch, argv):
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    monkeypatch.delenv("POD_NAMESPACE", raising=False)
    want = _main_args(JAX, argv, monkeypatch)
    got = _main_args(PORT, argv, monkeypatch)
    assert got == want
    assert got["store"] == ("KubeStore" if "--kube-api-url" in argv else "NoneType")


def test_manager_help_lists_every_jax_flag(monkeypatch):
    flags = _main_args(JAX, ["--disable-preset-autogen"], monkeypatch)["flags"]
    out = subprocess.run([sys.executable, "-m", "kaito_tpu_torch.controllers.manager",
                          "--help"], cwd=REPO, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    listed = {w.strip(",[]") for w in out.stdout.split() if w.startswith("-")}
    assert set(flags) <= listed
    assert {"--kube-api-url", "--in-memory-store", "--metrics-port"} <= set(flags)
