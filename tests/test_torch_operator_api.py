"""The port's copies of the operator's types against the JAX package's,
on the inputs of ``tests/test_quantity.py``, ``tests/test_api_types.py``
and ``tests/test_api_conversion.py``, on the CPU.

- ``utils/quantity``: parse, format and ``Quantity`` arithmetic equal,
  errors included.
- The API kinds (Workspace, InferenceSet, RAGEngine, MultiRoleInference,
  ModelMirror): defaulting leaves equal fields and ``validate()`` equal
  error lists; ``revision_payload`` is equal.  A GPU machine type (GKE's
  A3) is the one place they differ, by design: the port's Workspace
  accepts it, the JAX one needs a label selector for it.
- ``api/conversion``: to and from the hub, and a round trip, equal.
- ``featuregates``: the defaults and the parse of each input equal.
"""

import dataclasses
import importlib
import types

import pytest

from kaito_tpu.utils import quantity as jq
from kaito_tpu_torch.utils import quantity as tq


def _pkg(root):
    def mod(path):
        return importlib.import_module(f"{root}.{path}")
    return types.SimpleNamespace(
        api=mod("api"), ws=mod("api.workspace"), mri=mod("api.multiroleinference"),
        rag=mod("api.ragengine"), conv=mod("api.conversion"), gates=mod("featuregates"))


JAX, PORT = _pkg("kaito_tpu"), _pkg("kaito_tpu_torch")


def _outcome(fn):
    try:
        return ("ok", fn())
    except (ValueError, TypeError) as e:
        return ("error", type(e).__name__, str(e))


def _plain(x):
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)
                if f.name != "creation_timestamp"}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if hasattr(x, "__dict__"):
        return {k: _plain(v) for k, v in vars(x).items()}
    return x


# ---------------------------------------------------------------------------
# Quantities
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value", ["1Gi", "27.31Gi", "500Mi", "2k", 42, "abc", "1536Mi",
                                   "10Gi", "0.5Ki", " 3 M ", "1.5", "", "7Ti", "-1Gi"])
def test_parse_quantity_equals_the_jax_one(value):
    assert _outcome(lambda: tq.parse_quantity(value)) == \
        _outcome(lambda: jq.parse_quantity(value))


@pytest.mark.parametrize("n", [2**30, 10 * 2**30, 1536 * 2**20, 1, 1000, 123456789,
                               3 * 2**40, 0])
def test_format_quantity_equals_the_jax_one(n):
    assert tq.format_quantity(n) == jq.format_quantity(n)
    assert str(tq.Quantity(n)) == str(jq.Quantity(n))


def test_quantity_arithmetic_equals_the_jax_one():
    for mod in (tq, jq):
        assert mod.Quantity("2Gi") + "1Gi" == mod.Quantity("3Gi")
        assert mod.Quantity("1Gi") < "2Gi" and mod.Quantity("1Gi") <= "1Gi"
    assert str(tq.Quantity("1536Mi")) == str(jq.Quantity("1536Mi")) == "1.50Gi"
    for a, b in (("2Gi", "1Gi"), ("500Mi", 7), ("1k", "1Ki")):
        assert int(tq.Quantity(a) + b) == int(jq.Quantity(a) + b)
        assert repr(tq.Quantity(a) * 1.5) == repr(jq.Quantity(a) * 1.5)


# ---------------------------------------------------------------------------
# The API kinds: the inputs of tests/test_api_types.py
# ---------------------------------------------------------------------------

def _ws(p, **kw):
    return p.api.Workspace(p.api.ObjectMeta(name="ws"), **kw)


CASES = {
    "no-inference-or-tuning": lambda p: _ws(p),
    "valid-inference": lambda p: _ws(
        p, resource=p.api.ResourceSpec(instance_type="ct5lp-hightpu-4t"),
        inference=p.api.InferenceSpec(preset="phi-4-mini-instruct")),
    "bad-preset-and-topology": lambda p: _ws(
        p, resource=p.api.ResourceSpec(tpu_topology="4xx4"),
        inference=p.api.InferenceSpec(preset="not-a-preset")),
    "hf-id-preset": lambda p: _ws(p, inference=p.api.InferenceSpec(
        preset="someorg/some-model")),
    "unknown-instance-type": lambda p: _ws(
        p, resource=p.api.ResourceSpec(instance_type="n2-standard-4"),
        inference=p.api.InferenceSpec(preset="phi-4")),
    "unknown-instance-type-with-selector": lambda p: _ws(
        p, resource=p.api.ResourceSpec(instance_type="n2-standard-4",
                                       label_selector={"pool": "mine"}),
        inference=p.api.InferenceSpec(preset="phi-4")),
    "adapters": lambda p: _ws(p, inference=p.api.InferenceSpec(
        preset="phi-4", adapters=[p.ws.AdapterSpec(name="a", source_image="img",
                                                   strength=1.5),
                                  p.ws.AdapterSpec(name="a", source_image="img")])),
    "bad-tuning": lambda p: _ws(p, tuning=p.api.TuningSpec(
        preset="phi-4", method="bad", input=p.ws.TuningInput(),
        output=p.ws.TuningOutput())),
    "good-tuning": lambda p: _ws(p, tuning=p.api.TuningSpec(
        preset="phi-4", method="qlora", input=p.ws.TuningInput(urls=["https://x/d.jsonl"]),
        output=p.ws.TuningOutput(image="reg/out:v1"))),
    "both-and-count": lambda p: _ws(
        p, resource=p.api.ResourceSpec(count=9),
        inference=p.api.InferenceSpec(preset=" phi-4 "),
        tuning=p.api.TuningSpec(preset="phi-4", method="")),
    "zero-count": lambda p: _ws(p, resource=p.api.ResourceSpec(count=0),
                                inference=p.api.InferenceSpec(preset="phi-4")),
    "inferenceset": lambda p: p.api.InferenceSet(
        p.api.ObjectMeta(name="is"), p.api.InferenceSetSpec(replicas=-1)),
    "ragengine-empty": lambda p: p.api.RAGEngine(p.api.ObjectMeta(name="rag"),
                                                 p.api.RAGEngineSpec()),
    "ragengine-ok": lambda p: p.api.RAGEngine(p.api.ObjectMeta(name="rag"),
                                              p.api.RAGEngineSpec(
        embedding=p.rag.EmbeddingSpec(local=p.rag.LocalEmbedding(model_id="bge-small")),
        inference_service=p.rag.InferenceServiceSpec(url="http://ws:5000"))),
    "mri-ok": lambda p: p.api.MultiRoleInference(
        p.api.ObjectMeta(name="pd"), p.mri.MultiRoleInferenceSpec(
            model=p.mri.MRIModelSpec(name="llama-3.1-8b-instruct"),
            roles=[p.mri.RoleSpec(type="prefill"), p.mri.RoleSpec(type="decode")])),
    "mri-bad": lambda p: p.api.MultiRoleInference(
        p.api.ObjectMeta(name="pd"), p.mri.MultiRoleInferenceSpec(
            model=p.mri.MRIModelSpec(name="x"), roles=[p.mri.RoleSpec(type="decode")])),
    "modelmirror": lambda p: p.api.ModelMirror(p.api.ObjectMeta(name="m")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_defaulting_and_validation_equal_the_jax_ones(case):
    objs = []
    for p in (JAX, PORT):
        obj = CASES[case](p)
        before = obj.validate()
        if hasattr(obj, "default"):
            obj.default()
        objs.append((before, obj.validate(), _plain(obj)))
    assert objs[1] == objs[0]
    if case.startswith(("valid", "good", "hf-id", "ragengine-ok", "mri-ok")):
        assert objs[1][1] == []
    if hasattr(CASES[case](PORT), "revision_payload"):
        assert CASES[case](PORT).revision_payload() == CASES[case](JAX).revision_payload()


def test_inferenceset_update_strategy_error_equals_the_jax_one():
    errs = []
    for p in (JAX, PORT):
        s = p.api.InferenceSet(p.api.ObjectMeta(name="is"), p.api.InferenceSetSpec(replicas=-1))
        s.default()
        s.spec.template.inference.preset = "phi-4"
        s.spec.update_strategy = "Nope"
        errs.append(s.validate())
    assert errs[0] == errs[1] and any("updateStrategy" in e for e in errs[1])


@pytest.mark.parametrize("machine", ["a3-highgpu-1g", "a3-highgpu-8g", "a3-megagpu-8g"])
def test_gpu_machine_types_validate_in_the_port_only(machine):
    def make(p):
        return _ws(p, resource=p.api.ResourceSpec(instance_type=machine),
                   inference=p.api.InferenceSpec(preset="llama-3.1-8b-instruct"))
    assert make(PORT).validate() == []
    assert any("not a known TPU machine type" in e for e in make(JAX).validate())


# ---------------------------------------------------------------------------
# Conversion: the inputs of tests/test_api_conversion.py
# ---------------------------------------------------------------------------

def _legacy_rag(storage=None, svc=None):
    return {
        "apiVersion": "kaito-tpu.io/v1alpha1", "kind": "RAGEngine",
        "metadata": {"name": "rag1", "namespace": "default"},
        "spec": {"compute": {"instanceType": "ct5lp-hightpu-1t"},
                 "storage": storage if storage is not None else {
                     "persistentVolumeClaim": "rag-pvc", "mountPath": "/data"},
                 "inferenceService": svc if svc is not None else {
                     "URL": "http://svc:5000", "AccessSecret": "tok"}}}


WIRE = {
    "legacy-rag": _legacy_rag(),
    "half-migrated": _legacy_rag(storage={
        "persistentVolumeClaim": "flat-pvc", "mountPath": "/flat",
        "persistentVolume": {"persistentVolumeClaim": "nested-pvc",
                             "mountPath": "/nested"}}),
    "rag-no-storage": _legacy_rag(storage={}, svc={}),
    "workspace-tuning": {"apiVersion": "kaito-tpu.io/v1alpha1", "kind": "Workspace",
                         "metadata": {"name": "w"},
                         "tuning": {"method": "qlora", "preset": "phi-4-mini-instruct"}},
    "workspace-lora": {"apiVersion": "kaito-tpu.io/v1alpha1", "kind": "Workspace",
                       "metadata": {"name": "w"}, "tuning": {"method": "lora"}},
    "hub-object": {"apiVersion": "kaito-tpu.io/v1", "kind": "Workspace",
                   "metadata": {"name": "w"}, "extra": {"kept": True}},
}


@pytest.mark.parametrize("name", list(WIRE))
def test_conversion_equals_the_jax_one(name):
    obj = WIRE[name]
    for fn in ("convert_to_hub",):
        assert getattr(PORT.conv, fn)(obj) == getattr(JAX.conv, fn)(obj)
    hub = JAX.conv.convert_to_hub(obj)
    for desired in ("kaito-tpu.io/v1alpha1", "kaito-tpu.io/v1"):
        assert _outcome(lambda: PORT.conv.convert_from_hub(hub, desired)) == \
            _outcome(lambda: JAX.conv.convert_from_hub(hub, desired))
        assert _outcome(lambda: PORT.conv.convert(obj, desired)) == \
            _outcome(lambda: JAX.conv.convert(obj, desired))
    assert PORT.conv.is_legacy(obj) == JAX.conv.is_legacy(obj)
    assert obj == WIRE[name]          # neither mutated its input


# ---------------------------------------------------------------------------
# Feature gates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("text", ["", "modelMirror=true", "autoscaler=TRUE, pallasAttention=false",
                                  "nope=true", "modelMirror", "modelMirror=yes", ",,"])
def test_feature_gates_equal_the_jax_ones(text):
    assert PORT.gates.DEFAULT_GATES == JAX.gates.DEFAULT_GATES
    assert _outcome(lambda: PORT.gates.parse_feature_gates(text)) == \
        _outcome(lambda: JAX.gates.parse_feature_gates(text))
