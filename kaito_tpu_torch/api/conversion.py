"""Legacy API version conversion (hub-and-spoke).

The analogue of the reference's conversion webhooks
(``api/v1alpha1/ragengine_conversion.go``, ``workspace_conversion.go``):
``kaito-tpu.io/v1`` is the hub; legacy ``v1alpha1`` wire objects
upgrade in place before decoding, so old manifests keep applying after
the API graduates.  Shape changes mirrored from the reference:

- RAGEngine storage: v1alpha1 FLAT ``{persistentVolumeClaim,
  mountPath}`` -> v1 nested ``storage.persistentVolume{...}``.
- RAGEngine inference service: v1alpha1 ``inferenceService.URL`` (the
  Go JSON tag capitalizes) -> v1 ``inferenceService.url``.
- Workspace tuning method casing: v1alpha1 ``qlora``/``lora`` ->
  v1 ``QLoRA``/``LoRA`` preset names pass through unchanged.

Unknown fields pass through untouched — conversion must never drop
fields it does not understand (round-trip safety, the property the
reference encodes in its conversion fuzz tests).

A copy of ``kaito_tpu.api.conversion``.
"""

from __future__ import annotations

import copy

LEGACY_VERSIONS = ("kaito-tpu.io/v1alpha1",)
HUB_VERSION = "kaito-tpu.io/v1"


def is_legacy(d: dict) -> bool:
    return d.get("apiVersion") in LEGACY_VERSIONS


def convert_to_hub(d: dict) -> dict:
    """Upgrade a legacy wire object to the hub version (no-op for hub
    or unknown versions; never mutates the input)."""
    if not is_legacy(d):
        return d
    out = copy.deepcopy(d)
    out["apiVersion"] = HUB_VERSION
    kind = out.get("kind")
    if kind == "RAGEngine":
        _convert_ragengine(out)
    elif kind == "Workspace":
        _convert_workspace(out)
    return out


def _convert_ragengine(out: dict) -> None:
    spec = out.get("spec") or {}
    storage = spec.get("storage")
    if isinstance(storage, dict):
        # only restructure when the nested form is absent — a
        # half-migrated manifest carrying both keeps BOTH (never drop
        # fields; the nested form wins at decode time)
        if "persistentVolume" not in storage and (
                storage.get("persistentVolumeClaim")
                or storage.get("mountPath")):
            storage["persistentVolume"] = {
                "persistentVolumeClaim": storage.pop(
                    "persistentVolumeClaim", ""),
                "mountPath": storage.pop("mountPath", "")}
    svc = spec.get("inferenceService")
    if isinstance(svc, dict):
        for legacy_key, hub_key in (("URL", "url"),
                                    ("AccessSecret", "accessSecret")):
            if legacy_key in svc and hub_key not in svc:
                svc[hub_key] = svc.pop(legacy_key)


def _convert_workspace(out: dict) -> None:
    tuning = out.get("tuning")
    if isinstance(tuning, dict):
        method = tuning.get("method")
        aliases = {"qlora": "QLoRA", "lora": "LoRA"}
        if method in aliases:
            tuning["method"] = aliases[method]


def convert_from_hub(d: dict, desired: str) -> dict:
    """Downgrade a hub object to a served legacy version (the spoke
    direction: clients reading/applying at v1alpha1 must see the
    legacy SHAPE, not a relabeled hub object — otherwise kubectl apply
    of flat legacy manifests diffs forever against the nested live
    form)."""
    if desired not in LEGACY_VERSIONS or d.get("apiVersion") == desired:
        return d
    out = copy.deepcopy(d)
    out["apiVersion"] = desired
    kind = out.get("kind")
    if kind == "RAGEngine":
        spec = out.get("spec") or {}
        storage = spec.get("storage")
        if isinstance(storage, dict):
            pv = storage.pop("persistentVolume", None)
            if isinstance(pv, dict):
                storage.setdefault("persistentVolumeClaim",
                                   pv.get("persistentVolumeClaim", ""))
                storage.setdefault("mountPath", pv.get("mountPath", ""))
        svc = spec.get("inferenceService")
        if isinstance(svc, dict):
            for hub_key, legacy_key in (("url", "URL"),
                                        ("accessSecret", "AccessSecret")):
                if hub_key in svc and legacy_key not in svc:
                    svc[legacy_key] = svc.pop(hub_key)
    elif kind == "Workspace":
        tuning = out.get("tuning")
        if isinstance(tuning, dict):
            aliases = {"QLoRA": "qlora", "LoRA": "lora"}
            if tuning.get("method") in aliases:
                tuning["method"] = aliases[tuning["method"]]
    return out


def convert(d: dict, desired: str) -> dict:
    """Convert to the requested version, either direction."""
    if desired == HUB_VERSION:
        return convert_to_hub(d)
    return convert_from_hub(convert_to_hub(d), desired)
