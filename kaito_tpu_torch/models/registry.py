"""Model preset registry.

The analogue of the reference's plugin registry + lookup
(``pkg/utils/plugin/plugin.go:37-133`` and ``GetModelByName``,
``presets/workspace/models/vllm_model.go:116``): presets register by
name; unknown names fall back to on-the-fly auto-generation from a HF
config fetched by an injectable hook (the reference hits the HF Hub API
directly at reconcile time).
"""

from __future__ import annotations

import threading
from typing import Callable, Mapping, Optional

from kaito_tpu_torch.models.metadata import ModelMetadata

_lock = threading.Lock()
_registry: dict[str, ModelMetadata] = {}

# Optional hook: hf_id -> config.json dict (or None).  Installed by the
# controller when it has hub access; tests install fakes.
ConfigFetcher = Callable[[str], Optional[Mapping]]
_config_fetcher: Optional[ConfigFetcher] = None


def register_model(md: ModelMetadata, replace: bool = False) -> None:
    with _lock:
        if md.name in _registry and not replace:
            raise ValueError(f"model preset {md.name!r} already registered")
        _registry[md.name] = md


def is_valid_preset(name: str) -> bool:
    return name in _registry


def list_presets() -> list[str]:
    with _lock:
        return sorted(_registry)


def set_config_fetcher(fetcher: Optional[ConfigFetcher]) -> None:
    global _config_fetcher
    _config_fetcher = fetcher


def get_model_by_name(name: str) -> ModelMetadata:
    """Look up a preset; auto-generate for unregistered HF ids when a
    config fetcher is installed (reference behavior:
    ``vllm_model.go:116-160`` falls through to ``GeneratePreset``)."""
    with _lock:
        md = _registry.get(name)
        if md is None and "/" in name:
            # a Workspace may name the full HF id instead of the preset
            # short name; registered presets win over auto-generation
            # (their metadata carries curated file sizes/tags)
            low = name.lower()
            md = next((m for m in _registry.values()
                       if m.hf_id.lower() == low), None)
    if md is not None:
        return md
    if _config_fetcher is not None and "/" in name:
        cfg = _config_fetcher(name)
        if cfg is not None:
            from kaito_tpu_torch.models.autogen import metadata_from_hf_config

            # register under the FULL id: a fork's basename must never
            # clobber a curated preset sharing the short name (manifests
            # and the engine both resolve the same full id)
            md = metadata_from_hf_config(name, cfg, name=name)
            register_model(md, replace=True)
            return md
    raise KeyError(
        f"unknown model {name!r}; not a built-in preset and no config "
        f"fetcher produced a HuggingFace config for it"
    )


def draft_compatibility_errors(target: ModelMetadata,
                               draft: ModelMetadata) -> list[str]:
    """Why ``draft`` cannot speculate for ``target`` (empty = ok).

    Speculative decoding emits the DRAFT's token ids verbatim once the
    target accepts them, so both presets must share one tokenizer.  The
    catalog carries no tokenizer files, so vocab-size equality is the
    enforced proxy (it is also exactly what ``load_tokenizer`` keys
    on); the engine re-checks at load time.
    """
    errs: list[str] = []
    if draft.runtime != "engine":
        errs.append(f"draft preset {draft.name!r} runs on the "
                    f"{draft.runtime!r} runtime; speculation needs the "
                    f"first-party engine")
    if draft.arch.vocab_size != target.arch.vocab_size:
        errs.append(
            f"draft preset {draft.name!r} vocab_size "
            f"{draft.arch.vocab_size} != target {target.name!r} "
            f"vocab_size {target.arch.vocab_size} (speculation requires "
            f"a shared tokenizer)")
    return errs


def resolve_speculative_draft(target: ModelMetadata,
                              annotation: str) -> str:
    """Resolve the ``kaito-tpu.io/speculative-draft`` annotation (or
    the ``--speculative-draft`` flag value) to a validated draft preset
    name.  ``""`` disables; ``"auto"`` takes the target preset's
    curated ``speculative_draft`` pairing (may be empty — serving then
    stays non-speculative).  Raises ``ValueError`` on an unknown preset
    or an incompatible pairing (surfaced as a controller condition).
    """
    name = (annotation or "").strip()
    if name == "auto":
        name = target.speculative_draft
    if not name:
        return ""
    try:
        draft = get_model_by_name(name)
    except KeyError:
        raise ValueError(
            f"speculative draft preset {name!r} is not in the model "
            f"catalog") from None
    errs = draft_compatibility_errors(target, draft)
    if errs:
        raise ValueError("; ".join(errs))
    return draft.name
