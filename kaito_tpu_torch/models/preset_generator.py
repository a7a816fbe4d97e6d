"""Preset generator CLI.

The counterpart of the reference's ``cmd/preset-generator/main.go``
(1-88): generate a preset for any HF model id and print the derived
metadata the operator plans with — bytes/token, estimated file size,
and the parallelism plan per TPU generation.

Usage::

    python -m kaito_tpu_torch.models.preset_generator --model org/name
    python -m kaito_tpu_torch.models.preset_generator --model org/name \
        --config-file recorded_config.json --chip h100-80gb --json

Resolution order: --config-file > committed catalog > HF hub (needs
egress and, for gated models, HF_TOKEN).

The port's own copy of ``kaito_tpu/models/preset_generator.py``: it
plans against the port's catalog, so ``--chip`` takes a TPU generation
(``CHIP_CATALOG``, where the output equals the JAX CLI's key for key)
or an H100 entry (``GPU_CATALOG``: ``h100-80gb``, ``h100-mega-80gb``),
which the port's planner sizes for its own engine.
"""

from __future__ import annotations

import argparse
import json
import sys

from kaito_tpu_torch.models.autogen import metadata_from_hf_config
from kaito_tpu_torch.models.hub import catalog_config, fetch_hf_config


def generate(hf_id: str, cfg: dict):
    md = metadata_from_hf_config(hf_id, cfg)
    a = md.arch
    out = {
        "name": md.name,
        "hf_id": md.hf_id,
        "architecture": (cfg.get("architectures") or [""])[0],
        "num_layers": a.num_layers,
        "hidden_size": a.hidden_size,
        "num_heads": a.num_heads,
        "num_kv_heads": a.num_kv_heads,
        "vocab_size": a.vocab_size,
        "max_model_len": md.max_model_len,
        "num_experts": a.num_experts,
        "param_count": a.param_count(),
        "kv_bytes_per_token_bf16": md.kv_bytes_per_token(2),
        "kv_bytes_per_token_int8": md.kv_bytes_per_token(1),
        "model_file_bytes": md.file_bytes,
        "speculative_draft": md.speculative_draft,
    }
    return md, out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="kaito-tpu-preset-generator")
    ap.add_argument("--model", required=True, help="HF id (org/name)")
    ap.add_argument("--config-file", default="",
                    help="local recorded config.json (skips catalog/hub)")
    ap.add_argument("--chip", default="v5e",
                    help="catalog entry for the plan preview: a TPU "
                         "generation or an H100 entry (h100-80gb, "
                         "h100-mega-80gb)")
    ap.add_argument("--kv-cache-dtype", default="bfloat16",
                    choices=["bfloat16", "int8"],
                    help="KV pool dtype assumed by the plan preview "
                         "(int8 halves KV bytes/token)")
    ap.add_argument("--quantization", default="",
                    choices=["", "int8", "int4"],
                    help="weight-only quantization assumed by the plan "
                         "preview (int8 halves, int4 ~quarters weight "
                         "bytes -> fewer chips; docs/quantization.md)")
    ap.add_argument("--cp-autocarve", action="store_true",
                    help="opt the plan preview into the >=32k serve CP "
                         "carve (evidence-gated off by default: BENCH_r05 "
                         "cp_speedup_vs_chunked=0.68)")
    ap.add_argument("--speculative-draft", default="",
                    help="draft preset for speculative decoding: a "
                         "catalog name, or 'auto' for the curated "
                         "pairing; validated against the target "
                         "(tokenizer/runtime compatibility)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output")
    args = ap.parse_args(argv)

    if args.config_file:
        with open(args.config_file) as f:
            cfg = json.load(f)
    else:
        cfg = catalog_config(args.model) or fetch_hf_config(args.model)
    if cfg is None:
        print(f"error: no config for {args.model} (not in the catalog; "
              f"hub fetch failed or offline)", file=sys.stderr)
        return 1

    md, out = generate(args.model, cfg)

    # prefer the committed catalog entry when one matches: it carries
    # the curated speculative_draft pairing the autogen path can't know
    from kaito_tpu_torch.models.registry import (get_model_by_name,
                                                 resolve_speculative_draft)
    try:
        md = get_model_by_name(args.model)
        out["speculative_draft"] = md.speculative_draft
    except KeyError:
        pass
    if args.speculative_draft:
        try:
            out["speculative_draft"] = resolve_speculative_draft(
                md, args.speculative_draft)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1

    try:
        from kaito_tpu_torch.estimator.estimator import weight_bytes
        from kaito_tpu_torch.parallel.plan import plan_parallelism
        from kaito_tpu_torch.sku.catalog import CHIP_CATALOG, GPU_CATALOG
        # weight-byte ladder the operator plans against (the int4 row
        # is why a 70B fits half the chips; docs/quantization.md)
        out["weight_bytes_bf16"] = weight_bytes(md, "bf16")
        out["weight_bytes_int8"] = weight_bytes(md, "int8")
        out["weight_bytes_int4"] = weight_bytes(md, "int4")
        chip = {**CHIP_CATALOG, **GPU_CATALOG}[args.chip]
        plan = plan_parallelism(
            md, chip,
            kv_dtype_bytes=1 if args.kv_cache_dtype == "int8" else 2,
            quantization=args.quantization or None,
            cp_autocarve=args.cp_autocarve)
        out["plan"] = {"chip": args.chip, "topology": plan.topology,
                       "num_slices": plan.num_slices,
                       "mesh": str(plan.mesh),
                       "notes": list(plan.notes)}
    except Exception as e:
        out["plan_error"] = str(e)

    if args.json:
        print(json.dumps(out, indent=2))
    else:
        for k, v in out.items():
            print(f"{k:28s} {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
