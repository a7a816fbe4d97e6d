"""Tuning job CLI: ``python -m kaito_tpu_torch.tuning.cli --model M
--data-dir D --output-dir O [...]``.

Counterpart of ``kaito_tpu.tuning.cli``, with the same flags and the
same ``TrainConfig`` for the same argv (``--config-file``, a YAML file
whose ``training`` section overrides fields, imports ``yaml`` only when
given; ``--mesh`` is parsed and, as in the JAX package, not used).
``main`` trains on the card, in bf16 unless ``--dtype`` says otherwise.
"""

from __future__ import annotations

import argparse
import logging
import sys

from kaito_tpu_torch.tuning.lora import LoraConfig
from kaito_tpu_torch.tuning.trainer import TrainConfig, Trainer


def parse_args(argv=None) -> TrainConfig:
    ap = argparse.ArgumentParser(prog="kaito-tpu-tune")
    ap.add_argument("--model", required=True)
    ap.add_argument("--method", default="lora", choices=["lora", "qlora", "full"])
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--mesh", default="")
    ap.add_argument("--config-file", default="")
    ap.add_argument("--learning-rate", type=float, default=2e-4)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-seq-len", type=int, default=512)
    ap.add_argument("--num-epochs", type=int, default=1)
    ap.add_argument("--max-steps", type=int, default=0)
    ap.add_argument("--lora-r", type=int, default=8)
    ap.add_argument("--lora-alpha", type=int, default=16)
    ap.add_argument("--lora-targets", default="q,k,v,o")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default="")
    args = ap.parse_args(argv)

    cfg = TrainConfig(
        model=args.model, method=args.method, data_dir=args.data_dir,
        output_dir=args.output_dir, learning_rate=args.learning_rate,
        batch_size=args.batch_size, max_seq_len=args.max_seq_len,
        num_epochs=args.num_epochs, max_steps=args.max_steps,
        checkpoint_every=args.checkpoint_every, seed=args.seed,
        lora=LoraConfig(r=args.lora_r, alpha=args.lora_alpha,
                        targets=tuple(t for t in args.lora_targets.split(",") if t)))
    if args.dtype:
        cfg.dtype = args.dtype
    if args.config_file:
        import yaml

        with open(args.config_file) as f:
            overrides = (yaml.safe_load(f) or {}).get("training", {})
        for k, v in overrides.items():
            k = k.replace("-", "_")
            if hasattr(cfg, k):
                setattr(cfg, k, v)
    return cfg


def main(argv=None, device: str = "cuda") -> dict:
    """Parse ``argv`` (``sys.argv[1:]`` when None) and train on
    ``device``: in bf16 unless ``--dtype`` (or the config file) picks a
    dtype.  The JAX package's ``main`` means to do the same on a TPU,
    but its test never holds (``TrainConfig.dtype`` is never empty)."""
    logging.basicConfig(level=logging.INFO)
    argv = sys.argv[1:] if argv is None else list(argv)
    cfg = parse_args(argv)
    if cfg.dtype == TrainConfig.dtype and not any(
            a == "--dtype" or a.startswith("--dtype=") for a in argv):
        cfg.dtype = "bfloat16"
    result = Trainer(cfg, device=device).train()
    logging.info("training complete: %s", result)
    return result


if __name__ == "__main__":
    main()
