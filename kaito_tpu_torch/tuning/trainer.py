"""The tuning trainer: LoRA, QLoRA and full fine-tuning on one card.

Counterpart of ``kaito_tpu.tuning.trainer`` with its flow: a seeded
synthetic base (or a given parameter tree), for QLoRA the base's
projections quantized to int8 and then the lora factors added, for
LoRA the factors alone; gradients of the trainable leaves only; the
optimizer of ``optim.trainer_optimizer``; resume from the newest
readable checkpoint, the resumed steps' batches skipped in the seeded
order (the JAX trainer's skip never runs: it starts its step counter
at the resumed step, so a resumed run there retrains the first
batches); ``training_metrics.json`` written atomically after
every step (the JAX trainer's keys and tokens/s formula); and at the
end the adapter (``lora.save_adapter``), a final checkpoint and the
``fine_tuning_completed.txt`` sentinel.

Checkpoints are ``output_dir/checkpoints/<step>/state.pt`` in torch's
own format: the whole parameter tree, the optimizer state and the
step, written to a temporary directory and renamed into place.  The
JAX package's Orbax layout is left out on purpose: it needs packages
the card machine does not have.

The trainer runs on CUDA unless asked for the CPU, and raises when
CUDA is asked for and absent.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from kaito_tpu_torch.device import resolve_device
from kaito_tpu_torch.engine.model import TransformerLM
from kaito_tpu_torch.engine.tokenizer import load_tokenizer
from kaito_tpu_torch.models import get_model_by_name
from kaito_tpu_torch.tuning import dataset as ds
from kaito_tpu_torch.tuning.lora import (LoraConfig, add_lora_params, save_adapter,
                                         set_lora_params)
from kaito_tpu_torch.tuning.optim import trainer_optimizer
from kaito_tpu_torch.tuning.quant import quantize_base
from kaito_tpu_torch.tuning.train_step import (TrainState, flat_leaves,
                                               make_train_step, trainable_leaves)

logger = logging.getLogger(__name__)

SENTINEL = "fine_tuning_completed.txt"
METRICS_FILE = "training_metrics.json"
CHECKPOINT_FILE = "state.pt"


@dataclass
class TrainConfig:
    model: str = "tiny-llama-test"
    method: str = "lora"                  # lora | qlora | full
    data_dir: str = ""
    output_dir: str = ""
    lora: LoraConfig = field(default_factory=LoraConfig)
    learning_rate: float = 2e-4
    weight_decay: float = 0.0
    batch_size: int = 4
    max_seq_len: int = 512
    num_epochs: int = 1
    max_steps: int = 0                    # 0 = epochs decide
    warmup_steps: int = 10
    checkpoint_every: int = 50
    seed: int = 0
    dtype: str = "float32"


class Trainer:
    """``Trainer(cfg, device="cuda", params=None)``: ``params``, a
    parameter tree as ``TransformerLM.param_tree`` gives it (lora leaves
    and int8 QTensors included or not), replaces the seeded synthetic
    base; lora leaves in it replace the drawn factors."""

    def __init__(self, cfg: TrainConfig, device: str | torch.device = "cuda",
                 params: Optional[dict] = None):
        if cfg.method not in ("lora", "qlora", "full"):
            raise ValueError(f"unknown tuning method {cfg.method!r} "
                             f"(lora, qlora or full)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.md = get_model_by_name(cfg.model)
        self.model = TransformerLM(self.md.arch, dtype=getattr(torch, cfg.dtype),
                                   device=self.device)
        self.tokenizer = load_tokenizer(self.md.hf_id, self.md.arch.vocab_size)
        model = self.model
        if params is None:
            model.init_params(cfg.seed)
        else:
            model.load_params(params)
        if cfg.method in ("lora", "qlora"):
            if cfg.method == "qlora":
                quantize_base(model)
            if params is not None and any("_lora_" in n for n, _ in flat_leaves(params)):
                set_lora_params(model, params, cfg.lora)
            else:
                add_lora_params(model, cfg.lora, seed=cfg.seed)
        else:
            for p in model.parameters():
                p.requires_grad_(p.is_floating_point())
        self.optimizer = trainer_optimizer(cfg.learning_rate, cfg.warmup_steps,
                                           cfg.max_steps, cfg.weight_decay)
        self.train_names = [n for n, _ in trainable_leaves(model)]
        train = [p for _, p in trainable_leaves(model)]
        self.state = TrainState(params=train, opt_state=self.optimizer.init(train),
                                step=0)
        self._step_fn = make_train_step(model, self.optimizer)

    # -- checkpointing ---------------------------------------------------

    def _ckpt_dir(self) -> str:
        return os.path.join(self.cfg.output_dir, "checkpoints")

    def save_checkpoint(self, step: int) -> None:
        """The whole parameter tree, the optimizer state and the step, as
        ``checkpoints/<step>/state.pt`` (renamed into place whole)."""
        path = os.path.join(self._ckpt_dir(), str(step))
        tmp = path + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        params = {n: t.detach() for n, t in flat_leaves(self.model.param_tree())}
        torch.save({"params": params, "opt_state": self.state.opt_state,
                    "step": step}, os.path.join(tmp, CHECKPOINT_FILE))
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
        logger.info("checkpoint saved at step %d", step)

    def restore_latest(self) -> int:
        """Load the newest checkpoint that reads (older ones on failure);
        the step it holds, or 0 when none reads."""
        d = self._ckpt_dir()
        if not os.path.isdir(d):
            return 0
        steps = sorted((int(s) for s in os.listdir(d) if s.isdigit()), reverse=True)
        live = dict(flat_leaves(self.model.param_tree()))
        for step in steps:
            try:
                saved = torch.load(os.path.join(d, str(step), CHECKPOINT_FILE),
                                   map_location=self.device)
                if set(saved["params"]) != set(live):
                    raise ValueError("the checkpoint's parameters are not this "
                                     "model's")
                with torch.no_grad():
                    for k, t in live.items():
                        t.copy_(saved["params"][k])
                self.state = TrainState(params=self.state.params,
                                        opt_state=saved["opt_state"],
                                        step=int(saved["step"]))
                logger.info("resumed from checkpoint step %d", step)
                return step
            except Exception:
                logger.exception("failed restoring step %d; trying older", step)
        return 0

    # -- the loop --------------------------------------------------------

    def _write_metrics(self, payload: dict) -> None:
        if not self.cfg.output_dir:
            return
        os.makedirs(self.cfg.output_dir, exist_ok=True)
        tmp = os.path.join(self.cfg.output_dir, METRICS_FILE + ".tmp")
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, os.path.join(self.cfg.output_dir, METRICS_FILE))

    def train(self, on_step=None) -> dict:
        """Run the epochs (or ``max_steps``); ``on_step(step, metrics)``,
        when given, is called after every step taken with the step's
        ``loss`` (a float) and ``grad_norm`` (a tensor) and the metrics
        file's fields."""
        cfg = self.cfg
        dcfg = ds.DatasetConfig(data_dir=cfg.data_dir, max_seq_len=cfg.max_seq_len)
        train_data, eval_data = ds.build_examples(self.tokenizer, dcfg)
        logger.info("dataset: %d train / %d eval examples",
                    len(train_data["tokens"]), len(eval_data["tokens"]))

        start_step = self.restore_latest()
        step = seen = start_step
        t0 = time.monotonic()
        losses: list[float] = []
        done = False
        for epoch in range(cfg.num_epochs):
            for batch in ds.batches(train_data, cfg.batch_size, seed=cfg.seed + epoch):
                if seen > 0:
                    seen -= 1
                    continue  # fast-forward through the resumed steps' batches
                tb = {"tokens": torch.from_numpy(batch["tokens"]).to(self.device),
                      "mask": torch.from_numpy(batch["mask"]).to(self.device)}
                self.state, metrics = self._step_fn(self.state, tb)
                step += 1
                loss = float(metrics["loss"])
                losses.append(loss)
                if step % 10 == 0 or step == 1:
                    logger.info("step %d loss %.4f", step, loss)
                payload = {
                    "step": step, "loss": loss,
                    "tokens_per_second": cfg.batch_size * cfg.max_seq_len
                    * max(step - start_step, 1) / max(time.monotonic() - t0, 1e-6),
                    "epoch": epoch,
                }
                self._write_metrics(payload)
                if on_step is not None:
                    on_step(step, {**metrics, **payload})
                if cfg.checkpoint_every and step % cfg.checkpoint_every == 0:
                    self.save_checkpoint(step)
                if cfg.max_steps and step >= cfg.max_steps:
                    done = True
                    break
            if done:
                break

        result = {"steps": step, "final_loss": losses[-1] if losses else None,
                  "mean_last10": float(np.mean(losses[-10:])) if losses else None}
        if cfg.output_dir:
            os.makedirs(cfg.output_dir, exist_ok=True)
            if cfg.method in ("lora", "qlora"):
                save_adapter(os.path.join(cfg.output_dir, "adapter"),
                             self.model.param_tree(), cfg.lora, cfg.model)
            self.save_checkpoint(step)
            with open(os.path.join(cfg.output_dir, SENTINEL), "w") as f:
                f.write(json.dumps(result))
        return result
