"""The port's Trainer, CLI and metrics sidecar on the CPU.

- ``Trainer`` on ``tiny-llama-test`` (fp32, a seeded instruction /
  response jsonl) for lora, qlora and full: the loss falls; the
  sentinel's keys and ``training_metrics.json``'s keys are the JAX
  trainer's; a lora/qlora run's adapter loads through the JAX
  ``load_adapter``, and the JAX ``apply_adapter`` plus ``forward_train``
  on the port's base gives the port's logits (atol 1e-4);
- resume: a run cut after step 5 (its last checkpoint at step 4, or at
  step 2 when the newest checkpoint does not read) and resumed to step 6
  ends with the leaves and the step-6 loss of an uninterrupted 6-step
  run, bit for bit;
- ``parse_args`` gives the JAX package's ``TrainConfig`` for the same
  argv; ``main`` trains in bf16 unless ``--dtype`` is given;
  ``render_metrics`` is byte-equal to the JAX sidecar's, and the
  sidecar serves it; CUDA asked for without a card raises.
"""

import dataclasses
import json
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaito_tpu.engine.model import TransformerLM as JaxLM
from kaito_tpu.models import get_model_by_name as jax_model
from kaito_tpu.tuning.cli import parse_args as j_parse_args
from kaito_tpu.tuning.lora import LoraConfig as JLoraConfig
from kaito_tpu.tuning.lora import apply_adapter as j_apply_adapter
from kaito_tpu.tuning.lora import load_adapter as j_load_adapter
from kaito_tpu.tuning.metrics_server import render_metrics as j_render_metrics
from kaito_tpu.tuning.trainer import METRICS_FILE as J_METRICS_FILE
from kaito_tpu.tuning.trainer import SENTINEL as J_SENTINEL
from kaito_tpu.tuning.trainer import TrainConfig as JTrainConfig
from kaito_tpu.tuning.trainer import Trainer as JTrainer
from kaito_tpu_torch.tuning import cli, metrics_server
from kaito_tpu_torch.tuning.lora import LoraConfig
from kaito_tpu_torch.tuning.trainer import METRICS_FILE, SENTINEL, TrainConfig, Trainer
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

WORDS = ("alpha", "beta", "gamma", "delta", "river", "stone", "light", "north",
         "seven", "amber")


def write_data(path, n=40, seed=0):
    """A seeded instruction/response jsonl of ``n`` records."""
    rng = np.random.RandomState(seed)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "train.jsonl"), "w") as f:
        for _ in range(n):
            ins = " ".join(rng.choice(WORDS, 4))
            f.write(json.dumps({"instruction": f"Repeat: {ins}",
                                "response": f"{ins} {ins}"}) + "\n")
    return path


def _cfg(tmp_path, method, **kw):
    base = dict(model="tiny-llama-test", method=method,
                data_dir=write_data(str(tmp_path / "data")),
                output_dir=str(tmp_path / f"out-{method}"), learning_rate=1e-2,
                batch_size=4, max_seq_len=64, max_steps=6, warmup_steps=2,
                checkpoint_every=0, dtype="float32", lora=LoraConfig(r=4, alpha=8))
    base.update(kw)
    return TrainConfig(**base)


@pytest.mark.parametrize("method", ["lora", "qlora", "full"])
def test_trainer_runs_and_writes_the_jax_artifacts(tmp_path, method):
    cfg = _cfg(tmp_path, method)
    tr = Trainer(cfg, device="cpu")
    losses = []
    result = tr.train(on_step=lambda step, m: losses.append(float(m["loss"])))
    assert result["steps"] == 6 and len(losses) == 6
    assert losses[-1] < losses[0]
    with open(os.path.join(cfg.output_dir, SENTINEL)) as f:
        sentinel = json.load(f)
    with open(os.path.join(cfg.output_dir, METRICS_FILE)) as f:
        metrics = json.load(f)
    assert sentinel["final_loss"] == losses[-1]
    # the JAX trainer's files, from a one-step run on the same data
    fields = {k: v for k, v in dataclasses.asdict(cfg).items() if k != "lora"}
    jcfg = JTrainConfig(**{**fields, "max_steps": 1,
                           "output_dir": str(tmp_path / "jax-out")},
                        lora=JLoraConfig(r=4, alpha=8))
    JTrainer(jcfg).train()
    with open(os.path.join(jcfg.output_dir, J_SENTINEL)) as f:
        assert set(json.load(f)) == set(sentinel)
    with open(os.path.join(jcfg.output_dir, J_METRICS_FILE)) as f:
        assert set(json.load(f)) == set(metrics)
    assert os.path.isdir(os.path.join(cfg.output_dir, "checkpoints", "6"))
    if method == "full":
        assert not os.path.exists(os.path.join(cfg.output_dir, "adapter"))
        return
    # the adapter through the JAX package, on the port's trained base
    adapter, acfg, base = j_load_adapter(os.path.join(cfg.output_dir, "adapter"))
    assert (acfg.r, acfg.alpha, base) == (4, 8, "tiny-llama-test")
    assert sorted(adapter) == sorted(
        f"dense/{t}_lora_{ab}" for t in "qkvo" for ab in "ab")
    tree = tr.model.param_tree()
    base_tree = jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()),
                             {g: ({k: v for k, v in sub.items() if "_lora_" not in k}
                                  if isinstance(sub, dict) else sub)
                              for g, sub in tree.items()})
    jm = JaxLM(jax_model("tiny-llama-test").arch, dtype=jnp.float32)
    jm.lora_scaling = acfg.scaling
    jparams = j_apply_adapter(base_tree, adapter)
    tokens = np.random.RandomState(3).randint(0, 258, (2, 24)).astype(np.int32)
    want = np.asarray(jm.forward_train(jparams, jnp.asarray(tokens)))
    with torch.no_grad():
        got = tr.model.forward_train(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # the factors moved: the adapter is not the base
    jm.lora_scaling = 0.0
    plain = np.asarray(jm.forward_train(base_tree, jnp.asarray(tokens)))
    assert np.abs(plain - want).max() > 1e-3


@pytest.mark.parametrize("newest", ["reads", "does not read"])
def test_resumed_run_equals_an_uninterrupted_one(tmp_path, newest):
    whole = Trainer(_cfg(tmp_path, "lora", output_dir=str(tmp_path / "whole")),
                    device="cpu")
    whole_losses = []
    whole.train(on_step=lambda s, m: whole_losses.append(float(m["loss"])))

    cut_cfg = _cfg(tmp_path, "lora", output_dir=str(tmp_path / "cut"),
                   checkpoint_every=2)

    class Cut(Exception):
        pass

    def stop(step, m):
        if step == 5:
            raise Cut

    with pytest.raises(Cut):
        Trainer(cut_cfg, device="cpu").train(on_step=stop)
    ckpts = os.path.join(cut_cfg.output_dir, "checkpoints")
    assert sorted(os.listdir(ckpts)) == ["2", "4"]
    if newest == "does not read":
        with open(os.path.join(ckpts, "4", "state.pt"), "wb") as f:
            f.write(b"not a checkpoint")
    resumed = Trainer(cut_cfg, device="cpu")
    losses = []
    result = resumed.train(on_step=lambda s, m: losses.append((s, float(m["loss"]))))
    first = 5 if newest == "reads" else 3
    assert [s for s, _ in losses] == list(range(first, 7)) and result["steps"] == 6
    assert [l for _, l in losses] == whole_losses[first - 1:]
    assert resumed.train_names == whole.train_names
    for a, b in zip(resumed.state.params, whole.state.params):
        assert torch.equal(a, b)


ARGVS = [
    ["--model", "tiny-llama-test", "--data-dir", "/d", "--output-dir", "/o"],
    ["--model", "llama-3.1-8b-instruct", "--method", "qlora", "--data-dir", "/d",
     "--output-dir", "/o", "--mesh", "fsdp=4", "--learning-rate", "1e-4",
     "--batch-size", "8", "--max-seq-len", "1024", "--num-epochs", "2",
     "--max-steps", "100", "--lora-r", "16", "--lora-alpha", "32",
     "--lora-targets", "q,v,gate", "--checkpoint-every", "25", "--seed", "3",
     "--dtype", "bfloat16"],
    ["--model", "m", "--method", "full", "--data-dir", "d", "--output-dir", "o",
     "--lora-targets", ""],
]


@pytest.mark.parametrize("argv", ARGVS, ids=["defaults", "every-flag", "full"])
def test_parse_args_matches_jax(argv):
    assert dataclasses.asdict(cli.parse_args(argv)) == dataclasses.asdict(
        j_parse_args(argv))


def test_parse_args_config_file_matches_jax(tmp_path):
    pytest.importorskip("yaml")
    path = tmp_path / "cfg.yaml"
    path.write_text("training:\n  learning-rate: 0.001\n  warmup_steps: 3\n"
                    "  no_such_field: 1\n")
    argv = ARGVS[0] + ["--config-file", str(path)]
    got = cli.parse_args(argv)
    assert dataclasses.asdict(got) == dataclasses.asdict(j_parse_args(argv))
    assert got.learning_rate == 0.001 and got.warmup_steps == 3


@pytest.mark.parametrize("dtype", ["", "float32"])
def test_cli_main_trains_in_bf16_unless_a_dtype_is_given(tmp_path, dtype):
    out = str(tmp_path / "out")
    argv = ["--model", "tiny-llama-test", "--data-dir", write_data(str(tmp_path / "d"), 8),
            "--output-dir", out, "--max-steps", "2", "--max-seq-len", "32",
            "--batch-size", "2"] + (["--dtype", dtype] if dtype else [])
    result = cli.main(argv, device="cpu")
    assert result["steps"] == 2 and os.path.exists(os.path.join(out, SENTINEL))
    saved = torch.load(os.path.join(out, "checkpoints", "2", "state.pt"))
    want = torch.float32 if dtype else torch.bfloat16
    assert saved["params"]["dense/q_lora_a"].dtype == want


@pytest.mark.parametrize("payload,done", [
    ({}, False),
    ({"step": 12, "loss": 1.2345678, "tokens_per_second": 9876.5, "epoch": 0}, True),
    ({"step": 3, "loss": float("nan")}, False),
])
def test_render_metrics_is_byte_equal_to_jax(payload, done):
    assert metrics_server.render_metrics(payload, done) == j_render_metrics(payload, done)


def test_metrics_sidecar_serves_the_trainer_files(tmp_path):
    (tmp_path / METRICS_FILE).write_text(json.dumps({"step": 4, "loss": 0.5}))
    srv = metrics_server.make_server(str(tmp_path), port=0, host="127.0.0.1")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        body = urllib.request.urlopen(base + "/metrics").read().decode()
        assert body == j_render_metrics({"step": 4, "loss": 0.5}, False)
        (tmp_path / SENTINEL).write_text("{}")
        assert "kaito:tuning_completed 1" in urllib.request.urlopen(
            base + "/metrics").read().decode()
        assert json.loads(urllib.request.urlopen(base + "/progress").read()) == {
            "step": 4, "loss": 0.5}
        assert json.loads(urllib.request.urlopen(base + "/health").read()) == {
            "status": "ok"}
    finally:
        srv.shutdown()
        srv.server_close()


def test_cuda_asked_for_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(_cfg(tmp_path, "lora"))
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--model", "tiny-llama-test", "--data-dir", str(tmp_path),
                  "--output-dir", str(tmp_path / "o")])
