"""Fine-tuning on the card, held against the CPU.

These need an NVIDIA card and ``nvcc``; without one they skip.  On the
card (no JAX there, so without the suite's conftest):
``python -m pytest --noconftest tests/test_torch_cuda_train.py``.

- ``tiny-llama-real`` (LoRA, and QLoRA at 64 rows, whose projections run
  K4 under autograd) and ``tiny-moe-real`` (LoRA) in fp32 from their
  checkpoints, 5 steps from the same weights and factors on the CPU and
  on the card: losses (rtol 1e-4), grad norms (rtol 1e-3) and the final
  trainable leaves equal; the leaves measured in the summed learning
  rates (Adam moves an element about the learning rate a step, and
  divides each gradient's rounding by the element's own summed history,
  which cancels where it changes sign): 99% of each leaf within 1%, all
  within 25%, except where the gradient is at the rounding level of the
  leaf's largest (second moment below 1e-10 of the largest), where
  Adam's step may take either sign.  No training step launches the
  flash prefill kernel.
- The trained LoRA adapter, saved and served by a card engine, gives its
  first greedy token the logprob ``forward_train`` gives it (atol 2e-3).
- K4/K5 under autograd in bf16 at 17-256 rows: ``dx`` equals the dequant
  product's (within 2e-2 of its largest magnitude), and the bf16 logits
  head's gradients equal the fp32 product's (within 2e-2).
"""

import dataclasses
import json
import os
import random

import pytest
import torch

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ("river", "stone", "light", "north", "amber", "cedar", "violet", "harbor")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are CUDA C++ for sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _data(path, n=24, chars=64, seed=0):
    rng = random.Random(seed)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "train.jsonl"), "w") as f:
        for _ in range(n):
            words = []
            while sum(len(w) + 1 for w in words) < chars // 2:
                words.append(rng.choice(WORDS))
            f.write(json.dumps({"instruction": "Reverse: " + " ".join(words),
                                "response": " ".join(reversed(words))}) + "\n")
    return str(path)


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in tree.items()}


def _pair(tmp_path, model, method, B, T):
    """(CPU trainer, card trainer) from the checkpoint's weights and the
    CPU's drawn factors, each run 5 steps; their (loss, grad norm)s."""
    from kaito_tpu_torch.engine.model import TransformerLM
    from kaito_tpu_torch.engine.ops import flash_prefill
    from kaito_tpu_torch.engine.weights import load_safetensors_params
    from kaito_tpu_torch.models import get_model_by_name
    from kaito_tpu_torch.tuning.lora import LoraConfig
    from kaito_tpu_torch.tuning.trainer import TrainConfig, Trainer

    wdir = os.path.join(REPO, "checkpoints", model)
    tree = load_safetensors_params(
        TransformerLM(get_model_by_name(model).arch, torch.float32, "cpu"), wdir)
    cfg = TrainConfig(model=model, method=method, data_dir=_data(tmp_path / "data"),
                      lora=LoraConfig(r=8, alpha=16), batch_size=B, max_seq_len=T,
                      max_steps=5, warmup_steps=2, learning_rate=1e-3,
                      checkpoint_every=0, dtype="float32")
    cpu = Trainer(cfg, device="cpu", params=tree)
    dev = Trainer(cfg, device="cuda", params=_clone(cpu.model.param_tree()))
    got, want = [], []
    cpu.train(on_step=lambda s, m: want.append((m["loss"], float(m["grad_norm"]))))
    flash0 = flash_prefill.flash_prefill_attention_cuda.launches
    dev.train(on_step=lambda s, m: got.append((m["loss"], float(m["grad_norm"]))))
    assert flash_prefill.flash_prefill_attention_cuda.launches == flash0
    assert len(got) == 5 and all(loss > 0 for loss, _ in want)
    return cpu, dev, got, want


def _check(cpu, dev, got, want):
    from kaito_tpu_torch.tuning.optim import warmup_cosine_decay_schedule

    for (gl, gn), (wl, wn) in zip(got, want):
        assert abs(gl - wl) <= 1e-4 * abs(wl), (got, want)
        assert abs(gn - wn) <= 1e-3 * abs(wn), (got, want)
    cfg = cpu.cfg
    schedule = warmup_cosine_decay_schedule(0.0, cfg.learning_rate, cfg.warmup_steps,
                                            max(cfg.max_steps, cfg.warmup_steps + 1))
    lr_sum = sum(float(schedule(c)) for c in range(cfg.max_steps))
    nu = dev.state.opt_state[1][0]["nu"]
    for n, a, b, v in zip(dev.train_names, dev.state.params, cpu.state.params, nu):
        a, b, v = a.detach().cpu(), b.detach(), v.cpu()
        d = (a - b).abs() / lr_sum
        assert float((d > 1e-2).float().mean()) <= 1e-2, n
        assert not bool(((d > 0.25) & (v >= 1e-10 * v.max())).any()), n


@pytest.mark.parametrize("model", ["tiny-llama-real", "tiny-moe-real"])
def test_lora_steps_equal_the_cpu(card, tmp_path, model):
    _check(*_pair(tmp_path, model, "lora", 2, 64))


def test_qlora_at_64_rows_runs_k4_under_autograd(card, tmp_path):
    from kaito_tpu_torch.engine.ops.quant_matmul import quant_matmul_cuda

    k4 = quant_matmul_cuda.launches_int8
    _check(*_pair(tmp_path, "tiny-llama-real", "qlora", 1, 64))
    assert quant_matmul_cuda.launches_int8 > k4


def test_served_adapter_gives_the_forward_train_logprob(card, tmp_path):
    from kaito_tpu_torch.engine.engine import InferenceEngine, SamplingParams
    from kaito_tpu_torch.engine.server import parse_args
    from kaito_tpu_torch.tuning.lora import save_adapter

    _, dev, _, _ = _pair(tmp_path, "tiny-llama-real", "lora", 2, 64)
    root = tmp_path / "adapters"
    save_adapter(str(root / "tuned"), dev.model.param_tree(), dev.cfg.lora,
                 "tiny-llama-real")
    cfg, _ = parse_args(["--model", "tiny-llama-real", "--weights-dir",
                         os.path.join(REPO, "checkpoints", "tiny-llama-real"),
                         "--dtype", "float32", "--max-model-len", "256",
                         "--max-num-seqs", "4", "--no-enable-prefix-caching",
                         "--adapter-slots", "2", "--adapter-rmax", "8"])
    eng = InferenceEngine(dataclasses.replace(cfg, adapters_dir=str(root)), device="cuda")
    tokens = eng.tokenizer.encode("Reverse: river stone light")
    req = eng.submit(tokens, SamplingParams(max_tokens=1, temperature=0.0,
                                            ignore_eos=True, logprobs=True),
                     adapter="tuned")
    for _ in range(1000):
        eng.step()
        if req.finish_reason:
            break
    with torch.no_grad():
        logits = dev.model.forward_train(torch.tensor([tokens], device=card))
    ref = float(torch.log_softmax(logits[0, -1], -1)[req.output_tokens[0]])
    assert abs(float(req.output_logprobs[0]) - ref) <= 2e-3


@pytest.mark.parametrize("scheme", ["int8", "int4"])
@pytest.mark.parametrize("rows", [17, 200, 256])
def test_quant_matmul_fn_dx_on_the_card(card, scheme, rows):
    from kaito_tpu_torch.engine.ops.quant_matmul import (dequant_matmul, quant_linear,
                                                         quant_matmul_cuda)
    from kaito_tpu_torch.engine.quant import quantize_weight

    gen = torch.Generator(device=card).manual_seed(rows)
    K, N = 4096, 1024
    w = quantize_weight(torch.randn(K, N, device=card, generator=gen) / 64, scheme)
    x = torch.randn(rows, K, device=card, generator=gen).bfloat16().requires_grad_(True)
    g = torch.randn(rows, N, device=card, generator=gen).bfloat16()
    counter = "launches_int4" if scheme == "int4" else "launches_int8"
    n0 = getattr(quant_matmul_cuda, counter)
    y = quant_linear(x, w)
    assert getattr(quant_matmul_cuda, counter) == n0 + 1
    (dx,) = torch.autograd.grad(y, x, g)
    x2 = x.detach().clone().requires_grad_(True)
    (want,) = torch.autograd.grad(dequant_matmul(x2, w), x2, g)
    assert float((dx.float() - want.float()).abs().max()) <= 2e-2 * float(
        want.float().abs().max())


def test_bf16_logits_head_gradients(card):
    from kaito_tpu_torch.engine.model import _HeadLogits

    gen = torch.Generator(device=card).manual_seed(0)
    x = torch.randn(64, 512, device=card, generator=gen).bfloat16().requires_grad_(True)
    head = (torch.randn(1024, 512, device=card, generator=gen) / 16).bfloat16() \
        .requires_grad_(True)
    g = torch.randn(64, 1024, device=card, generator=gen)
    y = _HeadLogits.apply(x, head)
    assert y.dtype == torch.float32
    dx, dh = torch.autograd.grad(y, (x, head), g)
    xf, hf = x.detach().float().requires_grad_(True), head.detach().float() \
        .requires_grad_(True)
    wx, wh = torch.autograd.grad(xf @ hf.t(), (xf, hf), g)
    for got, want in ((dx, wx), (dh, wh)):
        assert got.dtype == torch.bfloat16
        assert float((got.float() - want).abs().max()) <= 2e-2 * float(want.abs().max())
