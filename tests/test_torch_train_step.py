"""The port's loss, optimizer and training step against the JAX package's
and optax, on the CPU in fp32.

- ``cross_entropy_loss`` against the JAX one (the masked mean, the
  denominator clamped at 1 when nothing is masked in);
- ``tuning.optim``: the schedule against ``optax.warmup_cosine_decay_
  schedule`` count by count, ``global_norm`` against optax's, and the
  trainer's chain (clip at 1.0, AdamW with weight decay 0.1) against
  optax's over 6 steps, with the clip active and inactive, in warmup
  and in the cosine: updates, moments and leaves;
- ``make_train_step``: 5 steps of the port against the JAX Trainer's
  jitted step, from the JAX trainer's parameters and the same batches,
  for lora, qlora (B=2, T=16: the quantized projections run the K4
  wrapper under autograd) and full: loss, grad_norm and the final
  trainable leaves.

Tolerances, fp32: loss and schedule rtol 1e-6 (the schedule's end,
where 1 + cos cancels, atol 1e-7 of the peak); one optimizer chain (the
same gradients in): updates, moments and leaves each within 1e-5 of
their largest magnitude (Adam divides by the root of small moments);
train steps rtol 2e-5 on the loss, 1e-4 on grad_norm, and the final
leaves: 99.9% of each leaf's elements within 1e-4 of its largest
magnitude (each framework sums the forward and backward in its own
order), the rest within 1% of the summed learning rates (Adam divides
each gradient's rounding by the element's own summed history, which
cancels where the gradient changes sign), or, where the gradient is at
the rounding level of the leaf's largest (second moment below 1e-10 of
the largest) and Adam's step may go either way, within the summed
learning rates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kaito_tpu.tuning.lora import LoraConfig as JLoraConfig
from kaito_tpu.tuning.train_step import cross_entropy_loss as j_xent
from kaito_tpu.tuning.trainer import TrainConfig as JTrainConfig
from kaito_tpu.tuning.trainer import Trainer as JTrainer
from kaito_tpu_torch.engine.model import TransformerLM, params_from_jax
from kaito_tpu_torch.models import get_model_by_name
from kaito_tpu_torch.tuning import optim
from kaito_tpu_torch.tuning.lora import LoraConfig, set_lora_params
from kaito_tpu_torch.tuning.train_step import (TrainState, cross_entropy_loss,
                                               make_train_step, trainable_leaves)
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.helpers.train_pairs import batch, np_tree


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("masked", ["some", "none", "all"])
def test_cross_entropy_loss_matches_jax(masked):
    rng = np.random.RandomState(0)
    logits = (3 * rng.randn(2, 7, 33)).astype(np.float32)
    targets = rng.randint(0, 33, (2, 7)).astype(np.int32)
    mask = {"some": (rng.rand(2, 7) > 0.4), "none": np.zeros((2, 7)),
            "all": np.ones((2, 7))}[masked].astype(np.float32)
    want = float(j_xent(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(mask)))
    got = float(cross_entropy_loss(_t(logits), _t(targets), _t(mask)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if masked == "none":
        assert got == 0.0


@pytest.mark.parametrize("warmup,decay", [(10, 1000), (3, 8), (0, 5), (4, 5)])
def test_schedule_matches_optax(warmup, decay):
    want = optax.warmup_cosine_decay_schedule(0.0, 2e-4, warmup, decay)
    got = optim.warmup_cosine_decay_schedule(0.0, 2e-4, warmup, decay)
    for count in range(0, decay + 4):
        w = float(want(jnp.asarray(count, jnp.int32)))
        # near the end of the cosine, 1 + cos(~pi) cancels: an fp32 ulp of
        # the cosine is 1e-7 of the peak there
        np.testing.assert_allclose(float(got(count)), w, rtol=1e-6, atol=1e-7 * 2e-4,
                                   err_msg=f"count {count}")
    if warmup:
        assert float(got(0)) == 0.0


SHAPES = ((3, 5, 4), (4, 7), (6,))


def _close_rel(got, want, rel, what=""):
    """Every element within ``rel`` of ``want``'s largest magnitude."""
    err = float(np.abs(got - want).max())
    assert err <= rel * max(float(np.abs(want).max()), 1e-30), (what, err)


def _grads(rng, scale):
    return [(scale * rng.randn(*s)).astype(np.float32) for s in SHAPES]


@pytest.mark.parametrize("clip", ["active", "inactive"])
@pytest.mark.parametrize("phase", ["warmup", "cosine"])
def test_trainer_chain_matches_optax_over_six_steps(clip, phase):
    """The JAX trainer's chain: clip_by_global_norm(1.0) then adamw over
    the warmup-cosine schedule, weight decay 0.1; 6 steps of the same
    gradients through both."""
    warmup, max_steps = (10, 0) if phase == "warmup" else (2, 8)
    lr = 5e-2
    schedule = optax.warmup_cosine_decay_schedule(
        0.0, lr, warmup, max(max_steps or 1000, warmup + 1))
    jopt = optax.chain(optax.clip_by_global_norm(1.0),
                       optax.adamw(schedule, weight_decay=0.1))
    topt = optim.trainer_optimizer(lr, warmup, max_steps, 0.1)
    rng = np.random.RandomState(1)
    p0 = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    jp = [jnp.asarray(p) for p in p0]
    tp = [_t(p) for p in p0]
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(6):
        g = _grads(rng, 1.0 if clip == "active" else 0.01)
        norm = float(optax.global_norm([jnp.asarray(x) for x in g]))
        assert (norm >= 1.0) == (clip == "active")
        np.testing.assert_allclose(float(optim.global_norm([_t(x) for x in g])), norm,
                                   rtol=1e-6)
        ju, js = jopt.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = topt.update([_t(x) for x in g], ts, tp)
        optim.apply_updates(tp, tu)
        adam = js[1][0]
        for got, want in ((tu, ju), (ts[1][0]["mu"], adam.mu), (ts[1][0]["nu"], adam.nu),
                          (tp, jp)):
            for a, b in zip(got, want):
                _close_rel(a.numpy(), np.asarray(b), 1e-5, f"step {step}")
        assert ts[1][0]["count"] == int(adam.count) == step + 1
    if phase == "warmup":
        # the first update runs at the schedule's count 0: lr 0
        assert float(schedule(0)) == 0.0


def test_moments_take_the_parameters_dtype():
    opt = optim.trainer_optimizer(1e-3, 2, 0, 0.0)
    params = [torch.zeros(3, dtype=torch.bfloat16), torch.zeros(2)]
    state = opt.init(params)
    assert [m.dtype for m in state[1][0]["mu"]] == [torch.bfloat16, torch.float32]
    updates, state = opt.update([torch.ones(3, dtype=torch.bfloat16), torch.ones(2)],
                                state, params)
    assert [u.dtype for u in updates] == [torch.bfloat16, torch.float32]
    assert [v.dtype for v in state[1][0]["nu"]] == [torch.bfloat16, torch.float32]


@pytest.mark.parametrize("method", ["lora", "qlora", "full"])
def test_five_steps_match_the_jax_trainer(method):
    cfg = dict(model="tiny-llama-test", method=method, learning_rate=5e-3,
               warmup_steps=2, max_steps=5, weight_decay=0.01, dtype="float32")
    jt = JTrainer(JTrainConfig(**cfg, lora=JLoraConfig(r=4, alpha=8)))
    arch = get_model_by_name("tiny-llama-test").arch
    tm = TransformerLM(arch, dtype=torch.float32, device="cpu")
    tree = params_from_jax(np_tree(jt.state.params), arch)
    tm.load_params(tree)
    if method == "full":
        for p in tm.parameters():
            p.requires_grad_(True)
    else:
        set_lora_params(tm, tree, LoraConfig(r=4, alpha=8))
    names = [n for n, _ in trainable_leaves(tm)]
    flat = jax.tree_util.tree_flatten_with_path(jt.state.params)[0]
    jnames = ["/".join(str(getattr(k, "key", k)) for k in path) for path, _ in flat]
    assert names == [jnames[i] for i in jt._train_idx]
    opt = optim.trainer_optimizer(cfg["learning_rate"], cfg["warmup_steps"],
                                  cfg["max_steps"], cfg["weight_decay"])
    train = [p for _, p in trainable_leaves(tm)]
    state = TrainState(params=train, opt_state=opt.init(train), step=0)
    step = make_train_step(tm, opt)
    jstate = jt.state
    for i in range(5):
        tokens, mask = batch(arch.vocab_size, 2, 16, seed=10 + i, pad=(0, 3))
        jstate, jm = jt._step_fn(jstate, {"tokens": jnp.asarray(tokens),
                                          "mask": jnp.asarray(mask)})
        state, tmet = step(state, {"tokens": _t(tokens), "mask": _t(mask)})
        np.testing.assert_allclose(float(tmet["loss"]), float(jm["loss"]), rtol=2e-5,
                                   err_msg=f"step {i + 1}")
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-4, err_msg=f"step {i + 1}")
    assert state.step == 5
    jflat = jax.tree_util.tree_leaves(jstate.params)
    nu = jstate.opt_state[1][0].nu
    lr_sum = sum(float(optim.warmup_cosine_decay_schedule(
        0.0, cfg["learning_rate"], 2, 5)(c)) for c in range(5))
    for k, (name, got, i) in enumerate(zip(names, state.params, jt._train_idx)):
        want = np.asarray(jflat[i])
        diff = np.abs(got.detach().numpy() - want)
        off = diff > 1e-4 * max(float(np.abs(want).max()), 1e-6)
        # Adam divides each gradient's rounding by the element's own
        # summed history, which cancels where the gradient changes sign:
        # a few elements stray, each within 1% of the summed learning
        # rates (Adam moves an element about the learning rate a step).
        # Where the gradient is at the rounding level of the leaf's
        # largest (v below 1e-10 of the largest v), the frameworks'
        # roundings may take the step either way: within lr_sum
        v = np.asarray(nu[k])
        rounding = v < 1e-10 * v.max()
        assert off.mean() < 1e-3, (name, off.sum())
        assert (diff[off & ~rounding] <= 1e-2 * lr_sum).all(), (name, diff.max())
        assert (diff[off] <= lr_sum).all(), (name, diff.max())
    if method != "full":
        # B moved from zero at step 2, A from step 3 on
        assert all(float(p.detach().abs().max()) > 0 for n, p in zip(names, state.params)
                   if n.endswith("_lora_b"))
