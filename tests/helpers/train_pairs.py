"""A JAX model and the port's model on the same weights, for the training
tests: the JAX ``init_params`` (optionally QLoRA-quantized and with lora
factors added by the JAX ``tuning`` functions) carried into a CPU
``TransformerLM`` with ``params_from_jax``, and the loss and gradients
of chosen leaves in both frameworks."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from kaito_tpu.engine.model import TransformerLM as JaxLM
from kaito_tpu.tuning.lora import LoraConfig as JLoraConfig
from kaito_tpu.tuning.lora import add_lora_params as j_add_lora
from kaito_tpu.tuning.quant import quantize_base as j_quantize_base
from kaito_tpu.tuning.train_step import cross_entropy_loss as j_xent
from kaito_tpu_torch.engine.model import TransformerLM, params_from_jax
from kaito_tpu_torch.tuning.lora import LoraConfig, set_lora_params
from kaito_tpu_torch.tuning.train_step import cross_entropy_loss


def np_tree(params):
    return jax.tree.map(np.asarray, params)


def lora_keys(params) -> list[str]:
    return sorted(f"{g}/{k}" for g, sub in params.items() if isinstance(sub, dict)
                  for k in sub if "_lora_" in k)


def get(tree, key: str):
    node = tree
    for k in key.split("/"):
        node = node[k]
    return node


def with_leaves(tree, leaves: dict):
    """``tree`` with the leaves at ``leaves``' keys replaced (fresh dicts)."""
    out = {k: (dict(v) if isinstance(v, dict) else v) for k, v in tree.items()}
    for key, val in leaves.items():
        *path, last = key.split("/")
        node = out
        for k in path:
            node = node[k]
        node[last] = val
    return out


def pair(jarch, tarch, *, method="lora", targets=("q", "k", "v", "o"), r=4,
         alpha=8, b_scale=0.05, seed=0):
    """(JAX model, JAX params, the port's CPU fp32 model) on the same
    weights.  lora/qlora: the JAX ``add_lora_params`` factors, B drawn
    at ``b_scale`` (so A's gradients are not zero); qlora quantizes the
    base with the JAX ``quantize_base`` first."""
    jm = JaxLM(jarch, dtype=jnp.float32)
    params = jm.init_params(jax.random.PRNGKey(seed))
    if method == "qlora":
        params = j_quantize_base(jm, params)
    if method in ("lora", "qlora"):
        params = j_add_lora(jm, params, JLoraConfig(r=r, alpha=alpha, targets=targets),
                            jax.random.PRNGKey(seed + 1))
        rng = np.random.RandomState(seed + 2)
        params = with_leaves(params, {
            k: jnp.asarray(b_scale * rng.randn(*get(params, k).shape), jnp.float32)
            for k in lora_keys(params) if k.endswith("_lora_b")})
    tm = TransformerLM(tarch, dtype=torch.float32, device="cpu")
    tree = params_from_jax(np_tree(params), tarch)
    tm.load_params(tree)
    if method in ("lora", "qlora"):
        set_lora_params(tm, tree, LoraConfig(r=r, alpha=alpha, targets=targets))
    return jm, params, tm


def batch(vocab, B, T, seed=0, pad=None):
    """tokens [B, T+1] and a loss mask [B, T] (the last ``pad[b]`` of row
    b masked off when given)."""
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, vocab, (B, T + 1)).astype(np.int32)
    mask = np.ones((B, T), np.float32)
    for b, n in enumerate(pad or ()):
        if n:
            mask[b, T - n:] = 0.0
    return tokens, mask


def jax_loss_grads(jm, params, keys, tokens, mask, attn_mask=None):
    """(logits, loss, {key: grad}) of the JAX ``forward_train`` and
    cross-entropy with respect to the leaves at ``keys``."""
    def f(train):
        p = with_leaves(params, train)
        logits = jm.forward_train(p, jnp.asarray(tokens[:, :-1]),
                                  mask=None if attn_mask is None
                                  else jnp.asarray(attn_mask))
        return j_xent(logits, jnp.asarray(tokens[:, 1:]), jnp.asarray(mask)), logits

    (loss, logits), grads = jax.value_and_grad(f, has_aux=True)(
        {k: get(params, k) for k in keys})
    return np.asarray(logits), float(loss), {k: np.asarray(v) for k, v in grads.items()}


def torch_loss_grads(tm, keys, tokens, mask, attn_mask=None, remat=True):
    """The same from the port's ``forward_train`` (the leaves at ``keys``
    made trainable, every other leaf frozen)."""
    tree = tm.param_tree()
    leaves = [get(tree, k) for k in keys]
    for p in tm.parameters():
        p.requires_grad_(False)
    for p in leaves:
        p.requires_grad_(True)
    logits = tm.forward_train(torch.from_numpy(tokens[:, :-1]),
                              None if attn_mask is None else torch.from_numpy(attn_mask),
                              remat=remat)
    loss = cross_entropy_loss(logits, torch.from_numpy(tokens[:, 1:]),
                              torch.from_numpy(mask))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return (logits.detach().numpy(), float(loss.detach()),
            {k: g.numpy() for k, g in zip(keys, grads)})
