"""kaito_tpu_torch.engine.sampler against kaito_tpu.engine.sampler.

Greedy tokens, ``chosen_logprob`` and the penalties are held to the JAX
sampler exactly (fp32 rtol/atol 2e-5 for values).  Sampled draws are
held by distribution here: empirical frequencies of many draws against
the exact masked distribution (tolerance 0.02, about 4 standard errors
at 20000 draws), with the JAX sampler's own draws held to the same
expectation (``tests/test_torch_spec.py`` holds the per-row keys and
draws to the JAX sampler's token for token)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaito_tpu.engine import sampler as js
from kaito_tpu_torch.engine import sampler as ts
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=2e-5, atol=2e-5)
N_DRAWS = 20000


def _states(B, **knobs):
    """The same per-row knobs in both samplers' states."""
    j = js.SamplingState.create(B, 0)
    t = ts.SamplingState.create(B, 0, "cpu")
    for i in range(B):
        kw = {k: (v[i] if isinstance(v, (list, tuple)) else v)
              for k, v in knobs.items()}
        base = dict(temperature=0.0, top_k=0, top_p=1.0, presence=0.0,
                    frequency=0.0, repetition=1.0, min_p=0.0)
        base.update(kw)
        j = j.set_slot(i, seed=i + 1, **base)
        t.set_slot(i, **base)
    return j, t


def test_greedy_matches():
    rng = np.random.RandomState(0)
    logits = rng.randn(6, 300).astype(np.float32) * 3
    j, t = _states(6)
    want, _ = js.sample(jnp.asarray(logits), j)
    got = ts.sample(torch.from_numpy(logits), t)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_chosen_logprob_matches():
    rng = np.random.RandomState(1)
    logits = rng.randn(4, 500).astype(np.float32) * 5
    toks = rng.randint(0, 500, size=4).astype(np.int32)
    np.testing.assert_allclose(
        ts.chosen_logprob(torch.from_numpy(logits), torch.from_numpy(toks)).numpy(),
        np.asarray(js.chosen_logprob(jnp.asarray(logits), jnp.asarray(toks))), **TOL)


@pytest.mark.parametrize("knobs", [
    dict(presence=[0.5, 0.0, 1.2]),
    dict(frequency=[0.3, 0.7, 0.0]),
    dict(repetition=[1.3, 1.0, 0.8]),
    dict(presence=0.4, frequency=0.2, repetition=1.1),
])
def test_penalties_match(knobs):
    rng = np.random.RandomState(2)
    B, V = 3, 64
    logits = rng.randn(B, V).astype(np.float32) * 2
    counts = rng.randint(0, 3, size=(B, V)).astype(np.int32)
    seen = rng.rand(B, V) < 0.2
    j, t = _states(B, **knobs)
    want = js.apply_penalties(jnp.asarray(logits), j, jnp.asarray(counts),
                              jnp.asarray(seen))
    got = ts.apply_penalties(torch.from_numpy(logits), t, torch.from_numpy(counts),
                             torch.from_numpy(seen))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # greedy after penalties picks the same tokens
    jt, _ = js.sample(jnp.asarray(logits), j, jnp.asarray(counts), jnp.asarray(seen))
    tt = ts.sample(torch.from_numpy(logits), t, torch.from_numpy(counts),
                   torch.from_numpy(seen))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def _expected(row, temperature, top_k=0, top_p=1.0, min_p=0.0):
    """The masked distribution the sampler draws from, from its
    definition (numpy, float64)."""
    s = row.astype(np.float64) / temperature
    keep = np.ones_like(s, bool)
    order = np.sort(s)[::-1]
    if top_k:
        keep &= s >= order[top_k - 1]
    if top_p < 1.0:
        p = np.exp(order - order.max())
        cum = np.cumsum(p / p.sum())
        cut = order[min(int((cum < top_p).sum()), len(order) - 1)]
        keep &= s >= cut
    if min_p > 0.0:
        keep &= s >= s.max() + np.log(min_p)
    p = np.where(keep, np.exp(s - s.max()), 0.0)
    return p / p.sum()


@pytest.mark.parametrize("knobs", [
    dict(temperature=1.0),
    dict(temperature=0.7, top_k=5),
    dict(temperature=1.3, top_p=0.8),
    dict(temperature=1.0, min_p=0.2),
])
def test_sampled_draws_follow_the_masked_distribution(knobs):
    rng = np.random.RandomState(3)
    V = 12
    row = (rng.randn(V) * 1.5).astype(np.float32)
    want = _expected(row, **knobs)
    logits = np.broadcast_to(row, (N_DRAWS, V)).copy()

    t = ts.SamplingState.create(N_DRAWS, seed=7, device="cpu")
    base = dict(top_k=0, top_p=1.0, min_p=0.0)
    base.update(knobs)
    t.temperature[:] = base["temperature"]
    t.top_k[:] = base["top_k"]
    t.top_p[:] = base["top_p"]
    t.min_p[:] = base["min_p"]
    t.set_slot(0, **base)
    got = ts.sample(torch.from_numpy(logits), t).numpy()
    freq = np.bincount(got, minlength=V) / N_DRAWS
    np.testing.assert_allclose(freq, want, rtol=0, atol=0.02)

    j = js.SamplingState.create(N_DRAWS, 11)
    j = js.SamplingState(
        temperature=jnp.full((N_DRAWS,), base["temperature"], jnp.float32),
        top_k=jnp.full((N_DRAWS,), base["top_k"], jnp.int32),
        top_p=jnp.full((N_DRAWS,), base["top_p"], jnp.float32), key=j.key,
        presence=j.presence, frequency=j.frequency, repetition=j.repetition,
        min_p=jnp.full((N_DRAWS,), base["min_p"], jnp.float32))
    jt, _ = jax.jit(js.sample)(jnp.asarray(logits), j)
    jfreq = np.bincount(np.asarray(jt), minlength=V) / N_DRAWS
    np.testing.assert_allclose(jfreq, want, rtol=0, atol=0.02)


def test_shared_uniforms_make_draws_reproducible():
    """Fed the same uniforms, the sampler is a pure function: Gumbel-max
    over the temperature-scaled logits."""
    rng = np.random.RandomState(4)
    logits = rng.randn(3, 40).astype(np.float32)
    u = rng.uniform(1e-6, 1 - 1e-6, size=(3, 40)).astype(np.float32)
    _, t = _states(3, temperature=[0.5, 0.0, 2.0])
    got = ts.sample(torch.from_numpy(logits), t, uniforms=torch.from_numpy(u))
    temp = np.array([0.5, 1e-6, 2.0], np.float32)[:, None]
    want = np.argmax(logits / temp - np.log(-np.log(u)), axis=-1)
    want[1] = np.argmax(logits[1])                 # greedy row
    np.testing.assert_array_equal(got.numpy(), want)


def test_reset_and_select_rows():
    _, t = _states(4, temperature=[0.0, 0.9, 0.0, 1.1], top_k=[0, 3, 0, 0])
    sub = t.select([1, 3])
    assert sub.temperature.tolist() == pytest.approx([0.9, 1.1])
    assert sub.top_k.tolist() == [3, 0]
    t.reset_slot(1)
    assert t.temperature[1] == 0.0 and t.top_k[1] == 0
    assert not t.any_penalty
