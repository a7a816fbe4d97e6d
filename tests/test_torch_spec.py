"""kaito_tpu_torch's speculation pieces and per-row keys against the JAX
package's, on the CPU.

- Keys: a slot's key words equal ``jax.random.key_data(fold_in(
  PRNGKey(seed), slot))``; ``split`` and ``uniform`` equal JAX's bit for
  bit; Gumbel noise within 1e-6 relative (the two frameworks' ``log``
  differ in the last bit).  ``sample`` draws the JAX sampler's tokens
  over several steps, keys equal after each.
- ``NgramIndex`` and ``DepthController`` give the JAX classes' outputs
  on the same inputs (the brute-force and window cases of
  ``tests/test_spec_draft.py`` as parametrised comparisons).
- ``spec_verify_sample``: greedy rows equal to the JAX function's; with
  the same keys every row's tokens and counts equal, logprobs within
  2e-5; the first-token marginal is the target distribution and a
  one-hot q's acceptance probability is p (the JAX tests' bounds).
- ``verify_window_logits`` against the JAX model at rtol 1e-5 / atol
  1e-5 in fp32, the pools after the window, and ``greedy_targets`` over
  its logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaito_tpu.engine import sampler as js
from kaito_tpu.engine import spec as jspec
from kaito_tpu.engine.kv_cache import create_kv_cache as j_cache
from kaito_tpu.engine.model import TransformerLM as JaxLM
from kaito_tpu.models import get_model_by_name as jax_model
from kaito_tpu_torch.engine import sampler as ts
from kaito_tpu_torch.engine import spec as tspec
from kaito_tpu_torch.engine.kv_cache import create_kv_cache as t_cache
from kaito_tpu_torch.engine.model import TransformerLM, greedy_targets, params_from_jax
from kaito_tpu_torch.models import get_model_by_name
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)


def _jkeys(keys: torch.Tensor):
    return jnp.asarray(keys.numpy(), jnp.uint32)


def _wrap(kd):
    return jax.random.wrap_key_data(kd, impl="threefry2x32")


# ---------------------------------------------------------------------------
# keys and draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7, 7919, 123456789, 2**32 - 1])
@pytest.mark.parametrize("slot", [0, 1, 5])
def test_slot_key_words_equal_jax(seed, slot):
    want = jax.random.key_data(jax.random.fold_in(jax.random.PRNGKey(seed), slot))
    assert ts.slot_key(seed, slot) == tuple(int(w) for w in np.asarray(want))


def test_state_keys_are_jax_split_of_the_engine_seed():
    t = ts.SamplingState.create(5, 3, "cpu")
    j = js.SamplingState.create(5, 3)
    np.testing.assert_array_equal(t.key_buffer().numpy(), np.asarray(j.key))


@pytest.mark.parametrize("n", [2, 3])
def test_split_and_uniform_bits_equal_jax(n):
    keys = torch.tensor([list(ts.slot_key(s, s % 4)) for s in (5, 9, 2**31 + 3)])
    got = ts.split_keys(keys, n)
    want = jax.vmap(lambda kd: jax.random.key_data(
        jax.random.split(_wrap(kd), n)))(_jkeys(keys))
    for i in range(n):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want)[:, i])
    u = jax.vmap(lambda kd: jax.random.uniform(_wrap(kd), (11,)))(_jkeys(keys))
    np.testing.assert_array_equal(ts.uniform(keys, 11).numpy(), np.asarray(u))
    g = jax.vmap(lambda kd: jax.random.gumbel(_wrap(kd), (64,)))(_jkeys(keys))
    np.testing.assert_allclose(ts.gumbel_noise(keys, 64).numpy(), np.asarray(g),
                               rtol=1e-6, atol=1e-6)


def _sampling_states(B, knobs, seeds):
    j = js.SamplingState.create(B, 0)
    t = ts.SamplingState.create(B, 0, "cpu")
    for i in range(B):
        kw = dict(top_k=0, top_p=1.0)
        kw.update({k: v[i] for k, v in knobs.items()})
        j = j.set_slot(i, seed=seeds[i], **kw)
        t.set_slot(i, seed=seeds[i], **kw)
    return j, t


@pytest.mark.parametrize("knobs", [
    dict(temperature=[0.0, 0.7, 1.0, 1.3]),
    dict(temperature=[0.9, 0.0, 1.1, 0.6], top_k=[0, 0, 5, 0],
         top_p=[1.0, 1.0, 1.0, 0.8], min_p=[0.0, 0.0, 0.0, 0.1]),
])
def test_sampled_tokens_equal_jax_token_for_token(knobs):
    rng = np.random.RandomState(0)
    B, V = 4, 400
    j, t = _sampling_states(B, knobs, seeds=[11, 12, 13, 14])
    np.testing.assert_array_equal(t.key_buffer().numpy(), np.asarray(j.key))
    jax_sample = jax.jit(js.sample)
    for _ in range(6):
        logits = (rng.randn(B, V) * 2).astype(np.float32)
        jt, j = jax_sample(jnp.asarray(logits), j)
        tt = ts.sample(torch.from_numpy(logits), t)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(t.key_buffer().numpy(), np.asarray(j.key))


def test_inactive_rows_keep_their_keys_and_greedy_batches_draw_nothing():
    B, V = 3, 50
    logits = torch.from_numpy(np.random.RandomState(1).randn(B, V).astype(np.float32))
    t = ts.SamplingState.create(B, 0, "cpu")
    for i in range(B):
        t.set_slot(i, temperature=0.0, top_k=0, top_p=1.0, seed=i + 1)
    before = t.key_buffer().clone()
    ts.sample(logits, t)                       # every row greedy: no split
    assert torch.equal(t.key_buffer(), before)
    t.set_slot(1, temperature=1.0, top_k=0, top_p=1.0, seed=9)
    before = t.key_buffer().clone()
    ts.sample(logits, t, active=torch.tensor([True, True, False]))
    after = t.key_buffer()
    assert torch.equal(after[2], before[2])     # inactive: kept
    assert torch.equal(after[:2], ts.split_keys(before[:2], 2)[0])


# ---------------------------------------------------------------------------
# NgramIndex and DepthController: the JAX classes' outputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,alphabet,n,window", [
    (2, 6, 40, 4096), (3, 6, 40, 4096), (2, 4, 300, 32), (3, 5, 200, 16),
])
def test_ngram_index_matches_jax(k, alphabet, n, window):
    rng = np.random.RandomState(k * alphabet + n)
    toks = rng.randint(0, alphabet, n).tolist()
    ji, ti = jspec.NgramIndex(k, toks[:10], window), tspec.NgramIndex(k, toks[:10], window)
    for tok in toks[10:]:
        ji.append(tok)
        ti.append(tok)
        for m in (1, 4, 8):
            assert ti.propose(m) == ji.propose(m)
    assert (ti.n, ti.off, ti.tokens, ti.last) == (ji.n, ji.off, ji.tokens, ji.last)


@pytest.mark.parametrize("tokens,appends,window,m", [
    ([1, 2, 3, 1, 2], [], 4096, 4),        # never the tail itself
    ([1, 2, 3, 4, 5], [], 4096, 4),
    ([5, 6, 9], [5, 6], 8, 3),             # in the window
    ([5, 6, 9], list(range(20, 27)) + [5, 6], 8, 3),   # fallen out of it
])
def test_ngram_index_edge_cases_match_jax(tokens, appends, window, m):
    ji, ti = jspec.NgramIndex(2, tokens, window), tspec.NgramIndex(2, tokens, window)
    for tok in appends:
        ji.append(tok)
        ti.append(tok)
    assert ti.propose(m) == ji.propose(m)


def _controller_trace(mod, rounds, **kw):
    ctl = mod.DepthController(2, **kw)
    trace = []
    for slot, proposed, accepted, tick in rounds:
        if tick:
            ctl.note_fallback_round(slot)
        else:
            ctl.observe(slot, proposed, accepted)
        trace.append((ctl.depth(0), ctl.mode(0), round(ctl.accept_ewma(0), 12),
                      ctl.depth(1), ctl.mode(1), ctl.mean_depth([0, 1])))
    ctl.reset(0)
    trace.append((ctl.depth(0), ctl.mode(0)))
    return trace


@pytest.mark.parametrize("kw", [
    dict(k_max=6, k_init=2), dict(k_max=8, k_init=8),
    dict(k_max=4, k_init=4, fallback_patience=2, probation_rounds=3),
])
def test_depth_controller_matches_jax(kw):
    rng = np.random.RandomState(sum(kw.values()))
    rounds = []
    for _ in range(80):
        slot = int(rng.randint(2))
        proposed = int(rng.randint(0, 5))
        rounds.append((slot, proposed, int(rng.randint(0, proposed + 1)) if
                       rng.rand() < 0.5 else 0, bool(rng.rand() < 0.25)))
    assert _controller_trace(tspec, rounds, **kw) == _controller_trace(jspec, rounds, **kw)


# ---------------------------------------------------------------------------
# spec_verify_sample
# ---------------------------------------------------------------------------

def _verify_inputs(seed, B, K, V, greedy_rows=(), onehot_rows=()):
    rng = np.random.RandomState(seed)
    tl = (rng.randn(B, K + 1, V) * 1.5).astype(np.float32)
    dl = (rng.randn(B, K, V) * 1.5).astype(np.float32)
    prop = rng.randint(0, V, size=(B, K)).astype(np.int32)
    for b in range(B):       # some proposals agree with the target's argmax
        agree = rng.randint(0, K + 1)
        prop[b, :agree] = np.argmax(tl[b, :agree], axis=-1)
    plen = rng.randint(0, K + 1, size=B).astype(np.int32)
    temp = np.where(np.isin(np.arange(B), greedy_rows), 0.0,
                    rng.uniform(0.5, 1.5, size=B)).astype(np.float32)
    onehot = np.isin(np.arange(B), onehot_rows)
    keys = torch.tensor([list(ts.slot_key(seed, b)) for b in range(B)])
    return tl, dl, prop, plen, temp, onehot, keys


_jax_verify = jax.jit(js.spec_verify_sample)


def _both_verify(tl, dl, prop, plen, temp, onehot, keys, any_random=True):
    jo = _jax_verify(jnp.asarray(tl), jnp.asarray(dl), jnp.asarray(prop),
                               jnp.asarray(plen), jnp.asarray(temp),
                               jnp.asarray(onehot), _jkeys(keys))
    to = ts.spec_verify_sample(torch.from_numpy(tl), torch.from_numpy(dl),
                               torch.from_numpy(prop), torch.from_numpy(plen),
                               torch.from_numpy(temp), torch.from_numpy(onehot), keys,
                               any_random=any_random)
    return [np.asarray(x) for x in jo], [x.numpy() for x in to]


@pytest.mark.parametrize("K", [1, 4])
def test_verify_greedy_rows_equal_jax(K):
    B, V = 5, 64
    args = _verify_inputs(10 + K, B, K, V, greedy_rows=range(B))
    (jo, jn, jl, jk), (to, tn, tlp, tk) = _both_verify(*args, any_random=False)
    np.testing.assert_array_equal(tn, jn)
    for b in range(B):
        np.testing.assert_array_equal(to[b, :tn[b]], jo[b, :jn[b]])
        np.testing.assert_allclose(tlp[b, :tn[b]], jl[b, :jn[b]], rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(tk, jk)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_verify_every_row_equal_jax_with_the_same_keys(seed):
    B, K, V = 8, 4, 96
    args = _verify_inputs(seed, B, K, V, greedy_rows=(0, 3), onehot_rows=(1, 3, 5))
    (jo, jn, jl, jk), (to, tn, tlp, tk) = _both_verify(*args)
    np.testing.assert_array_equal(tn, jn)
    for b in range(B):
        np.testing.assert_array_equal(to[b, :tn[b]], jo[b, :jn[b]])
        np.testing.assert_allclose(tlp[b, :tn[b]], jl[b, :jn[b]], rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(tk, jk)


def test_verify_injected_noise_decides_the_draw():
    """The uniforms/noise hooks replace the keys' draws: a uniform of 0
    accepts every proposal the target gives mass to, and the residual
    draw is the argmax of its log plus the given noise."""
    B, K, V = 4, 3, 32
    tl, dl, prop, plen, temp, onehot, keys = _verify_inputs(5, B, K, V)
    plen[:] = K
    out, n, _, _ = ts.spec_verify_sample(
        torch.from_numpy(tl), torch.from_numpy(dl), torch.from_numpy(prop),
        torch.from_numpy(plen), torch.from_numpy(temp), torch.ones(B, dtype=torch.bool),
        keys, uniforms=torch.zeros(B, K), noise=torch.zeros(B, V))
    assert n.tolist() == [K + 1] * B            # one-hot q: accept unless p = 0
    p = torch.softmax(torch.from_numpy(tl[:, K]) / torch.from_numpy(temp)[:, None], -1)
    assert out[:, K].tolist() == torch.argmax(p, -1).tolist()


def test_verify_first_token_marginal_is_the_target_distribution():
    V, N = 5, 6000
    rng = np.random.RandomState(3)
    tlog = rng.randn(V).astype(np.float32) * 1.5
    dlog = rng.randn(V).astype(np.float32) * 1.5
    p = np.exp(tlog - tlog.max())
    p /= p.sum()
    q = np.exp(dlog - dlog.max())
    q /= q.sum()
    prop = torch.from_numpy(rng.choice(V, size=(N, 1), p=q).astype(np.int32))
    keys = torch.stack(ts.split_keys(torch.tensor([list(ts.prng_key(9))]), N), 1)[0]
    out, n, _, _ = ts.spec_verify_sample(
        torch.from_numpy(tlog).expand(N, 2, V), torch.from_numpy(dlog).expand(N, 1, V),
        prop, torch.ones(N, dtype=torch.int32), torch.ones(N),
        torch.zeros(N, dtype=torch.bool), keys)
    assert int(n.min()) >= 1
    freq = np.bincount(out[:, 0].numpy(), minlength=V) / N
    assert np.abs(freq - p).max() < 3.5 * np.sqrt(p.max() / N) + 0.01


def test_verify_onehot_q_accepts_with_the_target_probability():
    V, N, tok = 5, 6000, 2
    rng = np.random.RandomState(4)
    tlog = rng.randn(V).astype(np.float32)
    p = np.exp(tlog - tlog.max())
    p /= p.sum()
    keys = torch.stack(ts.split_keys(torch.tensor([list(ts.prng_key(11))]), N), 1)[0]
    out, n, _, _ = ts.spec_verify_sample(
        torch.from_numpy(tlog).expand(N, 2, V), torch.zeros(N, 1, V),
        torch.full((N, 1), tok, dtype=torch.int32), torch.ones(N, dtype=torch.int32),
        torch.ones(N), torch.ones(N, dtype=torch.bool), keys)
    assert float((n == 2).float().mean()) == pytest.approx(float(p[tok]), abs=0.03)
    assert not bool((out[n == 1, 0] == tok).any())   # the residual excludes it


# ---------------------------------------------------------------------------
# the verify window forward
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jm = JaxLM(jax_model("tiny-llama-test").arch, dtype=jnp.float32)
    jp = jm.init_params(jax.random.PRNGKey(0))
    arch = get_model_by_name("tiny-llama-test").arch
    tm = TransformerLM(arch, dtype=torch.float32, device="cpu")
    tm.load_params(params_from_jax(jax.tree.map(np.asarray, jp), arch))
    return jm, jp, tm


@pytest.mark.parametrize("start", [(11, 30), (16, 3)])
def test_verify_window_logits_match_jax(models, start):
    jm, jp, tm = models
    PS, P, PMAX, W = 16, 24, 6, 5
    rng = np.random.RandomState(sum(start))
    B = 3
    pt = np.arange(1, 1 + B * PMAX, dtype=np.int32).reshape(B, PMAX)
    hist = 40
    toks = rng.randint(0, tm.arch.vocab_size, size=(B, hist)).astype(np.int32)
    tl = np.array([start[0], start[1], 0], np.int32)
    jc = j_cache(jm.arch, P, PS, jnp.float32)
    tc = t_cache(tm.arch, P, PS, torch.float32, "cpu")
    jc, _, _ = jm.prefill(jp, jc, jnp.asarray(toks), jnp.asarray(tl), jnp.asarray(pt))
    tc, _, _ = tm.prefill(tc, torch.from_numpy(toks), torch.from_numpy(tl),
                          torch.from_numpy(pt))
    win = rng.randint(0, tm.arch.vocab_size, size=(B, W)).astype(np.int32)
    wl = np.array([W, 3, 0], np.int32)        # a short window and a skipped row
    jc, jlg = jm.verify_window_logits(jp, jc, jnp.asarray(win), jnp.asarray(wl),
                                      jnp.asarray(pt), jnp.asarray(tl))
    tc, tlg = tm.verify_window_logits(tc, torch.from_numpy(win), torch.from_numpy(wl),
                                      torch.from_numpy(pt), torch.from_numpy(tl))
    assert tlg.shape == (B, W, tm.arch.vocab_size) and tlg.dtype == torch.float32
    for b in range(2):
        np.testing.assert_allclose(tlg[b, :wl[b]].numpy(), np.asarray(jlg)[b, :wl[b]],
                                   **TOL)
    np.testing.assert_allclose(tc.k[:, 1:].numpy(), np.asarray(jc.k[:, 1:]), **TOL)
    np.testing.assert_allclose(tc.v[:, 1:].numpy(), np.asarray(jc.v[:, 1:]), **TOL)
    # the greedy reduction: the argmax and its logprob at every position
    targets, lps = greedy_targets(tlg)
    np.testing.assert_array_equal(targets[:2, :3].numpy(),
                                  np.argmax(np.asarray(jlg)[:2, :3], axis=-1))
    np.testing.assert_allclose(
        lps[:2, :3].numpy(),
        np.asarray(jax.nn.log_softmax(jlg, axis=-1))[
            np.arange(2)[:, None], np.arange(3)[None], targets[:2, :3].numpy()], **TOL)


def test_width_bucket():
    assert [tspec.width_bucket(n, 128) for n in (0, 1, 2, 3, 5, 64, 65, 200)] == \
        [1, 1, 2, 4, 8, 64, 128, 128]
