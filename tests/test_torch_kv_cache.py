"""kaito_tpu_torch.engine.kv_cache against kaito_tpu.engine.kv_cache.

The same write sequence lands the same bytes in every page but the null
page 0, which takes the writes of padding tokens and inactive rows (in
either package, duplicate writes to one null-page slot keep an
unspecified one of them).  Exact comparison: writes move bytes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaito_tpu.engine import kv_cache as jkv
from kaito_tpu.models import get_model_by_name as jax_model
from kaito_tpu_torch.engine import kv_cache as tkv
from kaito_tpu_torch.models import get_model_by_name
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

PRESET = "tiny-llama-test"
P, PS = 24, 4


def _pools():
    arch = get_model_by_name(PRESET).arch
    t = tkv.create_kv_cache(arch, P, PS, torch.float32, "cpu")
    j = jkv.create_kv_cache(jax_model(PRESET).arch, P, PS, jnp.float32)
    return arch, t, j


def _same_except_null(t_pool, j_pool):
    t, j = t_pool.numpy(), np.asarray(j_pool)
    assert t.shape == j.shape
    np.testing.assert_array_equal(t[..., 1:, :, :, :], j[..., 1:, :, :, :])


def _changed_pages(before, after):
    diff = (before != after).reshape(before.shape[0], before.shape[1], -1).any(-1)
    return set(np.nonzero(diff)[1].tolist())


def test_create_kv_cache_layout():
    arch, t, _ = _pools()
    assert tuple(t.k.shape) == (arch.num_layers, P, PS, arch.num_kv_heads,
                                arch.head_dim)
    assert t.num_pages == P and t.page_size == PS
    assert not t.k.any() and not t.v.any()


@pytest.mark.parametrize("layer", [None, 2])
def test_prefill_writes_match(layer):
    arch, t, j = _pools()
    rng = np.random.RandomState(0)
    B, T = 3, 8
    new = rng.randn(B, T, arch.num_kv_heads, arch.head_dim).astype(np.float32)
    pt = np.stack([rng.permutation(np.arange(1, P))[:6] for _ in range(B)]
                  ).astype(np.int32)
    start = np.array([0, 5, 9], np.int32)
    true_lens = np.array([8, 3, 0], np.int32)     # pads and an empty row
    t_pool = t.k if layer is not None else t.k[0]
    j_pool = j.k if layer is not None else j.k[0]
    before = t.k.numpy().copy()
    out = tkv.write_prefill_tokens(t_pool, torch.from_numpy(new),
                                   torch.from_numpy(pt), torch.from_numpy(start),
                                   torch.from_numpy(true_lens), PS, layer=layer)
    assert out is t_pool                           # in place
    want = jkv.write_prefill_tokens(j_pool, jnp.asarray(new), jnp.asarray(pt),
                                    jnp.asarray(start), jnp.asarray(true_lens),
                                    PS, layer=None if layer is None else
                                    jnp.asarray(layer))
    _same_except_null(t_pool, want)
    targets = {int(pt[b, (start[b] + i) // PS]) for b in range(B)
               for i in range(true_lens[b])}
    assert _changed_pages(before, t.k.numpy()) <= targets | {0}


def test_packed_writes_match():
    arch, t, j = _pools()
    rng = np.random.RandomState(1)
    T = 12
    new = rng.randn(1, T, arch.num_kv_heads, arch.head_dim).astype(np.float32)
    # two segments of 5 and 4 tokens, three pad tokens on the null page
    tok_pages = np.array([3, 3, 3, 3, 7, 9, 9, 9, 9, 0, 0, 0], np.int32)
    offsets = np.array([0, 1, 2, 3, 0, 0, 1, 2, 3, 1, 2, 3], np.int32)
    tkv.write_packed_prefill_tokens(t.v, torch.from_numpy(new),
                                    torch.from_numpy(tok_pages),
                                    torch.from_numpy(offsets), layer=1)
    want = jkv.write_packed_prefill_tokens(j.v, jnp.asarray(new),
                                           jnp.asarray(tok_pages),
                                           jnp.asarray(offsets),
                                           layer=jnp.asarray(1))
    _same_except_null(t.v, want)


def test_decode_writes_match_and_inactive_rows_hit_null_page():
    arch, t, j = _pools()
    rng = np.random.RandomState(2)
    B = 4
    new = rng.randn(B, arch.num_kv_heads, arch.head_dim).astype(np.float32)
    pt = np.stack([rng.permutation(np.arange(1, P))[:5] for _ in range(B)]
                  ).astype(np.int32)
    pos = np.array([0, 7, 13, 19], np.int32)
    active = np.array([True, False, True, False])
    before = t.k.numpy().copy()
    tkv.write_decode_tokens(t.k, torch.from_numpy(new), torch.from_numpy(pt),
                            torch.from_numpy(pos), PS,
                            active=torch.from_numpy(active), layer=3)
    want = jkv.write_decode_tokens(j.k, jnp.asarray(new), jnp.asarray(pt),
                                   jnp.asarray(pos), PS,
                                   active=jnp.asarray(active),
                                   layer=jnp.asarray(3))
    _same_except_null(t.k, want)
    live = {int(pt[b, pos[b] // PS]) for b in range(B) if active[b]}
    assert _changed_pages(before, t.k.numpy()) == live | {0}


def test_decode_writes_without_active_mask_match():
    arch, t, j = _pools()
    rng = np.random.RandomState(3)
    new = rng.randn(2, arch.num_kv_heads, arch.head_dim).astype(np.float32)
    pt = np.array([[5, 6, 0], [8, 2, 0]], np.int32)
    pos = np.array([6, 1], np.int32)
    tkv.write_decode_tokens(t.v[0], torch.from_numpy(new), torch.from_numpy(pt),
                            torch.from_numpy(pos), PS)
    want = jkv.write_decode_tokens(j.v[0], jnp.asarray(new), jnp.asarray(pt),
                                   jnp.asarray(pos), PS)
    np.testing.assert_array_equal(t.v[0].numpy(), np.asarray(want))
