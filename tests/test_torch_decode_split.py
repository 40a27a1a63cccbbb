"""The split of ``flash_decode`` across blocks, on the CPU.

``ops.decode_splits`` chooses how the card's kernel splits each cache
(covering every row, no split empty); ``ref.flash_decode_split_ref``
mirrors the kernel's split-and-merge arithmetic in plain PyTorch. The
mirror is held to the port's plain version ``cached_attn_decode_ref``
and to the JAX package's TPU kernel ``flash_decode_pallas`` in interpret
mode, on the same numpy inputs, at fp32 1e-5 (the tolerance
``tests/test_torch_kernels.py`` holds the Pallas kernel to: only the
order of the sums differs). Fully masked rows are exactly zero. The
kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_decode_pallas
from repro_torch.kernels import ops, ref

TOL = dict(rtol=1e-5, atol=1e-5)

# (B, KVH, G, L, hd): the serving path's shape, the long caches timed on
# the card (Qwen1.5-0.5B's 32,768-token context, llama3-405b's head
# layout), tile edges and a single head.
SHAPES = [(4, 16, 1, 64, 64), (4, 16, 1, 4096, 64), (4, 16, 1, 32768, 64),
          (4, 8, 16, 4096, 128), (4, 2, 1, 1, 64), (4, 2, 1, 65, 64),
          (4, 2, 1, 4097, 64), (2, 2, 16, 4097, 128), (1, 1, 1, 32768, 64),
          (1, 1, 4, 31, 128), (64, 16, 1, 4096, 64), (3, 5, 2, 1000, 128),
          # Head dims the kernel runs zero-padded to its instance's HD
          # (tiles of 4096 / HD rows): 24 -> 32, 48 -> 64, 96 -> 128, 8.
          (4, 2, 1, 4097, 24), (2, 2, 4, 300, 48), (4, 2, 16, 257, 96),
          (3, 2, 1, 65, 8)]


@pytest.mark.parametrize("B,KVH,G,L,hd", SHAPES)
def test_decode_splits_cover_every_row_and_none_is_empty(B, KVH, G, L, hd):
    S, chunk = ops.decode_splits(B, KVH, G, L, hd)
    tile = ops.decode_tile_rows(hd)
    assert 1 <= S <= ops.MAX_DECODE_SPLITS
    assert chunk % tile == 0                 # whole tiles a split
    assert (S - 1) * chunk < L <= S * chunk  # every row, the last split not empty
    if L <= tile:
        assert S == 1
    assert ops.decode_splits(B, KVH, G, L, hd) == (S, chunk)  # a pure function


def test_decode_splits_at_the_timed_shapes():
    assert ops.decode_splits(4, 16, 1, 64, 64) == (1, 64)   # the path: one launch, no merge
    for B, KVH, G, L, hd in SHAPES[1:4]:
        S, _ = ops.decode_splits(B, KVH, G, L, hd)
        assert 4 * 132 * 0.9 <= B * KVH * S <= 4 * 132 * 1.1  # 4 blocks an SM


def _inputs(seed, B, L, KVH, G, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, KVH, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, L, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((B, L, KVH, hd)).astype(np.float32)
    valid = np.zeros((B, L), bool)
    valid[0, :5] = True                      # a prefix: later splits wholly masked
    valid[1] = True                          # the whole cache
    valid[2] = rng.random(L) < 0.5           # a scattered ring buffer
    valid[2, L - 1] = True
    # valid[3] stays all False: the fully masked row.
    return q, k, v, valid


def _pallas(q, k, v, valid):
    """flash_decode_pallas in interpret mode, on the (B*H, L, hd) layout
    its wrapper builds."""
    B, _, KVH, G, hd = q.shape
    L, H = k.shape[1], KVH * G
    kf = np.repeat(k, G, axis=2).transpose(0, 2, 1, 3).reshape(B * H, L, hd)
    vf = np.repeat(v, G, axis=2).transpose(0, 2, 1, 3).reshape(B * H, L, hd)
    validf = np.broadcast_to(valid[:, None], (B, H, L)).reshape(B * H, L)
    out = flash_decode_pallas(jnp.asarray(q.reshape(B * H, hd)),
                              jnp.asarray(kf), jnp.asarray(vf),
                              jnp.asarray(validf), bk=L, interpret=True)
    return np.asarray(out).reshape(B, 1, KVH, G, hd)


# (G, hd, L, (S, chunk), tile): small tiles so a short cache has many
# tiles and splits; a split of 8 rows past row 5 is wholly masked in row 0.
SPLITS = [(1, 64, 40, (5, 8), 4), (4, 64, 40, (3, 16), 8),
          (1, 128, 33, (4, 9), 3), (4, 128, 24, (1, 24), 5),
          (1, 64, 7, (7, 1), 1)]


@pytest.mark.parametrize("G,hd,L,splits,tile", SPLITS)
def test_split_mirror_matches_plain_and_pallas(G, hd, L, splits, tile):
    q, k, v, valid = _inputs(G * 100 + L, B=4, L=L, KVH=2, G=G, hd=hd)
    t = [torch.from_numpy(a) for a in (q, k, v, valid)]
    got = ref.flash_decode_split_ref(*t, splits=splits, tile=tile).numpy()
    np.testing.assert_allclose(got, ref.cached_attn_decode_ref(*t).numpy(),
                               **TOL)
    np.testing.assert_allclose(got, _pallas(q, k, v, valid), **TOL)
    assert np.all(got[3] == 0.0)


def test_padded_head_dims_run_on_whole_tiles():
    """hd 24 and 48 (the smoke LM's and the composition twin's) run on
    the HD 32 and HD 64 instances, whose tiles are whole numbers of rows
    (4096 / 24 is not)."""
    assert [ops.kernel_head_dim(h) for h in (8, 24, 32, 48, 64, 96, 128)] \
        == [32, 32, 32, 64, 64, 128, 128]
    assert ops.decode_tile_rows(24) == 128 and ops.decode_tile_rows(48) == 64
    assert all(ops.head_dim_ok(h) for h in range(8, 129, 8))
    assert not any(ops.head_dim_ok(h) for h in (0, 4, 20, 130, 136, 256))


@pytest.mark.parametrize("G,hd", [(1, 64), (4, 128), (1, 24), (4, 48)])
def test_split_mirror_at_the_chosen_splits(G, hd):
    """The mirror at what decode_splits chooses for a cache of 4.5 tiles
    (S > 1; row 0 lives only in the first split)."""
    L = ops.decode_tile_rows(hd) * 9 // 2
    splits = ops.decode_splits(4, 2, G, L, hd)
    assert splits[0] > 1
    q, k, v, valid = _inputs(5, B=4, L=L, KVH=2, G=G, hd=hd)
    t = [torch.from_numpy(a) for a in (q, k, v, valid)]
    got = ref.flash_decode_split_ref(*t, splits=splits,
                                     tile=ops.decode_tile_rows(hd)).numpy()
    np.testing.assert_allclose(got, ref.cached_attn_decode_ref(*t).numpy(),
                               **TOL)
    np.testing.assert_allclose(got, _pallas(q, k, v, valid), **TOL)
    assert np.all(got[3] == 0.0)


def test_a_wholly_masked_split_merges_as_nothing():
    """Live rows only in split 1 of 3: the other two splits carry m = NEG,
    l = 0 and leave the result as if they were not there."""
    q, k, v, valid = _inputs(9, B=4, L=24, KVH=2, G=2, hd=64)
    valid[:3] = False
    valid[:3, 9:13] = True
    t = [torch.from_numpy(a) for a in (q, k, v, valid)]
    got = ref.flash_decode_split_ref(*t, splits=(3, 8), tile=8)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(),
                               ref.cached_attn_decode_ref(*t).numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), _pallas(q, k, v, valid), **TOL)
