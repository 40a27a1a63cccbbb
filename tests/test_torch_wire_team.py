"""The wire encode's team choice (``ops.encode_warps``) and the order its
top-k sort relies on, on the CPU.

``csrc/wire_encode.cu`` runs a row on one warp (several rows a block) or
on a block of 256 threads, as ``ops.encode_warps`` says; the C entry
refuses any other team. Its top-k sorts one 64-bit key an element (the
bits of |c|, then the complement of the index); the last test holds that
key order to the codec's ``lax.top_k`` order on rows full of ties, with
numpy standing in for the card.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.codec import get_codec
from repro_torch.kernels import ops

KINDS = ["int8_row", "int4", "topk", "sketch"]


@pytest.mark.parametrize("kind", KINDS)
def test_encode_warps_is_a_team_the_kernel_takes(kind):
    """0 (a block a row) or ENCODE_WARPS, one of the C entry's 1, 2, 4, 8;
    warps only from ENCODE_WARP_ROWS rows (top-k: ENCODE_WARP_ROWS_TOPK)
    and up to ENCODE_WARP_MAX_D wide, where a warp's top-k keys stay in
    its registers (512)."""
    assert ops.ENCODE_WARPS in (1, 2, 4, 8)
    assert ops.ENCODE_WARP_MAX_D <= 512
    least = (ops.ENCODE_WARP_ROWS_TOPK if kind == "topk"
             else ops.ENCODE_WARP_ROWS)
    for d in (1, 31, 32, 33, 432, 512, 513, 1024, 1025, 2048, 8192):
        for rows in (1, 8, 32, 132, 1023, 1024, 4095, 4096, 100_000):
            w = ops.encode_warps(rows, d, kind)
            want = (ops.ENCODE_WARPS if rows >= least
                    and d <= ops.ENCODE_WARP_MAX_D else 0)
            assert w == want, (kind, d, rows, w)


@pytest.mark.parametrize("kind", KINDS)
def test_encode_warps_at_the_paths_shapes(kind):
    """The IFL path's (32, 432) runs a block a row, where warps wait on
    their own serial passes; (4096, 432) runs a warp a row."""
    assert ops.encode_warps(32, 432, kind) == 0
    assert ops.encode_warps(4096, 432, kind) == ops.ENCODE_WARPS


def _key_order(c):
    """Indices of each row sorted by the kernel's key, largest first: the
    bits of |c| (float32) in the high word, 0xFFFFFFFF - index in the
    low."""
    bits = np.abs(c).astype(np.float32).view(np.uint32).astype(np.uint64)
    idx = np.arange(c.shape[-1], dtype=np.uint64)
    key = (bits << np.uint64(32)) | (np.uint64(0xFFFFFFFF) - idx)
    return np.argsort(key, axis=-1)[:, ::-1]     # the keys are distinct


@pytest.mark.parametrize("ratio", ["0.0001", "", "1.0"])
def test_topk_key_order_is_the_codecs_order_on_ties(ratio):
    """Equal magnitudes, zeros of both signs and sign-flipped repeats: the
    first k of the key order are the codec's indices, in its order, and
    its values bit for bit."""
    rng = np.random.default_rng(0)
    d = 433
    half = rng.choice([0.5, 1.0, 2.0], 217)
    rows = [0.75 * np.where(rng.random(d) < 0.5, -1.0, 1.0),
            np.where(rng.random(d) < 0.5, -0.0, 0.0),
            np.concatenate([half, -half])[:d]]
    rows[1][rng.random(d) < 0.1] = -1.5
    z = np.stack(rows).astype(np.float32)
    codec = get_codec(f"topk{ratio}")
    k = codec.k_of(d)
    payload = codec.encode(torch.from_numpy(z))
    got = _key_order(z)[:, :k]
    np.testing.assert_array_equal(got, payload["indices"].numpy())
    np.testing.assert_array_equal(
        np.take_along_axis(z, got, axis=1).view(np.uint32),
        payload["values"].numpy().view(np.uint32))
