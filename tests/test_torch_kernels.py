"""The port's decode-attention kernel module against the JAX package.

The port's plain version ``cached_attn_decode_ref`` is held against the
JAX package's jnp oracle and against its TPU kernel
``flash_decode_pallas`` in interpret mode, on the same numpy inputs
(fp32, tolerance 1e-5: both sides sum in fp32, in different orders).
The CUDA kernel itself runs only on the card
(``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import flash_decode_pallas
from repro_torch.kernels import ops, ref

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, B, L, KVH, G, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, KVH, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, L, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((B, L, KVH, hd)).astype(np.float32)
    valid = np.zeros((B, L), bool)
    valid[0, :5] = True                      # a prefix, as decode has it
    valid[1] = True                          # the whole cache
    valid[2] = rng.random(L) < 0.5           # a scattered ring buffer
    valid[2, L - 1] = True
    # valid[3] stays all False: the fully masked row.
    return q, k, v, valid


def _pallas(q, k, v, valid):
    """flash_decode_pallas in interpret mode, on the (B*H, L, hd) layout
    its wrapper builds (this repeat/transpose is what the port avoids)."""
    B, _, KVH, G, hd = q.shape
    L, H = k.shape[1], KVH * G
    kf = np.repeat(k, G, axis=2).transpose(0, 2, 1, 3).reshape(B * H, L, hd)
    vf = np.repeat(v, G, axis=2).transpose(0, 2, 1, 3).reshape(B * H, L, hd)
    validf = np.broadcast_to(valid[:, None], (B, H, L)).reshape(B * H, L)
    out = flash_decode_pallas(jnp.asarray(q.reshape(B * H, hd)),
                              jnp.asarray(kf), jnp.asarray(vf),
                              jnp.asarray(validf), bk=L, interpret=True)
    return np.asarray(out).reshape(B, 1, KVH, G, hd)


def _port(q, k, v, valid):
    return ref.cached_attn_decode_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(valid)).numpy()


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("L", [16, 40])
def test_decode_ref_matches_jax_oracle_and_pallas(G, hd, L):
    q, k, v, valid = _inputs(G * 1000 + hd + L, B=4, L=L, KVH=2, G=G, hd=hd)
    got = _port(q, k, v, valid)
    # The TPU kernel, every row including the fully masked one.
    np.testing.assert_allclose(got, _pallas(q, k, v, valid), **TOL)
    # The jnp oracle on the live rows (it returns mean(v) on a fully
    # masked row, where the kernel and the port give zeros).
    want = np.asarray(jax_ref.cached_attn_decode_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid)))
    np.testing.assert_allclose(got[:3], want[:3], **TOL)


def test_fully_masked_row_gives_zeros_like_pallas():
    q, k, v, valid = _inputs(7, B=4, L=16, KVH=2, G=2, hd=64)
    got = _port(q, k, v, valid)
    assert np.all(got[3] == 0.0)
    assert np.all(_pallas(q, k, v, valid)[3] == 0.0)


def test_cpu_dispatch_is_the_plain_version_and_launches_nothing():
    q, k, v, valid = (torch.from_numpy(a) for a in
                      _inputs(3, B=4, L=40, KVH=2, G=2, hd=64))
    before = ops.flash_decode.launches
    got = ops.cached_attn_decode(q, k, v, valid)
    assert torch.equal(got, ref.cached_attn_decode_ref(q, k, v, valid))
    assert ops.flash_decode.launches == before


def test_flash_decode_refuses_cpu_tensors():
    q, k, v, valid = (torch.from_numpy(a) for a in
                      _inputs(3, B=4, L=16, KVH=2, G=1, hd=64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.flash_decode(q[:, 0], k, v, valid)


def test_library_name_follows_its_source_and_every_shared_header(
        tmp_path, monkeypatch):
    """An edited source or header builds a new library: a stale one is
    never loaded (names only; nothing is compiled here)."""
    from repro_torch.kernels import build

    (tmp_path / "k.cu").write_text('#include "row.cuh"\n')
    (tmp_path / "row.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build._library_path("k")
    assert build._library_path("k") == first
    (tmp_path / "row.cuh").write_text("// v2\n")
    second = build._library_path("k")
    assert second != first
    (tmp_path / "k.cu").write_text('#include "row.cuh"\n// edited\n')
    assert build._library_path("k") not in (first, second)
    assert second.parent == build.BUILD_DIR and second.suffix == ".so"
