"""The port's wire codecs and its plain wire-encode versions against the
JAX package, on the same numpy inputs.

Per quantity: payload leaf names, dtypes, shapes and ``encoded_nbytes``
are equal; integer leaves (int8/int4 codes, top-k indices) are bitwise
equal on the same fp32 input; float leaves, decodes and EF residuals
agree within 1e-6 (absolute and relative: both sides compute in fp32,
and the residual's norms and the sketch's sums may be taken in another
order). The JAX side is jitted, as its exchange plane runs it; its
kernels run in Pallas interpret mode. The CUDA kernel itself runs only on
the card (``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codec as jcodec
from repro.kernels import wire_fused
from repro_torch.core import codec as tcodec
from repro_torch.kernels import ops

TOL = dict(rtol=1e-6, atol=1e-6)

STATELESS = ["fp32", "bf16", "fp16", "int8", "int8_channel", "int8_row",
             "int4", "topk", "topk0.1", "sketch", "sketch0.5"]
# ef(...) of each quantizer and sparsifier.
EF = ["ef(int8)", "ef(int8_channel)", "ef(int8_row)", "ef(int4)",
      "ef(topk)", "ef(topk0.1)", "ef(sketch)", "ef(sketch0.5)"]
SCHEMES = ["int8_row", "int4", "topk", "sketch"]


def _z(d, seed, rows=8, scale=2.0):
    """fp32 rows with a zero row, ReLU zeros and top-k magnitude ties."""
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal((rows, d)) * scale).astype(np.float32)
    z[3] = 0.0                                   # all-zero row
    z[2, : d // 3] = 0.0                         # dead-ReLU zeros
    z[1, [5, 40, 77]] = [3.5, -3.5, 3.5]          # ties in |z|
    return z


def _np(x):
    """A leaf as numpy; bf16 leaves as their 16-bit patterns' values."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _dtype_name(x):
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return str(np.asarray(x).dtype)


def assert_payload_parity(pt, pj, label):
    assert sorted(pt) == sorted(pj), label
    for name in pj:
        a, b = pt[name], pj[name]
        assert _dtype_name(a) == _dtype_name(b), (label, name)
        assert tuple(a.shape) == tuple(np.shape(b)), (label, name)
        an, bn = _np(a), _np(b)
        if np.issubdtype(bn.dtype, np.integer):
            assert np.array_equal(an, bn), (label, name)
        else:
            np.testing.assert_allclose(an, bn, **TOL, err_msg=f"{label} {name}")


def assert_residual_close(et, ej, c):
    """e' = c - z_hat cancels, so a last-bit difference in z_hat shows at
    the scale of c, not of e': 1e-6 relative to max |c| of the block. (XLA
    contracts the affine int8 decode (q + 128) * scale + zero into an FMA;
    the port rounds the product first, as the reference's source says.)"""
    atol = 1e-6 * max(1.0, float(np.abs(c).max()))
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-6,
                               atol=atol)


@pytest.mark.parametrize("name", STATELESS + EF)
@pytest.mark.parametrize("d", [432, 433])
def test_encode_decode_matches_jax(name, d):
    z = _z(d, seed=d)
    ct, cj = tcodec.get_codec(name), jcodec.get_codec(name)
    pt = ct.encode(torch.from_numpy(z))
    pj = jax.jit(cj.encode)(jnp.asarray(z))
    assert_payload_parity(pt, pj, name)
    assert ct.encoded_nbytes(z.shape) == cj.encoded_nbytes(z.shape)
    assert ct.wire_bytes(pt) == ct.encoded_nbytes(z.shape)
    zt = ct.decode(pt, shape=z.shape, dtype=torch.float32)
    zj = jax.jit(lambda p: cj.decode(p, shape=z.shape,
                                     dtype=jnp.float32))(pj)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), **TOL)


@pytest.mark.parametrize("name", EF)
@pytest.mark.parametrize("d", [432, 433])
def test_ef_four_steps_fed_the_reference_residual(name, d):
    ct, cj = tcodec.get_codec(name), jcodec.get_codec(name)
    e = np.zeros((8, d), np.float32)
    step = jax.jit(cj.encode_with_state)
    for t in range(4):
        z = _z(d, seed=100 * t + d, scale=1.0 + t)
        pj, ej = step(jnp.asarray(z), jnp.asarray(e))
        pt, et = ct.encode_with_state(torch.from_numpy(z),
                                      torch.from_numpy(e))
        assert_payload_parity(pt, pj, (name, t))
        assert_residual_close(et, ej, z + e)
        e = np.array(ej)  # each step is fed the reference's residual


@pytest.mark.parametrize("name", SCHEMES + ["topk0.1", "sketch0.5"])
@pytest.mark.parametrize("d", [432, 433])
def test_plain_wire_encode_matches_pallas_interpret(name, d):
    z = _z(d, seed=7 + d)
    pj = wire_fused.wire_encode(jnp.asarray(z), jcodec.get_codec(name),
                                interpret=True)
    before = ops.wire_encode.launches
    pt = ops.wire_encode(torch.from_numpy(z), tcodec.get_codec(name))
    assert ops.wire_encode.launches == before  # CPU: the plain version
    assert_payload_parity(pt, pj, name)


@pytest.mark.parametrize("name", SCHEMES + ["topk0.1", "sketch0.5"])
@pytest.mark.parametrize("d", [432, 433])
def test_plain_wire_encode_ef_matches_pallas_interpret(name, d):
    ct, cj = (tcodec.get_codec(f"ef({name})"),
              jcodec.get_codec(f"ef({name})"))
    e = np.zeros((8, d), np.float32)
    for t in range(2):
        z = _z(d, seed=11 * t + d, scale=1.5 + t)
        pj, ej = wire_fused.wire_encode_ef(jnp.asarray(z), jnp.asarray(e),
                                           cj, interpret=True)
        before = ops.wire_encode_ef.launches
        pt, et = ops.wire_encode_ef(torch.from_numpy(z), torch.from_numpy(e),
                                    ct)
        assert ops.wire_encode_ef.launches == before
        assert_payload_parity(pt, pj, (name, t))
        assert_residual_close(et, ej, z + e)
        e = np.array(ej)


@pytest.mark.parametrize("name", STATELESS + ["ef(int4)", "ef(bf16)"])
@pytest.mark.parametrize("d", [1, 432, 433, 8192, 8193])
def test_scheme_envelope_matches_reference(name, d):
    """Which codec/shape pairs have a wire kernel: the reference's rule."""
    ct, cj = tcodec.get_codec(name), jcodec.get_codec(name)
    inner_t = ct.inner if isinstance(ct, tcodec.EFCodec) else ct
    inner_j = cj.inner if isinstance(cj, jcodec.EFCodec) else cj
    st, sj = ops.scheme_for(inner_t, d), wire_fused.scheme_for(inner_j, d)
    assert (st is None) == (sj is None)
    if st is not None:
        assert sorted(st.leaves) == sorted(sj.leaf_names)
        assert st.payload_bytes(8) == ct.encoded_nbytes((8, d))
    if st is None:  # no kernel: the wrappers hand the encode back
        z = torch.zeros((2, d))
        assert ct.fused_encode(z) is None
        assert ct.fused_encode_with_state(z, ct.init_state(z.shape)) is None


def test_registry_and_name_parsing_match_reference():
    assert tcodec.available_codecs() == jcodec.available_codecs()
    for name in ["topk0.3", "sketch0.125", "ef(topk0.1)", "ef(ef(int4))",
                 "ef(sketch0.5)", "int8_channel"]:
        ct, cj = tcodec.get_codec(name), jcodec.get_codec(name)
        assert ct.name == cj.name and type(ct).__name__ == type(cj).__name__
        assert ct.has_state == cj.has_state
        for shape in [(32, 432), (5, 433)]:
            assert ct.encoded_nbytes(shape) == cj.encoded_nbytes(shape)
    assert tcodec.get_codec(None).name == "fp32"
    for bad in ["topk0", "topk1.5", "sketchx", "int3", "ef(foo)", "ef(int4"]:
        with pytest.raises(ValueError):
            jcodec.get_codec(bad)
        with pytest.raises(ValueError):
            tcodec.get_codec(bad)


@pytest.mark.parametrize("d", [432, 433])
def test_sketch_tables_match_reference(d):
    c = tcodec.get_codec("sketch")
    h, s, inv, order, ptr = tcodec.sketch_tables(d, c.w_of(d), c.seed)
    hj, sj, invj = jcodec._sketch_tables(d, c.w_of(d), c.seed)
    assert np.array_equal(h, hj) and np.array_equal(s, sj)
    assert np.array_equal(inv, invj)
    # The bucket lists walk each bucket's features in ascending order.
    for b in range(c.w_of(d)):
        idx = order[ptr[b]: ptr[b + 1]]
        assert np.array_equal(idx, np.flatnonzero(h == b))
