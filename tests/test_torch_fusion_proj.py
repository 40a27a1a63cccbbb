"""The port's fused projection kernels' module (``fusion_proj``,
``fusion_proj_quant``, ``fusion_proj_encode``) against the JAX package,
on the same numpy inputs.

The port's CPU path (the plain versions of ``kernels/ref.py``) is held
against the JAX wrappers with their Pallas kernels in interpret mode
(``ops.fusion_proj`` / ``ops.fusion_proj_quant`` with ``interpret=True``,
``fusion_proj_encode_pallas`` with small blocks, as
``tests/test_kernels.py`` and ``tests/test_wire_fused.py`` run them) and
against the JAX oracles of ``repro/kernels/ref.py``. Tolerances:
- fp32 floats (projections, scales, kept top-k values, sketch sums, EF
  residuals) within 1e-5 of the tensor's largest magnitude: the products
  sum in other orders on the two sides;
- bf16 outputs within 2^-7 relative: one bf16 rounding of fp32 values
  that may differ in their last bits;
- integer codes within the JAX package's own flip budget for these
  kernels (``tests/test_wire_fused.py:215-233``; ``_wire_budget.py``):
  fewer than 2% differ, each by one step, because a y that sits on a
  rounding edge may round either way after another summation order;
  top-k decoded rows within one quantum;
- payload leaf names, dtypes, shapes and ``encoded_nbytes`` exactly.
The CUDA kernels run only on the card (``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _wire_budget as budget
from _port_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.core import codec as jcodec
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import wire_fused
from repro.kernels.fusion_proj import fusion_proj_encode_pallas
from repro_torch.core import codec as tcodec
from repro_torch.kernels import ops, ref

TOL = 1e-5
SCHEMES = ["int8_row", "int4", "topk", "sketch"]


def _inputs(m, k, n, seed, zero_row=True):
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((m, k))).astype(np.float32)
    if zero_row:
        x[min(2, m - 1)] = 0.0
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    b = (0.1 * rng.standard_normal(n)).astype(np.float32)
    return x, w, b


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


# ------------------------------------------------------------ fusion_proj

# Shapes the JAX kernel tiles (K a multiple of min(512, K), N of
# min(256, N)): the Table-II modular FCs and client 4's 1024 -> 512.
PROJ = [(32, 432, 256), (32, 64, 10), (32, 1024, 512), (7, 32, 16)]


@pytest.mark.parametrize("act", ["none", "relu", "silu"])
@pytest.mark.parametrize("m,k,n", PROJ)
def test_fusion_proj_matches_jax_kernel_and_oracle(m, k, n, act):
    x, w, b = _inputs(m, k, n, seed=m + k + n)
    for bias in (b, None):
        got = ops.fusion_proj(*_t(x, w), None if bias is None else
                              torch.from_numpy(bias), act).numpy()
        jb = None if bias is None else jnp.asarray(bias)
        kern = jops.fusion_proj(*_j(x, w), jb, act, interpret=True)
        oracle = jref.fusion_proj_ref(*_j(x, w), jb, act)
        assert got.dtype == np.float32 and got.shape == (m, n)
        budget.floats_close(got, np.asarray(kern), TOL, "kernel")
        budget.floats_close(got, np.asarray(oracle), TOL, "oracle")


@pytest.mark.parametrize("act", ["relu", "silu"])
def test_fusion_proj_bf16_matches_jax(act):
    x, w, b = _inputs(16, 64, 128, seed=3)
    xt, wt, bt = (t.to(torch.bfloat16) for t in _t(x, w, b))
    got = ops.fusion_proj(xt, wt, bt, act)
    assert got.dtype == torch.bfloat16
    jx, jw, jb = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (xt, wt, bt))
    kern = jops.fusion_proj(jx, jw, jb, act, interpret=True)
    budget.floats_close(got.float(), np.asarray(kern, np.float32), 2.0 ** -7)


def test_fusion_proj_takes_leading_dims_and_the_path_shapes():
    # The Table-II fusion FCs (K 1568, 784) do not tile the JAX kernel's
    # K blocks: the port takes them, held against the JAX oracle.
    for k in (1568, 784):
        x, w, b = _inputs(32, k, 432, seed=k)
        got = ops.fusion_proj(*_t(x.reshape(2, 16, k), w, b), "relu")
        assert tuple(got.shape) == (2, 16, 432)
        want = jref.fusion_proj_ref(*_j(x, w, b), "relu")
        budget.floats_close(got.reshape(32, 432), np.asarray(want), TOL)


# ------------------------------------------------------ fusion_proj_quant


@pytest.mark.parametrize("act", ["none", "relu", "silu"])
@pytest.mark.parametrize("m,k,n", [(32, 1568, 432), (5, 1000, 128)])
def test_fusion_proj_quant_matches_jax_kernel_and_oracle(m, k, n, act):
    x, w, b = _inputs(m, k, n, seed=k + n)
    q, s = ops.fusion_proj_quant(*_t(x, w, b), act)
    assert q.dtype == torch.int8 and tuple(q.shape) == (m, n)
    assert s.dtype == torch.float32 and tuple(s.shape) == (m, 1)
    got = {"q": q, "scale": s}
    for jq, js in (jops.fusion_proj_quant(*_j(x, w, b), act, interpret=True),
                   jref.fusion_proj_quant_ref(*_j(x, w, b), act)):
        budget.payload_close("int8_row", got, {"q": np.asarray(jq),
                                               "scale": np.asarray(js)},
                             n, TOL)
    # The port's quant is its int8_row payload of the same projection.
    p = ops.fusion_proj_encode(*_t(x, w, b), act,
                               codec=tcodec.get_codec("int8_row"))
    assert torch.equal(p["q"], q) and torch.equal(p["scale"], s)


# ----------------------------------------------------- fusion_proj_encode


def _pallas_encode(x, w, b, act, jc, e=None):
    """fusion_proj_encode_pallas with small blocks (bm 8, bk 32), as the
    JAX package's own epilogue tests run it -> (payload, e' or None)."""
    inner = jc.inner if isinstance(jc, jcodec.EFCodec) else jc
    scheme = wire_fused.scheme_for(inner, w.shape[1])
    outs = fusion_proj_encode_pallas(
        *_j(x, w, b), act, scheme=scheme,
        e=None if e is None else jnp.asarray(e),
        max_ratio=getattr(jc, "max_ratio", None), bm=8, bk=32,
        interpret=True)
    payload = dict(zip(scheme.leaf_names, (np.asarray(o) for o in outs)))
    return payload, (np.asarray(outs[-1]) if e is not None else None)


@pytest.mark.parametrize("name", SCHEMES + ["topk0.1", "sketch0.5"])
def test_fusion_proj_encode_matches_jax_kernel_and_oracle(name):
    m, k, n = 16, 96, 432
    x, w, b = _inputs(m, k, n, seed=6)
    tc, jc = tcodec.get_codec(name), jcodec.get_codec(name)
    kind = ops.scheme_for(tc, n).kind
    got = ops.fusion_proj_encode(*_t(x, w, b), "relu", codec=tc)
    assert tc.wire_bytes(got) == tc.encoded_nbytes((m, n)) == \
        jc.encoded_nbytes((m, n))
    kern, _ = _pallas_encode(x, w, b, "relu", jc)
    oracle = _np(jref.fusion_proj_encode_ref(*_j(x, w, b), "relu", codec=jc))
    for want in (kern, oracle):
        budget.payload_close(kind, got, want, n, TOL, name)
    # The JAX wrapper too, at the Table-II fusion FC's K.
    x, w, b = _inputs(32, 1568, n, seed=7)
    got = ops.fusion_proj_encode(*_t(x, w, b), "relu", codec=tc)
    want = _np(jops.fusion_proj_encode(*_j(x, w, b), "relu", codec=jc,
                                       interpret=True))
    budget.payload_close(kind, got, want, n, TOL, name)


@pytest.mark.parametrize("name", ["int4", "ef(int4)"])
def test_fusion_proj_encode_takes_an_odd_fusion_dim(name):
    """N 433 under int4: the JAX wrapper runs its oracle there (its kernel
    wants an even d); the port's kernel packs the pad nibble itself."""
    m, k, n = 33, 433, 433
    x, w, b = _inputs(m, k, n, seed=9)
    tc, jc = tcodec.get_codec(name), jcodec.get_codec(name)
    e = (0.01 * np.random.default_rng(1).standard_normal((m, n))).astype(
        np.float32) if tc.has_state else None
    got = ops.fusion_proj_encode(*_t(x, w, b), "relu", codec=tc,
                                 ef_state=None if e is None else torch.tensor(e))
    want = jops.fusion_proj_encode(*_j(x, w, b), "relu", codec=jc,
                                   ef_state=None if e is None else
                                   jnp.asarray(e), interpret=True)
    if e is None:
        budget.payload_close("int4", got, _np(want), n, TOL)
    else:
        flips = budget.payload_close("int4", got[0], _np(want[0]), n, TOL)
        budget.residual_close(got[1], want[1], flips, TOL)
    p = got if e is None else got[0]
    assert tuple(p["q4"].shape) == (m, 217)
    assert tc.wire_bytes(p) == jc.encoded_nbytes((m, n))


@pytest.mark.parametrize("name", ["ef(int8_row)", "ef(int4)", "ef(topk)",
                                  "ef(sketch)"])
def test_fusion_proj_encode_ef_matches_jax_over_chained_steps(name):
    """Three EF steps, both sides fed the JAX kernel's residual; e' is
    compared on the rows whose codes agree, and the flips are counted
    (``test_proj_encode_ef_epilogue``'s single atol is not carried over:
    it fails on some CPUs where one code flips)."""
    m, k, n = 16, 96, 432
    tc, jc = tcodec.get_codec(name), jcodec.get_codec(name)
    kind = ops.scheme_for(tc.inner, n).kind
    e = np.zeros((m, n), np.float32)
    for t in range(3):
        x, w, b = _inputs(m, k, n, seed=20 + t)
        got, e_got = ops.fusion_proj_encode(*_t(x, w, b), "relu", codec=tc,
                                            ef_state=torch.tensor(e))
        kern, e_kern = _pallas_encode(x, w, b, "relu", jc, e)
        o_p, o_e = jref.fusion_proj_encode_ref(*_j(x, w, b), "relu",
                                               codec=jc, e=jnp.asarray(e))
        for want, e_want in ((kern, e_kern), (_np(o_p), np.asarray(o_e))):
            flips = budget.payload_close(kind, got, want, n, TOL, name)
            budget.residual_close(e_got, e_want, flips, TOL, name)
        e = e_kern


def test_cpu_dispatch_is_the_plain_version_and_launches_nothing():
    x, w, b = _t(*_inputs(8, 40, 432, seed=1))
    counters = (ops.fusion_proj, ops.fusion_proj_quant,
                ops.fusion_proj_encode, ops.decode_proj)
    before = [c.launches for c in counters]
    assert torch.equal(ops.fusion_proj(x, w, b, "silu"),
                       ref.fusion_proj_ref(x, w, b, "silu"))
    q, s = ops.fusion_proj_quant(x, w, b, "relu")
    qr, sr = ref.fusion_proj_quant_ref(x, w, b, "relu")
    assert torch.equal(q, qr) and torch.equal(s, sr)
    for name in ("int4", "ef(topk)", "bf16", "int8"):   # with and without a scheme
        c = tcodec.get_codec(name)
        got = ops.fusion_proj_encode(x, w, b, "relu", codec=c)
        want = c.encode(ref.fusion_proj_ref(x, w, b, "relu"))
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert [c.launches for c in counters] == before


def test_wrappers_refuse_what_no_path_computes():
    x, w, b = _t(*_inputs(8, 40, 432, seed=2))
    with pytest.raises(ValueError):
        ops.fusion_proj(x, w, b, "gelu")
    with pytest.raises(ValueError):
        ops.fusion_proj_encode(x, w, b, codec=tcodec.get_codec("int8_row"),
                               ef_state=torch.zeros(8, 432))
    with pytest.raises(ValueError, match="CUDA tensors"):  # kernel checks
        ops._check_proj("fusion_proj", x, w, b, x.device)
