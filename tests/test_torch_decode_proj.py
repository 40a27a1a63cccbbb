"""The port's decode-projection kernel's module (``decode_proj``) and the
fused wire path at the Table-II client boundary against the JAX package,
on the same numpy inputs.

``decode_proj``: the port's CPU path (``ref.decode_proj_ref``) against
the JAX wrapper with its Pallas kernel in interpret mode
(``ops.decode_proj(interpret=True)``, as ``tests/test_wire_fused.py``
runs it) and against the JAX oracle, on the same payload: within 1e-5
of the largest magnitude (the products sum in other orders).

The client boundary: clients 2, 3 and 4 on the JAX package's carried
init at B 32 run their base block up to the fusion FC, then the
projection with the wire encode (``fusion_proj_encode``, relu) under
int8_row and ef(int4); each payload goes through ``decode_proj`` into
every Table-II modular block's first FC, then through the rest of that
block (``fusion_proj``). Payloads: leaf names, dtypes, shapes and
``encoded_nbytes`` exact, codes within the JAX package's flip budget
(``_wire_budget.py``). Logits: the port's modular path on the JAX
payload within 1e-5 of the JAX path's, and the port's fused path within
1e-5 of its unfused one (``client_base_apply`` -> codec encode / decode
-> ``client_modular_apply``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _wire_budget as budget
from _port_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.core import codec as jcodec
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import modules as jnn
from repro.models import small as jsmall
from repro_torch.checkpoint import params_from_numpy
from repro_torch.core import codec as tcodec
from repro_torch.kernels import ops, ref
from repro_torch.models import small as tsmall

TOL = 1e-5
SCHEMES = ["int8_row", "int4", "topk", "sketch"]


def _z(rows, d, seed):
    """Fusion-output-like rows: ReLU zeros, an all-zero row, ties."""
    rng = np.random.default_rng(seed)
    z = np.maximum(rng.standard_normal((rows, d)), 0).astype(np.float32)
    z[min(3, rows - 1)] = 0.0
    z[0, [5, 40, min(77, d - 1)]] = 1.5
    return z


def _payload(name, z):
    """The JAX codec's payload (jitted, as its exchange runs it) as numpy,
    and the same bytes as torch tensors."""
    p = jax.jit(jcodec.get_codec(name).encode)(jnp.asarray(z))
    pn = {k: np.asarray(v) for k, v in p.items()}
    return pn, {k: torch.tensor(v) for k, v in pn.items()}


def _w(d, n, seed):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((d, n)) / np.sqrt(d)).astype(np.float32),
            (0.1 * rng.standard_normal(n)).astype(np.float32))


@pytest.mark.parametrize("name", SCHEMES + ["topk0.1", "sketch0.5"])
@pytest.mark.parametrize("rows,n,act", [(12, 256, "relu"), (32, 10, "silu")])
def test_decode_proj_matches_jax_kernel_and_oracle(name, rows, n, act):
    d = 432
    pn, pt = _payload(name, _z(rows, d, seed=rows + n))
    w, b = _w(d, n, seed=n)
    got = ops.decode_proj(pt, torch.tensor(w), torch.tensor(b), act,
                          codec=tcodec.get_codec(name), shape=(rows, d))
    assert got.dtype == torch.float32 and tuple(got.shape) == (rows, n)
    jc = jcodec.get_codec(name)
    args = ({k: jnp.asarray(v) for k, v in pn.items()}, jnp.asarray(w),
            jnp.asarray(b), act)
    kern = jops.decode_proj(*args, codec=jc, shape=(rows, d),
                            interpret=True)
    oracle = jref.decode_proj_ref(*args, codec=jc, shape=(rows, d))
    budget.floats_close(got, np.asarray(kern), TOL, "kernel")
    budget.floats_close(got, np.asarray(oracle), TOL, "oracle")


@pytest.mark.parametrize("name,d,n", [("int4", 433, 300), ("topk", 433, 7),
                                      ("int8_row", 64, 1000)])
def test_decode_proj_takes_shapes_the_jax_kernel_does_not(name, d, n):
    """An odd d under int4 and N not a multiple of 256: the JAX wrapper
    runs its oracle there; the port's kernel takes any shape."""
    pn, pt = _payload(name, _z(9, d, seed=d))
    w, b = _w(d, n, seed=1)
    got = ops.decode_proj(pt, torch.tensor(w), torch.tensor(b), "relu",
                          codec=tcodec.get_codec(name), shape=(9, d))
    want = jops.decode_proj({k: jnp.asarray(v) for k, v in pn.items()},
                            jnp.asarray(w), jnp.asarray(b), "relu",
                            codec=jcodec.get_codec(name), shape=(9, d),
                            interpret=True)
    budget.floats_close(got, np.asarray(want), TOL)


def test_decode_proj_bf16_weights_leading_dims_and_ef_codecs():
    d, n = 432, 128
    pn, pt = _payload("int4", _z(32, d, seed=5))
    w, b = _w(d, n, seed=2)
    wt = torch.tensor(w).to(torch.bfloat16)
    got = ops.decode_proj({k: v.reshape(2, 16, -1) for k, v in pt.items()},
                          wt, torch.tensor(b), "relu",
                          codec=tcodec.get_codec("int4"), shape=(2, 16, d))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 16, n)
    want = jops.decode_proj({k: jnp.asarray(v) for k, v in pn.items()},
                            jnp.asarray(wt.float().numpy()).astype(
                                jnp.bfloat16), jnp.asarray(b), "relu",
                            codec=jcodec.get_codec("int4"), shape=(32, d),
                            interpret=True)
    budget.floats_close(got.reshape(32, n), np.asarray(want), TOL)
    # ef(...) decodes with its inner codec: the same function.
    again = ops.decode_proj({k: v.reshape(2, 16, -1) for k, v in pt.items()},
                            wt, torch.tensor(b), "relu",
                            codec=tcodec.get_codec("ef(int4)"),
                            shape=(2, 16, d))
    assert torch.equal(again, got)


def test_cpu_dispatch_is_the_plain_version_and_launches_nothing():
    _, pt = _payload("sketch", _z(8, 432, seed=1))
    w, b = (torch.tensor(a) for a in _w(432, 64, seed=3))
    codec = tcodec.get_codec("sketch")
    before = ops.decode_proj.launches
    got = ops.decode_proj(pt, w, b, "relu", codec=codec, shape=(8, 432))
    assert torch.equal(got, ref.decode_proj_ref(pt, w, b, "relu", codec=codec,
                                                shape=(8, 432)))
    assert ops.decode_proj.launches == before
    with pytest.raises(ValueError):
        ops.decode_proj(pt, w, b, "gelu", codec=codec, shape=(8, 432))


# ------------------------------------------- the Table-II client boundary

B = 32
D = tsmall.D_FUSION


def _carried(cid):
    """The reference's own init of client ``cid`` (non-zero biases, so
    the bias path counts), as JAX arrays and as the port's tensors."""
    jp = jsmall.init_client_model(jax.random.PRNGKey(100 + cid), cid)
    jp = jax.tree.map(lambda a: a + 0.01 * jnp.cos(jnp.arange(a.size)
                                                   .reshape(a.shape)), jp)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _acts(n):
    return ["relu"] * (n - 1) + ["none"]


def port_encode(tp, cid, x, codec, e=None):
    """The port's base block up to the fusion FC (convolutions in torch,
    FCs through ``ops.fusion_proj``), then ``ops.fusion_proj_encode``."""
    h = x
    descs = tsmall.CLIENT_ARCHS[cid]["base"]
    for p, d in zip(tp["base"][:-1], descs[:-1]):
        h = (tsmall._conv_pool_relu(p, h) if d[0] == "conv" else
             ops.fusion_proj(h.reshape(h.shape[0], -1), p["w"], p["b"],
                             "relu"))
    last = tp["base"][-1]
    return ops.fusion_proj_encode(h.reshape(h.shape[0], -1), last["w"],
                                  last["b"], "relu", codec=codec,
                                  ef_state=e)


def port_modular(tp, payload, codec):
    """``ops.decode_proj`` into the modular block's first FC, then the
    rest of the block through ``ops.fusion_proj`` -> logits."""
    layers = tp["modular"]
    acts = _acts(len(layers))
    y = ops.decode_proj(payload, layers[0]["w"], layers[0]["b"], acts[0],
                        codec=codec, shape=(B, D))
    for p, act in zip(layers[1:], acts[1:]):
        y = ops.fusion_proj(y, p["w"], p["b"], act)
    return y


def jax_encode(jp, cid, x, codec, e=None):
    h = x
    descs = jsmall.CLIENT_ARCHS[cid]["base"]
    for p, d in zip(jp["base"][:-1], descs[:-1]):
        h = (jsmall._conv_pool_relu(p, h) if d[0] == "conv" else
             jax.nn.relu(jnn.linear(p, h.reshape(h.shape[0], -1))))
    last = jp["base"][-1]
    return jops.fusion_proj_encode(h.reshape(h.shape[0], -1), last["w"],
                                   last["b"], "relu", codec=codec,
                                   ef_state=e, interpret=True)


def jax_modular(jp, payload, codec):
    layers = jp["modular"]
    acts = _acts(len(layers))
    y = jops.decode_proj(payload, layers[0]["w"], layers[0]["b"], acts[0],
                         codec=codec, shape=(B, D), interpret=True)
    for p, act in zip(layers[1:], acts[1:]):
        y = jnn.linear(p, y)
        y = jax.nn.relu(y) if act == "relu" else y
    return y


@pytest.mark.parametrize("name", ["int8_row", "ef(int4)"])
def test_client_boundary_at_table2_width_matches_jax(name):
    tc, jc = tcodec.get_codec(name), jcodec.get_codec(name)
    kind = ops.scheme_for(tc.inner if tc.has_state else tc, D).kind
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1.5, size=(B, 28, 28, 1)).astype(np.float32)
    e = (0.05 * rng.standard_normal((B, D))).astype(np.float32)
    models = {cid: _carried(cid) for cid in (1, 2, 3, 4)}
    for cid in (2, 3, 4):
        jp, tp = models[cid]
        et = torch.tensor(e) if tc.has_state else None
        ej = jnp.asarray(e) if tc.has_state else None
        out_t = port_encode(tp, cid, torch.tensor(x), tc, et)
        out_j = jax_encode(jp, cid, jnp.asarray(x), jc, ej)
        pt, pj = (out_t[0], out_j[0]) if tc.has_state else (out_t, out_j)
        pj = {k: np.asarray(v) for k, v in pj.items()}
        assert tc.wire_bytes(pt) == tc.encoded_nbytes((B, D)) == \
            jc.encoded_nbytes((B, D))
        flips = budget.payload_close(kind, pt, pj, D, TOL, f"client {cid}")
        if tc.has_state:
            budget.residual_close(out_t[1], out_j[1], flips, TOL)
        # The unfused path of the port: z, then the codec, then the block.
        z = tsmall.client_base_apply(tp, cid, torch.tensor(x))
        pu = tc.encode_with_state(z, et)[0] if tc.has_state else tc.encode(z)
        for k in pu:
            assert torch.equal(pu[k], pt[k]), (cid, k)
        z_hat = tc.decode(pu, shape=(B, D))
        for mid, (jm, tm) in models.items():
            got = port_modular(tm, pt, tc)
            assert tuple(got.shape) == (B, tsmall.NUM_CLASSES)
            budget.floats_close(got, tsmall.client_modular_apply(
                tm, mid, z_hat), TOL, f"{cid}->{mid} unfused")
            on_jax = port_modular(tm, {k: torch.tensor(v) for k, v in
                                       pj.items()}, tc)
            want = jax_modular(jm, {k: jnp.asarray(v) for k, v in pj.items()},
                               jc)
            budget.floats_close(on_jax, np.asarray(want), TOL,
                                f"{cid}->{mid} jax")
