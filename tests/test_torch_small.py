"""The port's Table-II client models against the JAX package's, on
parameters carried from the reference's own init
(``init_client_model(PRNGKey(100 + k), cid)`` as numpy, through
``checkpoint.params_from_numpy``) and the same numpy images.

Base outputs z, modular logits and the gradients of the loss with
respect to both blocks agree within 1e-5 (fp32 on both sides; the
convolutions and matrix products sum in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.core.ifl import softmax_xent as jax_xent
from repro.models import small as jsmall
from repro_torch.checkpoint import params_from_numpy
from repro_torch.core.comm import tree_leaves
from repro_torch.core.ifl import softmax_xent, tree_map
from repro_torch.models import small as tsmall

TOL = dict(rtol=1e-5, atol=1e-5)


def carried(cid, seed=None):
    jp = jsmall.init_client_model(
        jax.random.PRNGKey(100 + cid if seed is None else seed), cid)
    # Biases start at zero; make them non-zero so the bias path counts.
    jp = jax.tree.map(lambda a: a + 0.01 * jnp.cos(jnp.arange(a.size)
                                                   .reshape(a.shape)), jp)
    npp = jax.tree.map(np.asarray, jp)
    return jp, params_from_numpy(npp, device="cpu")


def images(n=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1.5, size=(n, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=n).astype(np.int32)
    return x, y


@pytest.mark.parametrize("cid", [1, 2, 3, 4])
def test_forward_matches_jax(cid):
    jp, tp = carried(cid)
    x, _ = images()
    zj = jsmall.client_base_apply(jp, cid, jnp.asarray(x))
    zt = tsmall.client_base_apply(tp, cid, torch.from_numpy(x))
    assert tuple(zt.shape) == (6, tsmall.D_FUSION)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), **TOL)
    lj = jsmall.client_modular_apply(jp, cid, zj)
    lt = tsmall.client_modular_apply(tp, cid, torch.from_numpy(np.array(zj)))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)


@pytest.mark.parametrize("cid", [1, 2, 3, 4])
def test_gradients_of_both_blocks_match_jax(cid):
    jp, tp = carried(cid)
    x, y = images(seed=cid)

    def jloss(p):
        return jax_xent(jsmall.client_apply(p, cid, jnp.asarray(x)),
                        jnp.asarray(y))

    lj, gj = jax.value_and_grad(jloss)(jp)
    live = tree_map(lambda a: a.clone().requires_grad_(), tp)
    lt = softmax_xent(tsmall.client_apply(live, cid, torch.from_numpy(x)),
                      torch.from_numpy(y))
    gt = torch.autograd.grad(lt, tree_leaves(live))
    np.testing.assert_allclose(lt.item(), float(lj), **TOL)
    for block in ("base", "modular"):
        for i, layer in enumerate(gj[block]):
            for name in ("w", "b"):
                leaf = live[block][i][name]
                g = gt[[id(t) for t in tree_leaves(live)].index(id(leaf))]
                np.testing.assert_allclose(g.numpy(), np.asarray(layer[name]),
                                           **TOL, err_msg=f"{block}/{i}/{name}")


@pytest.mark.parametrize("cid", [1, 2])
def test_flatten_runs_in_hwc_order(cid):
    """Client 1's conv fusion layer and client 2's fc 1568 -> 432 read the
    NHWC feature map flattened as (H, W, C). Flattening as (C, H, W), the
    NCHW habit, gives other features: this input tells the two apart."""
    jp, tp = carried(cid)
    x, _ = images()
    zj = np.asarray(jsmall.client_base_apply(jp, cid, jnp.asarray(x)))
    zt = tsmall.client_base_apply(tp, cid, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(zt, zj, **TOL)

    # The same layers with a (C, H, W) flatten.
    h = torch.from_numpy(x)
    descs = tsmall.CLIENT_ARCHS[cid]["base"]
    for p, d in zip(tp["base"], descs):
        if d[0] == "conv":
            h = tsmall._conv_pool_relu(p, h)
        else:
            h = torch.relu(h.permute(0, 3, 1, 2).reshape(h.shape[0], -1)
                           @ p["w"] + p["b"])
    if h.dim() == 4:
        h = torch.relu(h.permute(0, 3, 1, 2).reshape(h.shape[0], -1))
    assert np.abs(h.numpy() - zj).max() > 1e-2


def test_init_draws_the_reference_distributions():
    gen = torch.Generator().manual_seed(0)
    for cid in (1, 2, 3, 4):
        tp = tsmall.init_client_model(cid, generator=gen)
        jp = jsmall.init_client_model(jax.random.PRNGKey(0), cid)
        shapes_t = [tuple(a.shape) for a in tree_leaves(tp)]
        shapes_j = [a.shape for blk in ("base", "modular")
                    for layer in jp[blk] for a in (layer["b"], layer["w"])]
        assert sorted(shapes_t) == sorted(shapes_j)
        assert all(torch.all(layer["b"] == 0) for blk in tp.values()
                   for layer in blk)
        w = tp["base"][-1]["w"]
        fan_in = int(np.prod(w.shape[:-1]))
        assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.1
