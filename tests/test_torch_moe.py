"""The port's MoE channel mixer (``repro_torch.models.moe``) against the
JAX package's ``repro.models.moe``, on the reduced deepseek-v3-671b
widths (d 256, 4 experts, top-2, one shared expert, moe_d_ff 256) and
jamba-1.5-large-398b's (no shared expert), fp32.

Params are drawn by the port's init from a seeded generator and handed
to both packages as the same numpy arrays; inputs are made with numpy
from a seed. Expert choices, ranks and dropped entries are held exactly;
outputs, the auxiliary loss and gradients within 1e-5 of the largest
reference magnitude (fp32 on both sides, sums in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import moe as jmoe
from repro.models import modules as jnn
from repro_torch.config import ModelConfig
from repro_torch.configs import get_config
from repro_torch.core.ifl_spmd import value_and_grad
from repro_torch.models import moe

REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one intra-op thread: its steps are many small
    ops, and test workers each spinning a thread a core over them run
    many times slower than alone (a lane step or a training round here
    took 100x its time alone in a full parallel run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else v.detach().numpy()
            for k, v in tree.items()}


def _jax(tree):
    return jax.tree.map(jnp.asarray, _numpy(tree))


def _close(got, ref, rel=REL):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.all(np.isfinite(got))
    assert np.max(np.abs(got - ref)) <= rel * max(1.0, np.max(np.abs(ref)))


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _cfgs(arch, **kw):
    return (get_config(arch).reduced().replace(**kw),
            jax_get_config(arch).reduced().replace(**kw))


def _jax_choices(jp, jcfg, x):
    """The reference's routing of x (B, S, d): (idx (T, K), rank (T*K,),
    keep (T*K,)), from its own functions."""
    T = x.shape[0] * x.shape[1]
    logits = jnn.linear(jp["router"], jnp.asarray(x).reshape(T, -1))
    _, idx = jax.lax.top_k(jax.nn.softmax(logits.astype(jnp.float32), -1),
                           jcfg.num_experts_per_tok)
    e_flat = idx.reshape(-1).astype(jnp.int32)
    rank = jmoe._rank_in_expert(e_flat, jcfg.num_experts)
    return (np.asarray(idx), np.asarray(rank),
            np.asarray(rank < jmoe._capacity(T, jcfg)))


def _port_choices(p, cfg, x):
    xt = torch.from_numpy(x)
    _, _, idx = moe.route(p, cfg, xt)
    rank = moe.rank_in_expert(idx.reshape(-1), cfg.num_experts)
    T = x.shape[0] * x.shape[1]
    return idx.numpy(), rank.numpy(), (rank < moe._capacity(T, cfg)).numpy()


# ------------------------------------------- mirrors of test_models.py


def _small_cfg(cls, k, cf):
    return cls(d_model=32, num_experts=4, num_experts_per_tok=k,
               moe_d_ff=64, capacity_factor=cf, num_heads=2, num_kv_heads=2,
               compute_dtype="float32").validate()


def test_moe_all_tokens_routed_with_slack_capacity():
    cfg = _small_cfg(ModelConfig, 2, 8.0)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(_x((2, 16, 32), 1))
    y, aux = moe.moe_forward(p, cfg, x)
    assert y.shape == x.shape
    assert float(aux) > 0  # load-balance loss active
    # With high capacity every token's output is non-zero.
    assert float(torch.linalg.norm(y, dim=-1).min()) > 0


def test_moe_capacity_drops_tokens_deterministically():
    cfg_hi = _small_cfg(ModelConfig, 1, 8.0)
    cfg_lo = cfg_hi.replace(capacity_factor=0.25)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg_hi)
    x = torch.from_numpy(_x((1, 64, 32), 1))
    y_hi, _ = moe.moe_forward(p, cfg_hi, x)
    y_lo, _ = moe.moe_forward(p, cfg_lo, x)
    # Low capacity zeroes some tokens' routed contribution.
    dropped = int((torch.linalg.norm(y_lo, dim=-1) < 1e-9).sum())
    kept = int((torch.linalg.norm(y_hi, dim=-1) < 1e-9).sum())
    assert dropped > kept
    assert torch.equal(y_lo, moe.moe_forward(p, cfg_lo, x)[0])


# ------------------------------------------------------- against JAX


@pytest.fixture(scope="module", params=["deepseek-v3-671b",
                                        "jamba-1.5-large-398b"])
def case(request):
    """Params, inputs and the reference's forward, aux and gradients at
    slack (1.25) and tight (0.5) capacity, computed once."""
    out = {}
    for cf in (1.25, 0.5):
        cfg, jcfg = _cfgs(request.param, capacity_factor=cf)
        p = moe.init_moe(torch.Generator().manual_seed(3), cfg)
        jp = _jax(p)
        x = _x((2, 64, cfg.d_model), 5)
        w = _x((2, 64, cfg.d_model), 6)

        def loss(jp_, x_):
            y, aux = jmoe.moe_forward(jp_, jcfg, x_)
            return jnp.sum(y * w) + aux, (y, aux)

        (_, (y, aux)), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
        out[cf] = dict(cfg=cfg, jcfg=jcfg, p=p, jp=jp, x=x, w=w,
                       y=np.asarray(y), aux=float(aux),
                       grads=jax.tree.map(np.asarray, grads),
                       choices=_jax_choices(jp, jcfg, x))
    return out


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_choices_ranks_and_drops_match_jax(case, cf):
    c = case[cf]
    got = _port_choices(c["p"], c["cfg"], c["x"])
    for a, b in zip(got, c["choices"]):
        np.testing.assert_array_equal(a, b)
    if cf == 0.5:  # the tight capacity does drop entries
        assert not got[2].all()


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_forward_aux_and_grads_match_jax(case, cf):
    c = case[cf]
    cfg = c["cfg"]
    x = torch.from_numpy(c["x"])
    y, aux = moe.moe_forward(c["p"], cfg, x)
    _close(y, c["y"])
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), c["aux"], rtol=REL, atol=1e-7)
    w = torch.from_numpy(c["w"])

    def loss(tree):
        y_, a_ = moe.moe_forward(tree["p"], cfg, tree["x"])
        return torch.sum(y_ * w) + a_

    _, g = value_and_grad(loss, {"p": c["p"], "x": x})
    jg_p, jg_x = c["grads"]
    _close(g["x"], jg_x)
    flat = jax.tree_util.tree_flatten_with_path(jg_p)[0]
    for path, want in flat:
        got = g["p"]
        for k in path:
            got = got[k.key]
        _close(got, want)
    # An expert that received no entry has an exactly zero gradient.
    for e in range(cfg.num_experts):
        if not np.any(c["choices"][0] == e):
            assert float(g["p"]["experts"]["w_up"]["w"][e].abs().max()) == 0


def test_aux_is_switch_loss_of_the_routing(case):
    """aux == E * sum_e f_e * p_e * coef, f counting dropped entries too."""
    c = case[0.5]
    cfg = c["cfg"]
    x = torch.from_numpy(c["x"])
    probs, _, idx = moe.route(c["p"], cfg, x)
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    f = torch.bincount(idx.reshape(-1), minlength=E).float() / idx.numel()
    want = E * float((f * probs.mean(0)).sum()) * cfg.router_aux_coef
    np.testing.assert_allclose(float(moe.moe_forward(c["p"], cfg, x)[1]),
                               want, rtol=1e-6)
    assert idx.shape == (x.shape[0] * x.shape[1], K)


def test_top_k_ties_pick_the_lower_expert_first():
    """Equal probabilities: jax.lax.top_k takes the lower index first;
    the port's stable sort does the same (torch.topk promises no
    order). Columns 1 and 3 of the router are equal, and a zero router
    ties all four experts."""
    cfg, jcfg = _cfgs("jamba-1.5-large-398b")
    p = moe.init_moe(torch.Generator().manual_seed(1), cfg)
    w = p["router"]["w"]
    w[:, 3] = w[:, 1]
    x = _x((1, 32, cfg.d_model), 2)
    for router in (w, torch.zeros_like(w)):
        p["router"]["w"] = router
        got = _port_choices(p, cfg, x)
        want = _jax_choices(_jax(p), jcfg, x)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert (got[0] == [0, 1]).all()  # all tied: experts 0 and 1


@pytest.mark.parametrize("per_row", [False, True])
def test_decode_rows_match_vmap_of_the_b1_step(per_row):
    """moe_decode over W 5 rows == jax.vmap of the reference's B=1
    moe_forward over the rows, with shared or per-row (a lane's per-slot
    base) weights. Every row is steered to expert 2: with E 4, K 2 one
    joint capacity over the 5 rows, max(int(5 * 2 * 1.25 / 4), 4) = 4,
    would drop the fifth row's choice; each row routed alone drops
    none."""
    W = 5
    cfg, jcfg = _cfgs("deepseek-v3-671b")
    p = moe.init_moe(torch.Generator().manual_seed(4), cfg,
                     lead=(W,) if per_row else ())
    x = torch.from_numpy(_x((W, 1, cfg.d_model), 8))
    bias = torch.zeros(cfg.num_experts, 1)
    bias[2] = 50.0
    for b in range(W):  # a direction that adds 50 to expert 2's logit
        rw = p["router"]["w"][b] if per_row else p["router"]["w"]
        x[b, 0] += torch.linalg.lstsq(rw.T, bias).solution[:, 0]
    idx = moe.route(p, cfg, x)[2]
    assert (idx == 2).any(dim=1).all()
    y = moe.moe_decode(p, cfg, x)
    jp, jx = _jax(p), jnp.asarray(x.numpy())

    def one(prow, xrow):
        return jmoe.moe_forward(prow, jcfg, xrow[None])[0][0]

    if per_row:
        want = jax.jit(jax.vmap(one))(jp, jx)
    else:
        want = jax.jit(jax.vmap(lambda xrow: one(jp, xrow)))(jx)
    _close(y, want)
    if not per_row:  # one joint capacity drops a choice
        joint, _ = moe.moe_forward(p, cfg, x.reshape(1, W, -1))
        assert float((joint.reshape(W, 1, -1) - y).abs().max()) > 1e-3

