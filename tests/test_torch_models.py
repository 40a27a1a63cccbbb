"""The port's model modules against the JAX package, on the reduced
qwen1.5-0.5b config (2 layers, d_model 256, vocab 512, d_fusion 128,
fp32). JAX-initialized params are carried into the port with
``params_from_numpy``; inputs are made with numpy from a seed. Logits
and activations agree within rtol = atol = 1e-4 (both sides compute in
fp32 and sum in different orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import modules as jnn
from repro.models import transformer as jtf
from repro.models.mlp import init_mlp as jax_init_mlp
from repro.models.mlp import mlp_forward as jax_mlp_forward
from repro.models.rope import apply_rope as jax_apply_rope
from repro_torch.checkpoint import (
    load_checkpoint,
    params_from_numpy,
    save_checkpoint,
)
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import modules as nn
from repro_torch.models import transformer as tf
from repro_torch.models.attention import attn_decode, init_attn_cache
from repro_torch.models.mlp import mlp_forward
from repro_torch.models.rope import apply_rope

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "qwen1.5-0.5b"


@pytest.fixture(scope="module")
def cfg():
    return get_config(ARCH).reduced()


@pytest.fixture(scope="module")
def jcfg():
    return jax_get_config(ARCH).reduced()


@pytest.fixture(scope="module")
def jparams(jcfg):
    return jtf.init_lm(jax.random.PRNGKey(0), jcfg)


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = v
    return out


# ------------------------------------------------------------- configs


def test_configs_match_the_jax_registry():
    assert ARCH_IDS == JAX_ARCH_IDS
    for arch in ARCH_IDS:
        a, b = get_config(arch), jax_get_config(arch)
        assert dataclasses.asdict(a) == dataclasses.asdict(b), arch
        assert dataclasses.asdict(a.reduced()) == \
            dataclasses.asdict(b.reduced()), arch


@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b",
                                  "qwen1.5-0.5b+softcap",
                                  "seamless-m4t-large-v2", "qwen2-vl-2b",
                                  "gemma3-27b"])
def test_uncovered_families_raise(arch):
    # The families item 4a-iii ported, which raised before it: qk-norm
    # (llama4, gemma3), a logit softcap, M-RoPE with images (qwen2-vl),
    # the encoder and cross-attention (seamless). ``init_lm`` builds each
    # with the reference's tree and shapes.
    name, _, extra = arch.partition("+")
    cfg, jcfg = get_config(name).reduced(), jax_get_config(name).reduced()
    if extra == "softcap":
        cfg, jcfg = (c.replace(logit_softcap=30.0) for c in (cfg, jcfg))
    p = tf.init_lm(tf.check_supported(cfg),
                   generator=torch.Generator().manual_seed(0), device="cpu")
    want = jax.eval_shape(lambda k: jtf.init_lm(k, jcfg),
                          jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in _flat(p).items()} == {
        k: tuple(v.shape) for k, v in _flat(want).items()}


# ------------------------------------------------------------- modules


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "nonparam_ln"])
def test_apply_norm(kind):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 2, 64)).astype(np.float32) * 3
    p = {}
    if kind != "nonparam_ln":
        p["scale"] = rng.standard_normal(64).astype(np.float32)
    if kind == "layernorm":
        p["bias"] = rng.standard_normal(64).astype(np.float32)
    want = jnn.apply_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x), kind)
    got = nn.apply_norm(params_from_numpy(p, device="cpu"),
                        torch.from_numpy(x), kind)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_apply_norm_per_row_scale_equals_rowwise_calls():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((3, 1, 32)).astype(np.float32))
    scale = torch.from_numpy(rng.standard_normal((3, 32)).astype(np.float32))
    got = nn.apply_norm({"scale": scale}, x, "rmsnorm")
    for b in range(3):
        assert torch.equal(got[b], nn.apply_norm({"scale": scale[b]},
                                                 x[b:b + 1], "rmsnorm")[0])


def test_apply_rope_per_row_positions():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 2, 4, 64)).astype(np.float32)
    pos = np.array([[0, 1], [7, 8], [30, 31]], np.int32)
    want = jax_apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos).long(), 1e6)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_mlp_forward(cfg):
    p = jax_init_mlp(jax.random.PRNGKey(3), cfg.d_model, cfg.d_ff)
    x = np.random.default_rng(3).standard_normal(
        (2, 1, cfg.d_model)).astype(np.float32)
    want = jax_mlp_forward(p, jnp.asarray(x), cfg.act)
    got = mlp_forward(params_from_numpy(jax.tree.map(np.asarray, p),
                                        device="cpu"),
                      torch.from_numpy(x), cfg.act)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_linear_per_row_weights_equal_rowwise_products():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((3, 1, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 16, 8)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((3, 8)).astype(np.float32))
    got = nn.linear({"w": w, "b": b}, x)
    for r in range(3):
        want = nn.linear({"w": w[r], "b": b[r]}, x[r:r + 1])
        torch.testing.assert_close(got[r:r + 1], want, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------- attention


def _filled_slot_pos(L, pos, window):
    """slot_pos after writing positions 0..pos-1 (the ring/clamp rule)."""
    sp = np.full((L,), -1, np.int64)
    for p in range(pos):
        sp[p % L if window > 0 else min(p, L - 1)] = p
    return sp


@pytest.mark.parametrize("window", [-1, 8])
def test_attn_decode_per_row_positions(cfg, jcfg, jparams, params, window):
    """Three rows at three different positions in one call, against
    three B=1 JAX calls with scalar positions."""
    spec = dataclasses.replace(cfg.layer_specs()[0], window=window)
    jspec = dataclasses.replace(jcfg.layer_specs()[0], window=window)
    rng = np.random.default_rng(5)
    cache_len, positions = 16, [3, 9, 14]
    jp = jax.tree.map(lambda a: a[0], jparams["base"]["groups"]["l0"]["attn"])
    tp = nn.tree_index(params["base"]["groups"]["l0"]["attn"], 0)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    cache = init_attn_cache(cfg, spec, 3, cache_len, torch.float32)
    L = cache["k"].shape[1]
    kv = rng.standard_normal((2, 3, L, cfg.num_kv_heads,
                              cfg.resolved_head_dim)).astype(np.float32)
    step = jax.jit(lambda c, xb, pos: jattn.attn_decode(jp, jcfg, jspec, xb,
                                                        c, pos))
    want_y, want_k = [], []
    for b, pos in enumerate(positions):
        sp = _filled_slot_pos(L, pos, window)
        cache["k"][b] = torch.from_numpy(kv[0, b])
        cache["v"][b] = torch.from_numpy(kv[1, b])
        cache["slot_pos"][b] = torch.from_numpy(sp)
        jc = {"k": jnp.asarray(kv[0, b:b + 1]), "v": jnp.asarray(kv[1, b:b + 1]),
              "slot_pos": jnp.asarray(sp, jnp.int32)}
        y, jc = step(jc, jnp.asarray(x[b:b + 1]), jnp.int32(pos))
        want_y.append(np.asarray(y)[0])
        want_k.append(np.asarray(jc["k"])[0])
    y = attn_decode(tp, cfg, spec, torch.from_numpy(x), cache,
                    torch.tensor(positions))
    np.testing.assert_allclose(_np(y), np.stack(want_y), **TOL)
    np.testing.assert_allclose(_np(cache["k"]), np.stack(want_k), **TOL)


# ---------------------------------------------------------- full model


def test_init_lm_keys_and_shapes_match_jax(cfg, jparams):
    ours = _flat(tf.init_lm(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu"))
    theirs = _flat(jax.tree.map(np.asarray, jparams))
    assert ours.keys() == theirs.keys()
    for k, v in ours.items():
        assert tuple(v.shape) == theirs[k].shape, k
        assert v.dtype == torch.float32, k
        if k.endswith("/b"):
            assert torch.all(v == 0), k
        if k.endswith("/scale"):
            assert torch.all(v == 1), k
    w = ours["base/fusion_in/w"]
    assert abs(float(w.std()) - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5


def test_composed_decode_steps_match_jax(cfg, jcfg, jparams, params):
    B, steps, cache_len = 3, 10, 16
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (steps, B))
    jcache = jtf.init_composed_cache(jcfg, jcfg, B, cache_len)
    cache = tf.init_composed_cache(cfg, cfg, B, cache_len, device="cpu")
    step = jax.jit(lambda c, tok, pos: jtf.composed_decode_step(
        jparams["base"], jcfg, jparams["modular"], jcfg, c, tok, pos))
    for t in range(steps):
        jl, jcache = step(jcache, jnp.asarray(toks[t][:, None], jnp.int32),
                          jnp.int32(t))
        tl, cache = tf.composed_decode_step(
            params["base"], cfg, params["modular"], cfg, cache,
            torch.from_numpy(toks[t][:, None]).long(),
            torch.full((B,), t, dtype=torch.long))
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL,
                                   err_msg=f"step {t}")


def test_composed_prefill_ragged_matches_jax(cfg, jcfg, jparams, params):
    P, lengths = 8, [5, 8, 3, 0]
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (4, P))
    cache = tf.init_composed_cache(cfg, cfg, 4, 16, device="cpu")
    last, cache = tf.composed_prefill_ragged(
        params["base"], cfg, params["modular"], cfg, cache,
        torch.from_numpy(toks).long(), torch.tensor(lengths))
    prefill = jax.jit(lambda tk, ln: jtf.composed_prefill_ragged(
        jparams["base"], jcfg, jparams["modular"], jcfg,
        jtf.init_composed_cache(jcfg, jcfg, 1, 16), tk, ln))
    for b, n in enumerate(lengths[:3]):
        want, jc = prefill(jnp.asarray(toks[b], jnp.int32), jnp.int32(n))
        np.testing.assert_allclose(_np(last[b]), np.asarray(want), **TOL)
        k = cache["base"]["l0"]["mix"]["k"][0, b]   # group 0, row b
        np.testing.assert_allclose(
            _np(k), np.asarray(jc["base"]["l0"]["mix"]["k"])[0, 0], **TOL)
        sp = cache["base"]["l0"]["mix"]["slot_pos"][0, b]
        assert sp.tolist() == list(range(n)) + [-1] * (16 - n)
    # The length-0 row is untouched: fresh cache, zero logits.
    assert torch.all(last[3] == 0)
    assert torch.all(cache["mod"]["l0"]["mix"]["slot_pos"][0, 3] == -1)
    assert torch.all(cache["mod"]["l0"]["mix"]["k"][0, 3] == 0)


# ---------------------------------------------------------- checkpoint


def test_checkpoint_round_trip(tmp_path, params):
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, params, step=3)
    template = nn.tree_map(torch.zeros_like, params)
    back = _flat(load_checkpoint(path, template))
    for k, v in _flat(params).items():
        assert torch.equal(back[k], v), k
