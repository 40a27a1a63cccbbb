"""The port's Mamba mixer (``repro_torch.models.ssm``) against the JAX
package's ``repro.models.ssm``, on jamba-1.5-large-398b's reduced widths
(d_state 16, d_conv 4, expand 2), and a small Mamba hybrid LM (Jamba's
layer pattern cut to one period of 4 with dense FFNs, since MoE is not
ported yet) against the reference's transformer. Params are drawn by the
port's init from a seeded generator and handed to both packages as the
same numpy arrays; inputs are made with numpy from a seed.

Tolerances: 1e-5 of the largest |reference| value. The in-chunk scan is
a Hillis-Steele scan where the reference runs ``associative_scan``, so
the two multiply in other orders and agree to fp32 rounding, well
inside the bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import LayerSpec as JLayerSpec
from repro.configs import get_config as jax_get_config
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro_torch.checkpoint import cache_from_numpy, params_from_numpy
from repro_torch.config import LayerSpec
from repro_torch.configs import get_config
from repro_torch.models import ssm
from repro_torch.models import transformer as tf

ARCH = "jamba-1.5-large-398b"


def _cfgs(d_model):
    return (get_config(ARCH).reduced().replace(d_model=d_model),
            jax_get_config(ARCH).reduced().replace(d_model=d_model))


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else v.detach().numpy()
            for k, v in tree.items()}


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


def _close(got, ref, rel=1e-5):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.all(np.isfinite(got))
    assert np.max(np.abs(got - ref)) <= rel * np.max(np.abs(ref))


def _mamba(d_model, seed=1):
    cfg, jcfg = _cfgs(d_model)
    p = ssm.init_mamba(torch.Generator().manual_seed(seed), cfg)
    assert _shapes(p) == _shapes(jax.eval_shape(
        lambda k: jssm.init_mamba(k, jcfg), jax.random.PRNGKey(0)))
    return cfg, jcfg, p, jax.tree.map(jnp.asarray, _numpy(p))


def _fast_jit(fn, cfg, *args):
    """fn(args[0], cfg, *args[1:]) jitted with XLA's LLVM backend at
    optimization level 0: it compiles in about half the time and changes
    how the CPU code is generated, not the operations or their order."""
    low = jax.jit(fn, static_argnums=1).lower(args[0], cfg, *args[1:])
    return low.compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})(args[0], *args[1:])


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_forward_across_chunks_matches_jax():
    cfg, jcfg, p, jp = _mamba(64)
    S = 2 * ssm.CHUNK  # two chunks: the state crosses a chunk boundary
    x = _x((2, S, 64))
    ref = _fast_jit(jssm.mamba_forward, jcfg, jp, jnp.asarray(x))
    _close(ssm.mamba_forward(p, cfg, torch.from_numpy(x)), ref)


def test_decode_steps_match_jax_and_own_forward():
    cfg, jcfg, p, jp = _mamba(128)
    jcache = jssm.init_mamba_cache(jcfg, 2, jnp.float32)
    cache = ssm.init_mamba_cache(cfg, 2, torch.float32)
    for k, v in cache_from_numpy(jax.tree.map(np.asarray, jcache),
                                 device="cpu").items():
        assert torch.equal(v, cache[k]), k
    x = _x((2, 8, 128), 2)
    outs = []
    jdec = jax.jit(jssm.mamba_decode, static_argnums=1)
    for t in range(8):
        ref, jcache = jdec(jp, jcfg, jnp.asarray(x[:, t:t + 1]), jcache)
        outs.append(ssm.mamba_decode(p, cfg, torch.from_numpy(x[:, t:t + 1]),
                                     cache))
        _close(outs[-1], ref)
    for k, v in jcache.items():
        _close(cache[k], v)
    _close(torch.cat(outs, 1),
           ssm.mamba_forward(p, cfg, torch.from_numpy(x)).numpy())


def test_state_dtype_is_the_compute_dtype():
    cfg, jcfg, p, jp = _mamba(64)
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                    (torch.float32, jnp.float32)):
        cache = ssm.init_mamba_cache(cfg, 2, dt)
        jcache = jssm.init_mamba_cache(jcfg, 2, jdt)
        pc = {k: v.to(dt) for k, v in p.items() if not isinstance(v, dict)}
        pc.update({k: v for k, v in p.items() if isinstance(v, dict)})
        x = torch.from_numpy(_x((2, 1, 64))).to(dt)
        ssm.mamba_decode(pc, cfg, x, cache)
        for k, v in cache.items():
            assert v.dtype == dt, k
            assert str(jcache[k].dtype) == str(dt).split(".")[-1], k


def _hybrid(spec_cls, get):
    pat = tuple(spec_cls(mixer="attn" if i == 3 else "mamba", ffn="dense",
                         use_rope=False) for i in range(4))
    return get(ARCH).reduced().replace(
        name="jamba-hybrid-smoke", num_layers=8, num_experts=0,
        num_experts_per_tok=0, base_pattern=pat, mod_pattern=pat,
        d_model=128).validate()


def test_hybrid_lm_matches_jax():
    cfg = _hybrid(LayerSpec, get_config)
    jcfg = _hybrid(JLayerSpec, jax_get_config)
    params = tf.init_lm(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    assert _shapes(params) == _shapes(jax.eval_shape(
        lambda k: jtf.init_lm(k, jcfg), jax.random.PRNGKey(0)))
    jp = jax.tree.map(jnp.asarray, _numpy(params))
    toks = np.random.default_rng(3).integers(0, 512, (2, 64)).astype(np.int32)
    jlogits, _, _ = _fast_jit(jtf.lm_apply, jcfg, jp,
                              {"tokens": jnp.asarray(toks)})
    logits, _, _ = tf.lm_apply(params_from_numpy(_numpy(params),
                                                 device="cpu"),
                               cfg, {"tokens": torch.from_numpy(toks)})
    _close(logits, jlogits)


@pytest.mark.parametrize("lead", [(), (3,)])
def test_init_cache_lead_dims(lead):
    cfg, _ = _cfgs(64)
    c = ssm.init_mamba_cache(cfg, 2, torch.float32, lead=lead)
    assert c["ssm_h"].shape == (*lead, 2, 128, 16)
    assert c["ssm_conv"].shape == (*lead, 2, 3, 128)
