"""The port's xLSTM blocks (``repro_torch.models.xlstm``) against the
JAX package's ``repro.models.xlstm``, on the reduced xlstm-350m config
(d_model 256, 4 heads, d_inner 512, vocab 512, fp32). Inputs are made
with numpy from a seed. Params are drawn by the port's own init from a
seeded generator and handed to both packages as the same numpy arrays
(``jax.eval_shape`` of the reference's init checks that keys and shapes
agree): the JAX init compiles for seconds.

Tolerances: forwards and decodes within 1e-5 of the largest |reference|
value. Gradients: the two fp32 computations sum in different orders, and
through 8 recurrent layers each lands up to ~1e-4 of a leaf's largest
|value| from the exact gradient, JAX's further than the port's. So the
port's gradients are held within 1e-4 of its own fp64 gradients (the
bound rounding alone sets), and the port's and JAX's fp32 gradients
within 3e-4 of each other and of the fp64 ones.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.configs import get_config as jax_get_config
from repro.models import transformer as jtf
from repro.models import xlstm as jxl
from repro_torch.checkpoint import cache_from_numpy, params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import transformer as tf
from repro_torch.models import xlstm as xl

ARCH = "xlstm-350m"
B, S = 2, 32


def _close(got, ref, rel):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.all(np.isfinite(got))
    err = float(np.max(np.abs(got - ref)))
    assert err <= rel * float(np.max(np.abs(ref))), (err, rel)


def _cfgs(chunk=16):
    return (get_config(ARCH).reduced().replace(mlstm_chunk=chunk),
            jax_get_config(ARCH).reduced().replace(mlstm_chunk=chunk))


def _fast_compile(fn, cfg, *args):
    """fn(·, cfg, ·) compiled for args' shapes with XLA's LLVM backend at
    optimization level 0: the reduced LM's value-and-grad compiles in
    ~9 s where the default takes ~18 s (one core). It changes how the CPU
    code is generated, not the operations or their order."""
    low = jax.jit(fn, static_argnums=1).lower(args[0], cfg, *args[1:])
    return low.compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})


def _fast_jit(fn, cfg, *args):
    """fn(args[0], cfg, *args[1:]), compiled by ``_fast_compile``."""
    return _fast_compile(fn, cfg, *args)(args[0], *args[1:])


def _x(seed=0, shape=(B, S, 256)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


_BLOCKS = {
    "mlstm": (jxl.init_mlstm, jxl.mlstm_forward, jxl.init_mlstm_cache,
              jxl.mlstm_decode, xl.mlstm_forward, xl.init_mlstm_cache,
              xl.mlstm_decode),
    "slstm": (jxl.init_slstm, jxl.slstm_forward, jxl.init_slstm_cache,
              jxl.slstm_decode, xl.slstm_forward, xl.init_slstm_cache,
              xl.slstm_decode),
}


_INIT = {"mlstm": xl.init_mlstm, "slstm": xl.init_slstm}


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else v.detach().numpy()
            for k, v in tree.items()}


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


def _block(kind, jcfg, seed=1):
    cfg = get_config(ARCH).reduced().replace(mlstm_chunk=jcfg.mlstm_chunk)
    p = _INIT[kind](torch.Generator().manual_seed(seed), cfg)
    jshape = jax.eval_shape(lambda k: _BLOCKS[kind][0](k, jcfg),
                            jax.random.PRNGKey(0))
    assert _shapes(p) == _shapes(jshape)
    return jax.tree.map(jnp.asarray, _numpy(p)), p


@pytest.mark.parametrize("kind,chunk", [("mlstm", 8), ("mlstm", 16),
                                        ("slstm", 16)])
def test_forward_matches_jax(kind, chunk):
    cfg, jcfg = _cfgs(chunk)
    jp, p = _block(kind, jcfg)
    x = _x()
    ref = _fast_jit(_BLOCKS[kind][1], jcfg, jp, jnp.asarray(x))
    _close(_BLOCKS[kind][4](p, cfg, torch.from_numpy(x)), ref, 1e-5)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_steps_match_jax(kind):
    cfg, jcfg = _cfgs()
    jp, p = _block(kind, jcfg)
    _, _, jinit, jdec, _, init, dec = _BLOCKS[kind]
    jdec = jax.jit(jdec, static_argnums=1)
    jcache = jinit(jcfg, B, jnp.float32)
    cache = init(cfg, B, torch.float32)
    # The fresh caches agree, -inf stabilizers included.
    for k, v in cache_from_numpy(jax.tree.map(np.asarray, jcache),
                                 device="cpu").items():
        assert torch.equal(v, cache[k]), k
    x = _x(2, (B, 6, 256))
    for t in range(6):
        ref, jcache = jdec(jp, jcfg, jnp.asarray(x[:, t:t + 1]), jcache)
        _close(dec(p, cfg, torch.from_numpy(x[:, t:t + 1]), cache), ref,
               1e-5)
    for k, v in jcache.items():
        _close(cache[k], v, 1e-5)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_forward_equals_own_stepwise_decode(kind):
    cfg, jcfg = _cfgs(8)
    _, p = _block(kind, jcfg)
    _, _, _, _, fwd, init, dec = _BLOCKS[kind]
    x = torch.from_numpy(_x(3, (B, 16, 256)))
    full = fwd(p, cfg, x)
    cache = init(cfg, B, torch.float32)
    steps = torch.cat([dec(p, cfg, x[:, t:t + 1], cache) for t in range(16)],
                      dim=1)
    _close(steps, full.numpy(), 1e-5)


def test_decode_live_mask_keeps_old_state():
    cfg, jcfg = _cfgs()
    for kind in ("mlstm", "slstm"):
        _, p = _block(kind, jcfg)
        _, _, _, _, _, init, dec = _BLOCKS[kind]
        cache = init(cfg, B, torch.float32)
        x = torch.from_numpy(_x(4, (B, 1, 256)))
        dec(p, cfg, x, cache, torch.tensor([True, False]))
        fresh = init(cfg, 1, torch.float32)
        for k, v in cache.items():
            assert torch.equal(v[1:], fresh[k]), (kind, k)
            assert not torch.equal(v[:1], fresh[k]), (kind, k)


@pytest.fixture(scope="module")
def lm_case():
    cfg, jcfg = _cfgs()
    params = tf.init_lm(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    assert _shapes(params) == _shapes(
        jax.eval_shape(lambda k: jtf.init_lm(k, jcfg), jax.random.PRNGKey(0)))
    jp = _numpy(params)
    toks = np.random.default_rng(5).integers(0, 512, (B, S)).astype(np.int32)
    step = _fast_compile(jax.value_and_grad(jtf.lm_loss), jcfg,
                         jax.tree.map(jnp.asarray, jp),
                         {"tokens": jnp.asarray(toks)})
    loss, grads = step(jax.tree.map(jnp.asarray, jp),
                       {"tokens": jnp.asarray(toks)})
    return cfg, jp, toks, loss, grads, step


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def _loss_grads(cfg, jp, toks, dtype):
    params = params_from_numpy(jp, device="cpu", dtype=dtype)
    leaves = _flat(params)
    for t in leaves.values():
        t.requires_grad_(True)
    cdt = "float64" if dtype == torch.float64 else "float32"
    loss = tf.lm_loss(params, cfg.replace(compute_dtype=cdt),
                      {"tokens": torch.from_numpy(toks)})
    loss.backward()
    return float(loss.detach()), {k: t.grad for k, t in leaves.items()}


def test_lm_loss_and_gradients_match_jax(lm_case):
    cfg, jp, toks, jloss, jgrads, _ = lm_case
    loss, grads = _loss_grads(cfg, jp, toks, torch.float32)
    _, exact = _loss_grads(cfg, jp, toks, torch.float64)
    assert math.isfinite(loss)
    assert abs(loss - float(jloss)) <= 1e-5 * abs(float(jloss))
    jflat = _flat(jax.tree.map(np.asarray, jgrads))
    assert set(jflat) == set(grads)
    for k, g in grads.items():
        assert g is not None, k
        # No NaN from the -inf initial stabilizers of either block.
        assert torch.all(torch.isfinite(g)), k
        _close(g, jflat[k], 3e-4)
        _close(g.double(), exact[k].numpy(), 1e-4)
        _close(jflat[k].astype(np.float64), exact[k].numpy(), 3e-4)


def test_sgd_step_at_the_cli_lr_follows_jax(lm_case):
    """One plain SGD step at ``launch.train``'s lr 3e-3 (the DP baseline's
    update, ``make_dp_train_step``) from the same init and batch: the
    loss after the step follows the reference's within 1e-4 of its value
    (the gradients agree within 3e-4 of a leaf's largest value, above;
    readings: 3.6e-6), and it is lower than before the step."""
    from repro_torch.core.ifl_spmd import make_dp_train_step
    from repro_torch.optim.optim import make_optimizer

    cfg, jp, toks, jloss, jgrads, step = lm_case
    lr = 3e-3
    batch = {"tokens": torch.from_numpy(toks)}
    params = params_from_numpy(jp, device="cpu", dtype=torch.float32)
    params, _, m = make_dp_train_step(cfg, lr=lr)(
        params, make_optimizer("sgd").init(params), batch)
    with torch.no_grad():
        after = float(tf.lm_loss(params, cfg, batch))
    jparams = jax.tree.map(lambda a, g: jnp.asarray(a) - lr * g, jp, jgrads)
    jafter = float(step(jparams, {"tokens": jnp.asarray(toks)})[0])
    assert math.isfinite(after)
    assert abs(after - jafter) <= 1e-4 * abs(jafter), (after, jafter)
    assert after < float(m["loss"]), (float(m["loss"]), after)
