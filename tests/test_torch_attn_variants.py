"""The port's last attention variants against the JAX package on the CPU:
qk-norm (the reduced llama4-maverick-400b-a17b, with its NoPE global
layer and MoE, and gemma3-27b, with its local prefix layers), a logit
softcap (``qwen1.5-0.5b+softcap``, the reduced qwen1.5-0.5b with
``logit_softcap=30``) and M-RoPE with the image-token frontend (the
reduced qwen2-vl-2b, 16 image rows under a 4 x 4 grid), fp32, B 2, S 64.
gemma3's reduced 5:1 pattern is cut to its last local and its global
layer in each half (6 layers, its 2 local prefix layers kept) and
llama4's period of 4 to its local dense and its NoPE global MoE layer in
each half (4 layers), as ``test_torch_mla_mtp.py`` cuts jamba to one
period: tracing the reference's gradients of all 14 and 8 layers took
17 s and 12 s of this file's time.

Params are drawn by the port's init and handed to both packages as the
same numpy arrays; tokens and image rows are made with numpy from a
seed. The reference's forward, loss and gradients run once per config
in a module fixture, compiled once. Tolerances: z, logits, losses and
gradients within 1e-5 of the largest reference magnitude (fp32 on both
sides, sums in other orders); integer positions and draws exact; a lane
row bitwise the same request served alone.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_parity import (  # noqa: F401 (one_torch_thread is autouse)
    close, fast_jit, flat, numpy_tree, one_torch_thread)
from repro.configs import get_config as jax_get_config
from repro.core import ifl_spmd as jspmd
from repro.data.synthetic import SyntheticLM as JaxSyntheticLM
from repro.models import rope as jrope
from repro.models import transformer as jtf
from repro.train import loop as jloop
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import ifl_spmd as tspmd
from repro_torch.core.ifl_spmd import value_and_grad
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.models import rope
from repro_torch.models import transformer as tf
from repro_torch.optim import make_optimizer
from repro_torch.serve import CompositionStore, Request, ServeEngine
from repro_torch.train import loop as tloop

LLAMA4, GEMMA3, QWEN2VL = ("llama4-maverick-400b-a17b", "gemma3-27b",
                           "qwen2-vl-2b")
SOFTCAP = "qwen1.5-0.5b+softcap"
B, S = 2, 64
REL = 1e-5
_close = functools.partial(close, rel=REL)


def _cfgs(name):
    arch, _, extra = name.partition("+")
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    if extra == "softcap":
        cfg, jcfg = (c.replace(logit_softcap=30.0) for c in (cfg, jcfg))
    if arch == GEMMA3:  # (local 32, global) in each half, the prefix kept
        cfg, jcfg = (c.replace(
            num_layers=len(c.prefix_pattern) + 4,
            base_pattern=c.base_pattern[-2:],
            mod_pattern=c.mod_pattern[-2:]).validate() for c in (cfg, jcfg))
    if arch == LLAMA4:  # (local dense, NoPE global MoE) in each half
        cfg, jcfg = (c.replace(
            num_layers=4, base_pattern=c.base_pattern[::3],
            mod_pattern=c.mod_pattern[::3]).validate() for c in (cfg, jcfg))
    return cfg, jcfg


def _batch(cfg, seed):
    """Tokens and, for an image config, image rows, as numpy."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.num_image_tokens:
        b["image_embeds"] = rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    return b


def _torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture(scope="module", params=[LLAMA4, GEMMA3, QWEN2VL, SOFTCAP])
def lm(request):
    """The port's init as numpy and the reference's z, aux, logits, loss
    and gradients on one batch, from one compiled function."""
    cfg, jcfg = _cfgs(request.param)
    params = tf.init_lm(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    npp = numpy_tree(params)
    jp = jax.tree.map(jnp.asarray, npp)
    b = _batch(cfg, 3)

    def loss_and_forward(p, c, bb):
        # lm_loss's unchunked path written out (none of these configs has
        # the MTP head), so that the forward is traced once.
        z, aux_b = jtf.base_forward(p["base"], c, bb)
        logits, aux_m = jtf.modular_forward(p["modular"], c, z)
        loss = jtf._next_token_ce(logits, bb["tokens"], 1,
                                  c.num_image_tokens)
        return loss + aux_b + aux_m, (z, aux_b, logits, aux_m)

    (loss, out), grads = fast_jit(jax.value_and_grad(
        loss_and_forward, has_aux=True), jcfg, jp,
        jax.tree.map(jnp.asarray, b))
    return dict(name=request.param, cfg=cfg, jcfg=jcfg, params=npp, jp=jp,
                batch=b, out=[np.asarray(a) for a in out], loss=float(loss),
                grads=flat(jax.tree.map(np.asarray, grads)))


def test_every_config_builds_with_the_variants_leaves(lm):
    """No config raises any more; each variant's leaves (q_norm / k_norm,
    img_proj) are there (``test_torch_models.py`` holds the reduced
    configs' trees to the reference's, shape for shape; the gradient
    tests below hold these, leaf for leaf)."""
    for arch in ARCH_IDS:
        tf.check_supported(get_config(arch))
    cfg = lm["cfg"]
    attn = lm["params"]["base"]["groups"]["l0"]["attn"]
    assert ("q_norm" in attn) == ("k_norm" in attn) == cfg.use_qk_norm
    assert ("img_proj" in lm["params"]["base"]) == bool(cfg.num_image_tokens)


def test_forward_matches_jax(lm):
    cfg = lm["cfg"]
    p = params_from_numpy(lm["params"], device="cpu")
    z, aux_b = tf.base_forward(p["base"], cfg, _torch(lm["batch"]))
    _close(z, lm["out"][0], what="z")
    logits, aux_m = tf.modular_forward(
        p["modular"], cfg, torch.from_numpy(lm["out"][0].copy()))
    _close(logits, lm["out"][2], what="logits")
    assert abs(float(aux_b) - float(lm["out"][1])) <= REL
    assert abs(float(aux_m) - float(lm["out"][3])) <= REL
    if cfg.logit_softcap:
        assert float(logits.abs().max()) < cfg.logit_softcap


@pytest.mark.parametrize("ce_chunk", [0, 16])
def test_lm_loss_and_gradients_match_jax(lm, ce_chunk):
    """Next-token CE from position n_img on (no loss on image rows),
    unchunked and over chunks of 16 positions, and every gradient."""
    cfg = lm["cfg"].replace(ce_chunk=ce_chunk)
    p = params_from_numpy(lm["params"], device="cpu")
    loss, grads = value_and_grad(tf.lm_loss, p, cfg, _torch(lm["batch"]))
    assert abs(float(loss) - lm["loss"]) <= REL * max(1.0, lm["loss"])
    got = flat(grads)
    assert sorted(got) == sorted(lm["grads"])
    for key, w in lm["grads"].items():
        _close(got[key], w, what=key)


def test_dp_step_is_the_references_sgd_step(lm):
    """One DP step (``make_dp_train_step``, SGD) on the fixture's batch
    (image rows for qwen2-vl) moves every leaf by -lr times the
    reference's gradient."""
    lr = 1e-2
    p = params_from_numpy(lm["params"], device="cpu")
    p, _, m = tspmd.make_dp_train_step(lm["cfg"], lr=lr)(
        p, make_optimizer("sgd").init(p), _torch(lm["batch"]))
    assert abs(float(m["loss"]) - lm["loss"]) <= REL * max(1.0, lm["loss"])
    got, start = flat(p), flat(lm["params"])
    for key, g in lm["grads"].items():
        _close(got[key], start[key] - lr * g, what=key)


def test_image_positions_carry_no_loss():
    """Changing the tokens under the image rows moves no loss (the image
    rows replace them and the CE starts after them)."""
    cfg, _ = _cfgs(QWEN2VL)
    p = tf.init_lm(cfg, generator=torch.Generator().manual_seed(1),
                   device="cpu")
    b = _torch(_batch(cfg, 4))
    with torch.no_grad():
        a = tf.lm_loss(p, cfg, b)
        b["tokens"][:, :cfg.num_image_tokens] = 0
        assert torch.equal(a, tf.lm_loss(p, cfg, b))


# ------------------------------------------------------------- M-RoPE


@pytest.mark.parametrize("n_img,hw", [(16, None), (12, None), (7, None),
                                      (12, (2, 6)), (0, None)])
def test_mrope_positions_and_rotation_match_jax(n_img, hw):
    """``default_mrope_positions`` (a square, non-square and prime image
    count, an explicit grid, text only) exactly, and ``apply_mrope``
    within 1e-6 on those positions."""
    want = np.asarray(jrope.default_mrope_positions(B, 24, n_img, hw))
    got = rope.default_mrope_positions(B, 24, n_img, hw)
    np.testing.assert_array_equal(got.numpy(), want)
    x = np.random.default_rng(n_img).standard_normal(
        (B, 24, 3, 32)).astype(np.float32)
    sections = (8, 4, 4)
    ref = jax.jit(jrope.apply_mrope, static_argnums=(2, 3))(
        jnp.asarray(x), jnp.asarray(want), 1e4, sections)
    out = rope.apply_mrope(torch.from_numpy(x), got, 1e4, sections)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("n_img", [0, 16, 12, 256])
def test_decode_positions_per_row_match_jax(n_img):
    """A decode step's M-RoPE ids per row, ``max(pos - n_img, 0) +
    grid``, equal the reference's scalar rule row by row (its grid start
    differs from ``default_mrope_positions``'s for non-square counts,
    and both are kept as they are)."""
    cfg = get_config(QWEN2VL).reduced().replace(num_image_tokens=n_img)
    jcfg = jax_get_config(QWEN2VL).reduced().replace(num_image_tokens=n_img)
    pos = torch.tensor([0, 3, n_img, n_img + 5, 300])
    got = tf._decode_positions(cfg, pos)
    assert got.shape == (3, 5, 1)
    for b, t in enumerate(pos.tolist()):
        want = np.asarray(jtf._decode_positions(jcfg, jnp.int32(t), 1))
        np.testing.assert_array_equal(got[:, b:b + 1].numpy(), want)


def test_mrope_decode_steps_match_jax():
    """8 decode steps of the reference's ``lm_decode_step`` (scalar
    position) against the port's composed step with per-row positions,
    M-RoPE's decode ids on qwen2-vl. (qk-norm's decode is held to the
    port's forward below, which is held to the reference's above.)"""
    name = QWEN2VL
    cfg, jcfg = _cfgs(name)
    params = tf.init_lm(cfg, generator=torch.Generator().manual_seed(2),
                        device="cpu")
    jp = jax.tree.map(jnp.asarray, numpy_tree(params))
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, 8))
    jcache = jtf.init_decode_cache(jcfg, B, 16)
    cache = tf.init_composed_cache(cfg, cfg, B, 16, device="cpu")
    step = jax.jit(lambda p_, c_, t_, i_: jtf.lm_decode_step(p_, jcfg, c_,
                                                             t_, i_))
    for t in range(8):
        want, jcache = step(jp, jcache, jnp.asarray(toks[:, t:t + 1],
                                                    jnp.int32),
                            jnp.int32(t))
        got, cache = tf.composed_decode_step(
            params["base"], cfg, params["modular"], cfg, cache,
            torch.from_numpy(toks[:, t:t + 1]), torch.full((B,), t))
        _close(got, want, what=f"{name} position {t}")


# ------------------------------------------------------------- qk-norm


@pytest.mark.parametrize("name", [LLAMA4, GEMMA3])
def test_decode_with_qk_norm_agrees_with_the_forward(name):
    """Decoding a sequence token by token gives the full forward's
    logits at every position (qk-norm reached through the decode path,
    windows of 32 passed at S 40). llama4's MoE capacity is raised so
    that the full forward drops no choice, as a one-token decode never
    does."""
    cfg, _ = _cfgs(name)
    cfg = cfg.replace(capacity_factor=float(cfg.num_experts or 1))
    p = tf.init_lm(cfg, generator=torch.Generator().manual_seed(6),
                   device="cpu")
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (1, 40)))
    with torch.no_grad():
        full, _ = tf.modular_forward(
            p["modular"], cfg, tf.base_forward(p["base"], cfg,
                                               {"tokens": toks})[0])[:2]
        cache = tf.init_composed_cache(cfg, cfg, 1, 40, device="cpu")
        for t in range(40):
            got, cache = tf.composed_decode_step(
                p["base"], cfg, p["modular"], cfg, cache, toks[:, t:t + 1],
                torch.full((1,), t))
            _close(got[:, 0], full[:, t].numpy(), rel=1e-4, what=t)


def test_lane_rows_with_their_own_q_norm_scales():
    """Two tenants of the reduced gemma3 whose q_norm / k_norm scales
    differ decode together in one W 2 lane: each row is bitwise the
    same request served alone (``ServeEngine.oracle``) and within 1e-5
    of its tenant's plain one-row decode. (A per-row (W, hd) scale must
    broadcast as (W, 1, 1, hd) against per-head q of (W, 1, H, hd).)"""
    cfg, _ = _cfgs(GEMMA3)
    store = CompositionStore()
    name = store.add_arch(cfg, reduced=True)
    rng = np.random.default_rng(8)
    bases = []
    for k in range(2):
        p = tf.init_lm(cfg, generator=torch.Generator().manual_seed(10 + k),
                       device="cpu")
        for path, leaf in flat(p["base"]).items():
            if path.endswith(("q_norm/scale", "k_norm/scale")):
                leaf.copy_(torch.from_numpy(rng.uniform(
                    0.5, 1.5, leaf.shape).astype(np.float32)))
        if k == 0:
            store.set_modular(name, p["modular"])
            modular = p["modular"]
        store.add_tenant(f"tenant{k}", name, p["base"])
        bases.append(p["base"])
    assert not torch.equal(
        bases[0]["prefix"]["l0"]["attn"]["q_norm"]["scale"],
        bases[1]["prefix"]["l0"]["attn"]["q_norm"]["scale"])
    prompts = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 6))
    reqs = [Request(rid=k, tenant=f"tenant{k}",
                    prompt=[int(t) for t in prompts[k]], max_new_tokens=5,
                    arrival=0) for k in range(2)]
    engine = ServeEngine(store, width=2, cache_len=16, horizon=2,
                         device="cpu")
    comps = engine.run(reqs)
    assert len({c.admitted_tick for c in comps}) == 1  # decoded together
    for r, c in zip(reqs, comps):
        assert engine.oracle(r).tokens == c.tokens, r.rid
        # The tenant's own model, one row, shared weights: greedy tokens.
        cache = tf.init_composed_cache(cfg, cfg, 1, 16, device="cpu")
        seq = list(r.prompt)
        with torch.no_grad():
            for t in range(len(seq) + 4):
                logits, cache = tf.composed_decode_step(
                    bases[r.rid], cfg, modular, cfg, cache,
                    torch.tensor([[seq[t]]]), torch.full((1,), t))
                if t >= len(seq) - 1:
                    seq.append(int(logits[0, -1].argmax()))
        assert seq[len(r.prompt):] == c.tokens, r.rid


# ------------------------------------------------------------- training


def test_image_batches_and_ifl_round_match_jax():
    """qwen2-vl: the loop's image draws (IFL: ``default_rng(step)``
    normals; DP: zeros, as the reference's DP loop) equal the reference
    loop's; one IFL round (N 2, tau 1) on the same params and batch
    gives the reference's losses and parameters."""
    cfg, jcfg = _cfgs(QWEN2VL)
    n, tau, lr = 2, 1, 1e-2
    for r in range(2):
        want = jloop._ifl_batch(JaxSyntheticLM(cfg.vocab_size, seed=0), jcfg,
                                n, tau, B, S, r)
        got = tloop._ifl_batch(SyntheticLM(cfg.vocab_size, seed=0), cfg, n,
                               tau, B, S, r, device="cpu")
        assert sorted(got) == sorted(want) == ["image_embeds", "tokens"]
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    dp_b = tloop._dp_batch(SyntheticLM(cfg.vocab_size, seed=0), cfg, B, S, 0,
                           device="cpu")
    assert not dp_b["image_embeds"].any()

    gen = torch.Generator().manual_seed(4)
    params = [tf.init_lm(cfg, generator=gen, device="cpu") for _ in range(n)]
    jparams = jax.tree.map(lambda *a: jnp.stack(a),
                           *[jax.tree.map(jnp.asarray, numpy_tree(p))
                             for p in params])
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                             ("client", "data", "model"))
    jstep = jspmd.make_ifl_round_step(jcfg, mesh, n_clients=n, tau=tau,
                                      lr_base=lr, lr_modular=lr)
    with mesh:
        jparams, _, jm = fast_jit(lambda p_, c_, o_, b_: jstep(p_, o_, b_),
                                   jcfg, jparams, {"base": {}, "modular": {}},
                                   jax.tree.map(jnp.asarray, want))
    step = tspmd.make_ifl_round_step(cfg, n_clients=n, tau=tau, lr_base=lr,
                                     lr_modular=lr)
    opt = [{"base": {}, "modular": {}} for _ in range(n)]
    params, _, m = step(params, opt, got)
    for key in ("base_loss", "mod_loss"):
        assert abs(float(m[key]) - float(jm[key])) <= REL * 10, key
    want_p = flat(jax.tree.map(np.asarray, jparams))
    for k in range(n):
        for key, a in flat(params[k]).items():
            _close(a, want_p[key][k], what=f"client {k} {key}")
