"""The port's encoder-decoder against the JAX package on the CPU: the
reduced seamless-m4t-large-v2 (2 bidirectional encoder layers over 64
frames, a decoder layer with cross-attention below the fusion cut and
one without above it, 4 heads of 64, layernorm, GELU), fp32, B 2, S 64;
and the attention kernels' non-causal mode (the TPU kernel's
``causal=False``), which the encoder runs on the card, through its plain
version.

Params are drawn by the port's init and handed to both packages as the
same numpy arrays; tokens and frames are made with numpy from a seed.
The reference's encoder, forward, loss and gradients run once in a
module fixture, compiled once. Tolerances: encoder output, z, logits,
losses, gradients, cross caches and decode logits within 1e-5 of the
largest reference magnitude (fp32 on both sides, sums in other orders);
the plain non-causal attention within 2e-5 of the Pallas kernel in
interpret mode in fp32 (the bf16 kernels are held to that plain version
on the card, ``tests/test_torch_cuda.py``); frame draws exact.

Serving: the fixed-batch decode API (``lm_prefill``, ``composed_prefill``,
``lm_decode_step``) and the CLI's ``generate`` through the cross caches,
against the reference's ``lm_prefill`` (logits within 1e-5) and
``generate`` (the same greedy tokens).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_parity import (  # noqa: F401 (one_torch_thread is autouse)
    close, fast_jit, flat, numpy_tree, one_torch_thread, shapes)
from repro.configs import get_config as jax_get_config
from repro.core import ifl_spmd as jspmd
from repro.data.synthetic import SyntheticLM as JaxSyntheticLM
from repro.kernels import ops as jops
from repro.launch import serve as jserve
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.train import loop as jloop
from repro_torch import api as tapi
from repro_torch.api.spmd import SPMDIFLTrainer
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import ifl_spmd as tspmd
from repro_torch.core.ifl_spmd import value_and_grad
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.kernels import ref
from repro_torch.launch import serve as serve_cli
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tf
from repro_torch.optim import make_optimizer
from repro_torch.serve import CompositionStore, Lane
from repro_torch.train import loop as tloop

ARCH = "seamless-m4t-large-v2"
B, S = 2, 64
REL = 1e-5
_close = functools.partial(close, rel=REL)


@pytest.fixture(scope="module")
def cfgs():
    return get_config(ARCH).reduced(), jax_get_config(ARCH).reduced()


@pytest.fixture(scope="module")
def lm(cfgs):
    """The port's init as numpy and the reference's encoder output, z,
    logits, loss and gradients on one batch, from one compiled
    function."""
    cfg, jcfg = cfgs
    params = tf.init_lm(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    npp = numpy_tree(params)
    jp = jax.tree.map(jnp.asarray, npp)
    rng = np.random.default_rng(3)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "frame_embeds": rng.standard_normal(
             (B, cfg.enc_seq_len, cfg.d_model)).astype(np.float32)}

    def loss_and_forward(p, c, bb):
        # lm_loss's unchunked path written out, so that the forward is
        # traced once.
        z, aux_b = jtf.base_forward(p["base"], c, bb)
        logits, aux_m = jtf.modular_forward(p["modular"], c, z)
        loss = jtf._next_token_ce(logits, bb["tokens"], 1, 0)
        return loss + aux_b + aux_m, (z, logits)

    jb = jax.tree.map(jnp.asarray, b)
    (loss, out), grads = fast_jit(jax.value_and_grad(
        loss_and_forward, has_aux=True), jcfg, jp, jb)
    enc = jax.jit(lambda p_, f_: jtf.encoder_forward(p_, jcfg, f_))(
        jp["base"]["encoder"], jb["frame_embeds"])
    return dict(params=npp, jp=jp, batch=b, loss=float(loss),
                out=[np.asarray(a) for a in (enc, *out)],
                grads=flat(jax.tree.map(np.asarray, grads)))


def _torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_builds_the_encoder_and_cross_leaves(cfgs, lm):
    """The encoder stacked under base/encoder/groups (enc_layers deep),
    the cross-attention layers' norm_x and cross leaves below the fusion
    cut only (``test_torch_models.py`` holds the tree to the
    reference's, shape for shape)."""
    cfg, _ = cfgs
    enc = lm["params"]["base"]["encoder"]["groups"]
    assert enc["attn"]["wk"]["w"].shape[0] == cfg.enc_layers == 2
    assert "cross" in lm["params"]["base"]["groups"]["l0"]
    assert "cross" not in lm["params"]["modular"]["groups"]["l0"]


def test_encoder_and_forward_match_jax(cfgs, lm):
    cfg, _ = cfgs
    p = params_from_numpy(lm["params"], device="cpu")
    b = _torch(lm["batch"])
    enc = tf.encoder_forward(p["base"]["encoder"], cfg, b["frame_embeds"])
    _close(enc, lm["out"][0], what="encoder")
    z, _ = tf.base_forward(p["base"], cfg, b)
    _close(z, lm["out"][1], what="z")
    logits, _ = tf.modular_forward(p["modular"], cfg,
                                   torch.from_numpy(lm["out"][1].copy()))
    _close(logits, lm["out"][2], what="logits")


@pytest.mark.parametrize("remat,ce_chunk", [("none", 0), ("group", 16)])
def test_lm_loss_and_gradients_match_jax(cfgs, lm, remat, ce_chunk):
    """The loss and every gradient, the encoder's through the
    cross-attention layers, unchunked and chunked, without and with the
    groups' checkpointing."""
    cfg = cfgs[0].replace(remat=remat, ce_chunk=ce_chunk)
    p = params_from_numpy(lm["params"], device="cpu")
    loss, grads = value_and_grad(tf.lm_loss, p, cfg, _torch(lm["batch"]))
    assert abs(float(loss) - lm["loss"]) <= REL * max(1.0, lm["loss"])
    got = flat(grads)
    assert sorted(got) == sorted(lm["grads"])
    for key, w in lm["grads"].items():
        _close(got[key], w, what=key)
    assert float(got["base/encoder/groups/attn/wq/w"].abs().max()) > 0


def test_cross_caches_and_decode_match_jax(cfgs, lm):
    """``build_cross_caches`` on the encoder output (the base group's
    cross layer, stacked group-major), then 8 decode steps through the
    cross caches: the reference's ``lm_decode_step`` (scalar position)
    against the port's composed step with per-row positions."""
    cfg, jcfg = cfgs
    p = params_from_numpy(lm["params"], device="cpu")
    enc = lm["out"][0]
    jkv = jtf.build_cross_caches(lm["jp"], jcfg, jnp.asarray(enc))
    kv = tf.build_cross_caches(p, cfg, torch.from_numpy(enc.copy()))
    assert shapes(kv) == shapes(jkv)
    for key, w in flat(jax.tree.map(np.asarray, jkv)).items():
        _close(flat(kv)[key], w, what=key)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, 8))
    jcache = jtf.init_decode_cache(jcfg, B, 16)
    cache = tf.init_composed_cache(cfg, cfg, B, 16, device="cpu")
    step = jax.jit(lambda p_, c_, t_, i_, x_: jtf.lm_decode_step(
        p_, jcfg, c_, t_, i_, x_))
    for t in range(8):
        want, jcache = step(lm["jp"], jcache,
                            jnp.asarray(toks[:, t:t + 1], jnp.int32),
                            jnp.int32(t), jkv)
        got, cache = tf.composed_decode_step(
            p["base"], cfg, p["modular"], cfg, cache,
            torch.from_numpy(toks[:, t:t + 1]), torch.full((B,), t),
            cross_kvs=kv)
        _close(got, want, what=f"position {t}")


# ------------------------------------- the kernels' non-causal mode

# (S, window, KVH) with 4 query heads of 64: H = KVH and G > 1, with and
# without a window, S 100 off the card's 64-row tiles.
BIDIR = [(64, -1, 4), (100, -1, 2), (100, 48, 4), (128, 1, 1)]


@pytest.mark.parametrize("S,window,kvh", BIDIR)
def test_plain_bidirectional_matches_pallas_kernel_in_interpret_mode(
        S, window, kvh):
    """``ref.flash_attention_ref(..., causal=False)``, the plain version
    the card's kernels are held to, against the TPU kernel itself with
    ``causal=False`` in interpret mode, fp32; at S 100 its backward
    (``flash_attention_bwd_ref``) against ``jax.grad`` of the
    reference's plain attention, with and without a window."""
    rng = np.random.default_rng(S + window)
    q = rng.standard_normal((B, S, 4, 64)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, kvh, 64)).astype(np.float32)
            for _ in range(2))
    want = jops.flash_attention(
        *(jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v)),
        causal=False, window=window, interpret=True)
    want = np.asarray(want).transpose(0, 2, 1, 3)
    got = ref.flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                  causal=False, window=window)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    if S != 100:
        return
    do = rng.standard_normal(q.shape).astype(np.float32)
    g = 4 // kvh

    def jloss(q_, k_, v_):
        o = jref.flash_attention_ref(
            q_.transpose(0, 2, 1, 3),
            jnp.repeat(k_, g, axis=2).transpose(0, 2, 1, 3),
            jnp.repeat(v_, g, axis=2).transpose(0, 2, 1, 3),
            causal=False, window=window)
        return jnp.sum(o.transpose(0, 2, 1, 3) * do)

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))
    tg = ref.flash_attention_bwd_ref(
        *(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(do),
        causal=False, window=window)
    for a, w in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("S,q_block", [(64, 16), (100, 64), (64, 64)])
def test_cpu_encoder_attention_is_the_kernels_plain_version(S, q_block):
    """The encoder's CPU path (the reference's ``bidir_blocked_attention``,
    its ragged single-block fallback at S 100 included) equals the
    reference's within 1e-6 and the kernels' plain non-causal version
    within 1e-5, so the card and the CPU compute one function."""
    rng = np.random.default_rng(S)
    q, k, v = (rng.standard_normal((B, S, 4, 64)).astype(np.float32)
               for _ in range(3))
    got = tattn.bidir_blocked_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), q_block=q_block)
    want = jattn.bidir_blocked_attention(
        *(jnp.asarray(a) for a in (q, k, v)), q_block=q_block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    plain = ref.flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                    causal=False)
    _close(got, plain.numpy())


# ------------------------------------------------------------- training


def test_dp_step_is_the_references_sgd_step(cfgs, lm):
    """One DP step (``make_dp_train_step``, SGD) on the frame batch moves
    every leaf, the encoder's included, by -lr times the reference's
    gradient."""
    lr = 1e-2
    p = params_from_numpy(lm["params"], device="cpu")
    p, _, m = tspmd.make_dp_train_step(cfgs[0], lr=lr)(
        p, make_optimizer("sgd").init(p), _torch(lm["batch"]))
    assert abs(float(m["loss"]) - lm["loss"]) <= REL * max(1.0, lm["loss"])
    got, start = flat(p), flat(lm["params"])
    for key, g in lm["grads"].items():
        _close(got[key], start[key] - lr * g, what=key)


def test_frame_batches_and_ifl_round_match_jax(cfgs):
    """The loop's frame draws (IFL: ``default_rng(step + 1)``; DP:
    ``default_rng(step)``) equal the reference loop's; one IFL round
    (N 2, tau 1) on the same params and batch gives the reference's
    losses and parameters."""
    cfg, jcfg = cfgs
    n, tau, lr = 2, 1, 1e-2
    want = jloop._ifl_batch(JaxSyntheticLM(cfg.vocab_size, seed=0), jcfg, n,
                            tau, B, S, 1)
    got = tloop._ifl_batch(SyntheticLM(cfg.vocab_size, seed=0), cfg, n, tau,
                           B, S, 1, device="cpu")
    assert sorted(got) == sorted(want) == ["frame_embeds", "tokens"]
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    dp_b = tloop._dp_batch(SyntheticLM(cfg.vocab_size, seed=0), cfg, B, S, 3,
                           device="cpu")
    np.testing.assert_array_equal(
        dp_b["frame_embeds"].numpy(), np.random.default_rng(3).normal(
            size=(B, cfg.enc_seq_len, cfg.d_model)).astype(np.float32))

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


# ------------------------------------------------- what stays refused


def test_serving_paths_refuse_encdec_naming_item_5a(cfgs):
    """A lane carries no cross caches (nor do the reference's): it
    refuses an encoder-decoder and names the fixed-batch ``generate``
    path that serves one (the CLI's, ``test_encdec_cli_serves_on_cpu``)."""
    cfg, _ = cfgs
    p = tf.init_lm(cfg, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    store = CompositionStore()
    name = store.add_arch(cfg, reduced=True)
    store.set_modular(name, p["modular"])
    with pytest.raises(NotImplementedError, match="generate"):
        Lane(cfg, cfg, p["modular"], p["base"], width=2, cache_len=16,
             device="cpu")


# ------------------------------------------- fixed-batch enc-dec serving

P_SERVE, GEN = 6, 5


@pytest.fixture(scope="module")
def served(cfgs, lm):
    """The reference's ``lm_prefill`` (last logits and cache) and greedy
    ``generate`` on the fixture's params, through the cross caches of
    its encoder output, prompts from a seed."""
    _, jcfg = cfgs
    prompts = np.random.default_rng(8).integers(
        0, jcfg.vocab_size, (B, P_SERVE)).astype(np.int32)
    jkv = jtf.build_cross_caches(lm["jp"], jcfg, jnp.asarray(lm["out"][0]))
    logits, _ = jax.jit(lambda p_, c_, t_, k_: jtf.lm_prefill(
        p_, jcfg, c_, t_, k_))(lm["jp"], jtf.init_decode_cache(
            jcfg, B, P_SERVE + GEN), jnp.asarray(prompts), jkv)
    toks = jserve.generate(lm["jp"], jcfg, jnp.asarray(prompts), GEN, jkv)
    return dict(prompts=prompts, logits=np.asarray(logits),
                tokens=np.asarray(toks))


def _port_side(cfg, lm, prompts):
    p = params_from_numpy(lm["params"], device="cpu")
    kv = tf.build_cross_caches(p, cfg, torch.from_numpy(lm["out"][0].copy()))
    return p, kv, torch.from_numpy(prompts.astype(np.int64))


def test_lm_prefill_and_generate_match_jax(cfgs, lm, served):
    cfg, _ = cfgs
    p, kv, prompts = _port_side(cfg, lm, served["prompts"])
    cache = tf.init_decode_cache(cfg, B, P_SERVE + GEN, device="cpu")
    logits, _ = tf.lm_prefill(p, cfg, cache, prompts, kv)
    assert logits.shape == (B, 1, cfg.vocab_size)
    _close(logits, served["logits"], what="lm_prefill")
    toks = serve_cli.generate(p, cfg, prompts, GEN, kv)
    assert np.array_equal(toks.numpy(), served["tokens"])


def test_composed_prefill_is_sequential_decode_steps(cfgs, lm):
    """``composed_prefill`` from position ``start`` leaves bitwise the
    cache (and last logits) of P ``lm_decode_step`` calls with scalar
    positions."""
    cfg, _ = cfgs
    prompts = np.random.default_rng(9).integers(0, cfg.vocab_size, (B, 7))
    p, kv, toks = _port_side(cfg, lm, prompts)
    start = 2
    pre = tf.init_decode_cache(cfg, B, 12, device="cpu")
    seq = tf.init_decode_cache(cfg, B, 12, device="cpu")
    got, pre = tf.composed_prefill(p["base"], cfg, p["modular"], cfg, pre,
                                   toks, kv, start=start)
    for t in range(toks.shape[1]):
        want, seq = tf.lm_decode_step(p, cfg, seq, toks[:, t:t + 1],
                                      start + t, kv)
    assert torch.equal(got, want)
    for key, a in flat(pre).items():
        assert torch.equal(a, flat(seq)[key]), key


def test_encdec_cli_serves_on_cpu(capsys):
    serve_cli.main(["--arch", ARCH, "--device", "cpu", "--tenants", "2",
                    "--prompt-len", "4", "--gen", "3"])
    out = capsys.readouterr().out
    assert "fixed-batch generate path" in out
    assert "generated (2, 7)" in out


@pytest.mark.parametrize("arch,key", [(ARCH, "frame_embeds"),
                                      ("qwen2-vl-2b", "image_embeds")])
def test_spmd_front_door_names_the_missing_batch_key(arch, key):
    """The SPMD front door draws tokens only, as the reference's: a
    config with image or frame inputs raises a ValueError naming the
    batch key before any round."""
    spec = tapi.ExperimentSpec(scheme="ifl_spmd", model=arch, rounds=1,
                               tau=1, batch_size=2, d_fusion=32,
                               data=tapi.DataSpec(dataset="synth_tokens",
                                                  n_test=8))
    with pytest.raises(ValueError, match=key):
        SPMDIFLTrainer(spec, seq=32, device="cpu")
