"""The port's MoE, MLA and MTP families against the JAX package on the
CPU: the reduced deepseek-v3-671b (MLA with the q LoRA, 4 heads of
q/k 48 = nope 32 + rope 16 and v 32, a dense prefix layer, MoE layers of
4 experts top-2 with a shared expert, the MTP head) and one period of
jamba-1.5-large-398b with its experts on (attention at position 3,
Mamba elsewhere, MoE on odd positions; base = positions 0-3, modular =
4-7, d_model 128), fp32.

Params are drawn by the port's init from a seeded generator and handed
to both packages as the same numpy arrays; tokens are made with numpy
from a seed. The reference runs once per config in a module fixture.
Tolerances: losses (aux included) 1e-4 absolute; activations, logits
and gradients 1e-4 of the largest reference magnitude (fp32 on both
sides, sums in other orders); bytes and expert choices exact.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_parity import (  # noqa: F401 (one_torch_thread is autouse)
    close, fast_jit, flat, numpy_tree, one_torch_thread, shapes)
from repro.checkpoint import load_checkpoint as jax_load_checkpoint
from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.config import LayerSpec as JLayerSpec
from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro_torch.checkpoint import (
    cache_from_numpy,
    load_checkpoint,
    params_from_numpy,
    save_checkpoint,
)
from repro_torch.config import LayerSpec
from repro_torch.configs import get_config
from repro_torch.core.ifl_spmd import make_dp_train_step, value_and_grad
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import attention
from repro_torch.models import transformer as tf
from repro_torch.optim import make_optimizer
from repro_torch.serve import Request, ServeEngine

DEEPSEEK, JAMBA = "deepseek-v3-671b", "jamba-1.5-large-398b"
B, S = 2, 64
LOSS_TOL = 1e-4
REL = 1e-4
_close = functools.partial(close, rel=REL)


def _jamba_period(spec_cls, get):
    """Jamba's 8-layer period with its MoE FFNs, cut at the middle."""
    pat = tuple(spec_cls(mixer="attn" if i == 3 else "mamba",
                         ffn="moe" if i % 2 else "dense", use_rope=False)
                for i in range(8))
    return get(JAMBA).reduced().replace(
        name="jamba-moe-period-smoke", num_layers=8, base_pattern=pat[:4],
        mod_pattern=pat[4:], d_model=128).validate()


def _cfgs(name):
    if name == DEEPSEEK:
        return get_config(DEEPSEEK).reduced(), \
            jax_get_config(DEEPSEEK).reduced()
    return _jamba_period(LayerSpec, get_config), \
        _jamba_period(JLayerSpec, jax_get_config)


def _tokens(shape, seed, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


@pytest.fixture(scope="module", params=[DEEPSEEK, JAMBA])
def lm(request):
    """The port's init as numpy, and the reference's forward tuples,
    loss and (for deepseek-v3, whose MLA, MTP and MoE gradients no other
    file holds) gradients on one batch, from one compiled function. The
    jamba period's MoE and Mamba gradients are held in
    ``test_torch_moe.py`` and ``test_torch_mamba.py``; compiling its
    whole gradient would double this file's time."""
    cfg, jcfg = _cfgs(request.param)
    params = tf.init_lm(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    npp = numpy_tree(params)
    jp = jax.tree.map(jnp.asarray, npp)
    toks = _tokens((B, S), 3)
    batch = {"tokens": jnp.asarray(toks)}

    def loss_and_forward(p, c, b):
        z, aux_b = jtf.base_forward(p["base"], c, b)
        out = (z, aux_b) + tuple(jtf.modular_forward(p["modular"], c, z))
        return jtf.lm_loss(p, c, b), out

    grads = None
    if request.param == DEEPSEEK:
        (loss, out), grads = fast_jit(jax.value_and_grad(
            loss_and_forward, has_aux=True), jcfg, jp, batch)
        grads = flat(jax.tree.map(np.asarray, grads))
    else:
        loss, out = fast_jit(loss_and_forward, jcfg, jp, batch)
    return dict(name=request.param, cfg=cfg, jcfg=jcfg, params=npp, jp=jp,
                toks=toks, out=[np.asarray(a) for a in out],
                loss=float(loss), grads=grads)


def _port_params(lm):
    return params_from_numpy(lm["params"], device="cpu")


def test_families_build_with_the_references_shapes(lm):
    for arch in (DEEPSEEK, JAMBA):  # the full configs are accepted
        tf.check_supported(get_config(arch))
    cfg, jcfg = lm["cfg"], lm["jcfg"]
    assert shapes(lm["params"]) == shapes(jax.eval_shape(
        lambda k: jtf.init_lm(k, jcfg), jax.random.PRNGKey(0)))
    assert ("mtp" in lm["params"]["modular"]) == cfg.use_mtp


def test_base_and_modular_forward_tuples_match_jax(lm):
    cfg = lm["cfg"]
    p = _port_params(lm)
    batch = {"tokens": torch.from_numpy(lm["toks"])}
    z, aux_b = tf.base_forward(p["base"], cfg, batch)
    out = tf.modular_forward(p["modular"], cfg,
                             torch.from_numpy(lm["out"][0].copy()))
    assert len(out) == (3 if cfg.use_mtp else 2) == len(lm["out"]) - 2
    _close(z, lm["out"][0], what="z")
    for got, want, what in ((aux_b, lm["out"][1], "aux base"),
                            (out[1], lm["out"][3], "aux modular")):
        assert got.dtype == torch.float32 and float(got) > 0
        assert abs(float(got) - float(want)) <= LOSS_TOL, what
    _close(out[0], lm["out"][2], what="logits")
    if cfg.use_mtp:
        _close(out[2], lm["out"][4], what="mtp logits")
    logits, aux, mtp = tf.lm_apply(p, cfg, batch)
    assert abs(float(aux) - float(lm["out"][1] + lm["out"][3])) <= LOSS_TOL
    assert (mtp is None) != cfg.use_mtp


@pytest.mark.parametrize("remat,ce_chunk", [("none", 0), ("group", 0),
                                            ("none", 16)])
def test_lm_loss_with_mtp_and_aux_matches_jax(lm, remat, ce_chunk):
    """Next-token CE + 0.3 x the MTP head's offset-2 CE + aux, unchunked
    and chunked (the same mean over chunks of 16 positions); gradients
    under each remat and chunking."""
    cfg = lm["cfg"].replace(remat=remat, ce_chunk=ce_chunk)
    p = _port_params(lm)
    loss, grads = value_and_grad(tf.lm_loss, p, cfg,
                                 {"tokens": torch.from_numpy(lm["toks"])})
    assert abs(float(loss) - lm["loss"]) <= LOSS_TOL
    got = flat(grads)
    assert all(bool(torch.isfinite(g).all()) for g in got.values())
    if lm["grads"] is None:
        return
    assert sorted(got) == sorted(lm["grads"])
    for key, w in lm["grads"].items():
        _close(got[key], w, what=key)


def test_dp_step_is_the_references_sgd_step(lm):
    """One DP step (``make_dp_train_step``, SGD) moves every leaf by -lr
    times the reference's gradient (deepseek-v3; the jamba period's loss
    only)."""
    lr = 1e-2
    cfg = lm["cfg"]
    p = _port_params(lm)
    step = make_dp_train_step(cfg, lr=lr)
    p, _, m = step(p, make_optimizer("sgd").init(p),
                   {"tokens": torch.from_numpy(lm["toks"])})
    assert abs(float(m["loss"]) - lm["loss"]) <= LOSS_TOL
    if lm["grads"] is None:
        return
    got = flat(p)
    for key, g in lm["grads"].items():
        want = flat(lm["params"])[key] - lr * g
        np.testing.assert_allclose(got[key].numpy(), want, rtol=1e-5,
                                   atol=1e-5, err_msg=key)


def test_checkpoints_load_across_the_packages(lm, tmp_path):
    """Port-saved params load in the JAX package into its init's
    template, and JAX-saved ones in the port, leaf for leaf."""
    p = _port_params(lm)
    save_checkpoint(str(tmp_path / "port"), p, step=1)
    template = jax.eval_shape(lambda k: jtf.init_lm(k, lm["jcfg"]),
                              jax.random.PRNGKey(0))
    back = flat(jax.tree.map(np.asarray, jax_load_checkpoint(
        str(tmp_path / "port"), template)))
    want = flat(lm["params"])
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    jax_save_checkpoint(str(tmp_path / "jax"), lm["jp"], step=1)
    mine = flat(load_checkpoint(str(tmp_path / "jax"), p))
    for k in want:
        np.testing.assert_array_equal(mine[k].numpy(), want[k], err_msg=k)


# ------------------------------------------------------------- MLA


@pytest.fixture(scope="module")
def mla():
    """One MLA layer of the reduced deepseek-v3: the reference's expanded
    forward and its absorbed decode over 12 positions at B 2."""
    cfg, jcfg = _cfgs(DEEPSEEK)
    spec = LayerSpec()
    p = attention.init_attn(torch.Generator().manual_seed(5), cfg, spec)
    jp = jax.tree.map(jnp.asarray, numpy_tree(p))
    x = np.random.default_rng(6).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    full = jax.jit(lambda p_, x_: jattn._mla_forward(p_, jcfg, x_,
                                                     jnp.asarray(pos)))(
        jp, jnp.asarray(x))
    step = jax.jit(lambda p_, x_, c_, t_: jattn._mla_decode(p_, jcfg, x_, c_,
                                                            t_))
    cache = jattn.init_attn_cache(jcfg, JLayerSpec(), B, 16, jnp.float32)
    ys = []
    for t in range(12):
        y, cache = step(jp, jnp.asarray(x[:, t:t + 1]), cache, jnp.int32(t))
        ys.append(np.asarray(y))
    return dict(cfg=cfg, spec=spec, p=p, x=x, pos=pos, full=np.asarray(full),
                steps=np.concatenate(ys, 1),
                cache=jax.tree.map(np.asarray, cache))


def test_mla_forward_matches_jax(mla):
    cfg = mla["cfg"]
    y = attention.attn_forward(mla["p"], cfg, mla["spec"],
                               torch.from_numpy(mla["x"]),
                               torch.from_numpy(mla["pos"].copy()).long())
    _close(y, mla["full"], rel=1e-5)
    assert cfg.qk_nope_head_dim + cfg.qk_rope_head_dim != cfg.v_head_dim


def test_mla_absorbed_decode_matches_jax_and_freezes_dead_rows(mla):
    """The absorbed decode over the latent cache, per-row positions and
    an in-place cache write: the reference's steps, its cache, and (to
    rounding) the expanded forward's first positions. A row whose
    ``live`` is False keeps its cache and has no effect on the other."""
    cfg, spec, p = mla["cfg"], mla["spec"], mla["p"]
    cache = attention.init_attn_cache(cfg, spec, B, 16, torch.float32)
    assert sorted(cache) == ["ckv", "krope"]
    x = torch.from_numpy(mla["x"])
    ys = []
    for t in range(12):
        ys.append(attention.attn_decode(p, cfg, spec, x[:, t:t + 1], cache,
                                        torch.full((B,), t)))
    _close(torch.cat(ys, 1), mla["steps"], rel=1e-5)
    for k in ("ckv", "krope"):
        _close(cache[k], mla["cache"][k], rel=1e-5, what=k)
    _close(torch.cat(ys, 1), mla["full"][:, :12], rel=1e-4)
    before = {k: v.clone() for k, v in cache.items()}
    live = torch.tensor([True, False])
    y = attention.attn_decode(p, cfg, spec, x[:, 12:13], cache,
                              torch.full((B,), 12), live)
    for k in cache:
        assert torch.equal(cache[k][1], before[k][1])
        assert not torch.equal(cache[k][0], before[k][0])
    _close(y[:1], mla["full"][:1, 12:13], rel=1e-4)


def test_decode_cache_carried_across_the_packages(lm):
    """The reference decodes 6 tokens; its cache (MLA latents, Mamba
    states, K/V) goes to the port through ``cache_from_numpy`` and both
    decode 3 more: the same logits. At B 2 the reference's joint MoE
    capacity (4) cannot drop a choice, so its batched step is the port's
    per-row one."""
    cfg, jcfg, jp = lm["cfg"], lm["jcfg"], lm["jp"]
    toks = _tokens((B, 9), 9)
    cache = jtf.init_decode_cache(jcfg, B, 16)
    step = jax.jit(lambda p_, c_, t_, i_: jtf.lm_decode_step(p_, jcfg, c_,
                                                             t_, i_))
    for t in range(6):
        _, cache = step(jp, cache, jnp.asarray(toks[:, t:t + 1]),
                        jnp.int32(t))
    ours = cache_from_numpy(jax.tree.map(np.asarray, cache), device="cpu")
    p = _port_params(lm)
    for t in range(6, 9):
        want, cache = step(jp, cache, jnp.asarray(toks[:, t:t + 1]),
                           jnp.int32(t))
        got, ours = tf.composed_decode_step(
            p["base"], cfg, p["modular"], cfg, ours,
            torch.from_numpy(toks[:, t:t + 1]).long(), torch.full((B,), t))
        _close(got, want, what=f"position {t}")


# ------------------------------------------- through the front doors


@pytest.mark.parametrize("arch", [DEEPSEEK, JAMBA])
def test_train_cli_runs_ifl_and_dp(arch, tmp_path):
    """``launch.train --reduced --device cpu``: an IFL round and a DP
    step, finite losses, the reference loop's ledger bytes."""
    common = ["--arch", arch, "--reduced", "--device", "cpu", "--rounds",
              "1", "--batch", "2", "--seq", "32", "--out", str(tmp_path)]
    out = train_cli.main(common + ["--tau", "1", "--n-clients", "2",
                                   "--save-ckpt"])
    cfg = get_config(arch).reduced()
    h = out["history"][0]
    assert np.isfinite(h["base_loss"]) and np.isfinite(h["mod_loss"])
    up = 2 * (2 * 32 * cfg.d_fusion * 2 + 2 * 32 * 4)  # as the reference
    assert out["ledger"].per_round == [{"up": up, "down": 2 * up}]
    saved = json.loads((tmp_path / f"{cfg.name}__ifl.json").read_text())
    assert saved == out["history"]
    dp = train_cli.main(common + ["--mode", "dp"])
    assert np.isfinite(dp["history"][0]["loss"])


@pytest.mark.parametrize("name", [DEEPSEEK, JAMBA])
def test_busy_lane_serves_each_request_as_its_oracle(name):
    """Six tenants through a W 5 lane: five requests decode together,
    and every stream equals the same request served alone."""
    cfg, _ = _cfgs(name)
    store = serve_cli.build_demo_store(cfg, name if name == DEEPSEEK
                                       else cfg.name, 6, seed=2,
                                       reduced=True, device="cpu")
    engine = ServeEngine(store, width=5, cache_len=20, horizon=4,
                         device="cpu")
    reqs = serve_cli.demo_requests(cfg, 6, prompt_len=8, gen=6, stagger=0,
                                   seed=2)
    comps = engine.run(reqs)
    assert [len(c.tokens) for c in comps] == [6] * 6
    assert len({c.admitted_tick for c in comps}) == 2  # 5, then 1
    for r, c in zip(reqs, comps):
        assert engine.oracle(r).tokens == c.tokens, r.rid


def test_serve_cli_serves_deepseek_on_cpu(capsys):
    serve_cli.main(["--arch", DEEPSEEK, "--device", "cpu", "--tenants", "2",
                    "--width", "2", "--prompt-len", "8", "--gen", "4",
                    "--horizon", "2"])
    assert "served 2 requests / 8 new tokens" in capsys.readouterr().out


@pytest.mark.parametrize("name", [DEEPSEEK, JAMBA])
def test_configs_are_the_references(name):
    cfg, jcfg = _cfgs(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
