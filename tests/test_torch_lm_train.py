"""The port's LM training path against the JAX package on the CPU, at the
reduced qwen1.5-0.5b config (2 layers, d_model 256, vocab 512, d_fusion
128, fp32): the full-sequence forward and loss, the IFL round step
(``make_ifl_round_step``) under fp32, int8_row and ef(int4), the DP step,
the training loop's draws and ledger, and the ``launch.train`` CLI.

Parameters come from the reference's own init (``init_lm`` /
``init_ifl_state`` with ``PRNGKey(0)``), carried across as numpy; tokens
are made with numpy from a seed. Tolerances: activations, logits and
gradients 1e-4 (fp32 on both sides, sums in other orders); round-step
and DP losses 1e-4 over 2 rounds; decoded z and EF residuals 1e-4 but for
a rare code flipped by a last-bit difference in z (one quantization
step); parameters after 2 rounds 1e-5
(lr 0.01 times gradients that agree to ~1e-6); minibatch tokens and
ledger bytes exact; integer codes equal on the same z.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from _port_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.configs import get_config as jax_get_config
from repro.core import ifl_spmd as jspmd
from repro.core.codec import get_codec as jax_get_codec
from repro.data.synthetic import SyntheticLM as JaxSyntheticLM
from repro.models import transformer as jtf
from repro.optim import make_optimizer as jax_make_optimizer
from repro.train import loop as jloop
from repro_torch.checkpoint import (
    load_flat,
    params_from_numpy,
    unstack_clients,
)
from repro_torch.configs import get_config
from repro_torch.core import ifl_spmd as tspmd
from repro_torch.core.codec import get_codec
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.launch import train as tlaunch
from repro_torch.models import transformer as tf
from repro_torch.optim import make_optimizer
from repro_torch.train import loop as tloop

ARCH = "qwen1.5-0.5b"
TOL = dict(rtol=1e-4, atol=1e-4)
N, TAU, B, S, LR = 2, 2, 2, 32, 1e-2
# The largest quantization step is max|z| / qmax (0 for fp32: no flips).
QMAX = {"fp32": np.inf, "int8_row": 127, "ef(int4)": 7}


@pytest.fixture(scope="module")
def cfg():
    return get_config(ARCH).reduced()


@pytest.fixture(scope="module")
def jcfg():
    return jax_get_config(ARCH).reduced()


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                ("client", "data", "model"))


def _tokens(shape, seed, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, size=shape,
                                                dtype=np.int32)


def _leaves_np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = v
    return out


# ------------------------------------------------------------ the model


@pytest.fixture(scope="module")
def lm_case(jcfg):
    """The reference's forward, loss and gradients on one batch."""
    jp = jtf.init_lm(jax.random.PRNGKey(0), jcfg)
    # Biases start at zero; make them non-zero so the bias path counts.
    jp = jax.tree.map(lambda a: a + 0.01 * jnp.sin(jnp.arange(a.size)
                                                   .reshape(a.shape)), jp)
    toks = _tokens((B, S), seed=1)
    batch = {"tokens": jnp.asarray(toks)}
    z, _ = jtf.base_forward(jp["base"], jcfg, batch)
    logits, _ = jtf.modular_forward(jp["modular"], jcfg, z)
    loss, grads = jax.value_and_grad(jtf.lm_loss)(jp, jcfg, batch)
    return dict(params=_leaves_np(jp), toks=toks, z=np.asarray(z),
                logits=np.asarray(logits), loss=float(loss),
                grads=_flat(_leaves_np(grads)))


def test_base_and_modular_forward_match_jax(cfg, lm_case):
    p = params_from_numpy(lm_case["params"], device="cpu")
    batch = {"tokens": torch.from_numpy(lm_case["toks"])}
    z, aux = tf.base_forward(p["base"], cfg, batch)
    assert tuple(z.shape) == (B, S, cfg.d_fusion) and float(aux) == 0.0
    np.testing.assert_allclose(z.numpy(), lm_case["z"], **TOL)
    logits, aux = tf.modular_forward(p["modular"], cfg,
                                     torch.from_numpy(lm_case["z"].copy()))
    assert float(aux) == 0.0
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), lm_case["logits"], **TOL)


@pytest.mark.parametrize("remat,ce_chunk", [("none", 0), ("group", 0),
                                            ("layer", 0), ("group", 12)])
def test_lm_loss_and_gradients_match_jax(cfg, lm_case, remat, ce_chunk):
    """Every remat mode (and the chunked CE) gives the reference's loss
    and gradients (its reduced config runs remat 'none', unchunked)."""
    c = cfg.replace(remat=remat, ce_chunk=ce_chunk)
    p = params_from_numpy(lm_case["params"], device="cpu")
    batch = {"tokens": torch.from_numpy(lm_case["toks"])}
    loss, grads = tspmd.value_and_grad(tf.lm_loss, p, c, batch)
    np.testing.assert_allclose(float(loss), lm_case["loss"], **TOL)
    got = _flat(grads)
    assert sorted(got) == sorted(lm_case["grads"])
    for key, want in lm_case["grads"].items():
        np.testing.assert_allclose(got[key].numpy(), want, **TOL,
                                   err_msg=key)


# ------------------------------------------------------------ IFL round


@pytest.mark.parametrize("codec", ["fp32", "int8_row", "ef(int4)"])
def test_ifl_round_step_matches_jax(cfg, jcfg, mesh, codec):
    jparams, jopt = jspmd.init_ifl_state(jax.random.PRNGKey(0), jcfg,
                                         n_clients=N)
    params = unstack_clients(_leaves_np(jparams), device="cpu")
    opt_state = [{"base": {}, "modular": {}} for _ in range(N)]
    jstep = jax.jit(jspmd.make_ifl_round_step(
        jcfg, mesh, n_clients=N, tau=TAU, lr_base=LR, lr_modular=LR,
        codec=codec, debug_return_zhat=True))
    step = tspmd.make_ifl_round_step(cfg, n_clients=N, tau=TAU, lr_base=LR,
                                     lr_modular=LR, codec=codec,
                                     debug_return_zhat=True)
    stateful = get_codec(codec).has_state
    z_shape = (N, B, S, cfg.d_fusion)
    jef = jspmd.init_ef_state(codec, z_shape)
    ef = tspmd.init_ef_state(codec, z_shape)
    for r in range(2):
        toks = _tokens((N, TAU + 1, B, S), seed=10 + r)
        with mesh:
            jout = jstep(jparams, jopt, {"tokens": jnp.asarray(toks)},
                         *((jef,) if stateful else ()))
        jparams, jopt, jm = jout[:3]
        out = step(params, opt_state, {"tokens": torch.from_numpy(toks)},
                   *((ef,) if stateful else ()))
        params, opt_state, m = out[:3]
        for key in ("base_loss", "mod_loss"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       **TOL, err_msg=f"round {r} {key}")
        np.testing.assert_allclose(m["z"].numpy(), np.asarray(jm["z"]),
                                   **TOL)
        # z agrees to ~1e-6, so a code can flip at a .5 boundary: z_hat
        # (and the EF residual) agree within 1e-4 but for such flips,
        # which move an element by one quantization step.
        zh = [m["z_hat"].numpy(), np.asarray(jm["z_hat"])]
        if stateful:
            jef, ef = jout[3], out[3]
            zh += [ef.numpy(), np.asarray(jef)]
        step_q = np.abs(np.asarray(jm["z"])).max() / QMAX[codec]
        for a, b in zip(zh[::2], zh[1::2]):
            off = np.abs(a - b) > 1e-4
            assert off.mean() < 1e-3, off.mean()
            assert np.abs(a - b).max() <= max(1e-4, step_q * 1.01)
        # Integer codes: the port's codec on the reference's z gives the
        # reference's codes.
        jz = np.array(jm["z"])
        inner = codec[3:-1] if codec.startswith("ef(") else codec
        want = jax_get_codec(inner).encode(jnp.asarray(jz))
        got = get_codec(inner).encode(torch.from_numpy(jz))
        for name, a in want.items():
            if not np.issubdtype(np.asarray(a).dtype, np.floating):
                np.testing.assert_array_equal(got[name].numpy(),
                                              np.asarray(a))
    want_params = _flat(_leaves_np(jparams))
    for k in range(N):
        got = _flat(params[k])
        for key, a in want_params.items():
            np.testing.assert_allclose(got[key].numpy(), a[k], rtol=1e-5,
                                       atol=1e-5, err_msg=f"client {k} {key}")


def test_dp_train_step_matches_jax(cfg, jcfg):
    jp = jtf.init_lm(jax.random.PRNGKey(3), jcfg)
    p = params_from_numpy(_leaves_np(jp), device="cpu")
    jopt = jax_make_optimizer("sgd")
    jstate = jopt.init(jp)
    state = make_optimizer("sgd").init(p)
    jstep = jax.jit(jspmd.make_dp_train_step(jcfg, lr=LR))
    step = tspmd.make_dp_train_step(cfg, lr=LR)
    for s in range(2):
        toks = _tokens((B, S), seed=20 + s)
        jp, jstate, jm = jstep(jp, jstate, {"tokens": jnp.asarray(toks)})
        p, state, m = step(p, state, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   **TOL)
    for key, a in _flat(_leaves_np(jp)).items():
        np.testing.assert_allclose(_flat(p)[key].numpy(), a, rtol=1e-5,
                                   atol=1e-5, err_msg=key)


@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(momentum=0.9, weight_decay=0.01)),
    ("adamw", dict(weight_decay=0.1)),
])
def test_optimizers_match_jax(name, kw):
    rng = np.random.default_rng(5)
    tree = {"a": {"w": rng.standard_normal((4, 3)).astype(np.float32)},
            "b": rng.standard_normal((5,)).astype(np.float32)}
    jopt, topt = jax_make_optimizer(name, **kw), make_optimizer(name, **kw)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy(tree, device="cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(3):
        g = jax.tree.map(lambda a: (np.cos(a * (step + 1))).astype(
            np.float32), tree)
        jp, js = jopt.update(jp, jax.tree.map(jnp.asarray, g), js, 0.05)
        tp, ts = topt.update(tp, params_from_numpy(g, device="cpu"), ts,
                             0.05)
    for key, a in _flat(_leaves_np(jp)).items():
        np.testing.assert_allclose(_flat(tp)[key].numpy(), a, rtol=1e-6,
                                   atol=1e-6, err_msg=key)


# ------------------------------------------------------------ the loop


def test_ifl_batches_ledger_and_history_match_jax(cfg, jcfg):
    for r in range(2):
        want = jloop._ifl_batch(JaxSyntheticLM(512, seed=0), jcfg, N, TAU,
                                B, 16, r)["tokens"]
        got = tloop._ifl_batch(SyntheticLM(512, seed=0), cfg, N, TAU, B, 16,
                               r, device="cpu")["tokens"]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    kw = dict(rounds=2, n_clients=N, tau=1, batch=B, seq=16, log_every=1)
    jout = jloop.train_ifl_lm(jcfg, **kw)
    out = tloop.train_ifl_lm(cfg, **kw, device="cpu")
    assert out["ledger"].per_round == jout["ledger"].per_round
    assert (out["ledger"].uplink, out["ledger"].downlink) == (
        jout["ledger"].uplink, jout["ledger"].downlink)
    assert len(out["walls"]) == 2
    for a, b in zip(out["history"], jout["history"]):
        assert sorted(a) == sorted(b)
        assert (a["round"], a["uplink_mb"]) == (b["round"], b["uplink_mb"])
        assert np.isfinite(a["base_loss"]) and np.isfinite(a["mod_loss"])


def test_train_cli_on_cpu(tmp_path):
    out = tlaunch.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                        "--rounds", "2", "--tau", "1", "--n-clients", "2",
                        "--batch", "2", "--seq", "16", "--out",
                        str(tmp_path), "--save-ckpt"])
    hist = json.loads((tmp_path / f"{ARCH}-smoke__ifl.json").read_text())
    assert [h["round"] for h in hist] == [0, 1]
    assert hist == out["history"]
    flat = load_flat(str(tmp_path / f"{ARCH}-smoke__ifl_ckpt"))
    # Clients stacked along a leading (N,) dim, as the reference saves.
    emb = flat["base/embed/table"]
    assert emb.shape == (2, 512, 256)
    np.testing.assert_array_equal(emb[1],
                                  out["params"][1]["base"]["embed"]["table"]
                                  .numpy())
    tlaunch.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--mode",
                  "dp", "--rounds", "2", "--batch", "2", "--seq", "16",
                  "--out", str(tmp_path)])
    dp = json.loads((tmp_path / f"{ARCH}-smoke__dp.json").read_text())
    assert [h["step"] for h in dp] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in dp)


def test_train_cli_runs_on_the_card_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlaunch.main(["--arch", ARCH, "--reduced", "--rounds", "1",
                      "--out", str(tmp_path)])


def test_unsupported_families_and_partial_participation_raise(cfg):
    # llama4 (qk-norm, NoPE, MoE), which raised before item 4a-iii, now
    # takes a DP step (torch on one thread: its many small ops crawl
    # under the test workers' contention otherwise).
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = tloop.train_dp_lm(
            get_config("llama4-maverick-400b-a17b").reduced(), steps=1,
            batch=2, seq=32, device="cpu")
    finally:
        torch.set_num_threads(n)
    assert [h["step"] for h in out["history"]] == [0]
    assert np.isfinite(out["history"][0]["loss"])
