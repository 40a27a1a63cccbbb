"""Cross-family composition in the port: a dense base block composed
with a recurrent (xLSTM) modular block in one serving lane, against the
JAX package's lane (the mirror of ``tests/test_serve.py``'s
``test_cross_arch_lane_dense_base_recurrent_modular``); recurrent *base*
halves with per-slot weights and slots reused after eviction (engine ==
oracle, bitwise); the ragged prefill of recurrent states against the
reference's ``composed_prefill_ragged``; the compose_inference twin's
shapes; and the reduced xlstm-350m through the checks of
``tests/test_arch_smoke.py``.

Params are drawn by the port's init from seeded generators and handed to
both packages as the same numpy arrays. Everything is fp32 on the CPU;
float comparisons hold 1e-5 of the largest |reference| value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.config import LayerSpec as JLayerSpec
from repro.config import ModelConfig as JModelConfig
from repro.models import transformer as jtf
from repro.serve import CompositionStore as JStore
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro_torch.checkpoint import cache_from_numpy
from repro_torch.config import LayerSpec, ModelConfig
from repro_torch.configs import get_config
from repro_torch.examples import compose_inference as twin
from repro_torch.models import transformer as tf
from repro_torch.serve import CompositionStore, Request, ServeEngine
from repro_torch.serve.lanes import _cache_fills, _reset_cache_rows

VOCAB = 128


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else v.detach().numpy()
            for k, v in tree.items()}


def _jax(tree):
    return jax.tree.map(jnp.asarray, _numpy(tree))


def _vendors(spec_cls, cfg_cls):
    """The reference test's two vendors: d 48, 2 heads (head dim 24),
    fusion dim 32."""
    common = dict(vocab_size=VOCAB, d_fusion=32, d_model=48, num_heads=2,
                  num_kv_heads=2, compute_dtype="float32", remat="none",
                  q_block=16, mlstm_chunk=8)
    dense = cfg_cls(
        name="vendor-dense", num_layers=4, d_ff=96,
        base_pattern=(spec_cls(),), base_groups=2,
        mod_pattern=(spec_cls(),), mod_groups=2, **common).validate()
    recur = cfg_cls(
        name="vendor-xlstm", num_layers=4, d_ff=0, rope_type="none",
        base_pattern=(spec_cls(mixer="mlstm", ffn="none"),), base_groups=2,
        mod_pattern=(spec_cls(mixer="slstm", ffn="none"),), mod_groups=2,
        **common).validate()
    return dense, recur


def _init(cfg, seed):
    return tf.init_lm(cfg, generator=torch.Generator().manual_seed(seed),
                      device="cpu")


def test_cross_arch_lane_matches_the_jax_lane():
    dense, recur = _vendors(LayerSpec, ModelConfig)
    jdense, jrecur = _vendors(JLayerSpec, JModelConfig)
    pd, pr = _init(dense, 0), _init(recur, 1)
    jstore = JStore()
    jstore.add_arch(jdense)
    jstore.add_arch(jrecur)
    jstore.set_modular("vendor-xlstm", _jax(pr["modular"]))
    jstore.add_tenant("cross", "vendor-dense", _jax(pd["base"]),
                      modular_arch="vendor-xlstm")
    jcomp = JEngine(jstore, width=2, cache_len=24).run(
        [JRequest(rid=0, tenant="cross", prompt=[1, 2, 3, 4],
                  max_new_tokens=5)])[0]

    store = CompositionStore()
    store.add_arch(dense, reduced=False)
    store.add_arch(recur, reduced=False)
    store.set_modular("vendor-xlstm", pr["modular"])
    store.add_tenant("cross", "vendor-dense", pd["base"],
                     modular_arch="vendor-xlstm")
    eng = ServeEngine(store, width=2, cache_len=24, device="cpu")
    req = Request(rid=0, tenant="cross", prompt=[1, 2, 3, 4],
                  max_new_tokens=5)
    comp = eng.run([req])[0]
    assert comp.tokens == [int(t) for t in jcomp.tokens]
    assert comp.tokens == eng.oracle(req).tokens
    assert all(0 <= t < VOCAB for t in comp.tokens)


def _recurrent_base(mixers):
    """A base half of the given mixers (per-slot weights in a lane)
    under a dense modular half."""
    dense, _ = _vendors(LayerSpec, ModelConfig)
    specs = tuple(LayerSpec(mixer=m, ffn="dense" if m in ("attn", "mamba")
                            else "none", use_rope=False) for m in mixers)
    base = dense.replace(name="vendor-" + "-".join(mixers),
                         num_layers=len(specs) + 2, base_pattern=specs,
                         base_groups=1, rope_type="none").validate()
    return base, dense


def _solo_tokens(store, req, cache_len):
    """Greedy tokens of ``req`` from the model functions alone: one row,
    the tenant's own base (no slot stack), a cache made fresh by
    ``init_composed_cache``, nothing of the lane. Shares no reset code
    with the engine or its oracle."""
    e = store.entry(req.tenant)
    bc, mc = store.cfg(e.arch), store.cfg(e.modular_arch)
    mod = store.modular(e.modular_arch)
    cache = tf.init_composed_cache(bc, mc, 1, cache_len)
    P = len(req.prompt)
    with torch.no_grad():
        last, cache = tf.composed_prefill_ragged(
            e.base, bc, mod, mc, cache, torch.tensor([req.prompt]),
            torch.tensor([P]))
        toks = [int(last.argmax(-1))]
        for t in range(req.max_new_tokens - 1):
            logits, cache = tf.composed_decode_step(
                e.base, bc, mod, mc, cache, torch.tensor([[toks[-1]]]),
                torch.tensor([P + t]))
            toks.append(int(logits[0, -1].argmax()))
    return toks


@pytest.mark.parametrize("mixers", [("mlstm", "slstm"), ("mamba", "attn")])
def test_recurrent_base_half_per_slot_and_reused_slots(mixers):
    base_cfg, mod_cfg = _recurrent_base(mixers)
    store = CompositionStore()
    store.add_arch(base_cfg, reduced=False)
    store.add_arch(mod_cfg, reduced=False)
    store.set_modular(mod_cfg.name, _init(mod_cfg, 9)["modular"])
    for k in range(3):  # three tenants, three different base blocks
        store.add_tenant(f"t{k}", base_cfg.name,
                         _init(base_cfg, 10 + k)["base"],
                         modular_arch=mod_cfg.name)
    eng = ServeEngine(store, width=2, cache_len=32, horizon=2, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, tenant=f"t{i % 3}",
                    prompt=[int(t) for t in rng.integers(0, VOCAB, 3 + 4 * i)],
                    max_new_tokens=4 + i, arrival=i) for i in range(5)]
    comps = eng.run(reqs)
    lane = next(iter(eng._lanes.values()))
    # Five requests through two slots: every slot was reused after an
    # eviction, and its fresh state (-inf stabilizers) had to come back.
    assert len(comps) == 5 and lane.width == 2
    for req, comp in zip(reqs, comps):
        assert comp.tokens == eng.oracle(req).tokens, req.rid
        assert len(comp.tokens) == req.max_new_tokens
        # The engine and its oracle share the lane's reset; a direct
        # one-row decode from a fresh cache does not.
        assert comp.tokens == _solo_tokens(store, req, 32), req.rid


def _states(cache, row):
    return {(part, name, key): t[:, row] for part, sub in cache.items()
            for name, layer in sub.items()
            for key, t in layer["mix"].items() if key != "slot_pos"}


def test_reused_slot_starts_from_the_fresh_state():
    """A slot that held a request is admitted again: right after the
    prefill its recurrent state is what a prefill from a fresh cache
    gives. (The stabilizers cancel in the outputs, so a reset that wrote
    0 where the fresh value is -inf would keep the tokens and the
    engine == oracle contract, which share the reset, but not this.)"""
    base_cfg, mod_cfg = _recurrent_base(("mlstm", "slstm"))
    store = CompositionStore()
    store.add_arch(base_cfg, reduced=False)
    store.add_arch(mod_cfg, reduced=False)
    store.set_modular(mod_cfg.name, _init(mod_cfg, 9)["modular"])
    for k in range(2):
        store.add_tenant(f"t{k}", base_cfg.name,
                         _init(base_cfg, 10 + k)["base"],
                         modular_arch=mod_cfg.name)
    eng = ServeEngine(store, width=2, cache_len=32, device="cpu")
    first = Request(rid=0, tenant="t0", prompt=[3, 1, 4, 1, 5],
                    max_new_tokens=6)
    # A one-token prompt: the running max of a longer one can hide the
    # first step's stabilizer.
    again = Request(rid=1, tenant="t1", prompt=[9], max_new_tokens=2)
    eng.run([first])
    lane = next(iter(eng._lanes.values()))
    assert lane.free_slots() == [0, 1]  # slot 0 held `first`, now free
    lane.admit_batch([(again, store.entry("t1").base)], tick=0)
    solo = tf.init_composed_cache(base_cfg, mod_cfg, 1, 32)
    _, solo = tf.composed_prefill_ragged(
        store.entry("t1").base, base_cfg, store.modular(mod_cfg.name),
        mod_cfg, solo, torch.tensor([again.prompt]), torch.tensor([1]))
    ref = _states(solo, 0)
    for k, t in _states(lane.cache, 0).items():
        assert torch.equal(torch.isfinite(t), torch.isfinite(ref[k])), k
        fin = torch.isfinite(t)
        err = (t[fin] - ref[k][fin]).abs().max()
        assert err <= 1e-5 * max(ref[k][fin].abs().max(), 1.0), k


def test_reset_gives_admitted_rows_the_fresh_state():
    dense, recur = _vendors(LayerSpec, ModelConfig)
    cache = tf.init_composed_cache(recur, dense, 3, 16)
    fresh = tf.init_composed_cache(recur, dense, 1, 16)
    for sub in cache.values():
        for layer in sub.values():
            for t in layer["mix"].values():
                t.fill_(7)
    _reset_cache_rows(cache, _cache_fills(fresh), torch.tensor([0, 2]))
    m = cache["base"]["l0"]["mix"]["mlstm_m"]
    assert torch.all(torch.isneginf(m[:, [0, 2]]))
    for part, sub in cache.items():
        for name, layer in sub.items():
            for key, t in layer["mix"].items():
                ref = fresh[part][name]["mix"][key]
                assert torch.equal(t[:, [0, 2]], ref.expand_as(t[:, [0, 2]]))
                assert torch.all(t[:, 1] == 7), (part, name, key)


def test_ragged_prefill_of_recurrent_states_matches_jax():
    dense, recur = _vendors(LayerSpec, ModelConfig)
    jdense, jrecur = _vendors(JLayerSpec, JModelConfig)
    pr, pd = _init(recur, 3), _init(dense, 4)
    P, lengths = 8, [5, 0, 8]
    toks = np.random.default_rng(1).integers(0, VOCAB, (3, P))
    cache = tf.init_composed_cache(recur, dense, 3, 16)
    fresh = tf.init_composed_cache(recur, dense, 1, 16)
    last, cache = tf.composed_prefill_ragged(
        pr["base"], recur, pd["modular"], dense, cache,
        torch.from_numpy(toks), torch.tensor(lengths))
    jprefill = jax.jit(jtf.composed_prefill_ragged, static_argnums=(1, 3))
    for row, n in enumerate(lengths):
        jcache = jtf.init_composed_cache(jrecur, jdense, 1, 16)
        jlast, jcache = jprefill(
            _jax(pr["base"]), jrecur, _jax(pd["modular"]), jdense, jcache,
            jnp.asarray(toks[row], jnp.int32), jnp.int32(n))
        ref = cache_from_numpy(jax.tree.map(np.asarray, jcache), device="cpu")
        for part, sub in ref.items():
            for name, layer in sub.items():
                for key, t in layer["mix"].items():
                    got = cache[part][name]["mix"][key][:, row:row + 1]
                    if n == 0:  # a row of length 0 is not touched at all
                        assert torch.equal(got,
                                           fresh[part][name]["mix"][key])
                    fin = torch.isfinite(t)  # -inf where still fresh
                    assert torch.equal(fin, torch.isfinite(got))
                    if fin.any():
                        err = (got[fin] - t[fin]).abs().max()
                        assert err <= 1e-5 * max(t[fin].abs().max(), 1.0)
        if n:
            jl = np.array(jlast)
            err = (last[row] - torch.from_numpy(jl)).abs()
            assert err.max() <= 1e-5 * np.abs(jl).max()


def test_twin_composes_every_pair_on_cpu():
    dense, recur = twin.llm_configs()
    # The twin's vendors are the reference example's, field for field.
    jdense = JModelConfig(**{**dense.__dict__, "base_pattern": (JLayerSpec(),),
                             "mod_pattern": (JLayerSpec(),)})
    assert jdense.resolved_head_dim == dense.resolved_head_dim == 48
    out = twin.llm_scale("cpu")
    assert set(out) == {(b, m) for b in ("dense", "xlstm")
                        for m in ("dense", "xlstm")}
    for logits in out.values():
        assert logits.shape == (2, 32, 512)
        assert torch.all(torch.isfinite(logits))
    assert recur.d_fusion == dense.d_fusion


# ----------------------------------- the arch smoke checks, xlstm-350m

B, S = 2, 64


@pytest.fixture(scope="module")
def smoke():
    cfg = get_config("xlstm-350m").reduced()
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)))
    return cfg, _init(cfg, 0), {"tokens": toks}


def _loss_and_grads(params, cfg, batch):
    leaves = []

    def walk(t):
        for v in t.values():
            if isinstance(v, dict):
                walk(v)
            else:
                leaves.append(v.requires_grad_(True))

    walk(params)
    loss = tf.lm_loss(params, cfg, batch)
    return loss, torch.autograd.grad(loss, leaves)


def test_xlstm_forward_and_grad(smoke):
    cfg, params, batch = smoke
    logits, aux, mtp_logits = tf.lm_apply(params, cfg, batch)
    assert float(aux) == 0.0 and mtp_logits is None
    assert logits.shape == (B, S, cfg.vocab_size)
    assert not torch.any(torch.isnan(logits))
    loss, grads = _loss_and_grads(params, cfg, batch)
    gn = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
    assert np.isfinite(float(loss.detach())) and np.isfinite(float(gn))
    assert float(gn) > 0


def test_xlstm_one_train_step_reduces_loss(smoke):
    """SGD along the gradient strictly reduces the loss at a small lr.
    The reference's test takes lr 1e-2 on its own init draws; on these
    draws the exponential gates make the loss sharp enough that 1e-2
    overshoots (in both packages alike), so the step here is 1e-5, small
    enough to stay in the first-order regime."""
    cfg, params, batch = smoke
    loss0, grads = _loss_and_grads(params, cfg, batch)
    it = iter(grads)

    def step(t):
        return {k: step(v) if isinstance(v, dict)
                else (v - 1e-5 * next(it)).detach() for k, v in t.items()}

    loss1 = tf.lm_loss(step(params), cfg, batch)
    assert float(loss1) < float(loss0.detach())


def test_xlstm_decode_step(smoke):
    cfg, params, _ = smoke
    cache = tf.init_composed_cache(cfg, cfg, B, S)
    pos = torch.zeros((B,), dtype=torch.long)
    with torch.no_grad():
        logits, cache = tf.composed_decode_step(
            params["base"], cfg, params["modular"], cfg, cache,
            torch.zeros((B, 1), dtype=torch.long), pos)
        assert logits.shape == (B, 1, cfg.vocab_size)
        assert not torch.any(torch.isnan(logits))
        logits2, _ = tf.composed_decode_step(
            params["base"], cfg, params["modular"], cfg, cache,
            torch.ones((B, 1), dtype=torch.long), pos + 1)
        assert not torch.any(torch.isnan(logits2))
