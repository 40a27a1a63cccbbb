"""The port's SPMD exchange plane and masked LM round step against the
JAX package on the CPU, at the smoke config (4 layers, d_model 48, vocab
128, d_fusion 32, fp32), N 2, tau 2, B 2, S 32.

Both packages get the same seeded numpy inputs; the port starts from
the reference's ``init_ifl_state`` (``checkpoint.unstack_clients``).
Exact: payload leaf names, dtypes and shapes, integer codes on the same
fp32 z, ``age``, ``valid``, ``participating`` and ``cache_valid``, the
host ledger and shipped entries, and absent clients' params, optimizer
state, EF residuals and cache slots (bitwise frozen). Within 1e-4:
losses, decoded z and EF residuals (but for a code flipped by a
last-bit difference in z, one quantization step, as in
tests/test_torch_lm_train.py); params within 1e-5. The JAX step is
jitted (what its trainer runs) and each variant is run once, in a
module fixture shared by the tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from repro.api.spmd import smoke_model_config as jax_smoke_model_config
from repro.core import exchange as jex
from repro.core import ifl_spmd as jspmd
from repro.core.rounds import parse_participation as jparse_participation
from repro_torch.api.spmd import smoke_model_config
from repro_torch.checkpoint import unstack_clients
from repro_torch.config import RunConfig
from repro_torch.core import IFLTrainer
from repro_torch.core import exchange as tex
from repro_torch.core import ifl_spmd as tspmd
from repro_torch.core.codec import get_codec
from repro_torch.core.comm import ifl_round_bytes, tree_leaves
from repro_torch.core.rounds import parse_participation
from repro_torch.models import transformer as tf
from repro_torch.optim import make_optimizer
from test_torch_ifl import _linear_fleets

N, TAU, B, S, LR = 2, 2, 2, 32, 1e-2
D = 32
TOL = dict(rtol=1e-4, atol=1e-4)
QMAX = {"fp32": np.inf, "int8_row": 127, "ef(int4)": 7}
FULL, HALF, NONE = [True, True], [True, False], [False, False]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one intra-op thread: its steps are many small
    ops, and test workers each spinning a thread a core over them run
    many times slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cfg():
    return smoke_model_config()


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                ("client", "data", "model"))


@pytest.fixture(scope="module")
def batch():
    return np.random.default_rng(1).integers(
        0, 128, size=(N, TAU + 1, B, S)).astype(np.int32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_init(optimizer="sgd"):
    jcfg = jax_smoke_model_config()
    params, opt_state = jspmd.init_ifl_state(jax.random.PRNGKey(0), jcfg,
                                             n_clients=N,
                                             optimizer=optimizer)
    return jcfg, params, opt_state


def _port_state(params, opt_state):
    tp = unstack_clients(_np(params), device="cpu")
    if jax.tree.leaves(opt_state):
        to = unstack_clients(_np(opt_state), device="cpu")
    else:
        to = [{"base": {}, "modular": {}} for _ in range(N)]
    return tp, to


@pytest.fixture(scope="module")
def jax_runs(mesh, batch):
    """Each JAX masked-step variant, jitted once and run on a mask
    sequence: key -> list of (params, opt, metrics, cache, ef) per call,
    as numpy."""
    done = {}

    def run(codec, masks, *, optimizer="sgd", max_staleness=2):
        key = (codec, optimizer, max_staleness, tuple(map(tuple, masks)))
        if key in done:
            return done[key]
        jcfg, params, opt_state = _jax_init(optimizer)
        init = _np((params, opt_state))
        # Inputs committed to the mesh, as the step's outputs are, so the
        # second call does not compile the step again.
        rep = NamedSharding(mesh, P())
        params, opt_state = jax.tree.map(
            lambda a: jax.device_put(a, rep), (params, opt_state))
        step = jax.jit(jspmd.make_ifl_round_step(
            jcfg, mesh, n_clients=N, tau=TAU, lr_base=LR, lr_modular=LR,
            optimizer=optimizer, codec=codec, max_staleness=max_staleness,
            partial_participation=True, debug_return_zhat=True))
        cache = jspmd.init_payload_cache(codec, (N, B, S, D), (N, B, S))
        ef = jspmd.init_ef_state(codec, (N, B, S, D))
        stateful = get_codec(codec).has_state
        out = []
        cache, ef = jax.tree.map(lambda a: jax.device_put(a, rep),
                                 (cache, ef))
        toks = {"tokens": jax.device_put(jnp.asarray(batch), rep)}
        with mesh:
            for m in masks:
                res = step(params, opt_state, toks,
                           jax.device_put(jnp.array(m), rep), cache,
                           *((ef,) if stateful else ()))
                params, opt_state, met, cache = res[:4]
                if stateful:
                    ef = res[4]
                out.append(_np((params, opt_state, met, cache,
                                ef if stateful else None)))
        done[key] = (init, out)
        return done[key]

    return run


def _port_run(cfg, init, batch, codec, masks, *, optimizer="sgd",
              max_staleness=2, broadcast="full"):
    params, opt_state = _port_state(*init)
    exchange = tex.SPMDFusionExchange(codec, n_clients=N,
                                      max_staleness=max_staleness,
                                      broadcast=broadcast)
    step = tspmd.make_ifl_round_step(
        cfg, n_clients=N, tau=TAU, lr_base=LR, lr_modular=LR,
        optimizer=optimizer, partial_participation=True,
        debug_return_zhat=True, exchange=exchange)
    cache = tspmd.init_payload_cache(codec, (N, B, S, D), (N, B, S))
    ef = tspmd.init_ef_state(codec, (N, B, S, D))
    stateful = exchange.codec.has_state
    out = []
    for m in masks:
        res = step(params, opt_state, {"tokens": torch.from_numpy(batch)},
                   torch.tensor(m), cache, *((ef,) if stateful else ()))
        params, opt_state, met, cache = res[:4]
        if stateful:
            ef = res[4]
        # Copies: the step updates params and state in place.
        out.append(jax.tree.map(
            lambda a: a.clone() if isinstance(a, torch.Tensor) else a,
            (params, opt_state, met, cache, ef if stateful else None)))
    return exchange, out


def _close_codes(got, want, codec, z):
    """Decoded z / EF residuals: within 1e-4 but for rare one-step flips."""
    step_q = np.abs(z).max() / QMAX[codec]
    off = np.abs(got - want) > 1e-4
    assert off.mean() < 1e-3, off.mean()
    assert np.abs(got - want).max() <= max(1e-4, step_q * 1.01)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = v
    return out


# ------------------------------------------------------ the masked step


@pytest.mark.parametrize("broadcast", ["full", "delta"])
@pytest.mark.parametrize("codec", ["int8_row", "ef(int4)"])
def test_masked_round_matches_jax(cfg, batch, jax_runs, codec, broadcast):
    """Round 0 with everyone up fills the cache; round 1 masks client 1
    out. The port's losses, decoded chunks (client 1's from its cached
    round-0 payload), cache, EF residuals and params follow the JAX
    step's; client 1 is bitwise frozen; the host ledger equals the JAX
    plane's under both broadcast policies."""
    init, jout = jax_runs(codec, [FULL, HALF])
    plane, out = _port_run(cfg, init, batch, codec, [FULL, HALF],
                           broadcast=broadcast)
    stateful = codec.startswith("ef(")
    for r, ((tp, to, tm, tc, te), (jp, jo, jm, jc, je)) in enumerate(
            zip(out, jout)):
        for key in ("base_loss", "mod_loss"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), **TOL,
                                       err_msg=f"round {r} {key}")
        assert float(tm["participating"]) == float(jm["participating"])
        assert float(tm["cache_valid"]) == float(jm["cache_valid"])
        np.testing.assert_array_equal(tc["age"].numpy(), jc["age"])
        np.testing.assert_array_equal(tc["tokens"].numpy(), jc["tokens"])
        assert sorted(tc["payload"]) == sorted(jc["payload"])
        for name, a in jc["payload"].items():
            assert tc["payload"][name].numpy().dtype == a.dtype
            assert tuple(tc["payload"][name].shape) == a.shape
        live = [k for k in range(N) if [FULL, HALF][r][k]]
        np.testing.assert_allclose(tm["z"].numpy()[live], jm["z"][live],
                                   **TOL)
        _close_codes(tm["z_hat"].numpy(), jm["z_hat"], codec, jm["z"])
        if stateful:
            _close_codes(te.numpy(), je, codec, jm["z"])
        # The port's codec on the reference's input to the encode (z, plus
        # its carried residual under EF) gives the reference's codes: the
        # integer leaves of the participants' fresh cache slots.
        inner = get_codec(codec[3:-1] if stateful else codec)
        for k in live:
            ck = jm["z"][k] + (jout[r - 1][4][k] if stateful and r else 0.0)
            got = inner.encode(torch.from_numpy(np.asarray(ck, np.float32)))
            for name, a in jc["payload"].items():
                if not np.issubdtype(a.dtype, np.floating):
                    np.testing.assert_array_equal(got[name].numpy(), a[k])
    assert float(out[1][2]["participating"]) == 1.0
    assert float(out[1][2]["cache_valid"]) == 2.0
    np.testing.assert_array_equal(out[1][3]["age"].numpy(), [0, 1])
    # Client 1 is frozen in round 1: params, cache slot, EF residual.
    for a, b in zip(tree_leaves(out[0][0][1]), tree_leaves(out[1][0][1])):
        assert torch.equal(a, b)
    for name in out[0][3]["payload"]:
        assert torch.equal(out[0][3]["payload"][name][1],
                           out[1][3]["payload"][name][1])
    if stateful:
        assert torch.equal(out[0][4][1], out[1][4][1])
    want_params = _flat(jout[1][0])
    for k in range(N):
        got = _flat(out[1][0][k])
        for key, a in want_params.items():
            np.testing.assert_allclose(got[key].numpy(), a[k], rtol=1e-5,
                                       atol=1e-5, err_msg=f"{k} {key}")
    # The host half: the same ledger and valid entries as the JAX plane.
    jplane = jex.SPMDFusionExchange(codec, None, n_clients=N,
                                    max_staleness=2, broadcast=broadcast)
    entry = get_codec(codec).encoded_nbytes((B, S, D)) + B * S * 4
    for r, parts in enumerate([[0, 1], [0]]):
        got = plane.account_round(parts, r, entry)
        assert got == jplane.account_round(parts, r, entry)
        assert got[0] == float(out[r][2]["cache_valid"])
        plane.ledger.end_round()
        jplane.ledger.end_round()
    assert plane.ledger.per_round == jplane.ledger.per_round
    assert plane.aux_state() == jplane.aux_state()


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_masked_round_staleness_excludes_expired(cfg, batch, jax_runs,
                                                 optimizer):
    """max_staleness 0: client 1's round-0 chunk has expired in round 1,
    so the participant takes ONE modular step, on its own fresh chunk,
    and the expired chunk moves neither the params nor adamw's state."""
    masks = [FULL, HALF, NONE] if optimizer == "sgd" else [FULL, HALF]
    init, jout = jax_runs("fp32", masks, optimizer=optimizer,
                          max_staleness=0)
    _, out = _port_run(cfg, init, batch, "fp32", masks, optimizer=optimizer,
                       max_staleness=0)
    assert [float(o[2]["cache_valid"]) for o in out[:2]] == [2.0, 1.0]
    assert np.isfinite(float(out[1][2]["mod_loss"]))
    # Hand-rolled: one update of client 0's round-0 modular block on the
    # valid chunk.
    opt = make_optimizer(optimizer)
    mp0 = jax.tree.map(torch.clone, out[0][0][0]["modular"])
    os0 = jax.tree.map(torch.clone, out[0][1][0]["modular"])
    z0 = out[1][2]["z_hat"][0]
    _, g = tspmd.value_and_grad(tspmd._modular_loss, mp0, cfg, z0,
                                torch.from_numpy(batch[0, TAU]))
    opt.update(mp0, g, os0, LR)
    for a, b in zip(tree_leaves(mp0), tree_leaves(out[1][0][0]["modular"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)
    for r in range(2):
        for key in ("base_loss", "mod_loss"):
            np.testing.assert_allclose(float(out[r][2][key]),
                                       float(jout[r][2][key]), **TOL)
    # Against the JAX step: sgd's params; adamw's moments (its update
    # m / sqrt(v) scales an entry whose gradient is near 0 up to lr, so a
    # last-bit difference in such a gradient moves the param by ~1e-4
    # while m and v agree).
    want = _flat(jout[1][0]["modular"] if optimizer == "sgd" else
                 {k: jout[1][1]["modular"][k] for k in ("m", "v")})
    got = _flat(out[1][0][0]["modular"] if optimizer == "sgd" else
                {k: out[1][1][0]["modular"][k] for k in ("m", "v")})
    for key, a in want.items():
        np.testing.assert_allclose(got[key].numpy(), a[0], rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    if optimizer == "adamw":
        # Two valid chunks in round 0, one in round 1.
        assert int(out[1][1][0]["modular"]["step"]) == int(
            jout[1][1]["modular"]["step"][0]) == 3


def test_masked_round_empty_is_noop_with_nan_losses(cfg, batch, jax_runs):
    """An all-False mask: params, optimizer state and cache bitwise as
    they were but for ages + 1, NaN losses, nothing encoded; the JAX
    step reports the same."""
    masks = [FULL, HALF, NONE]
    init, jout = jax_runs("fp32", masks, optimizer="sgd", max_staleness=0)
    _, out = _port_run(cfg, init, batch, "fp32", masks, max_staleness=0)
    before, after = out[1], out[2]
    for key in ("base_loss", "mod_loss"):
        assert np.isnan(float(after[2][key]))
        assert np.isnan(float(jout[2][2][key]))
    assert float(after[2]["participating"]) == 0.0
    assert float(after[2]["cache_valid"]) == float(jout[2][2]["cache_valid"])
    for a, b in zip(tree_leaves((before[0], before[3]["payload"],
                                 before[3]["tokens"])),
                    tree_leaves((after[0], after[3]["payload"],
                                 after[3]["tokens"]))):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(after[3]["age"].numpy(),
                                  before[3]["age"].numpy() + 1)
    np.testing.assert_array_equal(after[3]["age"].numpy(), jout[2][3]["age"])


# ------------------------------------------------------------ the wire


@pytest.mark.parametrize("codec", ["int8_row", "ef(int4)", "topk0.25",
                                   "int8", "ef(sketch0.5)", "fp32"])
def test_wire_matches_jax_on_the_same_z(mesh, codec):
    """The plane's masked wire alone, three rounds over N 3 with the same
    fp32 z on both sides: the initial cache's leaves, the payload codes,
    ages (a never-filled slot stays at _NEVER), valid weights, tokens
    exact; floats and EF residuals within 1e-6."""
    n, shape = 3, (2, 5, 40)
    rng = np.random.default_rng(7)
    jplane = jex.SPMDFusionExchange(codec, mesh, n_clients=n,
                                    max_staleness=1)
    tplane = tex.SPMDFusionExchange(codec, n_clients=n, max_staleness=1)
    jwire = jax.jit(jplane.wire)
    jc = jex.init_payload_cache(codec, (n,) + shape, (n,) + shape[:-1])
    tc = tex.init_payload_cache(codec, (n,) + shape, (n,) + shape[:-1])
    assert {k: (str(v.dtype), v.shape) for k, v in jc["payload"].items()} \
        == {k: (str(v.numpy().dtype), tuple(v.shape))
            for k, v in tc["payload"].items()}
    np.testing.assert_array_equal(tc["age"].numpy(), np.asarray(jc["age"]))
    je = jex.init_ef_state(codec, (n,) + shape)
    te = tex.init_ef_state(codec, (n,) + shape)
    for r, m in enumerate([[True, True, False], [False, True, False],
                           [True, False, False]]):
        z = rng.standard_normal((n,) + shape).astype(np.float32)
        toks = rng.integers(0, 99, size=(n,) + shape[:-1]).astype(np.int32)
        with mesh:
            jzg, jyg, jvalid, jc, je = jwire(jnp.asarray(z), jnp.asarray(toks),
                                             jnp.asarray(m), jc, je)
        tzg, tyg, tvalid, tc, te = tplane.wire(
            torch.from_numpy(z), torch.from_numpy(toks), torch.tensor(m), tc,
            te)
        np.testing.assert_array_equal(tc["age"].numpy(), np.asarray(jc["age"]))
        np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
        np.testing.assert_array_equal(tyg.numpy(), np.asarray(jyg))
        for name, a in jc["payload"].items():
            a, b = np.asarray(a), tc["payload"][name].numpy()
            if np.issubdtype(a.dtype, np.floating):
                np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)
            else:
                np.testing.assert_array_equal(b, a, err_msg=f"{r} {name}")
        np.testing.assert_allclose(tzg.numpy(), np.asarray(jzg), rtol=1e-6,
                                   atol=1e-6)
        if get_codec(codec).has_state:
            np.testing.assert_allclose(te.numpy(), np.asarray(je),
                                       rtol=1e-6, atol=1e-6)
    # Slot 2 never uploaded: still _NEVER, never valid.
    assert int(tc["age"][2]) == tex._NEVER and float(tvalid[2]) == 0.0


def test_round_step_refuses_a_conflicting_plane(cfg):
    plane = tex.SPMDFusionExchange("int8_row", n_clients=N, max_staleness=2)
    with pytest.raises(ValueError, match="codec='fp32' conflicts"):
        tspmd.make_ifl_round_step(cfg, n_clients=N, tau=1, codec="fp32",
                                  exchange=plane)
    with pytest.raises(ValueError, match="max_staleness=3 conflicts"):
        tspmd.make_ifl_round_step(cfg, n_clients=N, tau=1, max_staleness=3,
                                  exchange=plane)
    # Inherit (None) or agree: fine.
    tspmd.make_ifl_round_step(cfg, n_clients=N, tau=1, codec="int8_row",
                              max_staleness=2, exchange=plane)


# ------------------------------------------------------ host accounting


@pytest.mark.parametrize("broadcast", ["full", "delta"])
@pytest.mark.parametrize("schedule,max_staleness,population", [
    ("k2", None, False), ("bern0.5", 1, False), ("straggle(0.5,2)", 0, False),
    ("k3", 2, True), ("bern0.3", 1, True)])
def test_account_round_matches_jax(schedule, max_staleness, population,
                                   broadcast):
    """Over 12 rounds of a schedule's mask stream: valid and shipped
    entries, per-round ledger bytes and the plane's aux state equal the
    JAX plane's; ``prune`` ages the same mirrors in the population
    regime."""
    n = 6
    kw = dict(n_clients=n, max_staleness=max_staleness, broadcast=broadcast,
              population=population)
    jplane = jex.SPMDFusionExchange("int8_row", None, **kw)
    tplane = tex.SPMDFusionExchange("int8_row", **kw)
    rng = np.random.default_rng(3)
    sched = parse_participation(schedule)
    for r in range(12):
        parts = np.flatnonzero(sched.mask(r, n, rng))
        got = tplane.account_round(parts, r, 100)
        assert got == jplane.account_round(parts, r, 100), r
        for p in (tplane, jplane):
            p.ledger.end_round()
            p.prune(r)
    assert tplane.ledger.per_round == jplane.ledger.per_round
    assert tplane.aux_state() == jplane.aux_state()


def test_delta_rejoin_catch_up_exceeds_fresh_set():
    """A rejoining client needs an entry that did not refresh this round:
    round 2 ships slot 1's round-1 entry as catch-up, so E (3) exceeds
    the fresh uploads (2)."""
    plane = tex.SPMDFusionExchange(None, n_clients=3, broadcast="delta")
    rows = [[0, 1, 2], [0, 1], [0, 2]]
    entry = ifl_round_bytes(1, 4, 16, participating=1,
                            broadcast_entries=0)["up"]
    shipped = []
    for r, parts in enumerate(rows):
        shipped.append(plane.account_round(parts, r, entry)[1])
        plane.ledger.end_round()
    assert shipped == [3, 2, 3]
    assert plane.ledger.per_round[2] == ifl_round_bytes(
        3, 4, 16, participating=2, broadcast="delta", delta_entries=3)


def test_delta_k1_eager_and_spmd_accounting_agree():
    """K = 1 rounds never re-ship the sole fresh entry to its producer:
    the port's eager trainer and its SPMD plane, fed the same
    participants, ledger the same bytes round for round."""

    _, tc = _linear_fleets(n=2)
    cfg = RunConfig(n_clients=2, tau=0, batch_size=4, d_fusion=16,
                    participation="k1", broadcast="delta")
    tr = IFLTrainer(tc, cfg, seed=2, device="cpu")
    plane = tex.SPMDFusionExchange("fp32", n_clients=2, broadcast="delta")
    entry = ifl_round_bytes(1, 4, 16, participating=1,
                            broadcast_entries=0)["up"]
    for r in range(6):
        m = tr.run_round()
        valid, shipped = plane.account_round(m["participants"], r, entry)
        plane.ledger.end_round()
        assert valid == m["cache_size"]
        assert shipped == m["shipped_entries"], r
        assert plane.ledger.per_round[r] == tr.ledger.per_round[r], r
    fresh = tex.SPMDFusionExchange("fp32", n_clients=2, broadcast="delta")
    assert fresh.account_round([0], 0, entry) == (1, 0)
    assert fresh.account_round([0], 1, entry) == (1, 0)
    assert fresh.account_round([1], 2, entry) == (2, 1)


@pytest.mark.parametrize("schedule,kw", [
    ("full", {}), ("k2", {}), ("bern0.5", dict(max_staleness=1)),
    ("straggle(0.5,2)", {}), ("k3", dict(cohort=2, max_staleness=2))])
def test_expected_delta_entries_matches_jax(schedule, kw):
    """The analytic mean shipped-entry count equals the JAX package's for
    the same schedule and seed: N at full participation, above K under
    partial schedules, and under a cohort."""
    got = tex.expected_delta_entries(parse_participation(schedule), 4,
                                     rounds=64, **kw)
    want = jex.expected_delta_entries(jparse_participation(schedule), 4,
                                      rounds=64, **kw)
    assert got == want
    if schedule == "full":
        assert got == 4
    if schedule == "k2":
        assert 2.0 < got <= 4


def test_expected_delta_entries_equals_a_measured_run():
    """For a deterministic schedule, the replay equals the mean the
    port's eager trainer ships."""
    sched = "straggle(0.5,2)"
    _, tc = _linear_fleets()
    cfg = RunConfig(n_clients=4, tau=0, batch_size=4, d_fusion=16,
                    participation=sched, broadcast="delta")
    tr = IFLTrainer(tc, cfg, seed=0, device="cpu")
    shipped = [tr.run_round()["shipped_entries"] for _ in range(8)]
    assert tex.expected_delta_entries(parse_participation(sched), 4,
                                      rounds=8) == sum(shipped) / 8


# ---------------------------------------------------- slot init, serving


def test_slot_init_is_a_function_of_seed_and_slot(cfg):
    a, sa = tspmd.init_ifl_slot_state(cfg, seed=3, slot=5)
    b, _ = tspmd.init_ifl_slot_state(cfg, seed=3, slot=5)
    c, _ = tspmd.init_ifl_slot_state(cfg, seed=3, slot=6)
    d, _ = tspmd.init_ifl_slot_state(cfg, seed=4, slot=5)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
    assert not torch.equal(a["base"]["embed"]["table"],
                           c["base"]["embed"]["table"])
    assert not torch.equal(a["base"]["embed"]["table"],
                           d["base"]["embed"]["table"])
    assert sa == {"base": {}, "modular": {}}
    _, sw = tspmd.init_ifl_slot_state(cfg, seed=3, slot=5,
                                      optimizer="adamw")
    assert int(sw["base"]["step"]) == 0


def test_prefill_and_serve_steps_match_jax(cfg, mesh):
    """``make_prefill_step`` gives the JAX package's logits on its init;
    ``make_serve_step`` over a fresh cache, token by token, gives the
    prefill's logits at each position."""
    jcfg = jax_smoke_model_config()
    jp = jax.tree.map(lambda a: a[0], _jax_init()[1])
    toks = np.random.default_rng(2).integers(0, 128, (2, 6)).astype(np.int32)
    want = np.asarray(jax.jit(jspmd.make_prefill_step(jcfg))(
        jp, {"tokens": jnp.asarray(toks)}))
    tp = unstack_clients(_np(jax.tree.map(lambda a: a[None], jp)),
                         device="cpu")[0]
    got = tspmd.make_prefill_step(cfg)(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    serve = tspmd.make_serve_step(cfg)
    cache = tf.init_composed_cache(cfg, cfg, 2, 8, device="cpu")
    with torch.no_grad():
        for t in range(toks.shape[1]):
            logits, cache = serve(tp, cache, torch.from_numpy(toks[:, t:t + 1]),
                                  t)
            np.testing.assert_allclose(logits[:, 0].numpy(), want[:, t],
                                       **TOL)


def test_smoke_model_config_matches_jax():
    """The port's smoke LM config is the JAX package's, field for field."""
    import dataclasses

    assert dataclasses.asdict(smoke_model_config()) == dataclasses.asdict(
        jax_smoke_model_config())
