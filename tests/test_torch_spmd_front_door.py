"""The port's SPMD trainer behind the front door (``run_experiment`` of
``ifl_spmd``, ``synth_tokens``, ``save_trainer`` / ``load_trainer``),
its export to serving (``CompositionStore.from_spmd_trainer``) and the
quickstart's ``--scheme``, on the CPU, against the JAX package.

Runs use the smoke LM (4 layers, d_model 48, d_fusion 32), tau 1, Bc 2,
S 32, and start the port from the JAX trainer's own init (its stacked
``init_ifl_state`` for the legacy regime, ``init_ifl_slot_state`` slot by
slot for a population). Exact: participants, arrivals, cache sizes,
shipped entries and per-round ledger bytes; greedy tokens served from
one checkpoint. Within 1e-4: losses; accuracies within two tokens of
the held-out batch. Port against port (save/resume, delta against full)
is bitwise. Each JAX trainer is built and run once, in a module fixture.
"""

import dataclasses
import io
import os
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from repro.api import DataSpec as JDataSpec
from repro.api import ExperimentSpec as JSpec
from repro.api import FleetSpec as JFleetSpec
from repro.api import load_trainer as jload_trainer
from repro.api import save_trainer as jsave_trainer
from repro.api.spmd import SPMDIFLTrainer as JSPMDIFLTrainer
from repro.configs import get_config as jget_config
from repro.core.ifl_spmd import init_ifl_slot_state as jinit_slot
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.store import CompositionStore as JCompositionStore
from repro.serve.types import Request as JRequest
from repro_torch import api as tapi
from repro_torch.api.spmd import SPMDIFLTrainer, smoke_model_config
from repro_torch.core.comm import ifl_round_bytes, tree_leaves
from repro_torch.core.exchange import _NEVER
from repro_torch.core.rounds import AsyncRoundEngine
from repro_torch.examples.llm_ifl_train import olmo_100m
from repro_torch.launch import quickstart
from repro_torch.serve import CompositionStore, ServeEngine
from repro_torch.serve.store import _resolve_cfg
from repro_torch.serve.types import Request

BASE = dict(scheme="ifl_spmd", tau=1, batch_size=2, d_fusion=32, lr=0.05,
            eval_every=0, seed=0)
LEGACY = dict(rounds=4, participation="k2", codec="ef(int4)",
              broadcast="delta", max_staleness=1)
COHORT = dict(rounds=4, mode="async", trace="pareto(1.2,0.5)",
              codec="int8_row", broadcast="delta", max_staleness=2,
              fleet=dict(n_population=16, cohort=2))
N_TEST, SEQ = 8, 32
TOL = dict(rtol=1e-4, atol=1e-4)
# Accuracy: the fraction of N_TEST x (SEQ - 1) next tokens; two may flip.
ACC_TOL = 2.0 / (N_TEST * (SEQ - 1))
REQS = [dict(rid=i, tenant=f"client{i}", prompt=[1 + i, 2, 3],
             max_new_tokens=6) for i in range(3)]


def _specs(**kw):
    kw = {**BASE, **kw}
    fleet = kw.pop("fleet", {})
    jspec = JSpec(**kw, fleet=JFleetSpec(**fleet),
                  data=JDataSpec(dataset="synth_tokens", n_test=N_TEST))
    tspec = tapi.ExperimentSpec(**kw, fleet=tapi.FleetSpec(**fleet),
                                data=tapi.DataSpec(dataset="synth_tokens",
                                                   n_test=N_TEST))
    assert tspec.spec_hash() == jspec.spec_hash()
    return jspec, tspec


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one intra-op thread: its steps are many small
    ops, and test workers each spinning a thread a core over them run
    many times slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _commit(jt):
    """Put a legacy JAX trainer's carried state on its mesh, as the
    step's outputs are, so the step compiles once, not twice."""
    rep = NamedSharding(jt.mesh, P())
    put = lambda t: jax.tree.map(lambda a: jax.device_put(a, rep), t)
    jt.params, jt.opt_state = put(jt.params), put(jt.opt_state)
    jt.cache = put(jt.cache)
    if jt.ef_state is not None:
        jt.ef_state = put(jt.ef_state)


def _same_rounds(tr, jr, *, exact_losses=False):
    """Port reports against JAX reports: exact bookkeeping, losses within
    1e-4 (or bitwise)."""
    assert len(tr) == len(jr)
    for a, b in zip(tr, jr):
        assert a.round == b.round and a.participants == b.participants
        assert (a.uplink_mb, a.downlink_mb) == (b.uplink_mb, b.downlink_mb)
        for k in ("cache_size", "shipped_entries", "sim_time", "arrivals",
                  "uploads_per_sec"):
            assert a.metrics.get(k) == b.metrics.get(k), k
        for k in ("base_loss", "mod_loss"):
            if exact_losses:
                assert a[k] == b[k] or (np.isnan(a[k]) and np.isnan(b[k]))
            else:
                np.testing.assert_allclose(a[k], b[k], **TOL, err_msg=k)


def _equal_trees(a, b):
    """Bitwise equal, key by key (a loaded tree's keys come sorted)."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal_trees(a[k], b[k])
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


def _serve(store, engine_cls, req_cls, **kw):
    eng = engine_cls(store, width=2, cache_len=32, horizon=4, **kw)
    return [c.tokens for c in eng.run([req_cls(**r) for r in REQS])]


@pytest.fixture(scope="module")
def legacy(tmp_path_factory):
    """The legacy regime: one JAX trainer (k2, ef(int4), delta,
    max_staleness 1) run 4 rounds, saved after 2 and exported (served)
    there; the port's run from the JAX init, saved after 2; the JAX
    trainer resumed from the port's checkpoint for 2 rounds."""
    d = tmp_path_factory.mktemp("legacy")
    jspec, tspec = _specs(**LEGACY)
    jt = JSPMDIFLTrainer(jspec)
    _commit(jt)
    init = [jax.tree.map(lambda a: np.asarray(a[k]), jt.params)
            for k in range(jspec.fleet.n_clients)]
    jreports = [jt.run_round() for _ in range(2)]
    jsave_trainer(str(d / "jax"), jt)
    jtokens = _serve(JCompositionStore.from_spmd_trainer(jt), JServeEngine,
                     JRequest)
    jreports += [jt.run_round() for _ in range(2)]
    jaccs = jt.evaluate()
    jledger = list(jt.ledger.per_round)

    port = tapi.build_trainer(tspec, device="cpu", params=init)
    preports = [port.run_round() for _ in range(2)]
    tapi.save_trainer(str(d / "port"), port)
    preports += [port.run_round() for _ in range(2)]
    jload_trainer(str(d / "port"), jt)
    _commit(jt)
    jfrom_port = [jt.run_round() for _ in range(2)]
    return dict(tspec=tspec, init=init, jreports=jreports, jaccs=jaccs,
                jledger=jledger, jtokens=jtokens, jpath=str(d / "jax"),
                preports=preports, jfrom_port=jfrom_port)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """The population regime under async ticks: one JAX trainer (N 16,
    cohort 2, pareto arrivals, int8_row, delta) run 4 ticks, saved after
    2; the port's run from the same slot inits, saved after 2; the JAX
    trainer resumed from the port's sparse checkpoint for 2 ticks."""
    d = tmp_path_factory.mktemp("cohort")
    jspec, tspec = _specs(**COHORT)
    jt = JSPMDIFLTrainer(jspec)
    jcfg = jt.model_cfg

    class JaxSlots:
        def __getitem__(self, slot):
            p, _ = jinit_slot(jax.random.PRNGKey(jspec.seed), jcfg,
                              slot=slot)
            return jax.tree.map(np.asarray, p)

    jreports = [jt.run_round() for _ in range(2)]
    jsave_trainer(str(d / "jax"), jt)
    jreports += [jt.run_round() for _ in range(2)]
    port = tapi.build_trainer(tspec, device="cpu", params=JaxSlots())
    preports = [port.run_round() for _ in range(2)]
    tapi.save_trainer(str(d / "port"), port)
    preports += [port.run_round() for _ in range(2)]
    jload_trainer(str(d / "port"), jt)
    jfrom_port = [jt.run_round() for _ in range(2)]
    return dict(tspec=tspec, slots=JaxSlots(), jreports=jreports,
                jaccs=jt.evaluate(), jpath=str(d / "jax"),
                jstore_slots=jt.store.slots(), port=port, preports=preports,
                jfrom_port=jfrom_port)


# ----------------------------------------------------------- the scheme


def test_scheme_builds_on_synth_tokens_and_the_card_by_default():
    _, tspec = _specs(rounds=1)
    assert tapi.load_data(tspec) == tapi.DataBundle(None, None, None, None)
    tr = tapi.build_trainer(tspec, device="cpu")
    assert isinstance(tr, SPMDIFLTrainer) and isinstance(tr, tapi.Trainer)
    assert tr.device.type == "cpu" and not tr.partial
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            SPMDIFLTrainer(tspec)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tapi.run_experiment(tspec)


def test_full_participation_through_the_front_door():
    """Every client every round, bytes on the ledger, accuracies in
    [0, 1] (the reference's cross-scheme contract for ifl_spmd)."""
    _, tspec = _specs(rounds=2)
    res = tapi.run_experiment(tspec, device="cpu", keep_trainer=True)
    assert len(res.reports) == 2
    assert res.uplink_mb > 0 and res.downlink_mb > 0
    assert 0.0 <= res.final["acc_mean"] <= 1.0
    assert all(rep["participants"] == [0, 1, 2, 3] for rep in res.reports)
    assert quickstart.round_bytes_match(res.trainer, tspec)


def test_run_experiment_matches_jax(legacy):
    """k2, ef(int4), delta, max_staleness 1 over 4 rounds from the JAX
    init: the port's run_experiment follows the JAX trainer."""
    res = tapi.run_experiment(legacy["tspec"], device="cpu",
                              params=legacy["init"], keep_trainer=True)
    _same_rounds(res.trainer.engine.history, legacy["jreports"])
    assert res.trainer.ledger.per_round == legacy["jledger"]
    np.testing.assert_allclose(res.final["accs"], legacy["jaccs"], rtol=0,
                               atol=ACC_TOL)
    assert quickstart.round_bytes_match(res.trainer, legacy["tspec"])
    # run_experiment is the trainer's rounds: the fixture's direct run of
    # the same trainer is bitwise the same.
    _same_rounds(res.trainer.engine.history, legacy["preports"],
                 exact_losses=True)


def test_jax_checkpoint_resumes_in_the_port(legacy):
    port = tapi.load_trainer(legacy["jpath"], tapi.build_trainer(
        legacy["tspec"], device="cpu"))
    _same_rounds([port.run_round() for _ in range(2)],
                 legacy["jreports"][2:])


def test_port_checkpoint_resumes_in_jax(legacy):
    _same_rounds(legacy["preports"][2:], legacy["jfrom_port"])


def test_jax_checkpoint_exported_by_the_port_serves_jax_tokens(legacy):
    """A JAX-trained checkpoint, loaded and exported by the port, serves
    the JAX engine's greedy tokens; its fusion state is the valid slots'
    decoded cache."""
    port = tapi.load_trainer(legacy["jpath"], tapi.build_trainer(
        legacy["tspec"], device="cpu"))
    store = CompositionStore.from_spmd_trainer(port)
    assert store.tenants() == [f"client{k}" for k in range(4)]
    ages = port.cache["age"].tolist()
    for k in range(4):
        fusion = store.entry(f"client{k}").fusion
        assert (fusion is not None) == (ages[k] <= 1)
        if fusion is not None:
            assert tuple(fusion["z_hat"].shape) == (2, SEQ, 32)
    assert _serve(store, ServeEngine, Request, device="cpu") \
        == legacy["jtokens"]


# ------------------------------------------------------- delta, resumes


@pytest.mark.parametrize("codec", ["int8_row", "ef(int4)"])
def test_delta_ledger_parity_and_training_equal_to_full(codec):
    """Under delta every round's ledger is ``ifl_round_bytes(delta,
    shipped)``; the training is bitwise the full broadcast's, with the
    same uplink and less downlink."""
    _, tspec = _specs(rounds=4, participation="k2", codec=codec,
                      broadcast="delta")
    res = tapi.run_experiment(tspec, device="cpu", keep_trainer=True)
    tr = res.trainer
    for r, rep in enumerate(tr.engine.history):
        assert tr.ledger.per_round[r] == ifl_round_bytes(
            4, 2 * SEQ, 32, codec=codec,
            participating=len(rep.participants),
            broadcast_entries=rep["cache_size"], broadcast="delta",
            delta_entries=rep["shipped_entries"])
    full = tapi.run_experiment(tspec.replace(broadcast="full"), device="cpu",
                               keep_trainer=True)
    for a, b in zip(tree_leaves(tr.params), tree_leaves(full.trainer.params)):
        assert torch.equal(a, b)
    assert res.downlink_mb < full.downlink_mb
    assert res.uplink_mb == full.uplink_mb
    assert [r["cache_size"] for r in res.reports] == \
        [r["cache_size"] for r in full.reports]


def test_resume_restores_delta_mirrors_bitwise(tmp_path):
    """A save after 2 rounds, loaded into a fresh trainer, replays the
    next 2 rounds bit for bit: losses, participants, shipped entries and
    bytes (the plane's host state rides in the aux)."""
    _, tspec = _specs(rounds=8, seed=1, participation="k2",
                      codec="int8_row", broadcast="delta")
    tr = tapi.build_trainer(tspec, device="cpu")
    for _ in range(2):
        tr.run_round()
    path = str(tmp_path / "ck")
    tapi.save_trainer(path, tr)
    cont = [tr.run_round() for _ in range(2)]
    tr2 = tapi.load_trainer(path, tapi.build_trainer(tspec, device="cpu"))
    _same_rounds([tr2.run_round() for _ in range(2)], cont,
                 exact_losses=True)


def test_legacy_aux_restore_rebuilds_age_replica():
    """An aux without the plane's state (an older checkpoint) brings the
    cache back warm: the host age replica is rebuilt from the ages."""
    _, tspec = _specs(rounds=8, seed=3, participation="k2")
    tr = tapi.build_trainer(tspec, device="cpu")
    for _ in range(3):
        tr.run_round()
    tree, aux = tr.snapshot()
    assert "exchange" in aux
    tr2 = tapi.build_trainer(tspec, device="cpu")
    tr2.restore(tree, {k: v for k, v in aux.items() if k != "exchange"})
    assert tr2.exchange._last_upload == tr.exchange._last_upload
    a, b = tr.run_round(), tr2.run_round()
    assert a["cache_size"] == b["cache_size"]
    assert a.downlink_mb == b.downlink_mb


# -------------------------------------------------- async and cohorts


def test_async_ticks_and_accounting():
    """Async ticks on the legacy regime: the masked step every tick,
    sim_time a tick a second, uplink == uploads x the entry's bytes, and
    the first tick's arrivals those of a plain async engine."""
    _, tspec = _specs(rounds=3, mode="async", trace="pareto(1.2,0.5)")
    tr = tapi.build_trainer(tspec, device="cpu")
    assert tr.partial
    reps = [tr.run_round() for _ in range(3)]
    for i, rep in enumerate(reps):
        assert rep["sim_time"] == pytest.approx(i + 1.0)
        assert tr.ledger.per_round[i]["up"] == \
            len(rep.participants) * tr._entry_bytes
    eager = AsyncRoundEngine(4, tspec.trace, tick=1.0, seed=tspec.seed)
    assert list(eager.participants()) == reps[0].participants


def test_async_cohort_run_matches_jax(cohort):
    """N 16, cohort 2, async pareto ticks: arrivals, participants, bytes
    exact, losses within 1e-4; the store holds the trained slots only."""
    _same_rounds(cohort["preports"], cohort["jreports"])
    port = cohort["port"]
    assert port.store.slots() == cohort["jstore_slots"]
    assert all(0 <= s < 16 for s in port.store.slots())
    assert all(len(r.participants) <= 2 for r in cohort["preports"])


def test_cohort_rounds_and_sparse_snapshot():
    """Sync cohorts of 2 from 16: K == C every round, the ledger of C
    uploads and C x C entries down, a store of the trained slots only,
    evaluation of the last cohort, and a sparse snapshot."""
    _, tspec = _specs(rounds=2, fleet=dict(n_population=16,
                                                     cohort=2))
    tr = tapi.build_trainer(tspec, device="cpu")
    for _ in range(2):
        tr.run_round()
    assert tr.ledger.uplink == 2 * 2 * tr._entry_bytes
    assert tr.ledger.downlink == 2 * 2 * 2 * tr._entry_bytes
    assert 2 <= len(tr.store) <= 4
    assert 0 < len(tr.evaluate(None, None)) <= 2
    tree, aux = tr.snapshot()
    assert set(tree["slots"]) == {str(s) for s in tr.store.slots()}
    assert aux["population"]["slots"] == tr.store.slots()


def test_jax_population_checkpoint_resumes_in_the_port(cohort):
    port = tapi.build_trainer(cohort["tspec"], device="cpu",
                              params=cohort["slots"])
    tapi.load_trainer(cohort["jpath"], port)
    _same_rounds([port.run_round() for _ in range(2)],
                 cohort["jreports"][2:])


def test_port_population_checkpoint_resumes_in_jax(cohort):
    _same_rounds(cohort["preports"][2:], cohort["jfrom_port"])


def test_population_snapshot_resumes_bitwise(tmp_path):
    _, tspec = _specs(rounds=8, seed=3, codec="ef(int8)", max_staleness=3,
                      fleet=dict(n_population=6, cohort=2))
    a = SPMDIFLTrainer(tspec, seq=8, device="cpu")
    for _ in range(3):
        a.run_round()
    path = str(tmp_path / "ck")
    tapi.save_trainer(path, a)
    b = tapi.load_trainer(path, SPMDIFLTrainer(tspec, seq=8, device="cpu"))
    for _ in range(2):
        assert a.run_round().metrics == b.run_round().metrics
    for sa, sb in ((a.store, b.store), (a.ef_store, b.ef_store)):
        (ta, la), (tb, lb) = sa.snapshot_state(), sb.snapshot_state()
        assert sorted(ta) == sorted(tb) and la == lb
        for s in ta:
            for x, y in zip(tree_leaves(ta[s]), tree_leaves(tb[s])):
                assert torch.equal(x, y)


def test_legacy_snapshot_resumes_bitwise(tmp_path):
    _, tspec = _specs(rounds=4, codec="int8",
                      fleet=dict(n_clients=2))
    a = SPMDIFLTrainer(tspec, seq=8, device="cpu")
    a.run_round()
    path = str(tmp_path / "ck")
    tapi.save_trainer(path, a)
    b = tapi.load_trainer(path, SPMDIFLTrainer(tspec, seq=8, device="cpu"))
    assert a.run_round().metrics == b.run_round().metrics


# ---------------------------------------------------------- serving


def test_export_round_trip_serves_the_oracle(tmp_path):
    """Train -> export -> save -> load on a fresh store -> serve: the
    loaded artifact equals the exported one, fusion state included, and
    served tokens equal the oracle's."""
    _, tspec = _specs(rounds=2, participation="k2", codec="int8",
                      fleet=dict(n_clients=3))
    tr = SPMDIFLTrainer(tspec, seq=8, device="cpu")
    for _ in range(2):
        tr.run_round()
    store = CompositionStore.from_spmd_trainer(tr)
    assert store.tenants() == ["client0", "client1", "client2"]
    path = os.path.join(str(tmp_path), "artifact.npz")
    store.save(path)
    loaded = CompositionStore.load(path, device="cpu")
    assert loaded.tenants() == store.tenants()
    for t in store.tenants():
        a, b = store.entry(t), loaded.entry(t)
        _equal_trees(a.base, b.base)
        assert (a.fusion is None) == (b.fusion is None)
        if a.fusion is not None:
            _equal_trees(a.fusion, b.fusion)
    eng = ServeEngine(loaded, width=2, cache_len=32, device="cpu")
    reqs = [Request(**r) for r in REQS]
    for req, comp in zip(reqs, eng.run(reqs)):
        assert comp.tokens == eng.oracle(req).tokens
    # The export is a copy: training on does not move it.
    before = [x.clone() for x in tree_leaves(store.entry("client0").base)]
    tr.run_round()
    for x, y in zip(before, tree_leaves(store.entry("client0").base)):
        assert torch.equal(x, y)


def test_population_restore_then_export_serves(tmp_path):
    _, tspec = _specs(rounds=4, seed=5, codec="int8", max_staleness=3,
                      fleet=dict(n_population=5, cohort=2))
    a = SPMDIFLTrainer(tspec, seq=8, device="cpu")
    for _ in range(3):
        a.run_round()
    path = str(tmp_path / "ck")
    tapi.save_trainer(path, a)
    b = tapi.load_trainer(path, SPMDIFLTrainer(tspec, seq=8, device="cpu"))
    sa = CompositionStore.from_spmd_trainer(a)
    sb = CompositionStore.from_spmd_trainer(b)
    assert sa.tenants() == sb.tenants() == [
        f"client{s}" for s in a.store.slots()]
    for t in sa.tenants():
        assert sb.entry(t).fusion is None
        _equal_trees(sa.entry(t).base, sb.entry(t).base)
    eng = ServeEngine(sb, width=2, cache_len=32, device="cpu")
    req = Request(rid=0, tenant=sb.tenants()[0], prompt=[1, 2, 3],
                  max_new_tokens=4)
    assert eng.run([req])[0].tokens == eng.oracle(req).tokens
    with pytest.raises(ValueError, match="materialized"):
        CompositionStore.from_spmd_trainer(
            SPMDIFLTrainer(tspec, seq=8, device="cpu"))


def test_store_resolves_the_smoke_arch():
    cfg = _resolve_cfg("spmd-smoke", reduced=False, d_fusion=None)
    assert cfg == smoke_model_config()
    assert _resolve_cfg("spmd-smoke", reduced=True, d_fusion=16).d_fusion == 16
    store = CompositionStore()
    assert store.add_arch(smoke_model_config(), reduced=False) == "spmd-smoke"
    assert store._meta["spmd-smoke"]["custom"] is False


# ------------------------------------------------------ the entry points


def test_quickstart_runs_the_spmd_scheme():
    out = io.StringIO()
    with redirect_stdout(out):
        quickstart.main(["--scheme", "ifl_spmd", "--device", "cpu",
                         "--rounds", "2", "--tau", "1", "--codec",
                         "ef(int4)", "--participation", "k2",
                         "--broadcast", "delta"])
    text = out.getvalue()
    assert "ifl_spmd quickstart" in text and "round   1:" in text
    assert "measured == analytic ifl_round_bytes, every round: True" in text


def test_llm_example_twin_trains_the_reference_config():
    """The twin's olmo-100m is the reference script's config, field for
    field (the script itself runs on the card in chip_smoke.py)."""
    olmo = jget_config("olmo-1b")
    want = olmo.replace(
        name="olmo-100m", num_layers=8, d_model=512, num_heads=8,
        num_kv_heads=8, d_ff=2048, vocab_size=16384, d_fusion=512,
        base_pattern=olmo.base_pattern, base_groups=4,
        mod_pattern=olmo.mod_pattern, mod_groups=4,
        compute_dtype="float32", remat="none", q_block=128).validate()
    assert dataclasses.asdict(olmo_100m()) == dataclasses.asdict(want)


def test_never_age_is_the_reference_constant():
    from repro.core.exchange import _NEVER as J_NEVER

    assert _NEVER == J_NEVER
