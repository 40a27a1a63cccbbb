"""The paper's baselines (FedAvg FL-1 / FL-2, federated split learning),
the ``zipf`` / ``diurnal`` schedules and the twins of the paper's scripts,
on the CPU, against live runs of the JAX package on the same box.

Per quantity, as in tests/test_torch_front_door.py: spec hashes,
participants, schedule masks and per-round ledger bytes are exact;
losses agree within 1e-4 and accuracies within 0.02 (the two packages sum
fp32 in other orders). Port against port (save/resume, no-op rounds) is
bitwise. The JAX runs are shared through module-scoped fixtures.
"""

import dataclasses
import json
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _port_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.api import DataSpec as JDataSpec
from repro.api import ExperimentSpec as JSpec
from repro.api import FleetSpec as JFleetSpec
from repro.api import build_trainer as jbuild_trainer
from repro.api import get_scheme as jget_scheme
from repro.api import load_trainer as jload_trainer
from repro.api import run_experiment as jrun_experiment
from repro.api import save_trainer as jsave_trainer
from repro.api.registry import SCHEMES as JSCHEMES
from repro.core.rounds import parse_participation as jparse_participation
from repro.models import small as jsmall
from repro_torch import api as tapi
from repro_torch.api.registry import SCHEMES, SchemeEntry
from repro_torch.benchmarks import (fig2_comm_efficiency, fig3_heterogeneity,
                                    fig4_matrix, paper_repro,
                                    table1_comm_costs)
from repro_torch.checkpoint import params_from_numpy
from repro_torch.core import FSLTrainer
from repro_torch.core.comm import fl_round_bytes, fsl_round_bytes, tree_leaves
from repro_torch.core.rounds import parse_participation
from repro_torch.models import small as tsmall

ROOT = Path(__file__).resolve().parents[1]
DATA = dict(n_train=800, n_test=200)
BASELINES = ["fl1", "fl2", "fsl"]


def _specs(**kw):
    jspec = JSpec(**kw, data=JDataSpec(**DATA))
    tspec = tapi.ExperimentSpec(**kw, data=tapi.DataSpec(**DATA))
    assert tspec.spec_hash() == jspec.spec_hash()
    return jspec, tspec


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _carry(monkeypatch, jspec):
    """Start the port's run of ``jspec`` from the JAX package's init: the
    clients' params through ``params=``, and for FSL the server block by
    constructing the trainer with ``params_from_numpy`` of its tree."""
    jt = jbuild_trainer(jspec)
    clients = [_numpy(c.params) for c in jt.clients]
    if jspec.scheme == "fsl":
        server = _numpy(jt.server_params)

        def build(spec, data, *, params=None, device=None):
            return FSLTrainer(
                tapi.build_fleet(spec, data, params=clients, device=device),
                spec.run_config(), params_from_numpy(server, device=device),
                tapi.apply_fns(1)[1], seed=spec.seed, device=device)

        monkeypatch.setitem(SCHEMES, "fsl", SchemeEntry("fsl", build))
        return None
    return clients


def _bitwise(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ---------------------------------------------- run_experiment vs the JAX one

PARITY = dict(rounds=3, tau=2, eval_every=0)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Live JAX run_experiment results, one per (scheme, schedule), whose
    trainer saves a checkpoint at the start of every round."""
    runs = {}

    def get(scheme, participation):
        key = (scheme, participation)
        if key not in runs:
            jspec, _ = _specs(scheme=scheme, participation=participation,
                              **PARITY)
            tmp = tmp_path_factory.mktemp(f"{scheme}_{participation}")
            entry = JSCHEMES[scheme]

            def build(spec, data):
                jt = entry.build(spec, data)
                run_round = jt.run_round

                def saved_run_round():
                    jsave_trainer(str(tmp / f"round{jt.engine.round_idx}"),
                                  jt)
                    return run_round()

                jt.run_round = saved_run_round
                return jt

            with pytest.MonkeyPatch.context() as mp:
                mp.setitem(JSCHEMES, scheme,
                           dataclasses.replace(entry, builder=build))
                runs[key] = jrun_experiment(jspec, keep_trainer=True), tmp
        return runs[key]

    return get


@pytest.mark.parametrize("participation", ["full", "k2"])
@pytest.mark.parametrize("scheme", BASELINES)
def test_run_experiment_matches_reference(jax_runs, monkeypatch, scheme,
                                          participation):
    """The whole run: hash, participants and bytes exact, accuracies
    within 0.02. Losses within 1e-4 round by round, each port round
    started from the JAX run's checkpoint at that round's start: the
    trajectories themselves are chaotic (in the JAX package alone, noise
    of 1e-5 on one weight matrix moves fl1's k2 loss by 7.7e-4 in 3
    rounds, and one ReLU whose pre-activation is below 1e-6 takes the
    other sign when the packages sum in other orders)."""
    jspec, tspec = _specs(scheme=scheme, participation=participation,
                          **PARITY)
    jres, ckpts = jax_runs(scheme, participation)
    jbytes = jres.trainer.ledger.per_round
    for r, rj in enumerate(jres.reports):
        tt = tapi.load_trainer(str(ckpts / f"round{r}"),
                               tapi.build_trainer(tspec, device="cpu"))
        rt = tt.run_round()
        assert (rt.round, rt.participants) == (rj["round"],
                                               rj["participants"])
        assert tt.ledger.per_round[-1] == jbytes[r]
        np.testing.assert_allclose(rt["loss"], rj["loss"], rtol=1e-4,
                                   atol=1e-4)

    tres = tapi.run_experiment(tspec, keep_trainer=True, device="cpu",
                               params=_carry(monkeypatch, jspec))
    assert tres.to_dict()["spec_hash"] == jres.to_dict()["spec_hash"]
    assert len(tres.reports) == len(jres.reports) == 3
    for rt, rj in zip(tres.reports, jres.reports):
        for key in ("round", "participants", "uplink_mb", "downlink_mb"):
            assert rt[key] == rj[key], key
        assert np.isfinite(rt["loss"])
    assert tres.trainer.ledger.per_round == jres.trainer.ledger.per_round
    assert (tres.uplink_mb, tres.downlink_mb) == (jres.uplink_mb,
                                                  jres.downlink_mb)
    for rt, rj in zip(tres.records, jres.records):
        assert (rt["round"], rt["uplink_mb"], rt["total_mb"]) == (
            rj["round"], rj["uplink_mb"], rj["total_mb"])
        np.testing.assert_allclose(rt["acc_mean"], rj["acc_mean"], atol=0.02)
        if scheme == "fsl":
            np.testing.assert_allclose(rt["accs"], rj["accs"], atol=0.02)
    # The ledger is the analytic formula, participant count by count.
    for rep, bytes_ in zip(tres.reports, tres.trainer.ledger.per_round):
        k = len(rep["participants"])
        if scheme == "fsl":
            want = fsl_round_bytes(4, 32, 432, participating=k)
        else:
            want = fl_round_bytes(
                4, tsmall.model_bytes(tres.trainer.global_params),
                participating=k)
        assert bytes_ == want


# ------------------------------------------------------------- checkpoints

RESUME = dict(rounds=10, tau=2, batch_size=16, participation="k2")


def _close_rounds(a, b):
    assert a.participants == b.participants
    np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("scheme", ["fl1", "fsl"])
def test_a_jax_checkpoint_resumes_in_the_port(tmp_path, scheme):
    jspec, tspec = _specs(scheme=scheme, **RESUME)
    jt = jbuild_trainer(jspec)
    for _ in range(2):
        jt.run_round()
    path = str(tmp_path / "jax_ckpt")
    jsave_trainer(path, jt)
    tt = tapi.load_trainer(path, tapi.build_trainer(tspec, device="cpu"))
    assert tt.engine.round_idx == 2
    assert (tt.ledger.uplink, tt.ledger.downlink) == (jt.ledger.uplink,
                                                      jt.ledger.downlink)
    for _ in range(2):
        _close_rounds(tt.run_round(), jt.run_round())
    assert tt.ledger.per_round == jt.ledger.per_round[2:]
    assert (tt.ledger.uplink, tt.ledger.downlink) == (jt.ledger.uplink,
                                                      jt.ledger.downlink)


@pytest.mark.parametrize("scheme", ["fl1", "fsl"])
def test_a_port_checkpoint_resumes_in_the_jax_package(tmp_path, scheme):
    """The port starts from the JAX package's round-0 checkpoint, trains
    two rounds and saves; the JAX package resumes that checkpoint, and
    both packages' next two rounds agree."""
    jspec, tspec = _specs(scheme=scheme, **RESUME)
    jsave_trainer(str(tmp_path / "jax_ckpt"), jbuild_trainer(jspec))
    tt = tapi.load_trainer(str(tmp_path / "jax_ckpt"),
                           tapi.build_trainer(tspec, device="cpu"))
    for _ in range(2):
        tt.run_round()
    path = str(tmp_path / "port_ckpt")
    tapi.save_trainer(path, tt)
    jt = jload_trainer(path, jbuild_trainer(jspec))
    assert jt.engine.round_idx == tt.engine.round_idx == 2
    assert (jt.ledger.uplink, jt.ledger.downlink) == (tt.ledger.uplink,
                                                      tt.ledger.downlink)
    for _ in range(2):
        _close_rounds(jt.run_round(), tt.run_round())
    assert (jt.ledger.uplink, jt.ledger.downlink) == (tt.ledger.uplink,
                                                      tt.ledger.downlink)


@pytest.mark.parametrize("scheme", BASELINES)
def test_save_and_load_resume_bitwise(tmp_path, scheme):
    _, spec = _specs(scheme=scheme, **RESUME)
    tr = tapi.build_trainer(spec, device="cpu")
    for _ in range(2):
        tr.run_round()
    path = str(tmp_path / "ckpt")
    tapi.save_trainer(path, tr)
    cont = [tr.run_round() for _ in range(2)]
    tr2 = tapi.load_trainer(path, tapi.build_trainer(spec, device="cpu"))
    replay = [tr2.run_round() for _ in range(2)]
    for a, b in zip(cont, replay):
        assert a.to_dict() == b.to_dict()  # losses to the last bit
    assert tr.ledger.per_round[2:] == tr2.ledger.per_round
    _bitwise(tr.snapshot()[0], tr2.snapshot()[0])
    assert tr.snapshot()[1] == tr2.snapshot()[1]


# ----------------------------------------------------------- no-op rounds


@pytest.mark.parametrize("scheme,kw", [
    ("fl1", dict(tau=0)),
    ("fl2", dict(participation="bern0.01")),
    ("fsl", dict(participation="bern0.01")),
])
def test_a_round_that_trains_nothing_changes_nothing(scheme, kw):
    """τ = 0, or a round with no participant: the global model (FL) or
    the server and the clients (FSL) stay bitwise as they were, not
    re-averaged, and the round's loss is NaN."""
    _, spec = _specs(scheme=scheme, **{**RESUME, **kw})
    tr = tapi.build_trainer(spec, device="cpu")
    before = [t.clone() for t in tree_leaves(tr.snapshot()[0])]
    rep = tr.run_round()
    if "tau" in kw:
        k = len(rep.participants)
        assert k == 2
        mb = tsmall.model_bytes(tr.global_params)
        assert tr.ledger.per_round == [fl_round_bytes(4, mb,
                                                      participating=k)]
    else:
        assert rep.participants == []
        assert tr.ledger.per_round == [{"up": 0, "down": 0}]
    assert np.isnan(rep["loss"])
    _bitwise(before, tree_leaves(tr.snapshot()[0]))


def test_fl_global_model_is_a_copy_of_client_0():
    _, spec = _specs(scheme="fl1", **RESUME)
    tr = tapi.build_trainer(spec, device="cpu")
    for g, c in zip(tree_leaves(tr.global_params),
                    tree_leaves(tr.clients[0].params)):
        assert torch.equal(g, c) and g.data_ptr() != c.data_ptr()


# ------------------------------------------------------------- refusals


@pytest.mark.parametrize("kind", ["async", "population"])
@pytest.mark.parametrize("scheme", BASELINES)
def test_baselines_refuse_async_and_populations_as_the_reference(scheme,
                                                                 kind):
    if kind == "async":
        kw = dict(mode="async", trace="poisson(0.5)")
        jspec, tspec = JSpec(scheme=scheme, **kw), tapi.ExperimentSpec(
            scheme=scheme, **kw)
    else:
        fkw = dict(n_population=8, cohort=2)
        jspec = JSpec(scheme=scheme, fleet=JFleetSpec(**fkw))
        tspec = tapi.ExperimentSpec(scheme=scheme,
                                    fleet=tapi.FleetSpec(**fkw))
    with pytest.raises(ValueError) as jerr:
        jget_scheme(scheme).build(jspec, None)
    with pytest.raises(ValueError) as terr:
        tapi.get_scheme(scheme).build(tspec, None, device="cpu")
    assert str(terr.value) == str(jerr.value)


# ------------------------------------------------------------- schedules


@pytest.mark.parametrize("n", [4, 17])
@pytest.mark.parametrize("spec", ["zipf(1.1)", "zipf(0)", "zipf( 3 )",
                                  "diurnal(24,4)", "diurnal(5)",
                                  "diurnal(2, 1)", "full", "k2", "bern0.5",
                                  "straggle(0.25,4)"])
def test_schedule_masks_match_reference(spec, n):
    ts, js = parse_participation(spec), jparse_participation(spec)
    assert type(ts).__name__ == type(js).__name__ and ts.name == js.name
    assert ts.expected_participants(n) == js.expected_participants(n)
    trng, jrng = np.random.default_rng(7), np.random.default_rng(7)
    for t in range(50):
        tm, jm = ts.mask(t, n, trng), js.mask(t, n, jrng)
        assert tm.dtype == jm.dtype == bool
        assert np.array_equal(tm, jm)
    # Both streams sit at the same point: diurnal drew nothing.
    assert trng.bit_generator.state == jrng.bit_generator.state
    if spec.startswith("diurnal"):
        assert trng.bit_generator.state == \
            np.random.default_rng(7).bit_generator.state


@pytest.mark.parametrize("spec", ["zipf(-1)", "zipf(a)", "zipf(1,2)",
                                  "diurnal(1)", "diurnal(24,0)",
                                  "diurnal(+24)", "zipf"])
def test_malformed_schedules_raise_as_the_reference(spec):
    with pytest.raises(ValueError) as jerr:
        jparse_participation(spec)
    with pytest.raises(ValueError) as terr:
        parse_participation(spec)
    assert str(terr.value) == str(jerr.value)


# ----------------------------------------------------- models/small.py


@pytest.mark.parametrize("cid", [1, 2, 3, 4])
def test_model_bytes_match_reference(cid):
    jp = jsmall.init_client_model(jax.random.PRNGKey(cid), cid)
    tp = tsmall.init_client_model(
        cid, generator=torch.Generator().manual_seed(cid))
    for block in (None, "base", "modular"):
        assert tsmall.model_bytes(tp, block) == jsmall.model_bytes(jp, block)


def test_compose_apply_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 28, 28, 1)).astype(np.float32)
    jb = jsmall.init_client_model(jax.random.PRNGKey(1), 2)
    jm = jsmall.init_client_model(jax.random.PRNGKey(2), 3)
    want = np.asarray(jsmall.compose_apply(jb, 2, jm, 3, x))
    got = tsmall.compose_apply(params_from_numpy(_numpy(jb), device="cpu"),
                               2, params_from_numpy(_numpy(jm),
                                                    device="cpu"), 3,
                               torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------- the script twins


def test_table1_twin_rows_equal_the_reference_script():
    path = ROOT / "benchmarks" / "table1_comm_costs.py"
    spec = importlib.util.spec_from_file_location("_ref_table1", path)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    assert table1_comm_costs.run(quiet=True, device="cpu") == ref.run(
        quiet=True)
    assert table1_comm_costs.FEATURES == ref.FEATURES


def test_fig2_twin_smoke_on_cpu(tmp_path):
    rows = fig2_comm_efficiency.run(2, force=True, quiet=True,
                                    codec="int8_row", smoke=True,
                                    device="cpu", cache_dir=str(tmp_path))
    assert {s for s, *_ in rows} == {"ifl", "ifl+int8_row", "fsl", "fl1",
                                     "fl2"}
    assert len(rows) == 5 * 2 and len(list(tmp_path.glob("*_cpu.json"))) == 5
    mb = {cid: tsmall.model_bytes(tsmall.init_client_model(
        cid, generator=torch.Generator())) for cid in (1, 2)}
    per_round = {"fsl": fsl_round_bytes(4, 32, 432)["up"],
                 "fl1": fl_round_bytes(4, mb[1])["up"],
                 "fl2": fl_round_bytes(4, mb[2])["up"]}
    for scheme, r, uplink_mb, acc in rows:
        if scheme in per_round:
            assert uplink_mb == per_round[scheme] * (r + 1) / 1e6
        assert 0.0 <= acc <= 1.0
    budget, hl = fig2_comm_efficiency.headline(rows)
    assert budget > 0 and set(hl) == {s for s, *_ in rows}
    last, ratio, _ = fig2_comm_efficiency.codec_headline(rows, "int8_row")
    assert last == 1 and ratio > 3.5
    out = tmp_path / "fig2_async.json"
    fig2_comm_efficiency.main(["--mode", "async", "--smoke", "--device",
                               "cpu", "--cache-dir", str(tmp_path / "async"),
                               "--out-json", str(out)])
    res = json.loads(out.read_text())
    assert res["axes"]["mode"] == "async"
    arows = res["rows"]
    assert {s for s, *_ in arows} == {"ifl", "fsl", "fl1", "fl2"}
    assert [r for s, r, *_ in arows if s == "ifl"] == [0, 1, 2, 3]
    for scheme, r, uplink_mb, acc in arows:
        if scheme in per_round:  # the baselines keep the barrier
            assert uplink_mb == per_round[scheme] * (r + 1) / 1e6
        assert 0.0 <= acc <= 1.0
    cached = [json.loads(p.read_text())
              for p in (tmp_path / "async").glob("ifl_*_cpu.json")]
    assert len(cached) == 1
    spec = cached[0]["spec"]
    assert (spec["mode"], spec["trace"]) == ("async", "pareto(1.2,0.5)")
    up = [r["uplink_mb"] for r in cached[0]["reports"]]
    assert [mb for s, _, mb, _ in arows if s == "ifl"] == up


def test_fig3_fig4_and_paper_repro_twins_on_cpu(tmp_path):
    cache = str(tmp_path)
    rows = fig3_heterogeneity.run(1, force=True, quiet=True, device="cpu",
                                  cache_dir=cache)
    assert [r[0] for r in rows] == [0] and len(rows[0]) == 5
    mat = fig4_matrix.run(1, quiet=True, device="cpu", cache_dir=cache)
    assert mat.shape == (4, 4) and ((0 <= mat) & (mat <= 1)).all()
    out = paper_repro.run_scheme("fl1", 1, n_train=800, n_test=200, tau=1,
                                 device="cpu", cache_dir=cache)
    assert out["scheme"] == "fl1" and out["uplink_mb"] > 0
    data = tapi.load_data(tapi.ExperimentSpec(data=tapi.DataSpec(**DATA)))
    clients = paper_repro.make_clients(data.train_x, data.train_y,
                                       heterogeneous=False, arch=2,
                                       device="cpu")
    assert [c.cid for c in clients] == [2, 2, 2, 2]
