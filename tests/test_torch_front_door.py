"""The port's front door (scheme registry, ``RunResult``,
``run_experiment`` with its cache, ``save_trainer``/``load_trainer``) and
the delta broadcast, on the CPU, against the JAX package.

Per quantity, as in tests/test_torch_ifl.py: spec hashes, participants,
cache sizes, shipped entries and per-round ledger bytes are exact; losses
agree within 1e-4 and accuracies within 0.02 (the two packages sum fp32
in other orders, and a last-bit difference may flip an int8 code). Port
against port (save/resume, delta against full) is bitwise.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from _port_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.api import DataSpec as JDataSpec
from repro.api import ExperimentSpec as JSpec
from repro.api import available_schemes as javailable_schemes
from repro.api import build_trainer as jbuild_trainer
from repro.api import run_experiment as jrun_experiment
from repro.api import load_trainer as jload_trainer
from repro.api import save_trainer as jsave_trainer
from repro.config import RunConfig as JRunConfig
from repro.core import IFLTrainer as JIFLTrainer
from repro.core.rounds import ParticipationSchedule as JParticipationSchedule
from repro_torch import api as tapi
from repro_torch.api.registry import SCHEMES
from repro_torch.api.runner import _cached
from repro_torch.config import RunConfig
from repro_torch.core import IFLTrainer
from repro_torch.core.comm import (DELTA_SIDECAR_BYTES, ifl_round_bytes,
                                   tree_leaves)
from repro_torch.core.exchange import parse_broadcast
from repro_torch.core.rounds import ParticipationSchedule
from test_torch_ifl import _linear_fleets

SMOKE = dict(rounds=2, tau=1, batch_size=8, lr=0.05, eval_every=0, seed=0)
SMOKE_DATA = dict(n_train=256, n_test=64)


def _smoke(**kw):
    return tapi.ExperimentSpec(**{**SMOKE, **kw},
                               data=tapi.DataSpec(**SMOKE_DATA))


def _bitwise(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ----------------------------------------------------------------- registry


def test_registry_holds_the_reference_schemes():
    assert tapi.available_schemes() == javailable_schemes()
    entry = tapi.get_scheme("ifl")
    assert entry.name == "ifl" and entry.builder is tapi.build_ifl
    with pytest.raises(ValueError, match="unknown scheme 'fedmd'.*ifl"):
        tapi.get_scheme("fedmd")


def test_register_scheme_is_open():
    built = []

    @tapi.register_scheme("toy", summary="a test scheme")
    def build_toy(spec, data, **kw):
        built.append(kw)
        return tapi.build_ifl(spec, data, **kw)

    try:
        assert "toy" in tapi.available_schemes()
        res = tapi.run_experiment(_smoke(scheme="toy", rounds=1),
                                  device="cpu")
        assert built == [{"device": "cpu", "params": None}]
        assert len(res.reports) == 1 and res.uplink_mb > 0
    finally:
        del SCHEMES["toy"]


# ---------------------------------------------------------------- RunResult


def test_run_result_json_round_trip(tmp_path):
    res = tapi.run_experiment(_smoke(rounds=2, eval_every=1), device="cpu")
    path = str(tmp_path / "r.json")
    res.to_json(path)
    for back in (tapi.RunResult.from_json(path),
                 tapi.RunResult.from_json(res.to_json())):
        assert back.spec == res.spec
        assert back.records == json.loads(json.dumps(res.records))
        assert back.reports == json.loads(json.dumps(res.reports))
        assert (back.uplink_mb, back.downlink_mb) == (res.uplink_mb,
                                                      res.downlink_mb)
        assert (back.package, back.device) == ("repro_torch", "cpu")
        assert back.trainer is None
    d = res.to_dict()
    assert d["spec_hash"] == res.spec.spec_hash() and d["scheme"] == "ifl"
    assert set(res.final) >= {"round", "uplink_mb", "total_mb", "acc_mean",
                              "accs", "matrix", "sd_per_base"}


# ------------------------------------------------- run_experiment vs JAX


def _jax_init(jspec):
    """The JAX package's initial params of every slot, as numpy."""
    jt = jbuild_trainer(jspec)
    return [jax.tree.map(np.asarray, c.params) for c in jt.clients]


def test_run_experiment_matches_reference_at_table2():
    kw = dict(scheme="ifl", rounds=3, tau=2, eval_every=1, codec="int8_row",
              participation="k2", broadcast="delta")
    jspec = JSpec(**kw, data=JDataSpec(n_train=800, n_test=200))
    tspec = tapi.ExperimentSpec(**kw, data=tapi.DataSpec(n_train=800,
                                                         n_test=200))
    assert tspec.spec_hash() == jspec.spec_hash()
    jres = jrun_experiment(jspec, keep_trainer=True)
    tres = tapi.run_experiment(tspec, keep_trainer=True, device="cpu",
                               params=_jax_init(jspec))
    assert tres.to_dict()["spec_hash"] == jres.to_dict()["spec_hash"]
    assert len(tres.reports) == len(jres.reports) == 3
    for rt, rj in zip(tres.reports, jres.reports):
        for key in ("round", "participants", "cache_size",
                    "shipped_entries", "uplink_mb", "downlink_mb"):
            assert rt[key] == rj[key], key
        for key in ("base_loss", "mod_loss"):
            np.testing.assert_allclose(rt[key], rj[key], rtol=1e-4,
                                       atol=1e-4)
    assert tres.trainer.ledger.per_round == jres.trainer.ledger.per_round
    assert (tres.uplink_mb, tres.downlink_mb) == (jres.uplink_mb,
                                                  jres.downlink_mb)
    for rt, rj in zip(tres.records, jres.records):
        assert (rt["round"], rt["uplink_mb"], rt["total_mb"]) == (
            rj["round"], rj["uplink_mb"], rj["total_mb"])
        np.testing.assert_allclose(rt["acc_mean"], rj["acc_mean"], atol=0.02)
        np.testing.assert_allclose(rt["matrix"], rj["matrix"], atol=0.02)
        np.testing.assert_allclose(rt["sd_per_base"], rj["sd_per_base"],
                                   atol=2.0)


# ------------------------------------------------------- delta broadcast


def test_parse_broadcast():
    assert parse_broadcast(None) == "full"
    assert parse_broadcast("delta") == "delta"
    with pytest.raises(ValueError, match="unknown broadcast"):
        parse_broadcast("gzip")
    _, tc = _linear_fleets()
    with pytest.raises(ValueError, match="unknown broadcast"):
        IFLTrainer(tc, RunConfig(d_fusion=16, batch_size=4,
                                 broadcast="multicast"), device="cpu")
    with pytest.raises(ValueError, match="unknown broadcast"):
        ifl_round_bytes(4, 4, 16, broadcast="gzip")


@pytest.mark.parametrize("codec", ["int8_row", "ef(int4)"])
@pytest.mark.parametrize("schedule", ["k2", "bern0.5"])
def test_delta_ledger_matches_reference(schedule, codec):
    """Under delta, the per-round ledger and shipped entries equal the
    reference's, and the analytic formula with E = shipped_entries; the
    uplink equals full broadcast's (tests/test_exchange.py:84-118)."""
    jc, tc = _linear_fleets()
    _, tc_full = _linear_fleets()
    kw = dict(n_clients=4, tau=1, batch_size=4, d_fusion=16, codec=codec,
              participation=schedule, max_staleness=1)
    jt = JIFLTrainer(jc, JRunConfig(**kw, broadcast="delta"), seed=11)
    tt = IFLTrainer(tc, RunConfig(**kw, broadcast="delta"), seed=11,
                    device="cpu")
    tf = IFLTrainer(tc_full, RunConfig(**kw), seed=11, device="cpu")
    for r in range(6):
        rj, rt, rf = jt.run_round(), tt.run_round(), tf.run_round()
        assert rt.participants == rj.participants == rf.participants
        assert rt["cache_size"] == rj["cache_size"]
        assert rt["shipped_entries"] == rj["shipped_entries"]
        assert "shipped_entries" not in rf.metrics
        got = tt.ledger.per_round[r]
        assert got == ifl_round_bytes(
            4, 4, 16, codec=codec, participating=len(rt.participants),
            broadcast_entries=rt["cache_size"], broadcast="delta",
            delta_entries=rt["shipped_entries"])
        assert got["up"] == tf.ledger.per_round[r]["up"]
    assert tt.ledger.per_round == jt.ledger.per_round
    assert tt.ledger.downlink <= tf.ledger.downlink


def test_delta_steady_state_is_k_entries_plus_sidecars():
    _, tc = _linear_fleets()
    tt = IFLTrainer(tc, RunConfig(d_fusion=16, batch_size=4, tau=0,
                                  codec="int8_row", broadcast="delta"),
                    device="cpu")
    tt.run_round()
    m = tt.run_round()
    entry = ifl_round_bytes(1, 4, 16, codec="int8_row", participating=1,
                            broadcast_entries=0)["up"]
    assert m["shipped_entries"] == 4
    assert tt.ledger.per_round[1]["down"] == 4 * (entry + DELTA_SIDECAR_BYTES)


def _rows(base, rows):
    """A fixed participation trace as a schedule of ``base``'s package:
    rows[t] (every client past the trace)."""

    class Rows(base):
        name = "rows"

        def mask(self, round_idx, n, rng):
            return np.array(rows.get(round_idx, [1] * n), bool)

    return Rows()


@pytest.mark.parametrize("rows,ships", [
    # Nobody in round 0: nothing ships.
    ({0: [0, 0, 0]}, [0, 3]),
    # Slot 1 away in rounds 1-2: the fresh uploads cover its catch-up.
    ({1: [1, 0, 1], 2: [1, 0, 1]}, [3, 2, 2, 3]),
    # Slot 2 rejoins in round 2 missing slot 1's round-1 entry, which
    # ships as catch-up although it is not fresh.
    ({1: [1, 1, 0], 2: [1, 0, 1]}, [3, 2, 3]),
])
def test_delta_ships_catch_up_entries_as_the_reference(rows, ships):
    """tests/test_exchange.py:139-219, against the JAX trainer; after every
    sync each participant's mirror equals the server's valid cache."""
    jc, tc = _linear_fleets(n=3)
    kw = dict(n_clients=3, tau=0, batch_size=4, d_fusion=16,
              broadcast="delta")
    jt = JIFLTrainer(jc, JRunConfig(
        **kw, participation=_rows(JParticipationSchedule, rows)))
    tt = IFLTrainer(tc, RunConfig(
        **kw, participation=_rows(ParticipationSchedule, rows)), device="cpu")
    got = [tt.run_round() for _ in ships]
    want = [jt.run_round() for _ in ships]
    assert [m["shipped_entries"] for m in got] == ships
    assert [m["shipped_entries"] for m in want] == ships
    assert tt.ledger.per_round == jt.ledger.per_round
    valid = {s: e.round_idx for s, e in
             tt.engine.cache.valid_entries(tt.engine.round_idx)}
    for p in got[-1].participants:
        assert tt.exchange.mirrors.versions[p] == valid


def test_delta_training_is_full_training_bitwise():
    """Delta and full broadcast serve the same decoded pairs, so params
    and accuracies are bitwise equal; only the downlink differs
    (tests/test_exchange.py:276-300)."""
    ex = np.random.default_rng(3).normal(size=(64, 16)).astype(np.float32)
    ey = np.random.default_rng(4).integers(0, 10, size=64).astype(np.int32)
    out = {}
    for policy in ("full", "delta"):
        _, tc = _linear_fleets()
        cfg = RunConfig(n_clients=4, tau=2, batch_size=4, d_fusion=16,
                        codec="ef(int4)", participation="k2",
                        broadcast=policy)
        tt = IFLTrainer(tc, cfg, seed=7, device="cpu")
        for _ in range(8):
            tt.run_round()
        out[policy] = (tt.evaluate(ex, ey), [c.params for c in tt.clients],
                       tt.ledger.downlink)
    assert out["delta"][0] == out["full"][0]
    _bitwise(out["delta"][1], out["full"][1])
    assert out["delta"][2] < out["full"][2]


# ----------------------------------------------------- snapshot / resume


def test_save_and_load_resume_bitwise(tmp_path):
    """Save after 2 rounds; a fresh trainer loaded from the file replays
    rounds 3-4 bit for bit (params, rng, ledger, cache, mirrors)."""
    spec = _smoke(rounds=10, participation="k2", codec="ef(int4)",
                  broadcast="delta")
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
    assert tr.ledger.per_round[2:] == tr2.ledger.per_round  # from the load
    _bitwise(tr.snapshot()[0], tr2.snapshot()[0])
    assert tr.snapshot()[1] == tr2.snapshot()[1]


def test_in_place_restore_rewinds_cleanly(tmp_path):
    """Restoring the same instance rewinds history, ledger and cache: the
    cache holds no payload uploaded after the snapshot, and the replay
    equals a freshly built restore's (tests/test_api.py:219-280)."""
    spec = _smoke(participation="k2", rounds=10)
    tr = tapi.build_trainer(spec, device="cpu")
    for _ in range(2):
        tr.run_round()
    snap = {s: e.round_idx for s, e in tr.engine.cache.valid_entries(2)}
    path = str(tmp_path / "ck")
    tapi.save_trainer(path, tr)
    fresh = tapi.load_trainer(path, tapi.build_trainer(spec, device="cpu"))
    assert {s: e.round_idx
            for s, e in fresh.engine.cache.valid_entries(2)} == snap
    fresh_replay = [fresh.run_round() for _ in range(2)]
    for _ in range(3):
        tr.run_round()
    tapi.load_trainer(path, tr)
    assert tr.engine.round_idx == 2
    assert len(tr.engine.history) == 2 and len(tr.ledger.per_round) == 2
    assert {s: e.round_idx for s, e in tr.engine.cache.valid_entries(2)} \
        == snap
    replay = [tr.run_round() for _ in range(2)]
    for a, b in zip(fresh_replay, replay):
        assert a.to_dict() == b.to_dict()


@pytest.mark.parametrize("broadcast", ["full", "delta"])
def test_snapshot_restores_a_mid_staleness_cache(tmp_path, broadcast):
    """Snapshot while the cache holds an entry of a slot that uploaded
    rounds ago (straggle(0.25,4), max_staleness 2): the restored trainer
    has the same entries, ages and bits, and replays the continuation
    bit for bit (tests/test_exchange.py:354-428)."""

    def build():
        _, tc = _linear_fleets()
        cfg = RunConfig(n_clients=4, tau=1, batch_size=4, d_fusion=16,
                        codec="ef(int8_row)", participation="straggle(0.25,4)",
                        max_staleness=2, broadcast=broadcast)
        return IFLTrainer(tc, cfg, seed=5, device="cpu")

    tr = build()
    for _ in range(5):
        tr.run_round()
    stale = tr.engine.cache.staleness(tr.engine.round_idx)
    assert max(stale.values()) >= 1, stale
    before = {s: (e.z_hat.clone(), e.y.clone(), e.round_idx)
              for s, e in tr.engine.cache.valid_entries(5)}
    path = str(tmp_path / "ck")
    tapi.save_trainer(path, tr)
    cont = [tr.run_round() for _ in range(4)]
    tr2 = tapi.load_trainer(path, build())
    assert tr2.engine.cache.staleness(tr2.engine.round_idx) == stale
    after = {s: (e.z_hat, e.y, e.round_idx)
             for s, e in tr2.engine.cache.valid_entries(5)}
    assert before.keys() == after.keys()
    for s in before:
        assert torch.equal(before[s][0], after[s][0])
        assert torch.equal(before[s][1], after[s][1])
        assert before[s][2] == after[s][2]
    replay = [tr2.run_round() for _ in range(4)]
    for a, b in zip(cont, replay):
        assert a.to_dict() == b.to_dict()
    _bitwise([c.params for c in tr.clients], [c.params for c in tr2.clients])


def test_a_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A checkpoint the JAX package's save_trainer wrote loads through the
    port's load_trainer (same keys, shapes and aux), and the next two
    rounds match the JAX trainer's own: participants, shipped entries and
    bytes exactly, losses within 1e-4."""
    kw = dict(scheme="ifl", rounds=10, tau=2, batch_size=16,
              codec="ef(int4)", participation="k2", max_staleness=1,
              broadcast="delta")
    jspec = JSpec(**kw, data=JDataSpec(n_train=800, n_test=200))
    tspec = tapi.ExperimentSpec(**kw, data=tapi.DataSpec(n_train=800,
                                                         n_test=200))
    jt = jbuild_trainer(jspec)
    for _ in range(2):
        jt.run_round()
    path = str(tmp_path / "jax_ckpt")
    jsave_trainer(path, jt)
    tt = tapi.load_trainer(path, tapi.build_trainer(tspec, device="cpu"))
    assert tt.engine.round_idx == 2
    assert tt.ledger.uplink == jt.ledger.uplink
    assert tt.ledger.downlink == jt.ledger.downlink
    assert {s: e.round_idx for s, e in tt.engine.cache._entries.items()} \
        == {s: e.round_idx for s, e in jt.engine.cache._entries.items()}
    for _ in range(2):
        rj, rt = jt.run_round(), tt.run_round()
        assert rt.participants == rj.participants
        assert rt["cache_size"] == rj["cache_size"]
        assert rt["shipped_entries"] == rj["shipped_entries"]
        for key in ("base_loss", "mod_loss"):
            np.testing.assert_allclose(rt[key], rj[key], rtol=1e-4,
                                       atol=1e-4)
    assert tt.ledger.per_round == jt.ledger.per_round[2:]
    assert (tt.ledger.uplink, tt.ledger.downlink) == (jt.ledger.uplink,
                                                      jt.ledger.downlink)


def test_a_port_checkpoint_resumes_in_the_jax_package(tmp_path):
    """The other direction: the port resumes a JAX checkpoint, trains two
    rounds of its own, and writes with its save_trainer; the JAX
    package's load_trainer takes that checkpoint, and its next two rounds
    match the port's own next two: participants, shipped entries and
    bytes exactly, losses within 1e-4."""
    kw = dict(scheme="ifl", rounds=10, tau=2, batch_size=16,
              codec="ef(int4)", participation="k2", max_staleness=1,
              broadcast="delta")
    jspec = JSpec(**kw, data=JDataSpec(n_train=800, n_test=200))
    tspec = tapi.ExperimentSpec(**kw, data=tapi.DataSpec(n_train=800,
                                                         n_test=200))
    jt = jbuild_trainer(jspec)
    jt.run_round()
    jsave_trainer(str(tmp_path / "jax_ckpt"), jt)
    tt = tapi.load_trainer(str(tmp_path / "jax_ckpt"),
                           tapi.build_trainer(tspec, device="cpu"))
    for _ in range(2):
        tt.run_round()
    path = str(tmp_path / "port_ckpt")
    tapi.save_trainer(path, tt)
    jt2 = jload_trainer(path, jbuild_trainer(jspec))
    assert jt2.engine.round_idx == tt.engine.round_idx == 3
    assert (jt2.ledger.uplink, jt2.ledger.downlink) == (tt.ledger.uplink,
                                                        tt.ledger.downlink)
    assert {s: e.round_idx for s, e in jt2.engine.cache._entries.items()} \
        == {s: e.round_idx for s, e in tt.engine.cache._entries.items()}
    for _ in range(2):
        rt, rj = tt.run_round(), jt2.run_round()
        assert rj.participants == rt.participants
        assert rj["cache_size"] == rt["cache_size"]
        assert rj["shipped_entries"] == rt["shipped_entries"]
        for key in ("base_loss", "mod_loss"):
            np.testing.assert_allclose(rj[key], rt[key], rtol=1e-4,
                                       atol=1e-4)
    assert (jt2.ledger.uplink, jt2.ledger.downlink) == (tt.ledger.uplink,
                                                        tt.ledger.downlink)


# ------------------------------------------------------------------ cache


def test_cache_is_spec_hash_keyed_and_replays_records(tmp_path):
    spec = _smoke(rounds=2, eval_every=1, codec="ef(int4)")
    cache = str(tmp_path)
    first = tapi.run_experiment(spec, cache_dir=cache, device="cpu")
    (f,) = os.listdir(cache)
    assert f == f"ifl_{spec.spec_hash()}_cpu.json"
    seen = []
    again = tapi.run_experiment(spec, cache_dir=cache, device="cpu",
                                on_record=lambda rec, rep: seen.append(
                                    (rec["round"], rep.participants,
                                     rep["base_loss"])))
    assert again.records == json.loads(json.dumps(first.records))
    assert seen == [(r["round"], r["participants"], r["base_loss"])
                    for r in first.reports]


def test_cache_is_not_clobbered_without_force(tmp_path):
    spec = _smoke(rounds=1)
    cache = str(tmp_path)
    tapi.run_experiment(spec, cache_dir=cache, device="cpu")
    path = os.path.join(cache, f"ifl_{spec.spec_hash()}_cpu.json")
    doc = json.load(open(path))
    doc["records"][0]["acc_mean"] = -1.0  # a detectable mutation
    json.dump(doc, open(path, "w"))
    live = tapi.run_experiment(spec, cache_dir=cache, keep_trainer=True,
                               device="cpu")
    assert live.trainer is not None and live.final["acc_mean"] >= 0.0
    assert json.load(open(path))["records"][0]["acc_mean"] == -1.0
    assert tapi.run_experiment(spec, cache_dir=cache,
                               device="cpu").final["acc_mean"] == -1.0
    tapi.run_experiment(spec, cache_dir=cache, force=True, device="cpu")
    assert json.load(open(path))["records"][0]["acc_mean"] >= 0.0


def test_a_cpu_entry_is_never_served_to_a_card_request(tmp_path):
    """The cache key names the device type and the entry names its
    package and device: a CPU run's result is a miss for a card request
    (which, with no CUDA, raises before the cache is read), and an entry
    another package or device wrote under the port's name is a miss."""
    spec = _smoke(rounds=1)
    cache = str(tmp_path)
    tapi.run_experiment(spec, cache_dir=cache, device="cpu")
    (f,) = os.listdir(cache)
    cpu_doc = json.load(open(os.path.join(cache, f)))
    assert (cpu_doc["package"], cpu_doc["device"]) == ("repro_torch", "cpu")
    if not torch.cuda.is_available():
        for dev in (None, "cuda"):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                tapi.run_experiment(spec, cache_dir=cache, device=dev)
    assert _cached(spec, cache, torch.device("cuda")) is None
    # A CPU record planted under the card's name, and a record with no
    # package (as the JAX package writes them) under the CPU's: misses.
    card_path = os.path.join(cache, f"ifl_{spec.spec_hash()}_cuda.json")
    json.dump(cpu_doc, open(card_path, "w"))
    assert _cached(spec, cache, torch.device("cuda")) is None
    assert _cached(spec, cache, torch.device("cpu")) is not None
    foreign = {k: v for k, v in cpu_doc.items() if k != "package"}
    json.dump(foreign, open(os.path.join(cache, f), "w"))
    assert _cached(spec, cache, torch.device("cpu")) is None


def test_params_with_a_cache_raises(tmp_path):
    spec = _smoke(rounds=1)
    with pytest.raises(ValueError, match="spec hash"):
        tapi.run_experiment(spec, cache_dir=str(tmp_path), device="cpu",
                            params=[{}] * 4)
    assert os.listdir(tmp_path) == []


def test_the_port_results_are_its_own():
    assert os.path.normpath(tapi.PAPER_RESULTS).endswith(
        os.path.join("results", "torch"))
