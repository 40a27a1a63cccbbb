"""The port's event-driven (async) rounds against the JAX package, on the
CPU: arrival traces and their parsing, the cursors' event streams, the
AsyncRoundEngine's tick coalescing, the sync-barrier wall-clock model,
and async ``run_experiment`` runs and checkpoints.

Per quantity: trace names, error messages, events, participants,
arrivals, simulated times, rng states and per-tick ledger bytes are
bitwise equal to the reference's (both packages draw from one numpy
stream in the same order); losses agree within 1e-4 (fp32 sums run in
other orders). Port against port (save/resume) is bitwise.
"""

import math
import os

import jax
import numpy as np
import pytest
import torch

from repro.api import DataSpec as JDataSpec
from repro.api import ExperimentSpec as JSpec
from repro.api import build_trainer as jbuild_trainer
from repro.api import save_trainer as jsave_trainer
from repro.core import rounds as jrounds
from repro_torch import api as tapi
from repro_torch.core import ifl_round_bytes
from repro_torch.core import exchange as texchange
from repro_torch.core import rounds as trounds
from repro_torch.core.comm import tree_leaves

FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                       "arrivals_real.jsonl")
TRACES = ["periodic(1)", "periodic(0.3)", "poisson(0.5)", "poisson(3)",
          "pareto(1.2,0.5)", "pareto(1,0.25)", f"replay:{FIXTURE}"]
MALFORMED = ["", "periodic", "periodic()", "periodic(a)", "poisson",
             "poisson(1,2)", "pareto(1.5)", "pareto(x,y)", "gzip",
             "pareto 1.5 0.5", "periodic(0)", "poisson(-1)", "pareto(0,0.5)",
             "pareto(1.5,0)"]
ASYNC = dict(scheme="ifl", rounds=6, tau=1, batch_size=8, lr=0.01,
             codec="ef(int4)", broadcast="delta", mode="async",
             trace="pareto(1.2,0.5)", tick=1.0, eval_every=0, seed=0)
DATA = dict(n_train=256, n_test=64)


def _specs(**kw):
    kw = {**ASYNC, **kw}
    jspec = JSpec(**kw, data=JDataSpec(**DATA))
    tspec = tapi.ExperimentSpec(**kw, data=tapi.DataSpec(**DATA))
    assert tspec.spec_hash() == jspec.spec_hash()
    return jspec, tspec



@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one intra-op thread: these runs are many small
    ops, and several test workers each spinning one thread a core over
    them made the twins' runs 30-70x slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _jax_init(jspec):
    jt = jbuild_trainer(jspec)
    return [jax.tree.map(np.asarray, c.params) for c in jt.clients]


def _raises_alike(fn_t, fn_j):
    """Both raise ValueError with the same message."""
    with pytest.raises(ValueError) as et:
        fn_t()
    with pytest.raises(ValueError) as ej:
        fn_j()
    assert str(et.value) == str(ej.value)


class _Shard:
    """A client stand-in whose samples are their own indices."""

    def __init__(self, n):
        self.data_x = np.arange(n, dtype=np.float32)[:, None]
        self.data_y = np.arange(n, dtype=np.int32)
        self.num_samples = n


# ------------------------------------------------------------ trace parsing


@pytest.mark.parametrize("spec", TRACES[:6])
def test_parse_trace_round_trips_as_the_reference(spec):
    tt, tj = trounds.parse_trace(spec), jrounds.parse_trace(spec)
    assert type(tt).__name__ == type(tj).__name__
    assert tt.name == tj.name and repr(tt) == repr(tj)
    assert trounds.parse_trace(tt.name) == tt and trounds.parse_trace(tt) is tt
    assert tt.mean_gap() == tj.mean_gap()


@pytest.mark.parametrize("bad", MALFORMED)
def test_parse_trace_errors_match_the_reference(bad):
    _raises_alike(lambda: trounds.parse_trace(bad),
                  lambda: jrounds.parse_trace(bad))


def test_trace_mean_gaps():
    assert trounds.parse_trace("periodic(3)").mean_gap() == 3
    assert trounds.parse_trace("poisson(0.5)").mean_gap() == 2
    assert trounds.parse_trace("pareto(1.5,0.5)").mean_gap() == \
        pytest.approx(1.5)
    assert math.isinf(trounds.parse_trace("pareto(1,0.5)").mean_gap())


# ------------------------------------------------------------ replay traces


def test_replay_trace_validation_matches_the_reference():
    evs = [(2.0, 1), (0.5, 0), (2.0, 0), (0.5, 0)]
    tr, jr = trounds.ReplayTrace(evs), jrounds.ReplayTrace(evs)
    assert tr.events == jr.events == [(0.5, 0), (0.5, 0), (2.0, 0), (2.0, 1)]
    assert tr.n_slots == jr.n_slots == 2 and tr.name == jr.name
    assert math.isinf(trounds.ReplayTrace([]).mean_gap())
    for events, n in [([(math.inf, 0)], None), ([(-1.0, 0)], None),
                      ([(1.0, -2)], None), ([(1.0, 7)], 4)]:
        _raises_alike(lambda: trounds.ReplayTrace(events, n),
                      lambda: jrounds.ReplayTrace(events, n))
    # A trace built without n_clients is checked when its cursor is made.
    rng = np.random.default_rng(0)
    _raises_alike(lambda: trounds.ReplayTrace([(0.5, 7)]).cursor(4, rng),
                  lambda: jrounds.ReplayTrace([(0.5, 7)]).cursor(4, rng))
    assert trounds.ReplayTrace([(0.5, 7)]).cursor(8, rng).next_after(
        7, 0.0, rng) == 0.5


def test_replay_from_file_fixture_and_malformed_files(tmp_path):
    tr = trounds.ReplayTrace.from_file(FIXTURE, n_clients=4)
    jr = jrounds.ReplayTrace.from_file(FIXTURE, n_clients=4)
    assert tr.events == jr.events and len(tr.events) == 37
    assert tr.name == jr.name and tr.mean_gap() == jr.mean_gap()
    assert tr.events.count((6.5, 2)) == 2
    assert trounds.parse_trace(f"replay:{FIXTURE}", 4).events == tr.events
    _raises_alike(lambda: trounds.parse_trace(f"replay:{FIXTURE}", 3),
                  lambda: jrounds.parse_trace(f"replay:{FIXTURE}", 3))
    p = tmp_path / "log.csv"
    for text in ["# comment\n0.5,0\n1.5,1\n\nnot-a-line\n", '{"t": 0.5}\n',
                 "0.5,0,1\n", '{"t": "x", "client": 0}\n', "0.5,-1\n",
                 "nan,0\n"]:
        p.write_text(text)
        _raises_alike(lambda: trounds.ReplayTrace.from_file(str(p)),
                      lambda: jrounds.ReplayTrace.from_file(str(p)))
    p.write_text("# t,slot\n0.5,0\n\n1.5,1\n")
    assert trounds.ReplayTrace.from_file(str(p)).events == [(0.5, 0),
                                                            (1.5, 1)]


# ------------------------------------------------------------ event streams


@pytest.mark.parametrize("spec", TRACES)
def test_cursor_streams_and_state_are_bitwise(spec):
    """pop_until over 64 ticks, with the cursor and rng state handed from
    the reference's cursor to a fresh port cursor at tick 32; then
    next_after over every slot in turn."""
    n = 4 if spec.startswith("replay") else 6
    rt, rj = np.random.default_rng(5), np.random.default_rng(5)
    ct = trounds.parse_trace(spec, n).cursor(n, rt)
    cj = jrounds.parse_trace(spec, n).cursor(n, rj)
    for tick in range(64):
        if tick == 32:
            assert ct.state() == cj.state()
            ct = trounds.parse_trace(spec, n).cursor(
                n, np.random.default_rng(0))
            ct.restore(cj.state())
            rt = np.random.default_rng(0)
            rt.bit_generator.state = rj.bit_generator.state
        t_end = 0.7 * (tick + 1)
        assert ct.pop_until(t_end, rt) == cj.pop_until(t_end, rj)
    assert rt.bit_generator.state == rj.bit_generator.state
    t = 44.8
    for i in range(40):
        got, want = ct.next_after(i % n, t, rt), cj.next_after(i % n, t, rj)
        assert got == want
        t = min(want, t + 1.3) if math.isfinite(want) else t + 1.3
    assert ct.state() == cj.state()


# -------------------------------------------------------------- the engines


def test_replay_fixture_drives_both_engines():
    et = trounds.AsyncRoundEngine(4, f"replay:{FIXTURE}", tick=1.0, seed=0)
    ej = jrounds.AsyncRoundEngine(4, f"replay:{FIXTURE}", tick=1.0, seed=0)
    seen = []
    for _ in range(14):
        pt, pj = et.participants(), ej.participants()
        assert pt.dtype == pj.dtype and np.array_equal(pt, pj)
        seen.append(list(pt))
        a, b = et.end_round({}), ej.end_round({})
        assert a.to_dict() == b.to_dict()
    assert seen[:3] == [[0, 1], [0, 1], [0, 1, 2]]
    assert 3 in seen[9] and et.total_arrivals == ej.total_arrivals
    assert et.sim_time == ej.sim_time == 14.0


@pytest.mark.parametrize("cohort", [None, 2])
@pytest.mark.parametrize("spec", ["poisson(0.8)", "pareto(1.2,0.5)",
                                  "periodic(0.5)"])
def test_async_engine_tick_by_tick_bitwise(spec, cohort):
    """Participants, arrivals, sim_time and uploads_per_sec every tick,
    with each participant's minibatches drawn between the pops, as the
    trainer draws them."""
    et = trounds.AsyncRoundEngine(5, spec, tick=1.0, seed=3, cohort=cohort)
    ej = jrounds.AsyncRoundEngine(5, spec, tick=1.0, seed=3, cohort=cohort)
    shards = [_Shard(30 + 3 * k) for k in range(5)]
    for _ in range(24):
        pt, pj = et.participants(), ej.participants()
        assert np.array_equal(pt, pj)
        assert cohort is None or len(pt) <= cohort
        assert np.array_equal(et.participants(), pt)  # idempotent
        for k in pt:
            for _ in range(2):
                xt, _ = et.sample(shards[k], 4, "cpu")
                xj, _ = ej.sample(shards[k], 4)
                assert np.array_equal(xt.numpy(), np.asarray(xj))
        rt, rj = et.end_round({}), ej.end_round({})
        assert rt.metrics == rj.metrics
    assert et.rng.bit_generator.state == ej.rng.bit_generator.state
    assert (et.total_uploads, et.total_arrivals) == (ej.total_uploads,
                                                     ej.total_arrivals)
    assert et.aux_state() == ej.aux_state()


def test_async_engine_coalescing_and_validation():
    tr = trounds.ReplayTrace([(0.5, 0), (0.5, 0), (0.7, 1), (2.5, 0)])
    eng = trounds.AsyncRoundEngine(4, tr, tick=1.0, seed=0)
    assert list(eng.participants()) == [0, 1]
    rep = eng.end_round({})
    assert rep.metrics == {"sim_time": 1.0, "arrivals": 3,
                           "uploads_per_sec": 2.0}
    assert list(eng.participants()) == []  # an empty tick is legal
    eng.end_round({})
    assert list(eng.participants()) == [0]
    eng.end_round({})
    assert (eng.total_uploads, eng.total_arrivals, eng.sim_time) == (3, 4,
                                                                    3.0)
    _raises_alike(lambda: trounds.AsyncRoundEngine(4, "periodic(1)",
                                                   tick=0.0),
                  lambda: jrounds.AsyncRoundEngine(4, "periodic(1)",
                                                   tick=0.0))
    _raises_alike(lambda: trounds.AsyncRoundEngine(4, ""),
                  lambda: jrounds.AsyncRoundEngine(4, ""))


# ----------------------------------------------------- wall-clock models


@pytest.mark.parametrize("participation", [None, "k2", "bern0.5"])
@pytest.mark.parametrize("spec", TRACES)
def test_simulate_sync_wall_clock_matches_the_reference(spec, participation):
    got = trounds.simulate_sync_wall_clock(spec, 4, 20, seed=2,
                                           participation=participation)
    want = jrounds.simulate_sync_wall_clock(spec, 4, 20, seed=2,
                                            participation=participation)
    assert got == want


def test_a_barrier_that_never_closes_stays_inf():
    tr = trounds.ReplayTrace([(0.5, 0), (0.7, 1), (1.2, 0), (1.4, 1)])
    durs = trounds.simulate_sync_wall_clock(tr, 2, 3)
    assert durs[:2] == pytest.approx([0.7, 0.7]) and math.isinf(durs[2])
    evs = [(1.0, 0), (1.0, 1), (2.0, 1), (3.0, 1), (4.0, 1)]

    def scripted(mod):
        class Scripted(mod.ParticipationSchedule):
            name = "scripted"

            def mask(self, round_idx, n, rng):
                m = np.zeros(n, bool)
                m[:] = round_idx < 2
                m[1] = True
                return m

        return Scripted()

    got = trounds.simulate_sync_wall_clock(
        trounds.ReplayTrace(evs, 2), 2, 4, participation=scripted(trounds))
    want = jrounds.simulate_sync_wall_clock(
        jrounds.ReplayTrace(evs, 2), 2, 4, participation=scripted(jrounds))
    assert got == want and got[0] == 1.0
    assert all(math.isinf(d) for d in got[1:])


@pytest.mark.parametrize("spec", TRACES)
def test_expected_async_participants_matches_the_reference(spec):
    got = trounds.expected_async_participants(spec, 4, 1.0, ticks=64, seed=1)
    assert got == jrounds.expected_async_participants(spec, 4, 1.0,
                                                      ticks=64, seed=1)
    assert 0 <= got[0] <= 4 and got[1] >= got[0]


def test_engine_end_round_prunes_and_a_long_run_stays_bounded():
    def plane(max_staleness):
        # The staleness bound is the fusion plane's; the engine adopts
        # the plane's cache and prunes it every end_round.
        return texchange.FusionExchange("fp32", 4, (2, 3),
                                        max_staleness=max_staleness)

    eng = trounds.RoundEngine(4, "full", seed=0, exchange=plane(1))
    eng.cache.put(2, payload="p", z_hat="z", y="y", round_idx=0)
    eng.end_round({})
    eng.end_round({})
    assert set(eng.cache._entries) == {2}
    eng.end_round({})
    assert eng.cache._entries == {}
    tr = trounds.ReplayTrace([(0.5, 3)] + [(t + 0.5, t % 2)
                                           for t in range(1, 40)])
    eng = trounds.AsyncRoundEngine(4, tr, tick=1.0, exchange=plane(2),
                                   seed=0)
    sizes = []
    for _ in range(40):
        for k in eng.participants():
            eng.cache.put(int(k), payload="p", z_hat="z", y="y",
                          round_idx=eng.round_idx)
        eng.end_round({})
        sizes.append(len(eng.cache._entries))
    assert 3 not in eng.cache._entries and max(sizes) <= 3


# ------------------------------------------------------- the front door


def test_async_spec_validation_matches_the_reference():
    for kw in [dict(mode="async"), dict(mode="weird"),
               dict(trace="poisson(1)"),
               dict(mode="async", trace="poisson(1)", participation="k2"),
               dict(mode="async", trace="poisson(1)", tick=-1.0)]:
        _raises_alike(lambda: tapi.ExperimentSpec(**kw),
                      lambda: JSpec(**kw))
    for scheme in ("fl1", "fl2", "fsl"):
        _, tspec = _specs(scheme=scheme)
        with pytest.raises(ValueError, match="only supports mode='sync'"):
            tapi.build_trainer(tspec, device="cpu")


@pytest.fixture(scope="module")
def async_runs(tmp_path_factory):
    """One live JAX run of ASYNC (its trainer checkpointed at the start of
    tick 3) and the port's run_experiment of the same spec from the JAX
    run's init."""
    jspec, tspec = _specs()
    params = _jax_init(jspec)
    jt = jbuild_trainer(jspec)
    ckpt = str(tmp_path_factory.mktemp("async") / "tick3")
    jreports = []
    for r in range(jspec.rounds):
        if r == 3:
            jsave_trainer(ckpt, jt)
        jreports.append(jt.run_round().to_dict())
    tres = tapi.run_experiment(tspec, keep_trainer=True, device="cpu",
                               params=params)
    return tspec, jt, jreports, ckpt, tres


def _same_tick(rt, rj, keys=("round", "participants", "arrivals",
                             "sim_time", "uploads_per_sec", "cache_size",
                             "shipped_entries", "uplink_mb", "downlink_mb")):
    for key in keys:
        assert rt[key] == rj[key], key
    for key in ("base_loss", "mod_loss"):
        if rj["participants"]:
            np.testing.assert_allclose(rt[key], rj[key], rtol=1e-4,
                                       atol=1e-4)
        else:
            assert math.isnan(rt[key]) and math.isnan(rj[key])


def test_async_run_experiment_matches_reference(async_runs):
    tspec, jt, jreports, _, tres = async_runs
    assert len(tres.reports) == len(jreports) == 6
    for i, (rt, rj) in enumerate(zip(tres.reports, jreports)):
        _same_tick(rt, rj)
        assert rt["sim_time"] == (i + 1) * tspec.tick
    tt = tres.trainer
    assert tt.ledger.per_round == jt.ledger.per_round
    for i, rep in enumerate(tres.reports):
        assert tt.ledger.per_round[i] == ifl_round_bytes(
            4, tspec.batch_size, tspec.d_fusion, codec=tspec.codec,
            participating=len(rep["participants"]),
            broadcast_entries=rep["cache_size"], broadcast="delta",
            delta_entries=rep["shipped_entries"])
    assert sum(len(r["participants"]) for r in tres.reports) == \
        tt.engine.total_uploads == jt.engine.total_uploads > 0
    assert tt.engine.aux_state()["async"] == jt.engine.aux_state()["async"]
    last = tres.records[-1]
    assert (last["sim_time"], last["uploads_per_sec"]) == (
        jreports[-1]["sim_time"], jreports[-1]["uploads_per_sec"])


def test_async_save_resume_is_bitwise(tmp_path):
    _, tspec = _specs(rounds=4)
    tr = tapi.build_trainer(tspec, device="cpu")
    for _ in range(2):
        tr.run_round()
    path = str(tmp_path / "ckpt")
    tapi.save_trainer(path, tr)
    want = [tr.run_round().to_dict() for _ in range(2)]
    tr2 = tapi.load_trainer(path, tapi.build_trainer(tspec, device="cpu"))
    assert tr2.engine.round_idx == 2
    assert tr2.engine.total_uploads == sum(
        len(r.participants) for r in tr.engine.history[:2])
    assert [tr2.run_round().to_dict() for _ in range(2)] == want
    assert tr2.ledger.per_round == tr.ledger.per_round[2:]
    assert tr2.engine.aux_state() == tr.engine.aux_state()
    for a, b in zip(tree_leaves([c.params for c in tr.clients]),
                    tree_leaves([c.params for c in tr2.clients])):
        assert torch.equal(a, b)


def test_a_jax_async_checkpoint_resumes_in_the_port(async_runs):
    """The JAX run's checkpoint at tick 3 loads through the port's
    load_trainer; its ticks 3-5 match the JAX run's: participants,
    arrivals and bytes exactly, losses within 1e-4."""
    tspec, jt, jreports, ckpt, _ = async_runs
    tt = tapi.load_trainer(ckpt, tapi.build_trainer(tspec, device="cpu"))
    assert tt.engine.round_idx == 3 and tt.engine.sim_time == 3.0
    for rj in jreports[3:]:
        _same_tick(tt.run_round(), rj)
    assert tt.ledger.per_round == jt.ledger.per_round[3:]
    assert tt.engine.cursor.state() == jt.engine.cursor.state()
    assert (tt.engine.rng.bit_generator.state
            == jt.engine.rng.bit_generator.state)
