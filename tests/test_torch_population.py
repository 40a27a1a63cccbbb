"""The port's population regime against the JAX package, on the CPU: the
population store and the lazy fleet, cohort draws in both engines,
eager IFL over a population fleet (cohort-fresh broadcast, EF residuals
aged out by max_staleness, sparse checkpoints), and the twins of
``benchmarks/fleet_scale.py`` and ``benchmarks/async_vs_sync.py``.

Per quantity: cohort draws, rng states, participants, materialized
slots, EF slots and per-round ledger bytes are bitwise equal to the
reference's; losses agree within 1e-4 (fp32 sums run in other orders).
Port against port (save/resume, lazy against eager) is bitwise.
"""

import jax
import numpy as np
import pytest
import torch

from repro.api import DataSpec as JDataSpec
from repro.api import ExperimentSpec as JSpec
from repro.api import FleetSpec as JFleetSpec
from repro.api import build_trainer as jbuild_trainer
from repro.api import save_trainer as jsave_trainer
from repro.core import rounds as jrounds
from repro_torch import api as tapi
from repro_torch.benchmarks import async_vs_sync, fleet_scale
from repro_torch.core import ifl_round_bytes
from repro_torch.core import rounds as trounds
from repro_torch.core.comm import tree_leaves
from repro_torch.core.population import LazyFleet, PopulationStore

POP = dict(scheme="ifl", rounds=3, tau=1, batch_size=8, lr=0.01,
           codec="ef(int4)", max_staleness=1, participation="full",
           eval_every=0, seed=0)
DATA = dict(n_train=256, n_test=64)
FLEET = dict(n_population=12, cohort=3)
SCHEDULES = ["full", "k5", "bern0.5", "zipf(0.5)", "diurnal(4,2)"]


def _specs(**kw):
    kw = {**POP, **kw}
    jspec = JSpec(**kw, data=JDataSpec(**DATA), fleet=JFleetSpec(**FLEET))
    tspec = tapi.ExperimentSpec(**kw, data=tapi.DataSpec(**DATA),
                                fleet=tapi.FleetSpec(**FLEET))
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

class _JaxInit:
    """params[k]: slot k's initial params as the JAX package draws them,
    from an untrained JAX trainer's lazy fleet (built on first touch)."""

    def __init__(self, jspec):
        self.fleet = jbuild_trainer(jspec).clients

    def __getitem__(self, k):
        return jax.tree.map(np.asarray, self.fleet[k].params)


def _bitwise(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ---------------------------------------------------------------- LazyFleet


def test_lazy_fleet_materializes_on_touch():
    built = []

    def build(k):
        built.append(k)
        return f"client-{k}"

    fleet = LazyFleet(100, build)
    assert len(fleet) == 100 and built == []
    assert fleet[7] == "client-7" and fleet[-1] == "client-99"
    assert fleet[7] == "client-7" and built == [7, 99]  # cached
    assert fleet[2:4] == ["client-2", "client-3"]
    assert fleet.materialized == [2, 3, 7, 99]
    with pytest.raises(IndexError):
        fleet[100]
    with pytest.raises(ValueError):
        LazyFleet(0, build)


def test_lazy_fleet_equals_the_eager_fleet_bitwise():
    """build_fleet of a population spec builds client k on first touch
    from its manual_seed(100 + k) draw: the same tensors as the eager
    fleet of the same size, touched in any order."""
    _, tspec = _specs()
    data = tapi.load_data(tspec)
    lazy = tapi.build_fleet(tspec, data, device="cpu")
    eager = tapi.build_fleet(tspec.replace(fleet=tapi.FleetSpec(
        n_clients=12)), data, device="cpu")
    assert isinstance(lazy, LazyFleet) and lazy.materialized == []
    for k in (11, 3, 0):
        assert lazy[k].cid == eager[k].cid == k % 4 + 1
        _bitwise(lazy[k].params, eager[k].params)
        assert np.array_equal(lazy[k].data_y, eager[k].data_y)
    assert lazy.materialized == [0, 3, 11]


# ---------------------------------------------------------- PopulationStore


def _slot_tree(slot: int):
    return {"w": np.full((3,), float(slot), np.float32),
            "b": np.asarray(slot, np.int32)}


def test_page_in_matches_eager_init_bitwise():
    store = PopulationStore(100, _slot_tree)
    cohort = store.page_in([7, 3, 7], device="cpu")  # repeats legal
    assert cohort["w"].shape == (3, 3) and cohort["w"].device.type == "cpu"
    for i, s in enumerate([7, 3, 7]):
        assert np.array_equal(cohort["w"][i].numpy(), _slot_tree(s)["w"])
        assert int(cohort["b"][i]) == s
    assert all(isinstance(x, torch.Tensor) and x.device.type == "cpu"
               for x in tree_leaves(store.get(7)))


@pytest.mark.parametrize("seed,c", [(0, 1), (1, 3), (2, 6), (5, 4)])
def test_scatter_touches_exactly_the_named_slots(seed, c):
    n = 32
    store = PopulationStore(n, _slot_tree)
    rng = np.random.default_rng(seed)
    slots = sorted(rng.choice(n, size=c, replace=False).tolist())
    cohort = store.page_in(slots)
    store.page_out(slots, {"w": cohort["w"] + 1.0, "b": cohort["b"]},
                   round_idx=0)
    for s in range(n):
        expect = _slot_tree(s)["w"] + (1.0 if s in slots else 0.0)
        assert np.array_equal(store.get(s)["w"].numpy(), expect)


def test_page_out_drops_trailing_padding_and_copies():
    store = PopulationStore(10, _slot_tree)
    slots = [4, 9]
    padded = store.page_in(slots + [slots[0]] * 2)  # a width-4 cohort
    store.page_out(slots, padded, round_idx=1)
    assert store.slots() == [4, 9]
    padded["w"][0, :] = -1.0  # the stored leaves are copies
    assert np.array_equal(store.get(4)["w"].numpy(), _slot_tree(4)["w"])


def test_store_aging_bounds_memory_on_10k_fleet():
    store = PopulationStore(10_000, _slot_tree, max_staleness=2)
    rng = np.random.default_rng(0)
    peak_slots = peak_bytes = 0
    for r in range(40):
        slots = sorted(rng.choice(10_000, size=16, replace=False))
        store.page_out(slots, store.page_in(slots), round_idx=r)
        store.prune(r)
        peak_slots = max(peak_slots, len(store))
        peak_bytes = max(peak_bytes, store.memory_bytes())
    bound = 16 * (2 + 2)
    assert peak_slots <= bound and peak_bytes <= bound * (3 * 4 + 4)
    assert store.memory_bytes() == len(store) * 16
    s = store.slots()[0]
    store.put(s, {"w": np.zeros(3, np.float32),
                  "b": np.asarray(-1, np.int32)}, round_idx=0)
    store._last_seen[s] = -100
    assert s in store.prune(200)
    assert np.array_equal(store.get(s)["w"].numpy(), _slot_tree(s)["w"])


def test_store_snapshot_restore_and_validation():
    store = PopulationStore(50, _slot_tree, max_staleness=3)
    store.page_out([5, 40], store.page_in([5, 40]), round_idx=2)
    store.get(7)
    state, seen = store.snapshot_state()
    assert sorted(state) == [5, 7, 40] and seen == {5: 2, 40: 2}
    again = PopulationStore(50, _slot_tree, max_staleness=3)
    again.restore_state({str(k): v for k, v in state.items()},
                        {str(k): v for k, v in seen.items()})
    assert again.slots() == [5, 7, 40] and again._last_seen == seen
    for k in state:
        _bitwise(again.get(k), state[k])
    assert again.prune(6) == [5, 40] and again.slots() == [7]
    with pytest.raises(ValueError, match="n_population"):
        PopulationStore(0, _slot_tree)
    with pytest.raises(ValueError, match="max_staleness"):
        PopulationStore(4, _slot_tree, max_staleness=-1)
    with pytest.raises(IndexError, match="slot 4 out of range"):
        PopulationStore(4, _slot_tree).get(4)
    with pytest.raises(ValueError, match="at least one slot"):
        PopulationStore(4, _slot_tree).page_in([])


# ------------------------------------------------------------- cohort draws


@pytest.mark.parametrize("cohort", [None, 1, 4])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_cohort_draws_bitwise_over_32_rounds(schedule, cohort):
    et = trounds.RoundEngine(20, schedule, seed=4, cohort=cohort)
    ej = jrounds.RoundEngine(20, schedule, seed=4, cohort=cohort)
    for _ in range(32):
        pt, pj = et.participants(), ej.participants()
        assert pt.dtype == pj.dtype and np.array_equal(pt, pj)
        assert cohort is None or len(pt) <= cohort
        assert (np.diff(pt) > 0).all()
        et.end_round({})
        ej.end_round({})
    assert et.rng.bit_generator.state == ej.rng.bit_generator.state


@pytest.mark.parametrize("schedule,cohort", [("bern0.5", None), ("k2", 4),
                                             ("zipf(1.1)", 20)])
def test_an_idle_cohort_cap_draws_nothing_extra(schedule, cohort):
    a = trounds.RoundEngine(20, schedule, seed=3)
    b = trounds.RoundEngine(20, schedule, seed=3, cohort=cohort)
    for _ in range(10):
        assert np.array_equal(a.participants(), b.participants())
        a.end_round({})
        b.end_round({})
    assert a.rng.bit_generator.state == b.rng.bit_generator.state


def test_cohort_validation_matches_the_reference():
    for kw in (dict(cohort=0), dict(cohort=9)):
        with pytest.raises(ValueError) as et:
            trounds.RoundEngine(8, "full", **kw)
        with pytest.raises(ValueError) as ej:
            jrounds.RoundEngine(8, "full", **kw)
        assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("schedule,cohort", [("full", 10), ("full", None),
                                             ("bern0.05", 50), ("k7", 3),
                                             ("zipf(1.1)", 4),
                                             ("diurnal(24,4)", 8)])
def test_expected_cohort_participants_matches_the_reference(schedule, cohort):
    got = trounds.expected_cohort_participants(schedule, 50, cohort,
                                               rounds=64, seed=2)
    assert got == jrounds.expected_cohort_participants(schedule, 50, cohort,
                                                       rounds=64, seed=2)
    assert got <= (cohort or 50)


def test_async_cohort_admits_the_earliest_arrivals():
    evs = [(0.1, 5), (0.2, 0), (0.3, 3), (0.4, 1), (0.45, 0), (1.5, 2)]
    et = trounds.AsyncRoundEngine(6, trounds.ReplayTrace(evs, 6), tick=1.0,
                                  cohort=2)
    ej = jrounds.AsyncRoundEngine(6, jrounds.ReplayTrace(evs, 6), tick=1.0,
                                  cohort=2)
    assert list(et.participants()) == list(ej.participants()) == [0, 5]
    rt, rj = et.end_round({}), ej.end_round({})
    assert rt.metrics == rj.metrics and rt["arrivals"] == 5
    assert list(et.participants()) == list(ej.participants()) == [2]


# --------------------------------------------------- eager IFL at N 12, C 3


@pytest.fixture(scope="module")
def pop_runs(tmp_path_factory):
    """A live JAX population run (N 12, C 3, ef(int4), max_staleness 1,
    3 rounds), checkpointed at the start of round 2, and the port's run
    of the same spec from the same init, with the EF and upload slots of
    both after every round."""
    jspec, tspec = _specs()
    jt = jbuild_trainer(jspec)
    tt = tapi.build_trainer(tspec, device="cpu", params=_JaxInit(jspec))
    ckpt = str(tmp_path_factory.mktemp("pop") / "round2")
    jrep, trep, slots = [], [], []
    for r in range(3):
        if r == 2:
            jsave_trainer(ckpt, jt)
        jrep.append(jt.run_round().to_dict())
        trep.append(tt.run_round().to_dict())
        slots.append(((sorted(jt.ef_state), sorted(jt.exchange._last_upload)),
                      (sorted(tt.exchange.ef_state),
                       sorted(tt.exchange._last_upload))))
    return tspec, jt, tt, jrep, trep, slots, ckpt


def test_population_ifl_matches_reference(pop_runs):
    tspec, jt, tt, jrep, trep, slots, _ = pop_runs
    for r, (rt, rj) in enumerate(zip(trep, jrep)):
        for key in ("participants", "cache_size", "max_staleness_seen",
                    "uplink_mb", "downlink_mb"):
            assert rt[key] == rj[key], key
        assert len(rt["participants"]) == rt["cache_size"] == 3
        for key in ("base_loss", "mod_loss"):
            np.testing.assert_allclose(rt[key], rj[key], rtol=1e-4,
                                       atol=1e-4)
        assert tt.ledger.per_round[r] == ifl_round_bytes(
            12, 8, 432, codec="ef(int4)", participating=3,
            broadcast_entries=3)
    assert tt.ledger.per_round == jt.ledger.per_round
    assert tt.clients.materialized == jt.clients.materialized
    for (j_ef, j_up), (t_ef, t_up) in slots:
        assert t_ef == j_ef and t_up == j_up
        assert len(t_ef) <= 3 * (1 + 1)  # this round's and the last's
    # Slots that uploaded in round 0 only have aged out of the EF state.
    r0 = set(trep[0]["participants"]) - set(trep[1]["participants"]) \
        - set(trep[2]["participants"])
    assert r0 and not r0 & set(tt.exchange.ef_state)
    assert tt.exchange.ef_state.keys() == jt.ef_state.keys()
    for k in tt.exchange.ef_state:
        np.testing.assert_allclose(tt.exchange.ef_state[k].numpy(),
                                   np.asarray(jt.ef_state[k]), atol=1e-4)


def test_population_eval_is_a_bounded_probe(pop_runs):
    tspec, jt, tt, *_ = pop_runs
    assert not tt.eval_matrix and tt._eval_slots() == jt._eval_slots()
    assert tt._eval_slots(cap=2) == tt.clients.materialized[:2]
    data = tapi.load_data(tspec)
    accs = tt.evaluate(data.test_x, data.test_y)
    assert len(accs) == len(tt.clients.materialized) <= 16
    assert tt.accuracy_matrix(data.test_x[:64], data.test_y[:64]).shape == \
        (len(accs), len(accs))


def test_population_snapshot_is_sparse_and_resumes_bitwise(tmp_path):
    _, tspec = _specs(rounds=4)
    tr = tapi.build_trainer(tspec, device="cpu")
    for _ in range(2):
        tr.run_round()
    tree, aux = tr.snapshot()
    assert set(tree["clients"]) == {str(k) for k in tr.clients.materialized}
    assert aux["population"]["ef"] == sorted(tr.exchange.ef_state)
    assert set(tree["cache"]) == {str(s) for s in tr.exchange.cache._entries}
    path = str(tmp_path / "ckpt")
    tapi.save_trainer(path, tr)
    want = [tr.run_round().to_dict() for _ in range(2)]
    tr2 = tapi.load_trainer(path, tapi.build_trainer(tspec, device="cpu"))
    assert [tr2.run_round().to_dict() for _ in range(2)] == want
    assert tr2.ledger.per_round == tr.ledger.per_round[2:]
    assert tr2.clients.materialized == tr.clients.materialized
    assert sorted(tr2.exchange.ef_state) == sorted(tr.exchange.ef_state)
    for k in tr.clients.materialized:
        _bitwise(tr2.clients[k].params, tr.clients[k].params)
    for k in tr.exchange.ef_state:
        assert torch.equal(tr2.exchange.ef_state[k], tr.exchange.ef_state[k])


def test_a_jax_population_checkpoint_resumes_in_the_port(pop_runs):
    """The JAX run's sparse checkpoint at round 2 (slot keys as strings)
    loads through the port's load_trainer; its round 2 matches the JAX
    run's: participants and bytes exactly, losses within 1e-4. The trainer
    it loads into builds the clients first touched after the checkpoint
    from the JAX package's init, as the JAX run does."""
    tspec, jt, _, jrep, _, _, ckpt = pop_runs
    jspec, _ = _specs()
    tt = tapi.load_trainer(ckpt, tapi.build_trainer(
        tspec, device="cpu", params=_JaxInit(jspec)))
    assert tt.engine.round_idx == 2
    assert tt.exchange.cache._entries.keys() == set(
        jrep[0]["participants"]) | set(jrep[1]["participants"])
    assert all(e.y.dtype == torch.int32
               for e in tt.exchange.cache._entries.values())
    rt, rj = tt.run_round().to_dict(), jrep[2]
    for key in ("participants", "cache_size", "uplink_mb", "downlink_mb"):
        assert rt[key] == rj[key], key
    for key in ("base_loss", "mod_loss"):
        np.testing.assert_allclose(rt[key], rj[key], rtol=1e-4, atol=1e-4)
    assert tt.ledger.per_round == jt.ledger.per_round[2:]
    assert sorted(tt.exchange.ef_state) == sorted(jt.ef_state)
    assert tt.exchange._last_upload == jt.exchange._last_upload


def test_baselines_reject_population_fleets():
    for scheme in ("fsl", "fl1", "fl2"):
        _, tspec = _specs(scheme=scheme)
        with pytest.raises(ValueError, match="no cohort-shaped path"):
            tapi.build_trainer(tspec, device="cpu")


# ------------------------------------------------------------------- twins


def test_fleet_scale_twin_smoke_on_cpu(tmp_path):
    out = tmp_path / "fleet.json"
    # Without --check: its wall-clock ratio is a card measurement, and
    # millisecond CPU rounds under a loaded host would make it flaky.
    # The byte and memory claims are asserted here directly.
    res = fleet_scale.main(["--smoke", "--device", "cpu",
                            "--out", str(out)])
    assert out.exists() and res["ns"] == [64, 256] and res["cohort"] == 8
    for arm in res["arms"] + [res["half_cohort_arm"]]:
        assert arm["parity_exact"]
        assert all(r["participants"] == arm["cohort"] for r in arm["rounds"])
        assert arm["max_live_server_slots"] <= arm["cohort"] * (4 + 2)
        assert arm["materialized_clients"] <= arm["cohort"] * 3
    small, big = res["arms"]
    half = res["half_cohort_arm"]
    assert small["up_bytes_per_round"] == ifl_round_bytes(
        64, 32, 432, codec="int8", participating=8,
        broadcast_entries=8)["up"]
    # Bytes are flat in N at a fixed C.
    assert (big["up_bytes_per_round"], big["down_bytes_per_round"]) == \
        (small["up_bytes_per_round"], small["down_bytes_per_round"])
    # The C/2 arm pays half the uplink and, under a full broadcast, a
    # quarter of the downlink.
    assert half["cohort"] == 4
    assert 2 * half["up_bytes_per_round"] == big["up_bytes_per_round"]
    assert 4 * half["down_bytes_per_round"] == big["down_bytes_per_round"]


def test_async_vs_sync_twin_smoke_on_cpu(tmp_path):
    out = tmp_path / "avs.json"
    res = async_vs_sync.main(["--smoke", "--device", "cpu",
                              "--out", str(out)])
    assert out.exists() and res["parity_exact"]
    assert res["async"]["matched_uplink"]
    assert res["async"]["uplink_mb"] >= res["sync"]["uplink_mb"]
    assert res["async"]["wall_clock_s"] == res["async"]["ticks"] * 1.0
    assert res["sync"]["round_durations_s"] == \
        jrounds.simulate_sync_wall_clock("pareto(1.2,0.5)", 4, 8, seed=0)
    assert set(res) >= {"acc_delta_pts", "wall_clock_per_acc"}
