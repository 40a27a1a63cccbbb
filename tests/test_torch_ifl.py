"""The port's eager IFL path (round engine, exchange plane, trainer,
front door, quickstart) against the JAX package.

Per quantity: participants, minibatch indices and per-round ledger
up/down bytes are exact; base and modular losses agree within 1e-4 and
final accuracies within 0.02. The two trainers start from the same
parameters (the reference's init, carried as numpy) and draw the same
numpy minibatches, but their fp32 sums run in other orders, and near a
rounding boundary a last-bit difference in z flips an int8/int4 code;
such differences stay far below these bounds over 4 rounds.
"""

import ast
import io
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.api import DataSpec as JDataSpec
from repro.api import ExperimentSpec as JSpec
from repro.api.schemes import build_ifl as jbuild_ifl
from repro.api.schemes import load_data as jload_data
from repro.config import RunConfig as JRunConfig
from repro.core import Client as JClient
from repro.core import IFLTrainer as JIFLTrainer
from repro.core.comm import ifl_round_bytes as j_ifl_round_bytes
from repro.core.rounds import RoundEngine as JRoundEngine
from repro_torch import api as tapi
from repro_torch.config import RunConfig
from repro_torch.core import Client, IFLTrainer
from repro_torch.core.comm import fl_round_bytes, fsl_round_bytes
from repro_torch.core.comm import ifl_round_bytes
from repro_torch.core.rounds import RoundEngine
from repro_torch.kernels import ops, ref
from repro_torch.launch import quickstart

SCHEDULES = ["full", "k2", "bern0.5", "straggle(0.25,4)"]


class _Shard:
    """A client stand-in whose samples are their own indices."""

    def __init__(self, n):
        self.data_x = np.arange(n, dtype=np.float32)[:, None]
        self.data_y = np.arange(n, dtype=np.int32)
        self.num_samples = n


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_engine_participants_and_minibatches_bitwise(schedule):
    te = RoundEngine(4, schedule, seed=3)
    je = JRoundEngine(4, schedule, seed=3)
    shards = [_Shard(50 + 7 * k) for k in range(4)]
    for _ in range(6):
        pt, pj = te.participants(), je.participants()
        assert np.array_equal(pt, pj)
        for k in pt:  # τ = 2 base minibatches, then the fusion one
            for _ in range(3):
                xt, yt = te.sample(shards[k], 8, "cpu")
                xj, yj = je.sample(shards[k], 8)
                assert np.array_equal(yt.numpy(), np.asarray(yj))
                assert np.array_equal(xt.numpy(), np.asarray(xj))
        te.round_idx += 1
        je.round_idx += 1


@pytest.mark.parametrize("codec", ["fp32", "int8_row", "ef(int4)",
                                   "topk0.1", "sketch", "bf16"])
@pytest.mark.parametrize("k,m", [(None, None), (2, 3), (1, 4), (0, 2)])
def test_ifl_round_bytes_matches_reference(codec, k, m):
    for batch, d in [(32, 432), (8, 433)]:
        assert (ifl_round_bytes(4, batch, d, codec=codec, participating=k,
                                broadcast_entries=m)
                == j_ifl_round_bytes(4, batch, d, codec=codec,
                                     participating=k, broadcast_entries=m))
    assert fl_round_bytes(4, 1000, 2) == {"up": 2000, "down": 2000}
    assert fsl_round_bytes(4, 32, 432, participating=2)["down"] == \
        2 * 32 * 432 * 4


def _linear_fleets(d=16, batch=4, n=4, samples=40, seed=0):
    """Toy vendors (base: elementwise gain, modular: one matrix) as the
    reference's engine tests build them, once per package."""
    rng = np.random.default_rng(seed)
    jc, tc = [], []
    for k in range(n):
        x = rng.normal(size=(samples, d)).astype(np.float32)
        y = rng.integers(0, 10, size=samples).astype(np.int32)
        gain = np.full((d,), 1.0 + 0.1 * k, np.float32)
        mod = (rng.normal(size=(d, 10)) * 0.05).astype(np.float32)
        jc.append(JClient(cid=k, params={"base": jnp.asarray(gain),
                                         "modular": jnp.asarray(mod)},
                          base_apply=lambda p, x: x * p,
                          modular_apply=lambda m, z: z @ m,
                          data_x=x, data_y=y))
        tc.append(Client(cid=k, params={"base": torch.from_numpy(gain),
                                        "modular": torch.from_numpy(mod)},
                         base_apply=lambda p, x: x * p,
                         modular_apply=lambda m, z: z @ m,
                         data_x=x, data_y=y))
    return jc, tc


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("codec", ["int8_row", "ef(topk0.25)", "sketch0.5"])
def test_exchange_plane_ledger_and_cache_match_reference(schedule, codec):
    jc, tc = _linear_fleets()
    kw = dict(n_clients=4, tau=1, batch_size=4, d_fusion=16, codec=codec,
              participation=schedule, max_staleness=1)
    jt = JIFLTrainer(jc, JRunConfig(**kw), seed=2)
    tt = IFLTrainer(tc, RunConfig(**kw), seed=2, device="cpu")
    for _ in range(5):
        rj, rt = jt.run_round(), tt.run_round()
        assert rt.participants == rj.participants
        assert rt["cache_size"] == rj["cache_size"]
        assert rt["max_staleness_seen"] == rj["max_staleness_seen"]
        np.testing.assert_allclose(rt["base_loss"], rj["base_loss"],
                                   rtol=1e-4, atol=1e-4)
    assert tt.ledger.per_round == jt.ledger.per_round
    for rep, got in zip(tt.engine.history, tt.ledger.per_round):
        assert got == ifl_round_bytes(4, 4, 16, codec=codec,
                                      participating=len(rep.participants),
                                      broadcast_entries=rep["cache_size"])


def _table2_pair(codec):
    """The reference's and the port's IFL trainer on the same spec, the
    port starting from the reference's init (carried as numpy)."""
    kw = dict(scheme="ifl", rounds=4, tau=2, codec=codec, eval_every=1)
    jspec = JSpec(**kw, data=JDataSpec(n_train=800, n_test=200))
    tspec = tapi.ExperimentSpec(**kw, data=tapi.DataSpec(n_train=800,
                                                         n_test=200))
    assert tspec.spec_hash() == jspec.spec_hash()
    jdata, tdata = jload_data(jspec), tapi.load_data(tspec)
    for a, b in zip(jdata, tdata):
        assert np.array_equal(a, b)
    jt = jbuild_ifl(jspec, jdata)
    init = [jax.tree.map(np.asarray, c.params) for c in jt.clients]
    tt = tapi.build_ifl(tspec, tdata, params=init, device="cpu")
    return jt, tt, tdata


# torch's own intra-op thread count, read before the module's one-thread
# pin (``one_torch_thread``) takes effect.
_DEFAULT_THREADS = torch.get_num_threads()


@pytest.fixture
def default_torch_threads():
    """torch's default thread count for one test: in the ef(int4) run
    at Table-II width some int4 codes sit on rounding edges, and the
    one-thread order of the port's convolution sums flips them against
    the JAX run (losses 3.5e-4 apart after 4 rounds), as the default
    order does not."""
    n = torch.get_num_threads()
    torch.set_num_threads(_DEFAULT_THREADS)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("codec", ["fp32", "int8_row", "ef(int4)"])
def test_ifl_trainer_matches_reference_at_table2(codec, request):
    if codec == "ef(int4)":
        request.getfixturevalue("default_torch_threads")
    jt, tt, data = _table2_pair(codec)
    assert [c.cid for c in tt.clients] == [c.cid for c in jt.clients]
    for c_t, c_j in zip(tt.clients, jt.clients):
        assert np.array_equal(c_t.data_y, c_j.data_y)
    for _ in range(4):
        rj, rt = jt.run_round(), tt.run_round()
        assert rt.participants == rj.participants
        assert rt["cache_size"] == rj["cache_size"]
        np.testing.assert_allclose(rt["base_loss"], rj["base_loss"],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(rt["mod_loss"], rj["mod_loss"],
                                   rtol=1e-4, atol=1e-4)
    assert tt.ledger.per_round == jt.ledger.per_round
    acc_t = tt.evaluate(data.test_x, data.test_y)
    acc_j = jt.evaluate(data.test_x, data.test_y)
    np.testing.assert_allclose(acc_t, acc_j, atol=0.02)


def test_quickstart_on_cpu():
    out = io.StringIO()
    with redirect_stdout(out):
        quickstart.main(["--device", "cpu", "--rounds", "2", "--tau", "1",
                         "--codec", "ef(int4)", "--participation", "k2"])
    text = out.getvalue()
    assert "round   1:" in text
    assert "measured == analytic ifl_round_bytes, every round: True" in text
    assert "composition matrix" in text


def test_unported_parts_raise_not_implemented():
    """The async and population configs, which raised before they were
    ported, build and run a round as the JAX trainer does."""
    for kw in (dict(mode="async", trace="poisson(0.5)"),
               dict(cohort=2, n_population=4)):
        jc, tc = _linear_fleets()
        kw = dict(d_fusion=16, batch_size=4, tau=1, codec="ef(int4)", **kw)
        jt = JIFLTrainer(jc, JRunConfig(**kw), seed=1)
        tt = IFLTrainer(tc, RunConfig(**kw), seed=1, device="cpu")
        rj, rt = jt.run_round(), tt.run_round()
        assert type(tt.engine).__name__ == type(jt.engine).__name__
        assert rt.participants == rj.participants and rt.participants
        assert rt.metrics.keys() == rj.metrics.keys()
        assert tt.ledger.per_round == jt.ledger.per_round
        np.testing.assert_allclose(rt["mod_loss"], rj["mod_loss"],
                                   rtol=1e-4, atol=1e-4)


def test_entry_points_run_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    spec = tapi.ExperimentSpec(data=tapi.DataSpec(n_train=64, n_test=16))
    data = tapi.load_data(spec)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapi.build_ifl(spec, data)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        quickstart.main(["--rounds", "1"])


def test_run_config_and_spec_match_reference():
    assert RunConfig() .__dict__ == JRunConfig().__dict__
    for kw in [dict(), dict(codec="ef(int4)", participation="k2"),
               dict(rounds=4, tau=2, data=dict(n_train=800, n_test=200))]:
        kw = dict(kw)
        data = kw.pop("data", None)
        jspec = JSpec(**kw, **({"data": JDataSpec(**data)} if data else {}))
        tspec = tapi.ExperimentSpec(
            **kw, **({"data": tapi.DataSpec(**data)} if data else {}))
        assert tspec.canonical_json() == jspec.canonical_json()
        assert tspec.spec_hash() == jspec.spec_hash()
        assert tspec.run_config().__dict__ == jspec.run_config().__dict__


def _chip_smoke_constant(name):
    """A constant of chip_smoke.py, read without importing the script."""
    tree = ast.parse((Path(__file__).parents[1] / "chip_smoke.py").read_text())
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == name):
            return ast.literal_eval(node.value)
    raise KeyError(name)


def test_one_int4_code_flip_stays_within_chip_smoke_tolerance(monkeypatch):
    """chip_smoke.py holds its card-vs-CPU short run (ef(int4), 2 rounds,
    tau 2, k2, Table-II fleet) to IFL_LOSS_TOL. A last-bit difference in z
    may rightly flip one int4 code, so force one flip at each encode of the
    run in turn (move the element of c = z + e nearest a rounding boundary
    just across it) and check that the losses move by less than that."""
    tol = _chip_smoke_constant("IFL_LOSS_TOL")
    spec = tapi.ExperimentSpec(
        scheme="ifl", rounds=2, tau=2, lr=0.01, batch_size=32, d_fusion=432,
        codec="ef(int4)", participation="k2", seed=0,
        data=tapi.DataSpec(n_train=4000, n_test=1000))
    data = tapi.load_data(spec)

    def losses(flip_at):
        calls = [0]

        def encode(z, e, ef_codec):
            if calls[0] == flip_at:
                c = z + e
                scale = c.abs().amax(-1, keepdim=True) * np.float32(1 / 7)
                y = c / scale
                i = int((y - y.floor() - 0.5).abs().argmin())
                r, col = divmod(i, z.shape[1])
                z = z.clone()
                z[r, col] += 2 * (y[r, col].floor() + 0.5 - y[r, col]) \
                    * scale[r, 0]
            calls[0] += 1
            return ref.wire_encode_ef_ref(z, e, ef_codec)

        monkeypatch.setattr(ops, "wire_encode_ef", encode)
        trainer = tapi.build_ifl(spec, data, device="cpu")
        for _ in range(spec.rounds):
            trainer.run_round()
        assert calls[0] == 4  # 2 participants x 2 rounds
        return np.array([[r["base_loss"], r["mod_loss"]]
                         for r in trainer.engine.history])

    clean = losses(-1)
    shifts = [float(np.abs(losses(k) - clean).max()) for k in range(4)]
    print(f"loss shift of one forced int4 flip at each encode: {shifts}")
    assert max(shifts) > 0  # the flips reached the losses
    assert max(shifts) <= tol, (shifts, tol)
