"""The SPMD IFL round on a mesh of real ranks against the same round in
one process, on the CPU.

Four ranks are spawned once (``tests/_mesh_ranks.py``: gloo, CPU
tensors, one torch thread each, a FileStore rendezvous under the test's
temporary directory) and run every scenario; this process runs the same
rounds without a mesh and compares. The smoke LM (4 layers, d_model 48,
vocab 128, d_fusion 32, fp32), N 4, tau 2, B 2, S 32.

(a) (4, 1, 1) under int8_row: losses, params and the decoded chunks
    bitwise the one-process round's (each rank holds one client; its
    rows are the whole minibatch). Its losses also match the JAX round
    on its one-device mesh from the same init, at test_torch_spmd.py's
    TOL (1e-4).
(b) (2, 2, 1) under ef(int4), k2 masks, max_staleness 1: each gradient
    is the mean of two half-minibatch gradients, so floats differ in
    their last bits: losses and params within MESH_TOL (1e-5), EF rows
    within MESH_TOL of max |e| but for codes flipped by a last-bit
    difference in z (one quantization step each); integer codes within
    the flip budget (tests/_wire_budget.py: < 2% differ, each by one
    step); ages and cached labels exact; absent clients bitwise frozen.
(c) An SPMDIFLTrainer saved on (4, 1, 1) resumes in one process and a
    one-process checkpoint resumes on (4, 1, 1), each next round equal
    to the uninterrupted run's; the export (``from_spmd_trainer``) is
    built on rank 0 alone and equals the one-process export.
(d) Under full participation the bytes every rank hands to the
    collective (payload leaves and int32 labels), summed over the ranks,
    equal the ledger's analytic uplink of the round: every client's
    encoded rows cross once, at d_fusion 32 with no int4 padding. Under
    a mask the whole cache crosses (N entries, plus each rank's int32
    ages), where the ledger counts the K fresh uploads.
(e) Each refusal raises: a 'model' axis above 1, a client axis that
    does not divide N, a CUDA mesh without a card, a mesh whose process
    group is gone, the population regime on a client axis above 1, a
    whole-tensor codec on a data axis above 1, a plane on another mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P
from torch.testing._internal.distributed.fake_pg import FakeStore

import _mesh_ranks as mr
import _wire_budget as wb
from repro.api.spmd import smoke_model_config as jax_smoke_model_config
from repro.core import ifl_spmd as jspmd
from repro_torch.api.spmd import SPMDIFLTrainer, smoke_model_config
from repro_torch.api.trainer import load_trainer, save_trainer
from repro_torch.checkpoint import load_flat, unstack_clients
from repro_torch.checkpoint.ckpt import _flatten
from repro_torch.core import ifl_spmd as tspmd
from repro_torch.core.codec import get_codec
from repro_torch.core.exchange import SPMDFusionExchange
from repro_torch.launch import mesh as tmesh
from repro_torch.serve.store import CompositionStore
from repro_torch.train.loop import train_ifl_lm

N, TAU, B, S = mr.N, mr.TAU, mr.B, mr.S
TOL = dict(rtol=1e-4, atol=1e-4)
MESH_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cfg():
    return smoke_model_config()


@pytest.fixture(scope="module")
def jax_init():
    params, _ = jspmd.init_ifl_state(jax.random.PRNGKey(0),
                                     jax_smoke_model_config(), n_clients=N)
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def run(tmp_path_factory, jax_init):
    """-> (out dir, the one-process trainer's round-3 report and final
    snapshot, each rank's results). The one-process checkpoint the ranks
    resume from is written first."""
    out = tmp_path_factory.mktemp("mesh")
    np.savez(out / "jax_init.npz", **_flatten(jax_init))
    one = SPMDIFLTrainer(mr.trainer_spec(), device="cpu")
    reports = [one.run_round().to_dict() for _ in range(2)]
    save_trainer(str(out / "one_process"), one)
    reports.append(one.run_round().to_dict())
    ranks = mr.spawn(str(out), ["a", "b", "c", "d", "pop"])
    return out, one, reports, ranks


def _step(cfg, params, codec, batches, masks=None, max_staleness=None):
    opt = [{"base": {}, "modular": {}} for _ in params]
    return mr.run_step(cfg, params, opt, codec, batches, masks,
                       max_staleness=max_staleness)[0]


# ------------------------------------------------------------------ (a)


def test_client_mesh_round_is_bitwise_one_process(cfg, run, jax_init):
    _, _, _, ranks = run
    want = _step(cfg, unstack_clients(jax_init, device="cpu"), "int8_row",
                 mr.smoke_batches(cfg.vocab_size, 2))
    for rank in ranks:
        got = rank["a"]
        for r, (g, w) in enumerate(zip(got["records"], want)):
            assert (g["base_loss"], g["mod_loss"]) == (w["base_loss"],
                                                       w["mod_loss"])
            assert torch.equal(g["z_hat"], w["z_hat"]), r
            for i, k in enumerate(got["clients"]):
                assert all(torch.equal(a, c) for a, c in
                           zip(g["params"][i], w["params"][k])), (r, k)


def test_client_mesh_losses_match_the_jax_round(cfg, run, jax_init):
    _, _, _, ranks = run
    jcfg = jax_smoke_model_config()
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                ("client", "data", "model"))
    rep = NamedSharding(mesh, P())
    params, opt = jax.tree.map(lambda a: jax.device_put(a, rep),
                               (jax_init, {"base": {}, "modular": {}}))
    step = jax.jit(jspmd.make_ifl_round_step(
        jcfg, mesh, n_clients=N, tau=TAU, lr_base=mr.LR, lr_modular=mr.LR,
        codec="int8_row"))
    got = ranks[0]["a"]["records"]
    with mesh:
        for r, toks in enumerate(mr.smoke_batches(cfg.vocab_size, 2)):
            params, opt, m = step(params, opt, {
                "tokens": jax.device_put(jnp.asarray(toks), rep)})
            np.testing.assert_allclose(
                [got[r]["base_loss"], got[r]["mod_loss"]],
                [float(m["base_loss"]), float(m["mod_loss"])], **TOL)


# ------------------------------------------------------------------ (b)


def test_client_data_mesh_masked_round_within_tolerance(cfg, run):
    _, _, _, ranks = run
    params, _ = tspmd.init_ifl_state(
        cfg, n_clients=N, generator=torch.Generator().manual_seed(3),
        device="cpu")
    want = _step(cfg, params, "ef(int4)", mr.smoke_batches(cfg.vocab_size, 3),
                 mr.MASKS, max_staleness=1)
    d = cfg.d_fusion
    for rank in ranks:
        got = rank["b"]
        assert got["init_same"]
        mine, rows = got["clients"], got["rows"]
        for r, (g, w) in enumerate(zip(got["records"], want)):
            assert abs(g["base_loss"] - w["base_loss"]) <= MESH_TOL
            assert abs(g["mod_loss"] - w["mod_loss"]) <= MESH_TOL
            assert g["frozen"], (r, g["absent"])
            for i, k in enumerate(mine):
                err = max(float((a - c).abs().max()) for a, c in
                          zip(g["params"][i], w["params"][k]))
                assert err <= MESH_TOL, (r, k, err)
            wc = {name: v[mine][:, rows]
                  for name, v in w["cache"]["payload"].items()}
            gc = g["cache"]["payload"]
            flips = wb.codes_close(wb.codes("int4", gc, d),
                                   wb.codes("int4", wc, d), f"round {r}")
            wb.floats_close(gc["scale"], wc["scale"], MESH_TOL)
            assert torch.equal(g["cache"]["age"], w["cache"]["age"][mine])
            assert torch.equal(g["cache"]["tokens"],
                               w["cache"]["tokens"][mine][:, rows])
            # EF rows: within MESH_TOL but where a code flipped.
            e = (g["ef"] - w["ef"][mine][:, rows]).abs().reshape(-1, d)
            ok = (e <= MESH_TOL) | torch.from_numpy(flips)
            assert bool(ok.all())
            assert float(e.max()) <= float(wc["scale"].max()) * 1.01 + MESH_TOL
    assert any(rec["absent"] for rk in ranks for rec in rk["b"]["records"])


# ------------------------------------------------------------------ (c)


def _tree_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_checkpoints_resume_across_meshes(run):
    out, one, reports, ranks = run
    keys = ("base_loss", "mod_loss", "participants", "cache_size",
            "uplink_mb", "downlink_mb")
    for rank in ranks:
        c = rank["c"]
        for g, w in zip(c["reports"], reports):
            assert {k: g[k] for k in keys} == {k: w[k] for k in keys}
        assert {k: c["tail"][k] for k in keys} == \
            {k: reports[2][k] for k in keys}
        assert c["accs"] == one.evaluate()
    assert [r["c"]["store_is_none"] for r in ranks] == [False, True, True,
                                                        True]
    # The mesh's checkpoint, resumed in one process.
    resumed = load_trainer(str(out / "mesh_ckpt"),
                           SPMDIFLTrainer(mr.trainer_spec(), device="cpu"))
    tail = resumed.run_round().to_dict()
    assert {k: tail[k] for k in keys} == {k: reports[2][k] for k in keys}
    save_trainer(str(out / "one_after"), one)
    save_trainer(str(out / "resumed_after"), resumed)
    want = load_flat(str(out / "one_after"))
    _tree_equal(load_flat(str(out / "resumed_after")), want)
    _tree_equal(load_flat(str(out / "mesh_resumed")), want)
    # The export from rank 0's gathered trees.
    CompositionStore.from_spmd_trainer(one).save(str(out / "one_store.npz"))
    _tree_equal(load_flat(str(out / "mesh_store.npz")),
                load_flat(str(out / "one_store.npz")))


# ------------------------------------------------------------------ (d)


def test_collective_bytes_against_the_ledger(cfg, run):
    _, _, _, ranks = run
    codec = get_codec("int8_row")
    entry = codec.encoded_nbytes((B, S, cfg.d_fusion)) + B * S * 4
    for scenario in ("a", "d"):   # full participation: == the uplink
        rounds = len(ranks[0][scenario]["gathered"])
        for r in range(rounds):
            handed = sum(rk[scenario]["gathered"][r]["payload"]
                         + rk[scenario]["gathered"][r]["labels"]
                         for rk in ranks)
            assert handed == N * entry, (scenario, r)
    for r, row in enumerate(ranks[0]["d"]["ledger"]):
        assert row["up"] == N * entry
    # Under a mask the whole cache crosses: N entries a round, and each
    # rank's int32 ages; the ledger counts the K = 2 fresh uploads.
    ef = get_codec("ef(int4)")
    entry4 = ef.encoded_nbytes((B, S, cfg.d_fusion)) + B * S * 4
    assert entry4 == B * S * (cfg.d_fusion // 2 + 4 + 4)   # no padding
    for r in range(3):
        g = [rk["b"]["gathered"][r] for rk in ranks]
        assert sum(x["payload"] + x["labels"] for x in g) == N * entry4
        assert sum(x["age"] for x in g) == 2 * N * 4   # D = 2 copies


def test_trainer_and_loop_on_a_client_data_mesh(cfg, run):
    _, _, _, ranks = run
    one = SPMDIFLTrainer(mr.trainer_spec(codec="int8_row",
                                         participation="full",
                                         broadcast="full"), device="cpu")
    want = one.run_round().to_dict()
    hist = train_ifl_lm(cfg, rounds=1, n_clients=N, tau=TAU, batch=B, seq=S,
                        log_every=99, device="cpu")["history"]
    for rank in ranks:
        got = rank["d"]
        for k in ("base_loss", "mod_loss"):
            assert abs(got["report"][k] - want[k]) <= MESH_TOL
            assert abs(got["history"][0][k] - hist[0][k]) <= MESH_TOL
        assert got["report"]["uplink_mb"] == want["uplink_mb"]
        assert got["ledger"] == one.ledger.per_round


def test_population_on_a_data_axis(run):
    _, _, _, ranks = run
    one = SPMDIFLTrainer(mr.trainer_spec(
        batch_size=4, participation="full",
        fleet=dict(n_population=8, cohort=2)), device="cpu")
    want = [one.run_round().to_dict() for _ in range(2)]
    for rank in ranks:
        for g, w in zip(rank["pop"]["reports"], want):
            assert g["participants"] == w["participants"]
            assert (g["uplink_mb"], g["downlink_mb"]) == (w["uplink_mb"],
                                                          w["downlink_mb"])
            for k in ("base_loss", "mod_loss"):
                assert abs(g[k] - w[k]) <= MESH_TOL


# ------------------------------------------------------------------ (e)


@pytest.fixture
def world():
    """A fake process group of ``n`` ranks (this process rank 0)."""
    def start(n):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


def test_refusals(cfg, world):
    axes = ("client", "data", "model")
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh((1, 1, 1), axes, device_type="cpu")
    world(4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.make_mesh((4, 1, 1), axes)
    with pytest.raises(NotImplementedError, match="ROADMAP item 1 \\(i\\)"):
        tspmd.make_ifl_round_step(
            cfg, mesh=tmesh.make_mesh((2, 1, 2), axes, device_type="cpu"),
            n_clients=4, tau=1)
    m = tmesh.make_mesh((4, 1, 1), axes, device_type="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        tspmd.make_ifl_round_step(cfg, mesh=m, n_clients=6, tau=1)
    with pytest.raises(ValueError, match="another mesh"):
        tspmd.make_ifl_round_step(
            cfg, mesh=m, n_clients=4, tau=1,
            exchange=SPMDFusionExchange("fp32", n_clients=4))
    with pytest.raises(NotImplementedError, match="ROADMAP item 1 \\(ii\\)"):
        SPMDIFLTrainer(mr.trainer_spec(fleet=dict(n_population=8,
                                                  cohort=4)), mesh=m)
    with pytest.raises(ValueError, match="whole tensor"):
        plane = SPMDFusionExchange("int8", n_clients=4, mesh=tmesh.make_mesh(
            (2, 2, 1), axes, device_type="cpu"))
        z = torch.zeros(2, 1, 4, 8)
        plane.wire(z, torch.zeros(2, 1, 4, dtype=torch.int32), None, None, ())
    dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="not initialised"):
        tspmd.make_ifl_round_step(cfg, mesh=m, n_clients=4, tau=1)
