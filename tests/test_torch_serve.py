"""The port's serving plane against the JAX package's.

A 3-tenant store of the reduced qwen1.5-0.5b config is built and saved
by the JAX package and loaded by the port; the same staggered greedy
requests (one of them ending on EOS) go through both engines at W = 2
and horizon 1 and 4. Token streams, finish reasons and tick stamps must
be identical (greedy argmax of fp32 logits that agree within ~1e-6),
and every stream the port's engine serves must equal the port's oracle
bitwise. The same requests sampled (temperature 0.8, top-k 5) give the
JAX engine's streams too: the port's lanes draw on the reference's own
threefry key chain, so a token differs only where two candidates'
gumbel + logit / t lie within the logits' ~1e-6 of each other.

Then the port alone: sampled reruns are bitwise and another seed
diverges, greedy rows are untouched by sampling neighbours, a sampling
slot's stream does not move when a neighbour is admitted mid-stream,
the serve-plan autotuner's file round trip and ``horizon="auto"``, and
the CLI's sampling and ``--horizon auto`` on the CPU.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.serve import build_demo_store as jax_build_demo_store
from repro.serve import CompositionStore as JaxStore
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxEngine
from _port_parity import one_torch_thread  # noqa: F401 (autouse)
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_cli
from repro_torch.serve import CompositionStore, Request, ServeEngine
from repro_torch.serve import engine as engine_mod

ARCH = "qwen1.5-0.5b"
WIDTH, CACHE_LEN = 2, 32
SAMPLED = dict(temperature=0.8, top_k=5)


def _request_fields(vocab):
    rng = np.random.default_rng(0)
    out = []
    for i in range(5):
        out.append(dict(
            rid=i, tenant=f"tenant{i % 3}",
            prompt=[int(t) for t in rng.integers(0, vocab, 3 + 2 * i)],
            max_new_tokens=4 + i, arrival=2 * i))
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _summary(c):
    return (c.rid, c.tenant, c.tokens, c.finish_reason, c.admitted_tick,
            c.finished_tick, c.token_ticks)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The JAX side, once: the saved artifact, the request set (rid 1
    stops on the third token of its own greedy stream), and the JAX
    engine's completions at horizon 1 and 4, greedy and sampled."""
    jcfg = jax_get_config(ARCH).reduced()
    jstore = jax_build_demo_store(jcfg, ARCH, 3, seed=0)
    path = str(tmp_path_factory.mktemp("artifact") / "store.npz")
    jstore.save(path)
    fields = _request_fields(jcfg.vocab_size)
    runs = {}
    for h in (1, 4):
        eng = JaxEngine(jstore, width=WIDTH, cache_len=CACHE_LEN, horizon=h)
        if h == 1:
            stream = eng.oracle(JaxRequest(**fields[1])).tokens
            fields[1]["eos_id"] = stream[2]
        runs[h] = eng.run([JaxRequest(**f) for f in fields])
        runs["sampled", h] = eng.fresh_clone().run(
            [JaxRequest(**f, **SAMPLED) for f in fields])
    return dict(path=path, jstore=jstore, fields=fields, runs=runs)


@pytest.fixture(scope="module")
def store(served):
    return CompositionStore.load(served["path"], device="cpu")


def test_port_loads_the_jax_artifact(served, store):
    jstore = served["jstore"]
    assert store.tenants() == jstore.tenants()
    arch = store.entry("tenant0").arch
    assert dataclasses.asdict(store.cfg(arch)) == \
        dataclasses.asdict(jstore.cfg(arch))
    for t in store.tenants():
        ours, theirs = _flat(store.entry(t).base), _flat(jstore.entry(t).base)
        assert ours.keys() == theirs.keys()
        for k in ours:
            assert np.array_equal(ours[k], theirs[k]), (t, k)
    assert _flat(store.modular(arch)).keys() == \
        _flat(jstore.modular(arch)).keys()


@pytest.mark.parametrize("horizon", [1, 4])
def test_greedy_streams_equal_jax_and_port_oracle(served, store, horizon):
    eng = ServeEngine(store, width=WIDTH, cache_len=CACHE_LEN,
                      horizon=horizon, device="cpu")
    reqs = [Request(**f) for f in served["fields"]]
    comps = eng.run(reqs)
    want = served["runs"][horizon]
    assert [_summary(c) for c in comps] == [_summary(c) for c in want]
    assert any(c.finish_reason == "eos" for c in comps)
    for r, c in zip(reqs, comps):
        assert eng.oracle(r).tokens == c.tokens, r.rid


def test_port_artifact_loads_in_jax(served, store, tmp_path):
    path = str(tmp_path / "port_store.npz")
    store.save(path)
    back = JaxStore.load(path)
    assert back.tenants() == store.tenants()
    for t in store.tenants():
        ours = _flat(store.entry(t).base)
        theirs = _flat(jax.tree.map(np.asarray, back.entry(t).base))
        assert ours.keys() == theirs.keys()
        for k in ours:
            assert np.array_equal(ours[k], theirs[k]), (t, k)


def test_one_host_transfer_per_step(served, store, monkeypatch):
    eng = ServeEngine(store, width=WIDTH, cache_len=CACHE_LEN, horizon=4,
                      device="cpu")
    for f in served["fields"]:
        eng.submit(Request(**f))
    calls = []
    real = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda self, *a, **k: calls.append(1) or
                        real(self, *a, **k))
    steps = 0
    while eng.inflight:
        before = len(calls)
        eng.step()
        steps += 1
        assert len(calls) - before <= 1
    assert 1 <= len(calls) <= steps


# ------------------------------------------------------------- sampling


def _serve(store, reqs, horizon=4, width=WIDTH):
    eng = ServeEngine(store, width=width, cache_len=CACHE_LEN,
                      horizon=horizon, device="cpu")
    return eng, eng.run(list(reqs))


@pytest.mark.parametrize("horizon", [1, 4])
def test_sampled_streams_equal_jax_and_port_oracle(served, store, horizon):
    reqs = [Request(**f, **SAMPLED) for f in served["fields"]]
    eng, comps = _serve(store, reqs, horizon)
    want = served["runs"]["sampled", horizon]
    assert [_summary(c) for c in comps] == [_summary(c) for c in want]
    greedy = served["runs"][horizon]
    assert [c.tokens for c in comps] != [c.tokens for c in greedy]
    assert all(lane.sampling for lane in eng.lanes())
    for r, c in zip(reqs, comps):
        assert eng.oracle(r).tokens == c.tokens, r.rid


def test_sampled_reruns_are_bitwise_and_another_seed_diverges(served, store):
    reqs = [Request(**f, **SAMPLED) for f in served["fields"]]
    _, first = _serve(store, reqs)
    _, again = _serve(store, reqs)
    assert [_summary(c) for c in again] == [_summary(c) for c in first]
    bumped = [dataclasses.replace(r, seed=r.seed + 1) for r in reqs]
    _, other = _serve(store, bumped)
    assert [c.tokens for c in other] != [c.tokens for c in first]


def test_greedy_rows_untouched_by_sampling_neighbours(served, store):
    """Admitting non-greedy requests turns the lane's sampling on; the
    greedy requests served beside them keep their streams (the twin of
    the JAX package's test_serve_hotloop.py test of the same name)."""
    greedy = [Request(**f) for f in served["fields"]]
    mixed = greedy + [
        Request(rid=100 + i, tenant=f"tenant{i}", prompt=[13, 7],
                max_new_tokens=4, temperature=1.2, top_k=3, seed=i)
        for i in range(2)]
    _, solo = _serve(store, greedy, width=3)
    eng, both = _serve(store, mixed, width=3)
    assert all(lane.sampling for lane in eng.lanes())
    by = {c.rid: (c.tokens, c.finish_reason) for c in both}
    assert all(by[c.rid] == (c.tokens, c.finish_reason) for c in solo)


def test_sampling_stream_unmoved_by_a_neighbours_admission(store):
    """A sampling slot mid-stream, then a second request admitted into
    the lane's other row: the slot's key chain and stream are those of
    the slot served alone (only the admitted row takes a key)."""
    a = Request(rid=1, tenant="tenant0", prompt=[5, 9, 2],
                max_new_tokens=12, **SAMPLED)
    b = Request(rid=2, tenant="tenant1", prompt=[7, 1, 3, 3, 8],
                max_new_tokens=5, arrival=4, temperature=1.1, top_k=0)
    for horizon in (1, 2):
        _, alone = _serve(store, [a], horizon)
        eng, pair = _serve(store, [a, b], horizon)
        assert pair[1].admitted_tick > pair[0].admitted_tick
        assert pair[0].tokens == alone[0].tokens
        assert pair[1].tokens == eng.oracle(b).tokens


# ------------------------------------------------------- the serve plan


@pytest.fixture
def plan_file(tmp_path, monkeypatch):
    path = tmp_path / "serve_plan.json"
    monkeypatch.setenv("REPRO_TORCH_SERVE_PLAN_CACHE", str(path))
    monkeypatch.setattr(ops, "_serve_cache_mem", None)
    return path


def test_serve_plan_cache_round_trip_and_horizon_auto(store, plan_file,
                                                      monkeypatch):
    """The twin of the JAX package's test_serve_plan_cache_roundtrip:
    the winner persisted, a cache hit without timing, ``horizon="auto"``
    picking the plan up for a matching geometry and 8 otherwise; a timer
    that raises is not skipped."""
    calls = []

    def timer(h, edges):
        calls.append((h, tuple(edges)))
        return {1: 3.0, 2: 1.0, 4: 2.0}[h]

    plan = ops.autotune_serve_plan("unit|W3|L32", timer, "cpu",
                                   horizons=(1, 2, 4), edge_sets=((8, 32),))
    assert plan["horizon"] == 2 and plan["bucket_edges"] == [8, 32]
    assert [c["seconds"] for c in plan["candidates"]] == [3.0, 1.0, 2.0]
    assert len(calls) == 3
    on_disk = json.loads(plan_file.read_text())
    assert on_disk["cpu|serve|unit|W3|L32"]["horizon"] == 2
    assert ops.serve_plan("unit|W3|L32", "cpu")["horizon"] == 2
    again = ops.autotune_serve_plan("unit|W3|L32", timer, "cpu",
                                    horizons=(1, 2, 4), edge_sets=((8, 32),))
    assert again["horizon"] == 2 and len(calls) == 3
    eng = ServeEngine(store, width=3, cache_len=32, horizon="auto",
                      device="cpu")
    assert eng.horizon == 8 and eng.bucket_edges is None
    monkeypatch.setattr(ServeEngine, "plan_key",
                        lambda self: "unit|W3|L32")
    eng = ServeEngine(store, width=3, cache_len=32, horizon="auto",
                      device="cpu")
    assert eng.horizon == 2 and eng.bucket_edges == [8, 32]

    def failing(h, edges):
        raise RuntimeError("kernel failed")

    with pytest.raises(RuntimeError, match="kernel failed"):
        ops.autotune_serve_plan("other|W3|L32", failing, "cpu", force=True)


def test_autotune_plan_is_taken_by_horizon_auto(served, store, plan_file):
    """``ServeEngine.autotune`` on the request set writes a plan that a
    ``horizon="auto"`` engine of the same geometry takes; its streams
    are the integer-horizon engine's."""
    reqs = [Request(**f, **SAMPLED) for f in served["fields"]]
    eng = ServeEngine(store, width=WIDTH, cache_len=CACHE_LEN,
                      device="cpu")
    plan = eng.autotune(reqs, horizons=(4,))
    assert [c["bucket_edges"] for c in plan["candidates"]] == [
        [8, 16, CACHE_LEN], [CACHE_LEN]]
    assert plan["seconds"] == min(c["seconds"] for c in plan["candidates"])
    auto = ServeEngine(store, width=WIDTH, cache_len=CACHE_LEN,
                       horizon="auto", device="cpu")
    assert auto.horizon == plan["horizon"]
    assert auto.bucket_edges == plan["bucket_edges"]
    want = served["runs"]["sampled", 4]
    assert [c.tokens for c in auto.run(reqs)] == [c.tokens for c in want]


def test_cli_samples_and_reads_the_plan_on_cpu(plan_file, capsys):
    args = ["--device", "cpu", "--tenants", "2", "--width", "2",
            "--prompt-len", "4", "--gen", "3"]
    serve_cli.main(args + ["--horizon", "2", "--temperature", "0.8",
                           "--top-k", "5"])
    out = capsys.readouterr().out
    assert "temperature=0.8 top_k=5" in out
    assert "served 2 requests / 6 new tokens" in out
    serve_cli.main(args + ["--horizon", "auto"])
    assert "at horizon 8" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve_cli.main(args + ["--horizon", "often"])


def test_entry_points_default_to_the_card(served, store, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(store)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CompositionStore.load(served["path"])
    cfg = store.cfg(store.entry("tenant0").arch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_cli.build_demo_store(cfg, ARCH, 1, reduced=True)


def test_cli_serves_on_cpu(capsys):
    serve_cli.main(["--device", "cpu", "--tenants", "2", "--width", "2",
                    "--prompt-len", "4", "--gen", "3", "--horizon", "2"])
    out = capsys.readouterr().out
    assert "served 2 requests / 6 new tokens" in out


def test_fetch_is_one_transfer_of_every_pending_tensor():
    w = torch.arange(6).reshape(3, 2)
    first, done = torch.tensor([7, 8]), torch.tensor([True, False])
    host = engine_mod.fetch({"a": {"window": w, "admit": [(first, done)]},
                             "b": {}})
    assert host["b"] == {}
    assert np.array_equal(host["a"]["window"], w.numpy())
    f, d = host["a"]["admit"][0]
    assert f.tolist() == [7, 8] and d.tolist() == [1, 0]


def test_serve_demo_twin_holds_engine_to_oracle_on_cpu(capsys):
    from repro_torch.examples import serve_demo

    out = serve_demo.main(["--device", "cpu", "--tenants", "3", "--width",
                           "2", "--prompt-len", "5", "--gen", "4",
                           "--horizon", "2"])
    assert out["parity"] and out["tokens"] == 12
    assert "bitwise parity vs fixed-batch oracle: True" in \
        capsys.readouterr().out
