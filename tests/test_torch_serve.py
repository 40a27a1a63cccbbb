"""The port's serving plane against the JAX package's.

A 3-tenant store of the reduced qwen1.5-0.5b config is built and saved
by the JAX package and loaded by the port; the same staggered greedy
requests (one of them ending on EOS) go through both engines at W = 2
and horizon 1 and 4. Token streams, finish reasons and tick stamps must
be identical (greedy argmax of fp32 logits that agree within ~1e-6),
and every stream the port's engine serves must equal the port's oracle
bitwise.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.serve import build_demo_store as jax_build_demo_store
from repro.serve import CompositionStore as JaxStore
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxEngine
from repro_torch.launch import serve as serve_cli
from repro_torch.serve import CompositionStore, Request, ServeEngine
from repro_torch.serve import engine as engine_mod

ARCH = "qwen1.5-0.5b"
WIDTH, CACHE_LEN = 2, 32


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
    engine's completions at horizon 1 and 4."""
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


def test_sampling_request_raises(store):
    eng = ServeEngine(store, width=WIDTH, cache_len=CACHE_LEN, device="cpu")
    with pytest.raises(NotImplementedError, match="greedy"):
        eng.submit(Request(rid=0, tenant="tenant0", prompt=[1, 2],
                           temperature=0.7))


def test_horizon_auto_raises(store):
    with pytest.raises(NotImplementedError, match="autotuner"):
        ServeEngine(store, horizon="auto", device="cpu")
    with pytest.raises(SystemExit):
        serve_cli.main(["--horizon", "auto", "--device", "cpu"])


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
