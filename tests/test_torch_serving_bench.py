"""The twin of ``benchmarks/serving_bench.py`` on the CPU: a small sweep
(W 2, T 2, gen 4) with exact parity on every arm and the reference's
result keys, and its ``--check`` gate against the reference's own gate
(read from the reference's source: importing it would load JAX) on
hand-made results."""

import ast
import contextlib
import io
import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from _port_parity import one_torch_thread  # noqa: F401 (autouse)
from repro_torch.benchmarks import serving_bench

ROOT = Path(__file__).resolve().parents[1]
REF_SRC = (ROOT / "benchmarks" / "serving_bench.py").read_text()


def _ref_function(name):
    tree = ast.parse(REF_SRC)
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _dict_keys(fn, var):
    """The string keys of the dict literal assigned to ``var`` in the
    reference's function, and of ``var["key"] = ...`` assignments."""
    keys = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            t = node.targets[0]
            if (isinstance(t, ast.Name) and t.id == var
                    and isinstance(node.value, ast.Dict)):
                keys += [k.value for k in node.value.keys]
            elif (isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
                  and t.value.id == var
                  and isinstance(t.slice, ast.Constant)):
                keys.append(t.slice.value)
    return set(keys)


def _reference_gate():
    """The body of the reference's ``if args.check and not args.load:``,
    run on a result -> (passed, the failure messages it printed)."""
    gate = next(n for n in ast.walk(_ref_function("run"))
                if isinstance(n, ast.If)
                and ast.unparse(n.test) == "args.check and (not args.load)")
    code = compile(ast.Module(body=gate.body, type_ignores=[]),
                   "reference_serving_gate", "exec")

    def verdict(result, min_speedup):
        out = io.StringIO()
        ns = {"result": result,
              "args": SimpleNamespace(min_speedup=min_speedup)}
        with contextlib.redirect_stdout(out):
            try:
                exec(code, ns)
                passed = True
            except SystemExit:
                passed = False
        msgs = [x[len("CHECK FAILED: "):] for x in out.getvalue().splitlines()
                if x.startswith("CHECK FAILED: ")]
        return passed, msgs
    return verdict


@pytest.fixture(scope="module")
def small_sweep(tmp_path_factory):
    path = tmp_path_factory.mktemp("bench") / "BENCH_serving.json"
    res = serving_bench.main(["--device", "cpu", "--widths", "2",
                              "--tenants", "2", "--gen", "4",
                              "--out", str(path)])
    return res, path


def test_small_sweep_on_the_cpu_is_exact_with_the_references_keys(
        small_sweep):
    res, path = small_sweep
    assert json.loads(path.read_text()) == json.loads(json.dumps(res))
    # A sweep's keys ("load" is the --load mode's, in place of the arms).
    assert set(res) - {"device"} == _dict_keys(_ref_function("run"),
                                              "result") - {"load"}
    assert res["device"] == "cpu" and res["arch"] == "spmd-smoke"
    (seq,) = res["sequential"]
    assert set(seq) == _dict_keys(_ref_function("run_sequential"), "base")
    assert seq["new_tokens"] == 2 * 4
    arm_keys = _dict_keys(_ref_function("run_arm"), "arm")
    assert [(a["width"], a["tenants"], a["horizon"]) for a in res["arms"]] \
        == [(2, 2, 1), (2, 2, 8)]
    for a in res["arms"]:
        assert a["parity_exact"] is True
        assert a["new_tokens"] == 2 * 4
        assert set(a) == arm_keys - ({"h1_tok_per_s", "speedup_vs_h1"}
                                     if a["horizon"] == 1 else set())
    # The small sweep has no 8-tenant arm: the gate fails as the
    # reference's does.
    failures = serving_bench.check_failures(res, 1.5)
    assert (not failures, failures) == _reference_gate()(res, 1.5)


def _arm(width, tenants, horizon, tok, seq, h1=None, parity=True):
    a = {"width": width, "tenants": tenants, "horizon": horizon,
         "tok_per_s": tok, "seq_tok_per_s": seq, "parity_exact": parity}
    if h1 is not None:
        a["h1_tok_per_s"] = h1
        a["speedup_vs_h1"] = tok / h1
    return a


GATE_CASES = {
    "passes": [_arm(8, 8, 1, 100.0, 50.0), _arm(8, 8, 8, 200.0, 50.0, 100.0)],
    "parity_broken": [_arm(8, 8, 1, 100.0, 50.0),
                      _arm(8, 8, 8, 200.0, 50.0, 100.0, parity=False)],
    "not_above_sequential": [_arm(8, 8, 1, 30.0, 50.0),
                             _arm(8, 8, 8, 50.0, 50.0, 30.0)],
    "speedup_short": [_arm(8, 8, 1, 100.0, 50.0),
                      _arm(8, 8, 8, 140.0, 50.0, 100.0)],
    "no_width_8": [_arm(4, 16, 1, 100.0, 50.0),
                   _arm(4, 16, 8, 200.0, 50.0, 100.0)],
    "too_few_tenants": [_arm(8, 4, 1, 100.0, 50.0),
                        _arm(8, 4, 8, 200.0, 50.0, 100.0)],
    "grid": [_arm(w, t, h, 60.0 + w * h, 50.0, None if h == 1 else 60.0 + w)
             for t in (8, 16) for w in (2, 4, 8) for h in (1, 8)],
}


@pytest.mark.parametrize("min_speedup", [1.5, 1.3])
@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_check_gate_is_the_references(case, min_speedup):
    result = {"arms": GATE_CASES[case]}
    failures = serving_bench.check_failures(result, min_speedup)
    assert (not failures, failures) == _reference_gate()(result, min_speedup)
    if case == "passes":
        assert not failures
