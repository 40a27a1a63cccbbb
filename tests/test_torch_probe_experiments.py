"""The twins of ``benchmarks/perf_probe.py`` and
``benchmarks/gen_experiments.py`` on the CPU: the probes are the
reference's that act on one card, a probe runs on meta tensors and
writes its variant beside the baseline, ``_paper_runs`` picks the
reference's runs from one set of files, and EXPERIMENTS.md has the
reference's five sections."""

import ast
import contextlib
import importlib.util
import io
import json
import shutil
from pathlib import Path

import pytest

from _port_parity import one_torch_thread  # noqa: F401 (autouse)
from repro_torch.benchmarks import gen_experiments, perf_probe
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]
ROW = ("qwen1.5-0.5b", "train_4k", "dp")
LEFT_OUT = {"no_fsdp", "embed_dshard", "ce_chunk_embed"}
SECTIONS = ["## §Paper", "## §Dry-run", "## §Roofline",
            "## §IFL vs FL-equivalent", "## §Perf"]


def _reference_probes():
    """The reference's PROBES, read from its source (importing it would
    set a 512-device XLA flag)."""
    tree = ast.parse((ROOT / "benchmarks" / "perf_probe.py").read_text())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", "") == "PROBES"):
            return ast.literal_eval(node.value)
    raise AssertionError("no PROBES in the reference")


def test_probes_are_the_references_that_act_on_one_card():
    ref = _reference_probes()
    assert set(perf_probe.PROBES) == set(ref) - LEFT_OUT
    for name, spec in perf_probe.PROBES.items():
        assert spec == ref[name], name
    # The three left out act on the TPU mesh's sharding, and the module
    # says so.
    for name in LEFT_OUT:
        assert "fsdp" in ref[name] or "REPRO_EMBED_SHARD" in ref[name].get(
            "env", {}), name
        assert f"``{name}``" in perf_probe.__doc__


@pytest.fixture(scope="module")
def probe_dir(tmp_path_factory):
    """The baseline row on meta, the perf_probe CLI's ce_chunk probe
    beside it (its printed table kept), and a prefill row."""
    out = tmp_path_factory.mktemp("dryrun")
    arch, shape, step = ROW
    dryrun.run_one(arch, shape, step_kind=step, n_clients=4, tau=2,
                   variant="", out_dir=str(out), force=True)
    dryrun.run_one(arch, "prefill_32k", step_kind="ifl", n_clients=4, tau=2,
                   variant="", out_dir=str(out), force=True)
    table = io.StringIO()
    with contextlib.redirect_stdout(table):
        perf_probe.main(["--arch", arch, "--shape", shape, "--step", step,
                         "--probe", "ce_chunk", "--out", str(out)])
    return out, table.getvalue()


def test_a_probe_on_meta_writes_its_variant_beside_the_baseline(probe_dir):
    out, table = probe_dir
    base = f"{'__'.join(ROW[:2])}__h100__{ROW[2]}"
    assert (out / f"{base}.json").exists()
    probe = json.loads((out / f"{base}__ce_chunk.json").read_text())
    baseline = json.loads((out / f"{base}.json").read_text())
    assert probe["variant"] == "ce_chunk" and probe["device"] == "meta"
    assert baseline["variant"] == "baseline"
    # The chunked loss never holds the full logits: less temp memory.
    assert probe["memory"]["temp_bytes"] < baseline["memory"]["temp_bytes"]
    lines = table.strip().splitlines()
    assert lines[-3].split() == ["variant", "compute_s", "memory_s",
                                 "coll_s", "temp_GB", "coll_MB"]
    for line, (name, row) in zip(lines[-2:], (("baseline", baseline),
                                              ("ce_chunk", probe))):
        cells = line.split()
        assert cells[0] == name
        assert float(cells[1]) == pytest.approx(
            row["roofline"]["compute_s"], abs=5e-4)
        assert float(cells[2]) == pytest.approx(
            row["roofline"]["memory_s"], abs=5e-4)
        assert float(cells[3]) == 0 and float(cells[5]) == 0
        assert float(cells[4]) == pytest.approx(
            row["memory"]["temp_bytes"] / 1e9, abs=0.05)


def _reference_gen_experiments():
    path = ROOT / "benchmarks" / "gen_experiments.py"
    spec = importlib.util.spec_from_file_location("_ref_gen_exp", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def paper_files(tmp_path_factory):
    """The JAX package's cached runs, both generations of names, and
    runs each rule of the selection turns away or prefers."""
    d = tmp_path_factory.mktemp("paper")
    for f in (ROOT / "results" / "paper").glob("*.json"):
        shutil.copy(f, d / f.name)
    rec = json.loads((d / "ifl_r20_n20000_tau10_s0_lr0.05.json").read_text())
    variants = {
        "ifl_000000000001.json": {"spec": {"lr": 0.01}},      # uncalibrated
        "fsl_000000000002.json": {"spec": {"broadcast": "delta"}},
        "fl1_000000000003.json": {"codec": "int4"},
        "fl2_000000000004.json": {"participation": "k2"},
        "fl2_000000000005.json": {"records": []},
        "fsl_000000000006.json": {"spec": {"lr": 0.05}, "scheme": "fsl"},
        "fl1_r20_n20000_tau10_s0.json": {"scheme": "fl1"},   # no lr: legacy
    }
    for name, change in variants.items():
        (d / name).write_text(json.dumps({**rec, **change}))
    (d / "broken.json").write_text("{not json")
    return d


@pytest.mark.parametrize("rounds", [4, 20, 200])
def test_paper_runs_select_the_references_runs(paper_files, rounds,
                                               monkeypatch):
    ref = _reference_gen_experiments()
    monkeypatch.setattr(ref, "PAPER", str(paper_files))
    want = ref._paper_runs(rounds)
    assert gen_experiments._paper_runs(rounds, str(paper_files)) == want
    if rounds != 200:
        assert set(want) == {"ifl", "fsl", "fl1", "fl2"}


def test_experiments_md_has_the_five_sections(probe_dir, paper_files,
                                              tmp_path):
    out, _ = probe_dir
    log = tmp_path / "PERF.md"
    log.write_text("# PERF\n\n## 4. Cells\n\ncells\n\n## 5. Where the "
                   "time goes\n\nbreakdown\n\n## 6. Findings\n\nfound\n\n"
                   "## 7. Open questions\n\nopen\n")
    path = gen_experiments.generate(
        str(tmp_path / "EXPERIMENTS.md"), dryrun_dir=str(out),
        paper_dir=str(paper_files), rounds=20, perf=str(log))
    text = Path(path).read_text()
    at = [text.index(h) for h in SECTIONS]
    assert at == sorted(at)
    paper = text[at[0]:at[1]]
    assert "| IFL |" in paper and "| FL1 |" in paper and "Fig. 4" in paper
    # The prefill row; the DP rows stay out of both tables, as in the
    # reference.
    for a, b in ((at[1], at[2]), (at[2], at[3])):
        assert "| qwen1.5-0.5b | prefill_32k |" in text[a:b]
        assert "train_4k" not in text[a:b]
    perf = text[at[4]:]
    assert perf.endswith("## 5. Where the time goes\n\nbreakdown\n\n"
                         "## 6. Findings\n\nfound\n")
    assert "## 4." not in perf and "## 7." not in perf
    # A checkout without the log still writes every section.
    path = gen_experiments.generate(
        str(tmp_path / "EXPERIMENTS.md"), dryrun_dir=str(out),
        paper_dir=str(paper_files), rounds=20,
        perf=str(tmp_path / "absent.md"))
    text = Path(path).read_text()
    assert all(h in text for h in SECTIONS)
    assert text.endswith("## §Perf — hypothesis → change → measure log\n\n"
                         "_PERF.md not found_\n")
    assert Path(gen_experiments.PERF).resolve() == ROOT / "PERF.md"
    assert gen_experiments.OUT == "results/torch/EXPERIMENTS.md"
    assert not (ROOT / "EXPERIMENTS.md").exists()
