"""The twin of ``benchmarks/gen_experiments.py`` on the port: an
EXPERIMENTS.md from the port's own dry-run files and paper runs.

    python -m repro_torch.benchmarks.gen_experiments [--out PATH]
        [--dryrun DIR] [--paper DIR] [--perf PATH]

It reads the dry-run's files (``python -m repro_torch.launch.dryrun``
and the ``perf_probe`` twin, under ``results/torch/dryrun``) and the
paper twins' cached runs (``run_experiment``'s files under
``results/torch/``), and writes ``results/torch/EXPERIMENTS.md`` by
default: never the repo root's EXPERIMENTS.md, and it never reads the
JAX package's ``results/paper/``. The sections are the reference's:
§Paper (Figs. 2-4 from the runs, picked by the reference's rule,
``_paper_runs``), §Dry-run, §Roofline (against one H100 SXM), §IFL vs
FL-equivalent (bytes at the client boundary against a DP step's
gradient all-reduce) and §Perf, which embeds ``PERF.md`` §5-§6, the
port's hand-written log, where the reference embeds
``benchmarks/perf_log.md`` (``--perf`` names another file; where the
file is missing, or has no §5, the section says so in one line).
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

from repro_torch.api import PAPER_RESULTS

ROOT = os.path.join(os.path.dirname(__file__), "..", "..", "..")
DRYRUN = os.path.join("results", "torch", "dryrun")
OUT = os.path.join("results", "torch", "EXPERIMENTS.md")
PERF = os.path.join(ROOT, "PERF.md")

MOVE_HINT = {
    # one sentence per dominant term on what would move it down on one H100
    "compute": "compute-bound: raise arithmetic efficiency (bf16 on the "
               "tensor cores, wgmma tiles in the hand-written kernels, "
               "fewer recomputed group bodies, a lower remat factor).",
    "memory": "memory-bound: cut HBM round-trips (fused epilogues, as the "
              "wire kernels' encode in the projection; chunked losses and "
              "scans whose intermediates stay in shared memory or L2; bf16 "
              "weights instead of fp32 ones cast every call).",
    "collective": "collective-bound: never on one card, which has no "
                  "collective term.",
}


def _load(dryrun_dir, pattern):
    out = []
    for f in sorted(glob.glob(os.path.join(dryrun_dir, pattern))):
        try:
            with open(f) as fh:
                out.append(json.load(fh))
        except Exception:
            pass
    return out


def _paper_runs(rounds: int = 200, paper_dir: str = PAPER_RESULTS):
    """Cached runs per scheme, selected by JSON content, by the
    reference's rule: the given rounds with records, the fp32 codec, full
    participation and the full broadcast, a calibrated-lr run before
    another."""
    runs = {}
    for f in sorted(glob.glob(os.path.join(paper_dir, "*.json"))):
        try:
            with open(f) as fh:
                d = json.load(fh)
        except Exception:
            continue
        if d.get("rounds") != rounds or not d.get("records"):
            continue
        if d.get("codec", "fp32") != "fp32":
            continue
        if d.get("participation", "full") != "full":
            continue
        if d.get("spec", {}).get("broadcast", "full") != "full":
            continue
        s = d.get("scheme")
        spec = d.get("spec", {})
        calibrated = (spec.get("lr", 0.05) != 0.01 if spec
                      else "lr" in os.path.basename(f))
        if s not in runs or (calibrated and not runs[s][0]):
            runs[s] = (calibrated, d["records"])
    return {s: recs for s, (_, recs) in runs.items()}


def paper_section(lines, paper_dir: str = PAPER_RESULTS,
                  rounds: int = 200):
    lines.append("## §Paper — validation against the paper's own claims\n")
    runs = _paper_runs(rounds, paper_dir)
    if "ifl" not in runs:
        lines.append(f"_paper experiments not yet cached — run `python -m "
                     f"repro_torch.benchmarks.run --rounds {rounds}`_\n")
        return
    lines.append(
        f"Setup: N=4 Table II clients, synthetic KMNIST (the offline "
        f"stand-in), Dirichlet α=0.5, τ=10, B=32, SGD, {rounds} rounds, "
        f"each run through the port's `run_experiment`; the calibrated "
        f"η=0.05 is the same for every scheme, as in the reference.\n")
    ifl = runs["ifl"]
    cross = next((r for r in ifl if r["acc_mean"] >= 0.90), None)
    lines.append("**Fig. 2 (communication efficiency).** Paper: IFL hits "
                 "90% at ~8.5 MB uplink; FSL ~64% at that budget; FL "
                 "orders of magnitude more expensive.")

    def acc_at(rs, mb):
        under = [r["acc_mean"] for r in rs if r["uplink_mb"] <= mb]
        return max(under) if under else float("nan")

    if cross:
        budget = cross["uplink_mb"]
        lines.append(
            f"Measured: IFL reaches 90% at **{budget:.1f} MB** uplink "
            f"(round {cross['round']}); at that same budget FSL = "
            f"**{acc_at(runs.get('fsl', []), budget):.1%}**, FL-1 = "
            f"**{acc_at(runs.get('fl1', []), budget):.1%}**, FL-2 = "
            f"**{acc_at(runs.get('fl2', []), budget):.1%}**.")
    else:
        budget = ifl[-1]["uplink_mb"]
        lines.append(
            f"Measured (the 90% level is not reached on the stand-in "
            f"dataset; the comparative ordering is): at IFL's full "
            f"{rounds}-round uplink budget ({budget:.1f} MB), IFL = "
            f"**{ifl[-1]['acc_mean']:.1%}** vs FSL = "
            f"**{acc_at(runs.get('fsl', []), budget):.1%}** at the same "
            f"bytes; FL-1/FL-2 reach "
            f"**{acc_at(runs.get('fl1', []), 1e12):.1%}** / "
            f"**{acc_at(runs.get('fl2', []), 1e12):.1%}** only at "
            f"**{runs.get('fl1', [{}])[-1].get('uplink_mb', 0):.0f} / "
            f"{runs.get('fl2', [{}])[-1].get('uplink_mb', 0):.0f} MB**.")
    lines.append(f"\n| scheme | final acc | uplink MB @{rounds} rounds |")
    lines.append("|---|---|---|")
    for s in ["ifl", "fsl", "fl1", "fl2"]:
        if s in runs:
            r = runs[s][-1]
            lines.append(f"| {s.upper()} | {r['acc_mean']:.3f} | "
                         f"{r['uplink_mb']:.1f} |")
    sds = ifl[-1].get("sd_per_base")
    if sds:
        first_sds = next((r["sd_per_base"] for r in ifl
                          if r.get("sd_per_base")), sds)
        lines.append(
            "\n**Fig. 3 (heterogeneity robustness).** Paper: SD of "
            "accuracy across modular-block pairings < 0.6 points by the "
            "end of training. Measured SD (points, per base block): start "
            + "/".join(f"{x:.1f}" for x in first_sds) + " → final "
            + "/".join(f"{x:.1f}" for x in sds) + ".")
    if ifl[-1].get("matrix") is not None:
        mat = np.array(ifl[-1]["matrix"])
        local = np.diag(mat)
        n_ok = int(((mat - local[:, None]) >= -0.005).sum() - 4)
        lines.append("\n**Fig. 4 (composability).** Accuracy matrix "
                     "base×modular (rows = base block of A1..D1):\n")
        lines.append("| base \\ mod | A2 | B2 | C2 | D2 |")
        lines.append("|---|---|---|---|---|")
        for i, n in enumerate("ABCD"):
            lines.append(f"| {n}1 | " + " | ".join(
                f"{mat[i, j]:.3f}" for j in range(4)) + " |")
        lines.append(
            f"\nLocal mean {local.mean():.3f}, cross mean "
            f"{mat[~np.eye(4, dtype=bool)].mean():.3f}; {n_ok}/12 cross "
            "pairings within 0.5 pt of (or above) the local pairing.")
    lines.append("\n**Table I** — per-round costs: `python -m "
                 "repro_torch.benchmarks.table1_comm_costs`.\n")


def _baseline_rows(dryrun_dir, pattern="*.json"):
    return [r for r in _load(dryrun_dir, pattern)
            if r.get("variant") in (None, "baseline")
            and not r.get("accounting_only") and r.get("step") != "dp"]


def dryrun_section(lines, dryrun_dir: str = DRYRUN):
    lines.append("\n## §Dry-run — meta runs across (arch × shape) on one "
                 "H100\n")
    lines.append("Every row is one eager run of the port's step function "
                 "on meta tensors (`python -m repro_torch.launch.dryrun`): "
                 "no card and no memory behind it. Peak and argument bytes "
                 "are the accounting's live bytes on the one card; there "
                 "is no collective on one card.\n")
    lines.append("| arch | shape | mesh | step | meta run s | peak GB "
                 "| args GB | kernel launches |")
    lines.append("|---|---|---|---|---|---|---|---|")
    rows = _baseline_rows(dryrun_dir)
    for r in rows:
        mem = r["memory"]
        launches = sum(k["launches"] for k in r.get("kernels", {}).values())
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['step']} | "
            f"{r['timing']['run_s']:.1f} | {mem['peak_bytes'] / 1e9:.1f} | "
            f"{(mem['argument_bytes'] or 0) / 1e9:.1f} | {launches} |")
    over = [r for r in rows if (r["memory"].get("peak_bytes") or 0) > 80e9]
    if over:
        lines.append("\nRows with peak > 80 GB (one H100's memory): "
                     + ", ".join(f"{r['arch']}/{r['shape']}" for r in over))
    lines.append(
        "\n**Method note.** FLOPs, bytes and peak live bytes come from a "
        "`TorchDispatchMode` over every aten op and every hand-written "
        "kernel at its own cost (`repro_torch/roofline/accounting.py`, "
        "`kernels/cost.py`); the card's count of the same step equals the "
        "meta count (`chip_smoke.py` phase 4p).\n")


def roofline_section(lines, dryrun_dir: str = DRYRUN):
    lines.append("\n## §Roofline — one H100 SXM (989 TF bf16, 67 TF fp32, "
                 "3.35 TB/s HBM)\n")
    rows = _baseline_rows(dryrun_dir, "*__h100__*.json")
    lines.append("| arch | shape | compute s | memory s | collective s | "
                 "dominant | model TFLOPs | useful ratio | MFU@bound |")
    lines.append("|---|---|---|---|---|---|---|---|---|")
    agg = {}
    for r in rows:
        t = r["roofline"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {t['compute_s']:.3f} | "
            f"{t['memory_s']:.3f} | {t['collective_s']:.3f} | "
            f"**{t['dominant']}** | "
            f"{t.get('model_flops_total', 0) / 1e12:.1f} | "
            f"{t.get('useful_flops_ratio', 0):.2f} | "
            f"{t.get('mfu_bound', 0):.3f} |")
        agg.setdefault(t["dominant"], []).append((r["arch"], r["shape"]))
    lines.append("\nPer-row bottleneck guidance:")
    for dom, hint in MOVE_HINT.items():
        lines.append(f"- **{dom}** ({len(agg.get(dom, []))} rows): {hint}")
    lines.append(
        "\nIFL-specific note: `useful ratio` counts the N× modular-block "
        "redundancy (every client trains on all clients' z) as useful "
        "work, per the algorithm's definition; what the paper's scheme "
        "saves is cross-boundary communication, not FLOPs — see the "
        "IFL-vs-DP table.")


def ifl_vs_dp_section(lines, dryrun_dir: str = DRYRUN):
    from repro_torch.benchmarks import ifl_vs_dp_collectives

    lines.append("\n\n## §IFL vs FL-equivalent (dense DP) — cross-boundary "
                 "traffic at train_4k\n")
    rows = []
    for r in _load(dryrun_dir, "*__train_4k__h100__dp.json"):
        ifl = os.path.join(dryrun_dir,
                           f"{r['arch']}__train_4k__h100__ifl.json")
        if os.path.exists(ifl):
            with open(ifl) as fh:
                rows.append((r["arch"], json.load(fh)))
    if not rows:
        return
    lines.append("On one card neither step has a collective; the bytes a "
                 "fleet of clients would move are analytic: IFL's per-round "
                 "client boundary (the dry-run's `client_boundary`) against "
                 "a DP step's ring all-reduce of the gradients over the same "
                 "clients (`ifl_vs_dp_collectives`).\n")
    lines.append("| arch | IFL boundary MB/round (up + down) | DP "
                 "all-reduce MB/client/step | collective MB on one card |")
    lines.append("|---|---|---|---|")
    for arch, i in rows:
        cb = i["client_boundary"]
        dp = ifl_vs_dp_collectives.run(quiet=True, archs=[arch],
                                       codec=cb["codec"],
                                       n_clients=i["n_clients"])[0]
        b = cb["per_round_bytes"]
        lines.append(f"| {arch} | {(b['up'] + b['down']) / 1e6:.1f} | "
                     f"{dp['dp_allreduce_bytes_per_client'] / 1e6:.0f} | 0 |")


def perf_section(lines, perf: str = PERF):
    lines.append("\n## §Perf — hypothesis → change → measure log\n")
    try:
        with open(perf) as fh:
            text = fh.read()
    except OSError:
        lines.append("_PERF.md not found_")
        return
    start, end = text.find("\n## 5."), text.find("\n## 7.")
    if start < 0:
        lines.append("_PERF.md has no §5_")
        return
    lines.append(text[start + 1:end if end > start else None].rstrip())


def generate(out: str = OUT, *, dryrun_dir: str = DRYRUN,
             paper_dir: str = PAPER_RESULTS, rounds: int = 200,
             perf: str = PERF) -> str:
    lines = ["# EXPERIMENTS (the PyTorch port on one H100)",
             "",
             "Reproduction of *Communication-Efficient and Interoperable "
             "Distributed Learning* (IFL) on the port, with its dry-run, "
             "roofline and perf results. All numbers regenerate via the "
             "commands noted per section.",
             ""]
    paper_section(lines, paper_dir, rounds)
    dryrun_section(lines, dryrun_dir)
    roofline_section(lines, dryrun_dir)
    ifl_vs_dp_section(lines, dryrun_dir)
    perf_section(lines, perf)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {out} ({len(lines)} blocks)")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--dryrun", default=DRYRUN,
                    help="the dry-run's files")
    ap.add_argument("--paper", default=PAPER_RESULTS,
                    help="the paper twins' cached runs")
    ap.add_argument("--perf", default=PERF,
                    help="the hand-written log whose §5-§6 §Perf embeds")
    args = ap.parse_args(argv)
    generate(args.out, dryrun_dir=args.dryrun, paper_dir=args.paper,
             perf=args.perf)


if __name__ == "__main__":
    main()
