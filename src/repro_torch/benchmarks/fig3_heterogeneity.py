"""Paper Fig. 3: the SD of test accuracy of each client's base block
combined with ALL modular blocks, over communication rounds; the twin of
``benchmarks/fig3_heterogeneity.py``.

    python -m repro_torch.benchmarks.fig3_heterogeneity [--rounds 60]
        [--participation k2] [--device cpu]

The claim under test: by the end of training every SD falls below 0.6
accuracy points. Prints CSV: round,sd_A1,sd_B1,sd_C1,sd_D1.
"""

from __future__ import annotations

import argparse

from repro_torch.api import ExperimentSpec, PAPER_RESULTS, run_experiment

LABELS = ["A1-X2", "B1-X2", "C1-X2", "D1-X2"]


def run(rounds: int = 60, force: bool = False, quiet: bool = False,
        participation: str = "full", *, device=None,
        cache_dir: str = PAPER_RESULTS):
    """(round, sd per base block...) rows of the IFL run on ``device``
    (the card unless ``'cpu'``), cached under ``cache_dir``."""
    spec = ExperimentSpec(scheme="ifl", rounds=rounds,
                          eval_every=max(1, rounds // 40),
                          participation=participation)
    out = run_experiment(spec, cache_dir=cache_dir, force=force,
                         device=device)
    rows = [(rec["round"], *rec["sd_per_base"]) for rec in out.records
            if "sd_per_base" in rec]
    if not quiet:
        print("round," + ",".join(f"sd_{l}" for l in LABELS))
        for r in rows:
            print(f"{r[0]}," + ",".join(f"{x:.3f}" for x in r[1:]))
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--participation", default="full",
                    help="client schedule (repro_torch.core.rounds), e.g. k2")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where the run trains (default: the card)")
    args = ap.parse_args(argv)
    rows = run(args.rounds, args.force, participation=args.participation,
               device=args.device)
    final = rows[-1][1:]
    print(f"# final SDs (acc points): {[f'{x:.2f}' for x in final]} "
          f"(paper: all < 0.6 by end of training)")


if __name__ == "__main__":
    main()
