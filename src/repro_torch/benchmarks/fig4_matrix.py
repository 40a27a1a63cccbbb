"""Paper Fig. 4: the test-accuracy matrix over every (base block k,
modular block i) composition after training; the twin of
``benchmarks/fig4_matrix.py``.

    python -m repro_torch.benchmarks.fig4_matrix [--rounds 60]
        [--participation k2] [--device cpu]

The claim under test: cross-client compositions are comparable to (and
sometimes better than) local ones. Prints CSV rows of the 4x4 matrix.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.api import ExperimentSpec, PAPER_RESULTS, run_experiment

NAMES = ["A", "B", "C", "D"]


def run(rounds: int = 60, force: bool = False, quiet: bool = False,
        participation: str = "full", *, device=None,
        cache_dir: str = PAPER_RESULTS):
    """The final 4x4 composition matrix of the IFL run on ``device`` (the
    card unless ``'cpu'``), cached under ``cache_dir``."""
    spec = ExperimentSpec(scheme="ifl", rounds=rounds,
                          eval_every=max(1, rounds // 40),
                          participation=participation)
    out = run_experiment(spec, cache_dir=cache_dir, force=force,
                         device=device)
    mat = np.array(out.final["matrix"])
    if not quiet:
        print("base\\modular," + ",".join(f"{n}2" for n in NAMES))
        for k in range(4):
            print(f"{NAMES[k]}1," + ",".join(f"{mat[k, i]:.4f}"
                                             for i in range(4)))
    return mat


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--participation", default="full",
                    help="client schedule (repro_torch.core.rounds), e.g. k2")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where the run trains (default: the card)")
    args = ap.parse_args(argv)
    mat = run(args.rounds, args.force, participation=args.participation,
              device=args.device)
    local = np.diag(mat)
    cross = mat[~np.eye(4, dtype=bool)]
    n_better = int((mat - local[:, None] >= -0.005).sum() - 4)
    print(f"# local mean {local.mean():.3f}, cross mean {cross.mean():.3f}, "
          f"{n_better}/12 cross combos within 0.5pt of (or above) local")


if __name__ == "__main__":
    main()
