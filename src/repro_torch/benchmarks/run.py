"""The paper's benchmark suite on the port, the twin of
``benchmarks/run.py``: Table I, then Figs. 2-4.

    python -m repro_torch.benchmarks.run [--rounds N] [--skip-training]
        [--device cpu]

Every training run goes through ``repro_torch.api.run_experiment`` and
is cached under ``results/torch/`` by its spec hash. Then the twins of
the reference's kernel, roofline and collectives reports:
``kernel_bench`` (``cost.py``'s rows, and on the card the kernels
timed; ``--device cpu`` gives the rows alone), ``roofline_report`` (the
files of ``python -m repro_torch.launch.dryrun`` under
``results/torch/dryrun``, and the wire table) and
``ifl_vs_dp_collectives`` (analytic bytes).

Three twins run only when called: ``perf_probe`` (a dry-run row's terms
over config variants), ``gen_experiments`` (``results/torch/
EXPERIMENTS.md`` from the dry-run's files and these runs) and
``serving_bench`` (the serving sweep and its ``--check`` gate), as the
reference's ``run.py`` runs neither ``perf_probe`` nor
``serving_bench``.
"""

from __future__ import annotations

import argparse
import time

from repro_torch.benchmarks import (
    fig2_comm_efficiency,
    fig3_heterogeneity,
    fig4_matrix,
    ifl_vs_dp_collectives,
    kernel_bench,
    roofline_report,
    table1_comm_costs,
)


def _section(title):
    print(f"\n### {title}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=40,
                    help="communication rounds of the paper experiments "
                         "(the paper runs 200)")
    ap.add_argument("--skip-training", action="store_true",
                    help="only the analytic Table I")
    ap.add_argument("--codec", default="fp32",
                    help="wire codec for a compressed-IFL Fig.-2 curve "
                         "(fp32 = baseline only), e.g. ef(int4)")
    ap.add_argument("--participation", default="full",
                    help="client schedule of the paper experiments, e.g. k2")
    ap.add_argument("--broadcast", default="full", choices=["full", "delta"],
                    help="downlink policy of the IFL curves")
    ap.add_argument("--device", default=None,
                    help="where the runs train (default: the card)")
    args = ap.parse_args(argv)
    t0 = time.time()

    _section("table1_comm_costs (paper Table I)")
    table1_comm_costs.run(device=args.device)

    if not args.skip_training:
        _section(f"fig2_comm_efficiency (paper Fig. 2, rounds={args.rounds})")
        rows = fig2_comm_efficiency.run(args.rounds, codec=args.codec,
                                        participation=args.participation,
                                        broadcast=args.broadcast,
                                        device=args.device)
        budget, hl = fig2_comm_efficiency.headline(rows)
        print(f"# at IFL-90% uplink budget {budget:.2f} MB: "
              + ", ".join(f"{k}={v:.3f}" for k, v in hl.items()))
        if args.codec != "fp32":
            last, ratio, dacc = fig2_comm_efficiency.codec_headline(
                rows, args.codec)
            print(f"# ifl+{args.codec} @ round {last}: {ratio:.2f}x lower "
                  f"uplink, acc delta {dacc*100:+.2f} pts")

        _section("fig3_heterogeneity (paper Fig. 3)")
        r3 = fig3_heterogeneity.run(args.rounds,
                                    participation=args.participation,
                                    device=args.device)
        print(f"# final SDs: {[f'{x:.2f}' for x in r3[-1][1:]]}")

        _section("fig4_matrix (paper Fig. 4)")
        fig4_matrix.run(args.rounds, participation=args.participation,
                        device=args.device)

    _section("kernel_bench")
    kernel_bench.main(["--device", "cpu" if args.device == "cpu"
                       else "cuda"])
    _section("roofline_report")
    roofline_report.run()
    _section("ifl_vs_dp_collectives")
    ifl_vs_dp_collectives.run(codec=args.codec)

    print(f"\n# benchmarks done in {time.time() - t0:.0f}s")


if __name__ == "__main__":
    main()
