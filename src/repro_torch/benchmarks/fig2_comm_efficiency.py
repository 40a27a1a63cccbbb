"""Paper Fig. 2: test accuracy against cumulative uplink communication
(MB) for IFL (proposed), FSL, FL-1 and FL-2, plus a compressed-IFL
curve; the twin of ``benchmarks/fig2_comm_efficiency.py``.

    python -m repro_torch.benchmarks.fig2_comm_efficiency [--rounds 60]
        [--codec int8] [--participation k2] [--broadcast delta]
        [--mode async [--trace "pareto(1.2,0.5)"] [--tick 1]]
        [--smoke] [--out-json PATH] [--device cpu]

The claim under test: IFL reaches ~90% at a few MB of uplink while FSL
is far lower at the same budget and the FL variants cost orders of
magnitude more. ``--codec`` adds a compressed-IFL run next to the fp32
one; ``--participation`` runs every scheme under a partial-participation
schedule (``repro_torch.core.rounds``); ``--broadcast delta`` switches
the IFL downlink to mirror-sync delta shipping. ``--mode async`` puts
the IFL curves on the event-driven engine
(``repro_torch.core.rounds.AsyncRoundEngine``): vendors upload on
``--trace`` clocks (pareto(1.2,0.5) by default) and the server fuses
every ``--tick`` simulated seconds; FL and FSL keep the barrier.
``--smoke`` shrinks the data and rounds to a seconds-long check of the
axis grid. Prints CSV: scheme,round,uplink_mb,accuracy.
"""

from __future__ import annotations

import argparse
import json
import os

from repro_torch.api import (DataSpec, ExperimentSpec, PAPER_RESULTS,
                             run_experiment)


def run(rounds: int = 60, force: bool = False, quiet: bool = False,
        codec: str = "fp32", participation: str = "full",
        smoke: bool = False, broadcast: str = "full", mode: str = "sync",
        trace: str = "", tick: float = 1.0, *, device=None,
        cache_dir: str = PAPER_RESULTS):
    """Every scheme's eval records as (scheme, round, uplink_mb,
    acc_mean) rows, each run through ``run_experiment`` on ``device``
    (the card unless ``'cpu'``) and cached under ``cache_dir``."""
    if mode == "async" and not trace:
        trace = "pareto(1.2,0.5)"
    rows = []
    schemes = ["ifl", "fsl", "fl1", "fl2"]
    if codec != "fp32":
        schemes.insert(1, f"ifl+{codec}")
    base_spec = ExperimentSpec(
        rounds=rounds, eval_every=max(1, rounds // 40),
        participation=participation,
        **(dict(tau=2, data=DataSpec(n_train=800, n_test=200))
           if smoke else {}),
    )
    for scheme in schemes:
        base, _, cdc = scheme.partition("+")
        # The broadcast and clocking axes exist only for fusion downlinks
        # and the fusion cache; FL/FSL keep the defaults, and with them
        # their spec hashes. Async draws participants from the trace.
        ifl = base.startswith("ifl")
        asy = ifl and mode == "async"
        spec = base_spec.replace(
            scheme=base, codec=cdc or "fp32",
            broadcast=broadcast if ifl else "full",
            mode=mode if ifl else "sync", trace=trace if asy else "",
            tick=tick if asy else 1.0,
            participation="full" if asy else participation)
        out = run_experiment(spec, cache_dir=cache_dir, force=force,
                             device=device)
        for rec in out.records:
            rows.append((scheme, rec["round"], rec["uplink_mb"],
                         rec["acc_mean"]))
    if not quiet:
        print("scheme,round,uplink_mb,accuracy")
        for r in rows:
            print(f"{r[0]},{r[1]},{r[2]:.3f},{r[3]:.4f}")
    return rows


def headline(rows):
    """Accuracy of each scheme at IFL's 90%-crossing uplink budget."""
    ifl = [(mb, a) for s, _, mb, a in rows if s == "ifl"]
    budget = next((mb for mb, a in ifl if a >= 0.90), ifl[-1][0])
    out = {}
    for scheme in sorted({s for s, *_ in rows}):
        pts = [(mb, a) for s, _, mb, a in rows if s == scheme]
        under = [a for mb, a in pts if mb <= budget]
        out[scheme] = max(under) if under else pts[0][1]
    return budget, out


def codec_headline(rows, codec: str):
    """Compressed-IFL against fp32 IFL at equal rounds: the uplink ratio
    and the final accuracy delta."""
    fp32 = {r: (mb, a) for s, r, mb, a in rows if s == "ifl"}
    comp = {r: (mb, a) for s, r, mb, a in rows if s == f"ifl+{codec}"}
    last = max(set(fp32) & set(comp))
    ratio = fp32[last][0] / max(comp[last][0], 1e-12)
    dacc = comp[last][1] - fp32[last][1]
    return last, ratio, dacc


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--codec", default="fp32",
                    help="wire codec for the compressed-IFL curve (fp32 = "
                         "baseline only; ef(<codec>) adds error feedback, "
                         "e.g. ef(int4))")
    ap.add_argument("--participation", default="full",
                    help="client schedule for every scheme: full | k<K> | "
                         "bern<p> | straggle(<frac>,<period>) | zipf(<a>) "
                         "| diurnal(<period>[,<zones>])")
    ap.add_argument("--broadcast", default="full", choices=["full", "delta"],
                    help="downlink policy for the IFL curves")
    ap.add_argument("--mode", default="sync", choices=["sync", "async"],
                    help="round clocking of the IFL curves: sync barrier, "
                         "or async arrival-driven server ticks")
    ap.add_argument("--trace", default="",
                    help="async arrival trace, e.g. pareto(1.2,0.5) (the "
                         "default under --mode async)")
    ap.add_argument("--tick", type=float, default=1.0,
                    help="async server fuse period in simulated seconds")
    ap.add_argument("--smoke", action="store_true",
                    help="seconds-long check: tiny data, few rounds")
    ap.add_argument("--out-json", default="",
                    help="also write the rows and the headline here")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where the runs train (default: the card)")
    ap.add_argument("--cache-dir", default=PAPER_RESULTS,
                    help="where the runs are cached (default: "
                         "results/torch/)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.rounds = min(args.rounds, 4)
        args.force = True  # never serve a smoke run from the full cache
    rows = run(args.rounds, args.force, codec=args.codec,
               participation=args.participation, smoke=args.smoke,
               broadcast=args.broadcast, mode=args.mode, trace=args.trace,
               tick=args.tick, device=args.device,
               cache_dir=args.cache_dir)
    budget, hl = headline(rows)
    print(f"# at IFL-90% uplink budget {budget:.2f} MB: {hl}")
    if args.codec != "fp32":
        last, ratio, dacc = codec_headline(rows, args.codec)
        print(f"# ifl+{args.codec} @ round {last}: {ratio:.2f}x lower "
              f"cumulative uplink than fp32 IFL, "
              f"final acc delta {dacc*100:+.2f} pts")
    if args.out_json:
        os.makedirs(os.path.dirname(args.out_json) or ".", exist_ok=True)
        with open(args.out_json, "w") as f:
            json.dump({
                "axes": {"codec": args.codec, "broadcast": args.broadcast,
                         "mode": args.mode, "trace": args.trace,
                         "tick": args.tick,
                         "participation": args.participation,
                         "rounds": args.rounds, "smoke": args.smoke},
                "rows": [list(r) for r in rows],
                "ifl90_budget_mb": budget,
                "acc_at_budget": hl,
            }, f, indent=1)
        print(f"# wrote {args.out_json}")


if __name__ == "__main__":
    main()
