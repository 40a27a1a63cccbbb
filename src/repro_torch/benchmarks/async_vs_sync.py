"""Sync barrier against async event-driven IFL at matched cumulative
uplink; the twin of ``benchmarks/async_vs_sync.py``.

    python -m repro_torch.benchmarks.async_vs_sync [--smoke] [--check]
        [--trace "pareto(1.2,0.5)"] [--tick 1] [--device cpu]

On a heavy-tailed arrival trace a synchronous round waits for the
slowest scheduled client's next arrival, while the async engine fuses
whatever arrived each fixed tick. Both arms share one trace and seed:

  sync  — the barriered ``run_experiment``; its wall-clock is priced by
          ``simulate_sync_wall_clock`` (a round lasts until the last
          scheduled participant's next arrival).
  async — ``ExperimentSpec(mode='async', trace=...)`` run tick by tick
          until its ledger has absorbed at least the sync arm's
          cumulative uplink; its wall-clock is ticks x tick.

Every async tick's ledger is held to ``ifl_round_bytes`` exactly.
``--check`` exits non-zero unless (a) async's final accuracy is within 2
points of sync's at matched uplink, (b) async takes strictly less
simulated wall-clock per accuracy point and (c) the byte parity is
exact. The result (the reference's JSON keys) goes to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from repro_torch.api import (DataSpec, ExperimentSpec, build_trainer,
                             load_data, run_experiment)
from repro_torch.core import ifl_round_bytes
from repro_torch.core.rounds import simulate_sync_wall_clock


def _spec(args, **overrides) -> ExperimentSpec:
    base = dict(
        scheme="ifl", rounds=args.rounds, tau=args.tau, lr=0.05,
        codec=args.codec, broadcast=args.broadcast, seed=args.seed,
        eval_every=args.eval_every,
        data=DataSpec(n_train=args.n_train, n_test=args.n_test),
    )
    base.update(overrides)
    return ExperimentSpec(**base)


def check_parity(trainer, spec, reports) -> bool:
    """Exact analytic == ledger bytes, every async tick."""
    n = spec.fleet.population
    for i, rep in enumerate(reports):
        exp = ifl_round_bytes(
            n, spec.batch_size, spec.d_fusion, codec=spec.codec,
            participating=len(rep["participants"]),
            broadcast_entries=rep["cache_size"],
            broadcast=spec.broadcast,
            delta_entries=rep.get("shipped_entries"))
        got = trainer.ledger.per_round[i]
        if got["up"] != exp["up"] or got["down"] != exp["down"]:
            print(f"  PARITY MISMATCH tick {i}: ledger {got} != "
                  f"analytic {exp}")
            return False
    return True


def run(args):
    # ---------------------------------------------------------- sync arm
    sync_spec = _spec(args, mode="sync", participation="full")
    sync_res = run_experiment(sync_spec, device=args.device)
    sync_acc = sync_res.records[-1]["acc_mean"]
    sync_uplink = sync_res.uplink_mb
    # The barrier's clock, from the same trace the async arm trains on.
    durations = simulate_sync_wall_clock(
        args.trace, sync_spec.fleet.n_clients, args.rounds, seed=args.seed)
    sync_clock = sum(durations)
    print(f"sync : {args.rounds} rounds, uplink {sync_uplink:.3f} MB, "
          f"final acc {sync_acc:.4f}, simulated wall-clock "
          f"{sync_clock:.1f}s (worst round {max(durations):.1f}s)")

    # --------------------------------------------------------- async arm
    # Tick by tick until the ledger has absorbed the sync arm's uplink,
    # capped so that a sparse trace cannot spin forever.
    async_spec = _spec(args, mode="async", trace=args.trace, tick=args.tick,
                       participation="full", rounds=args.rounds)
    trainer = build_trainer(async_spec, device=args.device)
    data = load_data(async_spec)
    max_ticks = args.max_ticks or 50 * args.rounds
    reports, curve = [], []
    while trainer.ledger.uplink_mb < sync_uplink and \
            len(reports) < max_ticks:
        rep = trainer.run_round()
        reports.append(rep)
        if len(reports) % max(args.eval_every, 1) == 0:
            acc = float(np.mean(trainer.evaluate(data.test_x, data.test_y)))
            curve.append({"tick": len(reports), "sim_time": rep["sim_time"],
                          "uplink_mb": trainer.ledger.uplink_mb,
                          "acc_mean": acc})
    async_acc = float(np.mean(trainer.evaluate(data.test_x, data.test_y)))
    eng = trainer.engine
    async_clock = eng.sim_time
    ups = eng.total_uploads / max(async_clock, 1e-12)
    matched = trainer.ledger.uplink_mb >= sync_uplink
    print(f"async: {len(reports)} ticks, uplink "
          f"{trainer.ledger.uplink_mb:.3f} MB "
          f"({'matched' if matched else 'NOT matched'}), "
          f"final acc {async_acc:.4f}, simulated wall-clock "
          f"{async_clock:.1f}s, {ups:.2f} uploads/sec absorbed "
          f"({eng.total_arrivals} raw arrivals)")

    parity = check_parity(trainer, async_spec, reports)
    print(f"async analytic<->ledger byte parity: "
          f"{'exact' if parity else 'BROKEN'}")

    # Simulated seconds paid per accuracy point.
    sync_wpa = sync_clock / max(sync_acc, 1e-12)
    async_wpa = async_clock / max(async_acc, 1e-12)
    print(f"wall-clock per accuracy point: sync {sync_wpa:.1f}s, "
          f"async {async_wpa:.1f}s "
          f"({sync_wpa / max(async_wpa, 1e-12):.1f}x reduction)")

    result = {
        "trace": args.trace, "tick": args.tick, "codec": args.codec,
        "broadcast": args.broadcast, "rounds": args.rounds,
        "seed": args.seed, "smoke": args.smoke,
        "sync": {"rounds": args.rounds, "uplink_mb": sync_uplink,
                 "final_acc": sync_acc, "wall_clock_s": sync_clock,
                 "round_durations_s": durations,
                 "records": sync_res.records},
        "async": {"ticks": len(reports),
                  "uplink_mb": trainer.ledger.uplink_mb,
                  "final_acc": async_acc, "wall_clock_s": async_clock,
                  "uploads_per_sec": ups,
                  "total_uploads": eng.total_uploads,
                  "total_arrivals": eng.total_arrivals,
                  "matched_uplink": matched, "curve": curve},
        "parity_exact": parity,
        "acc_delta_pts": (async_acc - sync_acc) * 100,
        "wall_clock_per_acc": {"sync": sync_wpa, "async": async_wpa},
    }
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {args.out}")

    if args.check:
        failures = []
        if not matched:
            failures.append("async never matched the sync uplink budget "
                            f"within {max_ticks} ticks")
        if async_acc < sync_acc - 0.02:
            failures.append(f"async acc {async_acc:.4f} more than 2 pts "
                            f"below sync {sync_acc:.4f} at matched uplink")
        if not async_wpa < sync_wpa:
            failures.append(f"async wall-clock/acc {async_wpa:.1f}s not "
                            f"strictly below sync {sync_wpa:.1f}s")
        if not parity:
            failures.append("async analytic<->ledger byte parity broken")
        if failures:
            for msg in failures:
                print(f"CHECK FAILED: {msg}")
            raise SystemExit(1)
        print("all async-vs-sync acceptance checks passed")
    return result


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace", default="pareto(1.2,0.5)",
                    help="heavy-tail arrival trace shared by both arms "
                         "(repro_torch.core.rounds.parse_trace)")
    ap.add_argument("--tick", type=float, default=1.0)
    ap.add_argument("--rounds", type=int, default=40,
                    help="sync rounds (async runs until uplink matches)")
    ap.add_argument("--tau", type=int, default=10)
    ap.add_argument("--codec", default="int8")
    ap.add_argument("--broadcast", default="delta", choices=["full", "delta"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--n-train", type=int, default=6000)
    ap.add_argument("--n-test", type=int, default=1500)
    ap.add_argument("--max-ticks", type=int, default=0,
                    help="async tick cap (0 = 50x rounds)")
    ap.add_argument("--smoke", action="store_true",
                    help="seconds-long mode: tiny data, few rounds")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero unless the acceptance criteria hold")
    ap.add_argument("--out", default="results/torch/BENCH_async_vs_sync.json")
    ap.add_argument("--device", default=None,
                    help="where the runs train (default: the card)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.rounds = min(args.rounds, 8)
        args.tau = min(args.tau, 2)
        args.n_train, args.n_test = 800, 200
        args.eval_every = 2
    return args


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
