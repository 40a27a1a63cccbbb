"""Fleet scale-out: cohort-shaped rounds at N >> C; the twin of
``benchmarks/fleet_scale.py``.

    python -m repro_torch.benchmarks.fleet_scale [--smoke | --nightly]
        [--check] [--device cpu]

The claim: with a C-of-N cohort a round, every per-round cost (wall,
uplink and downlink bytes, live server state) scales in the cohort width
C and is flat in the fleet size N. The sweep runs the eager IFL trainer
on synthetic-KMNIST population fleets (``FleetSpec(n_population=N,
cohort=C)``) for each N at a fixed C, then one arm at C/2 on the largest
N:

  bytes   — per-round ledger bytes equal across N at a fixed C (full
            participation, so K == C every round), the uplink linear and
            the full-broadcast downlink quadratic in C; ledger ==
            ``ifl_round_bytes`` every round of every arm.
  clock   — mean round wall (round 0, the warm-up, left out) flat in N:
            the largest fleet's over the smallest's under ``--time-tol``.
  memory  — live server slots (cache entries, EF residuals, upload
            stamps, delta mirrors) at most C * (max_staleness + 2).

``--check`` exits non-zero unless all three hold. The result (the
reference's JSON keys) goes to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch.api import DataSpec, ExperimentSpec, FleetSpec, build_trainer
from repro_torch.core import ifl_round_bytes


def _spec(args, n: int, cohort: int) -> ExperimentSpec:
    return ExperimentSpec(
        scheme="ifl", rounds=args.rounds, tau=args.tau, lr=0.05,
        codec=args.codec, broadcast=args.broadcast, seed=args.seed,
        participation="full", max_staleness=args.max_staleness,
        eval_every=0,
        data=DataSpec(n_train=args.n_train, n_test=args.n_test),
        fleet=FleetSpec(n_population=n, cohort=cohort),
    )


def live_server_slots(trainer) -> int:
    """Live per-slot state on the server, in slots: what the staleness
    window must bound at N >> C."""
    ex = trainer.exchange
    mirror_slots = sum(1 for v in ex.mirrors.versions if v)
    return max(len(ex.cache._entries), len(ex.ef_state),
               len(ex._last_upload), mirror_slots)


def run_arm(args, n: int, cohort: int):
    spec = _spec(args, n, cohort)
    trainer = build_trainer(spec, device=args.device)
    sync = (torch.cuda.synchronize if trainer.device.type == "cuda"
            else lambda: None)
    rounds, parity = [], True
    for r in range(args.rounds):
        sync()
        t0 = time.perf_counter()
        rep = trainer.run_round()
        sync()
        dt = time.perf_counter() - t0
        got = trainer.ledger.per_round[r]
        exp = ifl_round_bytes(
            n, spec.batch_size, spec.d_fusion, codec=spec.codec,
            participating=len(rep["participants"]),
            broadcast_entries=rep["cache_size"],
            broadcast=spec.broadcast,
            delta_entries=rep.get("shipped_entries"))
        if got["up"] != exp["up"] or got["down"] != exp["down"]:
            print(f"  PARITY MISMATCH N={n} C={cohort} round {r}: "
                  f"ledger {got} != analytic {exp}")
            parity = False
        rounds.append({
            "round": r, "wall_s": dt,
            "participants": len(rep["participants"]),
            "up_bytes": got["up"], "down_bytes": got["down"],
            "live_server_slots": live_server_slots(trainer),
        })
    timed = rounds[1:] or rounds  # round 0 pays the first-touch costs
    arm = {
        "n_population": n, "cohort": cohort,
        "mean_round_s": float(np.mean([r["wall_s"] for r in timed])),
        "up_bytes_per_round": rounds[-1]["up_bytes"],
        "down_bytes_per_round": rounds[-1]["down_bytes"],
        "max_live_server_slots": max(r["live_server_slots"]
                                     for r in rounds),
        "materialized_clients": len(trainer.clients.materialized),
        "parity_exact": parity,
        "rounds": rounds,
    }
    print(f"N={n:>6} C={cohort:>4}: {arm['mean_round_s']*1e3:8.1f} ms/round, "
          f"up {arm['up_bytes_per_round']/1e6:.3f} MB, "
          f"down {arm['down_bytes_per_round']/1e6:.3f} MB, "
          f"server slots <= {arm['max_live_server_slots']}, "
          f"clients touched {arm['materialized_clients']}/{n}, "
          f"parity {'exact' if parity else 'BROKEN'}")
    return arm


def run(args):
    ns = sorted(args.ns)
    print(f"fleet scale sweep: N in {ns} at C={args.cohort}, "
          f"{args.rounds} rounds, codec {args.codec}, "
          f"broadcast {args.broadcast}, "
          f"max_staleness {args.max_staleness}")
    arms = [run_arm(args, n, args.cohort) for n in ns]
    # One narrower arm on the biggest fleet: the costs scale in C.
    c_half = max(2, args.cohort // 2)
    half = run_arm(args, ns[-1], c_half) if c_half < args.cohort else None

    result = {
        "ns": ns, "cohort": args.cohort, "rounds": args.rounds,
        "codec": args.codec, "broadcast": args.broadcast,
        "max_staleness": args.max_staleness, "seed": args.seed,
        "smoke": args.smoke, "arms": arms, "half_cohort_arm": half,
    }
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {args.out}")

    if args.check:
        failures = []
        if not all(a["parity_exact"] for a in arms + [half] if a):
            failures.append("analytic<->ledger byte parity broken")
        base = arms[0]
        for a in arms[1:]:
            if (a["up_bytes_per_round"] != base["up_bytes_per_round"] or
                    a["down_bytes_per_round"] !=
                    base["down_bytes_per_round"]):
                failures.append(
                    f"bytes not flat in N: N={a['n_population']} rounds "
                    f"cost {a['up_bytes_per_round']}/"
                    f"{a['down_bytes_per_round']} B vs "
                    f"N={base['n_population']}'s "
                    f"{base['up_bytes_per_round']}/"
                    f"{base['down_bytes_per_round']} B at the same C")
            ratio = a["mean_round_s"] / max(base["mean_round_s"], 1e-9)
            if ratio > args.time_tol:
                failures.append(
                    f"wall-clock not flat in N: {ratio:.2f}x slower at "
                    f"N={a['n_population']} than N={base['n_population']} "
                    f"(tolerance {args.time_tol}x)")
        bound = args.cohort * ((args.max_staleness or 0) + 2)
        for a in arms:
            if a["max_live_server_slots"] > bound:
                failures.append(
                    f"server memory unbounded: {a['max_live_server_slots']}"
                    f" live slots at N={a['n_population']} exceeds "
                    f"C*(max_staleness+2) = {bound}")
        if half is not None:
            big = arms[-1]
            cr = args.cohort // c_half
            if half["up_bytes_per_round"] * cr != big["up_bytes_per_round"]:
                failures.append(
                    f"uplink not linear in C: C={args.cohort} pays "
                    f"{big['up_bytes_per_round']} B, C={c_half} pays "
                    f"{half['up_bytes_per_round']} B")
            if (args.broadcast == "full" and
                    half["down_bytes_per_round"] * cr * cr !=
                    big["down_bytes_per_round"]):
                failures.append(
                    f"full-broadcast downlink not quadratic in C: "
                    f"C={args.cohort} pays {big['down_bytes_per_round']} "
                    f"B, C={c_half} pays {half['down_bytes_per_round']} B")
        if failures:
            for msg in failures:
                print(f"CHECK FAILED: {msg}")
            raise SystemExit(1)
        print("all fleet-scale acceptance checks passed")
    return result


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ns", type=int, nargs="+", default=[1000, 10000],
                    help="fleet sizes N to sweep at a fixed cohort")
    ap.add_argument("--cohort", type=int, default=256,
                    help="cohort width C (the headline regime is N=10^4, "
                         "C=256)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--tau", type=int, default=1)
    ap.add_argument("--codec", default="int8")
    ap.add_argument("--broadcast", default="full", choices=["full", "delta"])
    ap.add_argument("--max-staleness", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-train", type=int, default=4096)
    ap.add_argument("--n-test", type=int, default=256)
    ap.add_argument("--time-tol", type=float, default=2.0,
                    help="largest allowed slowdown of the largest N over "
                         "the smallest")
    ap.add_argument("--smoke", action="store_true",
                    help="seconds-long mode: tiny fleets and cohort")
    ap.add_argument("--nightly", action="store_true",
                    help="the 10^4-client sweep at a cohort of 32")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero unless bytes and wall are flat in "
                         "N, scale in C, parity is exact and server memory "
                         "is staleness-bounded")
    ap.add_argument("--out", default="results/torch/BENCH_fleet_scale.json")
    ap.add_argument("--device", default=None,
                    help="where the runs train (default: the card)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.ns = [64, 256]
        args.cohort = 8
        args.rounds = 3
        args.n_train, args.n_test = 512, 128
    elif args.nightly:
        # The eager modular phase is O(C^2) steps: keep the 10^4-client
        # fleet and cut the cohort; the claims do not depend on C.
        args.ns = [1000, 10000]
        args.cohort = 32
        args.rounds = 3
    return args


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
