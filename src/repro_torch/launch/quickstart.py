"""Quickstart of the port: collaborative IFL training (the paper's
Algorithm 1), end to end through the front door, the twin of
``examples/quickstart.py``.

Four vendors with the paper's Table-II architectures train on non-IID
synthetic KMNIST while exchanging only fusion-layer outputs through the
chosen wire codec, then compose each other's modular blocks (eq. 11).
The whole run is one ``run_experiment(spec, keep_trainer=True,
on_record=...)``:

  PYTHONPATH=src python -m repro_torch.launch.quickstart              # the card
  PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu
  PYTHONPATH=src python -m repro_torch.launch.quickstart --codec "ef(int4)" \
      --participation k2 --max-staleness 2 --broadcast delta --rounds 10

``--broadcast delta`` has the vendors mirror the server cache, so each
entry ships at most once a round: the same training, fewer downlink
bytes. ``--mode async`` retires the round barrier: vendors upload on
``--trace`` clocks (periodic(<T>) | poisson(<rate>) |
pareto(<alpha>,<scale>) | replay:<path>; pareto(1.2,0.5) by default) and
the server fuses what arrived every ``--tick`` simulated seconds.
``--n-population N --cohort C`` runs a fleet of N vendors (built on first
touch) of which C train a round; bytes follow C, not N:

  PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu \
      --mode async --trace "pareto(1.2,0.5)" --codec "ef(int4)" \
      --broadcast delta
  PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu \
      --n-population 1000 --cohort 8 --max-staleness 4 --codec "ef(int4)"

``--scheme`` swaps the whole algorithm (ifl | fsl | fl1 | fl2 |
ifl_spmd): the baselines are a flag, not a fork. ``ifl_spmd`` trains the
smoke LM (``repro_torch.api.spmd``) on synthetic tokens, with d_fusion
32, as the JAX package's quickstart does; ``--model <arch>`` trains that
arch's reduced config instead (the smoke config's head dim is 24, which
the card's attention kernels run zero-padded to 32):

  PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu \
      --scheme ifl_spmd --codec "ef(int4)" --participation k2
  PYTHONPATH=src python -m repro_torch.launch.quickstart \
      --scheme ifl_spmd --model qwen1.5-0.5b --codec "ef(int4)"

Every eval round (each 5th and the last) prints the losses, the
participants, the cumulative ledger MB and the accuracies; at the end it
prints, for the IFL schemes, whether every round's measured bytes equal
the analytic ``ifl_round_bytes``, an async run's uploads a simulated second, and the
cross-vendor composition matrix (a population fleet skips it). It runs
on the card unless ``--device cpu``, and raises where there is no CUDA.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.api import DataSpec, ExperimentSpec, FleetSpec, run_experiment
from repro_torch.core.comm import ifl_round_bytes
from repro_torch.device import resolve_device


def round_bytes_match(trainer, spec: ExperimentSpec) -> bool:
    """Every closed round's ledger bytes == the analytic formula at that
    round's participants, cache size and (under delta) shipped entries.
    An LM trainer's entry is a client's Bc x S fusion rows."""
    rows = spec.batch_size * getattr(trainer, "seq", 1)
    for rep, got in zip(trainer.engine.history, trainer.ledger.per_round):
        exp = ifl_round_bytes(spec.fleet.population, rows,
                              spec.d_fusion, codec=spec.codec,
                              participating=len(rep.participants),
                              broadcast_entries=rep["cache_size"],
                              broadcast=spec.broadcast,
                              delta_entries=rep.metrics.get(
                                  "shipped_entries"))
        if got != exp:
            return False
    return True


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scheme", default="ifl",
                    choices=["ifl", "fsl", "fl1", "fl2", "ifl_spmd"],
                    help="the algorithm: IFL, a baseline, or IFL on an LM")
    ap.add_argument("--model", default="",
                    help="ifl_spmd's LM: a named arch, run reduced() "
                         "(default: the smoke config)")
    ap.add_argument("--codec", default="fp32",
                    help="fusion-payload wire codec: fp32 | bf16 | fp16 | "
                         "int8 | int8_channel | int8_row | int4 | topk<r> | "
                         "sketch<r> | ef(<codec>)")
    ap.add_argument("--participation", default="full",
                    help="full | k<K> | bern<p> | straggle(<frac>,<period>)")
    ap.add_argument("--max-staleness", type=int, default=None,
                    help="fusion-cache staleness bound in rounds "
                         "(default: never evict)")
    ap.add_argument("--broadcast", default="full", choices=["full", "delta"],
                    help="downlink policy: the full cache to every "
                         "participant, or delta mirror-sync (each entry "
                         "ships once a round)")
    ap.add_argument("--mode", default="sync", choices=["sync", "async"],
                    help="round clocking: sync barrier, or async "
                         "arrival-driven server ticks")
    ap.add_argument("--trace", default="",
                    help="async arrival trace: periodic(<T>) | "
                         "poisson(<rate>) | pareto(<alpha>,<scale>) | "
                         "replay:<path> (default under --mode async: "
                         "pareto(1.2,0.5))")
    ap.add_argument("--tick", type=float, default=1.0,
                    help="async server fuse period in simulated seconds")
    ap.add_argument("--n-population", type=int, default=0,
                    help="fleet size N of a population (needs --cohort; "
                         "0 = the 4-vendor fleet)")
    ap.add_argument("--cohort", type=int, default=0,
                    help="cohort width C: at most C vendors a round")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--tau", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)

    if args.model and args.scheme != "ifl_spmd":
        ap.error("--model picks the LM of --scheme ifl_spmd")
    dev = resolve_device(args.device)
    trace = args.trace or ("pareto(1.2,0.5)" if args.mode == "async" else "")
    fleet = FleetSpec(n_population=args.n_population, cohort=args.cohort)
    # lr 0.05, B 32, seed 0, eval every 5th round, 6000/1500 samples (the
    # LM: d_fusion 32, 32 held-out sequences): the JAX package's
    # quickstart spec.
    spmd = args.scheme == "ifl_spmd"
    spec = ExperimentSpec(
        scheme=args.scheme, rounds=args.rounds, tau=args.tau, lr=0.05,
        batch_size=32, codec=args.codec, participation=args.participation,
        max_staleness=args.max_staleness, broadcast=args.broadcast,
        mode=args.mode, trace=trace, tick=args.tick, fleet=fleet,
        eval_every=5, seed=0, model=args.model,
        d_fusion=32 if spmd else 432,
        data=(DataSpec(dataset="synth_tokens", n_test=32) if spmd
              else DataSpec(n_train=6000, n_test=1500)))
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    vendors = (f"{fleet.population} vendors, cohort {args.cohort}/round"
               if args.cohort else "4 vendors")
    clock = (f"async trace {trace} tick {args.tick}" if args.mode == "async"
             else f"participation {args.participation}")
    data_name = (f", the {args.model or 'smoke'} LM on synthetic tokens"
                 if spmd else
                 f"(Table II), synthetic KMNIST {spec.data.n_train}/"
                 f"{spec.data.n_test}")
    print(f"== {args.scheme} quickstart: {vendors} {data_name}, codec "
          f"{args.codec}, {clock}, broadcast {args.broadcast}, tau "
          f"{args.tau}, on {name} ==")
    print(f"   spec {spec.spec_hash()}")

    def progress(rec, report):
        clock = (f"t={rec['sim_time']:.1f}s, " if "sim_time" in rec else "")
        losses = " ".join(f"{k} {report[k]:.4f}" for k in
                          ("base_loss", "mod_loss", "loss")
                          if k in report.metrics)
        cache = (f" (cache {report['cache_size']})"
                 if "cache_size" in report.metrics else "")
        accs = [round(a, 3) for a in rec.get("accs", [rec["acc_mean"]])]
        print(f"round {rec['round']:3d}: {clock}{losses} participants "
              f"{report.participants}{cache}, cumulative uplink "
              f"{rec['uplink_mb']:.4f} MB, total {rec['total_mb']:.4f} MB, "
              f"accs {accs}")

    t0 = time.perf_counter()
    result = run_experiment(spec, keep_trainer=True, on_record=progress,
                            device=dev)
    wall = time.perf_counter() - t0
    trainer = result.trainer
    print(f"\n{args.rounds} rounds in {wall:.2f} s (evaluations included)")
    if args.scheme in ("ifl", "ifl_spmd"):
        print(f"per-round bytes measured == analytic ifl_round_bytes, "
              f"every round: {round_bytes_match(trainer, spec)}")
    print(f"ledger totals: uplink {trainer.ledger.uplink_mb:.3f} MB, "
          f"downlink {trainer.ledger.downlink_mb:.3f} MB")
    if args.mode == "async":
        eng = trainer.engine
        print(f"async: {eng.total_uploads} uploads ({eng.total_arrivals} "
              f"arrivals, coalesced per tick) over {eng.sim_time:.1f} "
              f"simulated s = {eng.total_uploads / eng.sim_time:.2f} "
              f"uploads/s")
    if args.cohort and spmd:
        print(f"population: {len(trainer.store)} of {fleet.population} "
              f"vendors materialized, EF residuals held for "
              f"{len(trainer.ef_store) if trainer.ef_store else 0}")
    elif args.cohort:
        print(f"population: {len(trainer.clients.materialized)} of "
              f"{fleet.population} vendors built, EF residuals held for "
              f"{len(trainer.exchange.ef_state)}")
    accs = result.final.get("accs", [result.final["acc_mean"]])
    print(f"local accuracy per vendor (eq. 10): "
          f"{[round(a, 3) for a in accs]}")
    if "matrix" in result.final:
        print("cross-vendor composition matrix (eq. 11), [base k, "
              "modular i]:")
        print(np.round(np.asarray(result.final["matrix"]), 3))


if __name__ == "__main__":
    main()
