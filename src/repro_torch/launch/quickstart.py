"""Quickstart of the port: collaborative IFL training (the paper's
Algorithm 1), end to end, the twin of ``examples/quickstart.py``.

Four vendors with the paper's Table-II architectures train on non-IID
synthetic KMNIST while exchanging only fusion-layer outputs through the
chosen wire codec, then compose each other's modular blocks (eq. 11):

  PYTHONPATH=src python -m repro_torch.launch.quickstart              # the card
  PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu
  PYTHONPATH=src python -m repro_torch.launch.quickstart --codec "ef(int4)" \
      --participation k2 --rounds 10 --tau 10

Each round prints the base and modular losses, the participants and the
round's ledger bytes; at the end it prints whether every round's measured
bytes equal the analytic ``ifl_round_bytes`` and the cross-vendor
composition matrix. It runs on the card unless ``--device cpu``, and
raises where there is no CUDA.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.api import DataSpec, ExperimentSpec, build_ifl, load_data
from repro_torch.core.comm import ifl_round_bytes


def round_bytes_match(trainer, spec: ExperimentSpec) -> bool:
    """Every closed round's ledger bytes == the analytic formula at that
    round's participants and cache size."""
    for rep, got in zip(trainer.engine.history, trainer.ledger.per_round):
        exp = ifl_round_bytes(spec.fleet.population, spec.batch_size,
                              spec.d_fusion, codec=spec.codec,
                              participating=len(rep.participants),
                              broadcast_entries=rep["cache_size"])
        if got != exp:
            return False
    return True


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--codec", default="fp32",
                    help="fusion-payload wire codec: fp32 | bf16 | fp16 | "
                         "int8 | int8_channel | int8_row | int4 | topk<r> | "
                         "sketch<r> | ef(<codec>)")
    ap.add_argument("--participation", default="full",
                    help="full | k<K> | bern<p> | straggle(<frac>,<period>)")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--tau", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)

    # lr 0.05, B 32, seed 0, 6000/1500 samples: the JAX package's
    # quickstart spec.
    spec = ExperimentSpec(
        scheme="ifl", rounds=args.rounds, tau=args.tau, lr=0.05,
        batch_size=32, codec=args.codec, participation=args.participation,
        seed=0, data=DataSpec(n_train=6000, n_test=1500))
    data = load_data(spec)
    trainer = build_ifl(spec, data, device=args.device)
    dev = trainer.device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"== ifl quickstart: 4 vendors (Table II), synthetic KMNIST "
          f"{spec.data.n_train}/{spec.data.n_test}, codec {args.codec}, "
          f"participation {args.participation}, tau {args.tau}, on {name} ==")
    print(f"   spec {spec.spec_hash()}")
    for _ in range(args.rounds):
        t0 = time.perf_counter()
        rep = trainer.run_round()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        got = trainer.ledger.per_round[-1]
        print(f"round {rep.round:3d}: base_loss {rep['base_loss']:.4f} "
              f"mod_loss {rep['mod_loss']:.4f} participants "
              f"{rep.participants} (cache {rep['cache_size']}) "
              f"up {got['up']} B down {got['down']} B, {wall * 1e3:.1f} ms")

    ok = round_bytes_match(trainer, spec)
    print(f"\nper-round bytes measured == analytic ifl_round_bytes, every "
          f"round: {ok}")
    accs = trainer.evaluate(data.test_x, data.test_y)
    print(f"local accuracy per vendor (eq. 10): "
          f"{[round(a, 3) for a in accs]}")
    print("cross-vendor composition matrix (eq. 11), [base k, modular i]:")
    print(np.round(trainer.accuracy_matrix(data.test_x, data.test_y), 3))


if __name__ == "__main__":
    main()
