"""End-to-end example: IFL-train a ~100M-param LM, the twin of
``examples/llm_ifl_train.py``.

Four clients share one architecture (the olmo-1b family at ~100M reduced
scale: 8 layers, d_model 512) with private weights and private synthetic
dialects; every round is the port's IFL round step
(``repro_torch.core.ifl_spmd.make_ifl_round_step``) through
``repro_torch.train.loop.train_ifl_lm``. Loss on both blocks falls;
cumulative uplink is reported against what FedAvg would have cost. It
runs on the card unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.examples.llm_ifl_train [--rounds 200]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.config import ModelConfig
from repro_torch.configs import get_config
from repro_torch.core.comm import tree_leaves
from repro_torch.models.transformer import init_lm
from repro_torch.train.loop import train_ifl_lm


def olmo_100m() -> ModelConfig:
    """The ~100M-param member of the olmo family the reference trains."""
    olmo = get_config("olmo-1b")
    return olmo.replace(
        name="olmo-100m",
        num_layers=8, d_model=512, num_heads=8, num_kv_heads=8,
        d_ff=2048, vocab_size=16384, d_fusion=512,
        base_pattern=olmo.base_pattern, base_groups=4,
        mod_pattern=olmo.mod_pattern, mod_groups=4,
        compute_dtype="float32", remat="none", q_block=128,
    ).validate()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=40,
                    help="one round = tau+1 base/fusion steps + 4 modular "
                         "steps per client")
    ap.add_argument("--tau", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)

    cfg = olmo_100m()
    n_params = sum(x.numel() for x in tree_leaves(
        init_lm(cfg, generator=torch.Generator().manual_seed(0),
                device="cpu")))
    print(f"== IFL LM training: {cfg.name}, {n_params/1e6:.1f}M params, "
          f"{args.rounds} rounds x (tau={args.tau} base steps + fusion "
          f"exchange + 4 modular steps) ==")

    out = train_ifl_lm(
        cfg, rounds=args.rounds, n_clients=4, tau=args.tau,
        batch=args.batch, seq=args.seq, lr_base=0.05, lr_modular=0.05,
        log_every=max(1, args.rounds // 20), device=args.device,
    )
    h = out["history"]
    print(f"\nbase loss {h[0]['base_loss']:.3f} -> {h[-1]['base_loss']:.3f}; "
          f"modular loss {h[0]['mod_loss']:.3f} -> {h[-1]['mod_loss']:.3f}")
    fedavg_round_mb = 2 * 4 * n_params * 4 / 1e6  # up+down, fp32
    print(f"uplink total {out['ledger'].uplink_mb:.1f} MB over "
          f"{len(h)} rounds; FedAvg would ship "
          f"{fedavg_round_mb * len(h):.0f} MB "
          f"({fedavg_round_mb * len(h) / max(out['ledger'].uplink_mb, 1e-9):.0f}x more)")
    out["n_params"] = n_params
    return out


if __name__ == "__main__":
    main()
