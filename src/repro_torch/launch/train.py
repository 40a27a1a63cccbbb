"""Training launcher: LM-scale IFL (and the DP baseline), the port of
``repro.launch.train`` with its flags and defaults plus ``--device``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --mode ifl --rounds 3 --tau 2 --batch 2 --seq 512

runs on the card; ``--reduced --device cpu`` runs the smoke-scale
family variant on the CPU. Every config of the registry: dense GQA
(with qk-norm, sliding windows, NoPE), MLA, MoE (with its load-balance
loss), MTP, Mamba and xLSTM layer programs, qwen2-vl's M-RoPE with its
image rows and seamless-m4t's encoder and cross-attention, whose batches
carry numpy-drawn ``image_embeds`` / ``frame_embeds`` as the reference's
loop draws them. Writes ``<out>/<name>__<mode>.json``
(the history) and, with ``--save-ckpt``, the params in the reference's
checkpoint format (IFL clients stacked along a leading (N,) dim).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

from repro_torch.checkpoint import save_checkpoint, stack_clients
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.train.loop import train_dp_lm, train_ifl_lm


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="olmo-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mode", choices=["ifl", "dp"], default="ifl")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--tau", type=int, default=4)
    ap.add_argument("--n-clients", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="results/train")
    ap.add_argument("--save-ckpt", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    print(f"== {args.mode} training: {cfg.name} "
          f"({cfg.num_layers}L d={cfg.d_model}) on {args.device} ==")

    if args.mode == "ifl":
        out = train_ifl_lm(
            cfg, rounds=args.rounds, n_clients=args.n_clients,
            tau=args.tau, batch=args.batch, seq=args.seq,
            lr_base=args.lr, lr_modular=args.lr, seed=args.seed,
            device=args.device,
        )
    else:
        out = train_dp_lm(
            cfg, steps=args.rounds, batch=args.batch, seq=args.seq,
            lr=args.lr, seed=args.seed, device=args.device,
        )

    os.makedirs(args.out, exist_ok=True)
    tag = f"{cfg.name}__{args.mode}"
    with open(os.path.join(args.out, tag + ".json"), "w") as f:
        json.dump(out["history"], f, indent=1)
    if args.save_ckpt:
        params = out["params"]
        if args.mode == "ifl":
            params = stack_clients(params)
        save_checkpoint(os.path.join(args.out, tag + "_ckpt"), params,
                        step=args.rounds)
    first, last = out["history"][0], out["history"][-1]
    key = "base_loss" if args.mode == "ifl" else "loss"
    print(f"loss {first[key]:.4f} -> {last[key]:.4f} "
          f"over {len(out['history'])} rounds")
    return out


if __name__ == "__main__":
    main()
