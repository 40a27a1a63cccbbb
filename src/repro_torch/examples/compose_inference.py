"""Cross-vendor modular composition at inference (the paper's Fig. 1b /
eq. 11), at both scales: the twin of ``examples/compose_inference.py``.

  1. Table II CNN/MLP vendors: 10 IFL rounds through ``run_experiment``,
     then vendor i's base block with every vendor's modular block (the
     composition matrix of test accuracies).
  2. LM scale: two architecture *families*, an olmo-style dense decoder
     and an xLSTM-style recurrent one, sharing vocab and d_fusion,
     compose across the fusion interface in all four pairings (base of
     one, modular of the other), which is the interoperability the
     standardized fusion dim buys.

It runs on the card unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.examples.compose_inference
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.api import DataSpec, ExperimentSpec, run_experiment
from repro_torch.config import LayerSpec, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.transformer import (
    base_forward,
    init_lm,
    modular_forward,
)


def small_scale(device: DeviceLike = None, rounds: int = 10) -> List[List]:
    print(f"== Table II vendors: composition after {rounds} IFL rounds ==")
    spec = ExperimentSpec(
        scheme="ifl", rounds=rounds, tau=10, lr=0.03, eval_every=0, seed=0,
        data=DataSpec(n_train=4000, n_test=1000),
    )
    mat = run_experiment(spec, device=device).final["matrix"]
    names = "ABCD"
    for i in range(4):
        row = " ".join(f"{names[i]}1-{names[j]}2:{mat[i][j]:.2f}"
                       for j in range(4))
        print("  " + row)
    return mat


def llm_configs() -> Tuple[ModelConfig, ModelConfig]:
    """The reference's two vendors: d 192, 4 heads (head dim 48), fusion
    dim 128, vocab 512, fp32; a dense decoder and an mLSTM-base /
    sLSTM-modular xLSTM."""
    common = dict(vocab_size=512, d_fusion=128, d_model=192, num_heads=4,
                  num_kv_heads=4, compute_dtype="float32", remat="none",
                  q_block=32, mlstm_chunk=8)
    dense = ModelConfig(
        name="vendor-dense", num_layers=4, d_ff=384,
        base_pattern=(LayerSpec(),), base_groups=2,
        mod_pattern=(LayerSpec(),), mod_groups=2, **common,
    ).validate()
    recur = ModelConfig(
        name="vendor-xlstm", num_layers=4, d_ff=0, rope_type="none",
        base_pattern=(LayerSpec(mixer="mlstm", ffn="none"),), base_groups=2,
        mod_pattern=(LayerSpec(mixer="slstm", ffn="none"),), mod_groups=2,
        **common,
    ).validate()
    return dense, recur


def llm_scale(device: DeviceLike = None, seed: int = 0
              ) -> Dict[Tuple[str, str], torch.Tensor]:
    """Every (base family, modular family) pair on one batch of tokens:
    -> {(base, modular): logits (2, 32, 512) fp32}."""
    print("\n== Cross-FAMILY LLM composition: dense base + recurrent "
          "modular (and vice versa) via the standardized fusion dim ==")
    dev = resolve_device(device)
    dense, recur = llm_configs()
    gen = torch.Generator(device=dev).manual_seed(seed)
    vendors = [("dense", dense, init_lm(dense, generator=gen, device=dev)),
               ("xlstm", recur, init_lm(recur, generator=gen, device=dev))]
    toks = np.random.default_rng(seed + 2).integers(0, 512, (2, 32))
    batch = {"tokens": torch.from_numpy(toks).to(dev)}
    out = {}
    with torch.no_grad():
        for bname, bcfg, bp in vendors:
            z, _ = base_forward(bp["base"], bcfg, batch)
            for mname, mcfg, mp in vendors:
                logits = modular_forward(mp["modular"], mcfg, z)[0]
                ok = bool(torch.all(torch.isfinite(logits)))
                print(f"  base[{bname}] -> z{tuple(z.shape)} -> "
                      f"modular[{mname}] -> logits{tuple(logits.shape)} "
                      f"finite={ok}")
                out[(bname, mname)] = logits
    print("  (any base composes with any modular: the interface is only "
          "(B, S, d_fusion))")
    return out


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    ap.add_argument("--rounds", type=int, default=10,
                    help="IFL rounds before the Table-II composition matrix")
    args = ap.parse_args(argv)
    return {"matrix": small_scale(args.device, args.rounds),
            "llm": llm_scale(args.device)}


if __name__ == "__main__":
    main()
