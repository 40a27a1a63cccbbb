"""Paper Table I, quantified: the per-round bytes of each scheme at the
paper's configuration (N=4, B=32, d_fusion=432), the compressed-IFL
codecs and the feature matrix; the twin of
``benchmarks/table1_comm_costs.py``, with the same rows.

    python -m repro_torch.benchmarks.table1_comm_costs [--device cpu]

Prints CSV: scheme,up_bytes,down_bytes,notes.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.config import RunConfig
from repro_torch.core import fl_round_bytes, fsl_round_bytes, ifl_round_bytes
from repro_torch.device import resolve_device
from repro_torch.models.small import init_client_model, model_bytes

FEATURES = [
    ("client params private", {"fl": 0, "fsl": 1, "ifl": 1}),
    ("local e2e inference", {"fl": 1, "fsl": 0, "ifl": 1}),
    ("lightweight uplink", {"fl": 0, "fsl": 1, "ifl": 1}),
    ("multiple updates/round", {"fl": 1, "fsl": 0, "ifl": 1}),
    ("full arch privacy", {"fl": 0, "fsl": 0, "ifl": 1}),
    ("heterogeneous models", {"fl": 0, "fsl": 0, "ifl": 1}),
    ("cross-client composition", {"fl": 0, "fsl": 0, "ifl": 1}),
]


def run(quiet: bool = False, *, device=None):
    """The table's rows, (scheme, {'up', 'down'}, note); the FL rows'
    model bytes are those of client 1's and client 2's models built on
    ``device`` (the card unless ``'cpu'``)."""
    dev = resolve_device(device)
    cfg = RunConfig()
    m1, m2 = (model_bytes(init_client_model(
        cid, generator=torch.Generator().manual_seed(0), device=dev))
        for cid in (1, 2))
    fp32_up = ifl_round_bytes(4, cfg.batch_size, cfg.d_fusion)["up"]
    rows = [
        ("ifl", ifl_round_bytes(4, cfg.batch_size, cfg.d_fusion),
         f"tau={cfg.tau} local steps amortized per upload"),
    ]
    for codec in ["bf16", "int8", "topk", "int4"]:
        b = ifl_round_bytes(4, cfg.batch_size, cfg.d_fusion, codec=codec)
        rows.append((f"ifl+{codec}", b,
                     f"wire codec; {fp32_up / b['up']:.1f}x less uplink"))
    for codec in ["ef(topk0.1)", "ef(int4)"]:
        b = ifl_round_bytes(4, cfg.batch_size, cfg.d_fusion, codec=codec)
        rows.append((f"ifl+{codec}", b,
                     f"EF21 residual; {fp32_up / b['up']:.1f}x less uplink"
                     " at near-fp32 accuracy"))
    rows += [
        ("fsl", fsl_round_bytes(4, cfg.batch_size, cfg.d_fusion),
         "1 update per round"),
        ("fl1", fl_round_bytes(4, m1), f"model={m1/1e6:.2f}MB (client 1)"),
        ("fl2", fl_round_bytes(4, m2), f"model={m2/1e6:.2f}MB (client 2)"),
    ]
    if not quiet:
        print("scheme,up_bytes_per_round,down_bytes_per_round,notes")
        for name, b, note in rows:
            print(f"{name},{b['up']},{b['down']},{note}")
        print("\nfeature," + ",".join(["fl", "fsl", "ifl"]))
        for feat, v in FEATURES:
            print(f"{feat},{v['fl']},{v['fsl']},{v['ifl']}")
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="where the models are built (default: the card)")
    run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
