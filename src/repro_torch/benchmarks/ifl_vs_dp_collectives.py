"""The twin of ``benchmarks/ifl_vs_dp_collectives.py`` on the port: the
paper's Fig. 2 claim restated per architecture, as bytes.

    python -m repro_torch.benchmarks.ifl_vs_dp_collectives [--codec C]
        [--n-clients N] [--shape train_4k]

The reference reads the collectives of two compiled TPU-pod programs.
On one card there are none, so both sides are analytic: per arch, the
bytes of one IFL round at the client boundary (``comm.ifl_round_bytes``
at the shape's rows per client and the arch's ``d_fusion``, as the
dry-run's ``client_boundary`` prices them) against one DP step's
gradient all-reduce over the same clients (a ring: 2·P·(g−1)/g bytes a
client, P the params' bytes in the config's ``param_dtype``, g the
clients). Prints CSV:

arch,n_clients,codec,ifl_up_bytes,ifl_down_bytes,ifl_bytes_per_client,
dp_allreduce_bytes_per_client,dp_over_ifl   (analytic, both sides)
"""

from __future__ import annotations

import argparse
from typing import Dict, List


def run(quiet: bool = False, *, codec: str = "fp32", n_clients: int = 4,
        shape: str = "train_4k", archs=None) -> List[Dict]:
    """One row per arch (``archs``, default every config)."""
    from repro_torch.config import INPUT_SHAPES
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.core.comm import ifl_round_bytes
    from repro_torch.launch.dryrun import _block_params
    from repro_torch.models import modules as nn

    sh = INPUT_SHAPES[shape]
    rows_per_client = (sh.global_batch // n_clients) * sh.seq_len
    out = []
    for arch in archs or ARCH_IDS:
        cfg = get_config(arch)
        b = ifl_round_bytes(n_clients, rows_per_client, cfg.d_fusion,
                            codec=codec)
        p_base, p_mod = _block_params(cfg)
        esz = nn.dtype_of(cfg.param_dtype).itemsize
        p_bytes = (p_base + p_mod) * esz
        g = n_clients
        dp = 2 * p_bytes * (g - 1) / g
        ifl = (b["up"] + b["down"]) / n_clients
        out.append({"arch": arch, "n_clients": n_clients, "codec": codec,
                    "ifl_up_bytes": b["up"], "ifl_down_bytes": b["down"],
                    "ifl_bytes_per_client": ifl,
                    "dp_allreduce_bytes_per_client": dp,
                    "dp_over_ifl": dp / ifl})
    if not quiet:
        print("arch,n_clients,codec,ifl_up_bytes,ifl_down_bytes,"
              "ifl_bytes_per_client,dp_allreduce_bytes_per_client,"
              "dp_over_ifl   (analytic, both sides)")
        for r in out:
            print(f"{r['arch']},{r['n_clients']},{r['codec']},"
                  f"{r['ifl_up_bytes']},{r['ifl_down_bytes']},"
                  f"{r['ifl_bytes_per_client']:.4e},"
                  f"{r['dp_allreduce_bytes_per_client']:.4e},"
                  f"{r['dp_over_ifl']:.3f}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--codec", default="fp32")
    ap.add_argument("--n-clients", type=int, default=4)
    ap.add_argument("--shape", default="train_4k")
    args = ap.parse_args(argv)
    run(codec=args.codec, n_clients=args.n_clients, shape=args.shape)


if __name__ == "__main__":
    main()
