"""The twin of ``benchmarks/perf_probe.py`` on the port: bisect one
dry-run row's roofline terms by running controlled config variants and
diffing the accounting.

    python -m repro_torch.benchmarks.perf_probe --arch qwen1.5-0.5b \\
        --shape train_4k --step dp --probe remat_none ce_chunk

Each probe is one hypothesis about the dominant term. The row runs
again on meta tensors (``repro_torch.launch.dryrun.run_one``, no card
and no memory behind it) with the probe's config overrides, and is
saved as a ``--variant`` run beside the baseline
(``<arch>__<shape>__h100__<step>__<probe>.json`` under ``--out``, which
the ``gen_experiments`` twin reads). A before/after table prints
compute_s, memory_s and temp_GB, as the reference's does; its
collective columns print 0, since one card's roofline has no
collective term.

Three of the reference's probes are not here: ``no_fsdp`` (ZeRO-3
sharding of the params over a TPU mesh's data axis), ``embed_dshard``
and ``ce_chunk_embed`` (the embedding sharded over the mesh's model axis
through ``REPRO_EMBED_SHARD``). They act on the TPU mesh's sharding,
which one card does not have (``launch/dryrun.py`` leaves ``--fsdp``
out for the same reason).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Sequence, Tuple

PROBES = {
    "remat_layer": {"overrides": {"remat": "layer"}},
    "remat_none": {"overrides": {"remat": "none"}},
    "ce_chunk": {"overrides": {"ce_chunk": 512}},
    "tau1": {"tau": 1},
    "qblock_256": {"overrides": {"q_block": 256}},
    "qblock_1024": {"overrides": {"q_block": 1024}},
    "mlstm_chunk_128": {"overrides": {"mlstm_chunk": 128}},
}


def run(arch: str, shape: str, probes: Sequence[str], *, step: str = "ifl",
        out: str = "results/torch/dryrun") -> List[Tuple[str, dict]]:
    """(name, dry-run row) of the baseline, where its file exists, and
    of each probe, each probe run anew; prints the table."""
    from repro_torch.launch import dryrun as dr

    base_path = os.path.join(out, f"{arch}__{shape}__h100__{step}.json")
    rows = []
    if os.path.exists(base_path):
        with open(base_path) as f:
            rows.append(("baseline", json.load(f)))
    for name in probes:
        spec = PROBES[name]
        rows.append((name, dr.run_one(
            arch, shape, step_kind=step, n_clients=4,
            tau=spec.get("tau", 2), variant=name, out_dir=out, force=True,
            overrides=spec.get("overrides"))))
    print(f"\n{'variant':16s} {'compute_s':>10s} {'memory_s':>10s} "
          f"{'coll_s':>10s} {'temp_GB':>8s} {'coll_MB':>8s}")
    for name, r in rows:
        t = r["roofline"]
        print(f"{name:16s} {t['compute_s']:10.3f} {t['memory_s']:10.3f} "
              f"{t['collective_s']:10.3f} "
              f"{(r['memory']['temp_bytes'] or 0) / 1e9:8.1f} "
              f"{t['collective_bytes_total'] / 1e6:8.0f}")
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--step", default="ifl")
    ap.add_argument("--probe", nargs="+", required=True,
                    choices=list(PROBES))
    ap.add_argument("--out", default="results/torch/dryrun")
    args = ap.parse_args(argv)
    run(args.arch, args.shape, args.probe, step=args.step, out=args.out)


if __name__ == "__main__":
    main()
