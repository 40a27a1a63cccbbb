"""The twin of ``benchmarks/roofline_report.py`` on the port: the
roofline table of the dry-run's files and the wire-path table.

    python -m repro_torch.benchmarks.roofline_report [--dir DIR]

The first CSV has one row per ``results/torch/dryrun/*.json`` (written
by ``python -m repro_torch.launch.dryrun``; accounting-only files carry
no roofline and are left out): the step's compute, memory and (on one
card, zero) collective terms against one H100 SXM, the dominant one,
the model's useful FLOPs, their share of the counted FLOPs, the MFU at
the bound and the step's peak memory on the card:

arch,shape,mesh,step,variant,compute_ms,memory_ms,collective_ms,dominant,
model_gflops,useful_ratio,mfu_bound,peak_gb

The second is analytic (``kernels/cost.py``, no run needed): per codec
with a wire scheme and every config's ``d_fusion``, at 1,024 rows, the
bytes the port's encode kernel must move beside those of the plain
composition (which round-trips c and the decoded z_hat under EF), the
payload's bytes, the saving and the kernel's bound on the card:

codec,d_fusion,kernel_bytes,plain_bytes,payload_bytes,savings,bound_ms
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

DRYRUN = os.path.join("results", "torch", "dryrun")

WIRE_CODECS = ("int8_row", "int4", "topk", "sketch",
               "ef(int4)", "ef(int8_row)")


def wire_rows(batch: int = 1024) -> List[Dict]:
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.core.codec import get_codec
    from repro_torch.kernels import cost, ops

    d_fusions = sorted({get_config(a).d_fusion for a in ARCH_IDS})
    out = []
    for name in WIRE_CODECS:
        codec = get_codec(name)
        ef = codec.has_state
        for d in d_fusions:
            scheme = ops.scheme_for(codec.inner if ef else codec, d)
            if scheme is None:
                continue
            rep = ops.fused_wire_report(codec, (batch, d))
            c = cost.wire_encode(scheme, batch, ef=ef)
            out.append({
                "codec": name, "d_fusion": d,
                "kernel_bytes": rep["hbm_bytes_fused"],
                "plain_bytes": rep["hbm_bytes_unfused"],
                "payload_bytes": rep["payload_bytes"],
                "savings": 1.0 - rep["hbm_bytes_fused"]
                / rep["hbm_bytes_unfused"],
                "bound_ms": c["bound_ms"],
            })
    return out


def load_all(dirpath: str = DRYRUN) -> List[Dict]:
    out = []
    for f in sorted(glob.glob(os.path.join(dirpath, "*.json"))):
        with open(f) as fh:
            r = json.load(fh)
        if "roofline" in r:
            out.append(r)
    return out


def rows(results=None, dirpath: str = DRYRUN) -> List[Dict]:
    results = results if results is not None else load_all(dirpath)
    out = []
    for r in results:
        t = r["roofline"]
        out.append({
            "arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"],
            "step": r["step"], "variant": r.get("variant", "baseline"),
            "compute_ms": t["compute_s"] * 1e3,
            "memory_ms": t["memory_s"] * 1e3,
            "collective_ms": t["collective_s"] * 1e3,
            "dominant": t["dominant"],
            "model_gflops": t.get("model_flops_total", 0) / 1e9,
            "useful_ratio": t.get("useful_flops_ratio", 0.0),
            "mfu_bound": t.get("mfu_bound", 0.0),
            "peak_gb": (r["memory"].get("peak_bytes") or 0) / 1e9,
        })
    return out


def _csv(cols, rs) -> None:
    print(",".join(cols))
    for r in rs:
        print(",".join((f"{r[c]:.4g}" if c == "bound_ms" else
                        f"{r[c]:.3f}") if isinstance(r[c], float)
                       else str(r[c]) for c in cols))


def run(quiet: bool = False, dirpath: str = DRYRUN) -> List[Dict]:
    rs = rows(dirpath=dirpath)
    if not quiet:
        _csv(["arch", "shape", "mesh", "step", "variant", "compute_ms",
              "memory_ms", "collective_ms", "dominant", "model_gflops",
              "useful_ratio", "mfu_bound", "peak_gb"], rs)
        print()
        _csv(["codec", "d_fusion", "kernel_bytes", "plain_bytes",
              "payload_bytes", "savings", "bound_ms"], wire_rows())
    return rs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default=DRYRUN,
                    help="the dry-run's output directory")
    args = ap.parse_args(argv)
    run(dirpath=args.dir)


if __name__ == "__main__":
    main()
