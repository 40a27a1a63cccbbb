"""Multi-tenant serving demo: continuous batching over per-tenant
composed models, the twin of ``examples/serve_demo.py``.

  PYTHONPATH=src python -m repro_torch.examples.serve_demo [--arch xlstm-350m]

Builds a CompositionStore of N personalized base blocks sharing one
modular block (the arch's reduced variant), serves staggered requests
through the per-arch lane engine, and checks every served continuation
bitwise against its fixed-batch oracle (the engine's correctness
contract); exits with status 1 if one differs. Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.serve import build_demo_store
from repro_torch.serve import Request, ServeEngine


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen1.5-0.5b")
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--width", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--horizon", type=int, default=8,
                    help="fused decode ticks per engine step")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    if cfg.is_encdec:
        raise SystemExit("enc-dec archs: use `python -m "
                         "repro_torch.launch.serve` (fixed-batch path)")
    dev = resolve_device(args.device)
    print(f"== serving {cfg.name}: {args.tenants} tenants, "
          f"lane width {args.width} ==")
    store = build_demo_store(cfg, args.arch, args.tenants, reduced=True,
                             device=dev)
    engine = ServeEngine(store, width=args.width,
                         cache_len=args.prompt_len + args.gen,
                         horizon=args.horizon, device=dev)

    stream = SyntheticLM(cfg.vocab_size, seed=1)
    prompts = stream.sample(args.tenants, args.prompt_len, step=0)
    reqs = [
        Request(rid=i, tenant=f"tenant{i}",
                prompt=[int(t) for t in prompts[i]],
                max_new_tokens=args.gen, arrival=i)  # staggered arrivals
        for i in range(args.tenants)
    ]

    def timed_run(eng):
        t0 = time.perf_counter()
        out = eng.run(list(reqs))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t0

    comps, warm = timed_run(engine)
    total_new = sum(len(c.tokens) for c in comps)
    comps, hot = timed_run(engine.fresh_clone())
    print(f"{len(comps)} requests / {total_new} new tokens: "
          f"warm {warm:.2f}s, hot {hot:.2f}s "
          f"({total_new / hot:.1f} new tok/s)")

    by_rid = {c.rid: c for c in comps}
    ok = all(by_rid[r.rid].tokens == engine.oracle(r).tokens for r in reqs)
    print("bitwise parity vs fixed-batch oracle:", ok)
    c0 = by_rid[0]
    print(f"tenant0 continuation (admitted@t{c0.admitted_tick}):",
          np.asarray(c0.tokens)[:12])
    return {"parity": ok, "tokens": total_new, "hot_s": hot}


if __name__ == "__main__":
    sys.exit(0 if main()["parity"] else 1)
