"""Serving launcher: the multi-tenant continuous-batching engine CLI.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
      --no-reduced --tenants 4 --prompt-len 32 --gen 32 --horizon 8

Each tenant gets its own randomly initialized base block (a stand-in for
per-client personalization) and all share tenant 0's modular block.
Runs on the card; ``--device cpu`` runs on the CPU. ``--reduced`` (the
default) serves the CPU-sized variant of the arch, ``--no-reduced`` its
full width. Greedy decoding only; enc-dec archs wait for a later slice.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.transformer import init_lm
from repro_torch.serve import CompositionStore, Request, ServeEngine


def tenant_generator(seed: int, k: int, device) -> torch.Generator:
    """Tenant k's init generator, seeded from (seed, k)."""
    s = int(np.random.SeedSequence([seed, k]).generate_state(1,
                                                             np.uint64)[0])
    return torch.Generator(device=device).manual_seed(s)


def build_demo_store(cfg: ModelConfig, arch: str, n_tenants: int,
                     seed: int = 0, *, reduced: bool,
                     device: DeviceLike = None) -> CompositionStore:
    """A CompositionStore of ``n_tenants`` per-tenant base blocks (each
    a different init) sharing tenant 0's modular block, on ``device``
    (default: the card). ``reduced`` says whether ``cfg`` is the arch's
    reduced variant, so a saved store resolves to the same config."""
    dev = resolve_device(device)
    store = CompositionStore()
    if arch in ARCH_IDS:
        name = store.add_arch(arch, reduced=reduced, d_fusion=cfg.d_fusion)
    else:
        name = store.add_arch(cfg, reduced=reduced)
    for k in range(n_tenants):
        params = init_lm(cfg, generator=tenant_generator(seed, k, dev),
                         device=dev)
        if k == 0:
            store.set_modular(name, params["modular"])
        store.add_tenant(f"tenant{k}", name, params["base"])
    return store


def demo_requests(cfg: ModelConfig, n: int, prompt_len: int, gen: int,
                  stagger: int, seed: int = 0) -> List[Request]:
    """One greedy request per tenant, prompts from ``SyntheticLM``,
    arrivals ``stagger`` ticks apart."""
    prompts = SyntheticLM(cfg.vocab_size, seed=seed).sample(
        n, prompt_len, step=0)
    return [Request(rid=i, tenant=f"tenant{i}",
                    prompt=[int(t) for t in prompts[i]],
                    max_new_tokens=gen, arrival=i * stagger, seed=seed)
            for i in range(n)]


def _horizon(text: str) -> int:
    try:
        h = int(text)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--horizon takes an integer, got {text!r} ('auto' needs the "
            "serve-plan autotuner, which the port does not have yet)")
    if h < 1:
        raise argparse.ArgumentTypeError(f"--horizon must be >= 1, got {h}")
    return h


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve the arch's reduced variant (default) or, "
                         "with --no-reduced, its full width")
    ap.add_argument("--tenants", type=int, default=4,
                    help="concurrent tenants (= demo requests)")
    ap.add_argument("--width", type=int, default=4, help="lane width")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--stagger", type=int, default=2,
                    help="ticks between consecutive request arrivals")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--horizon", type=_horizon, default=1,
                    help="fused decode ticks per engine step (an integer)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: enc-dec serving (the JAX package's fixed-batch "
            "path) is not ported yet (ROADMAP.md queue 1, item 5a)")
    dev = resolve_device(args.device)
    print(f"== serving {cfg.name} on {dev}: tenants={args.tenants} "
          f"width={args.width} prompt={args.prompt_len} gen={args.gen} "
          f"horizon={args.horizon} ==")
    store = build_demo_store(cfg, args.arch, args.tenants, args.seed,
                             reduced=args.reduced, device=dev)
    engine = ServeEngine(store, width=args.width,
                         cache_len=args.prompt_len + args.gen,
                         horizon=args.horizon, device=dev)
    reqs = demo_requests(cfg, args.tenants, args.prompt_len, args.gen,
                         args.stagger, args.seed)
    t0 = time.perf_counter()
    comps = engine.run(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    total_new = sum(len(c.tokens) for c in comps)
    print(f"served {len(comps)} requests / {total_new} new tokens in "
          f"{dt:.2f}s over {engine.tick} ticks "
          f"({total_new / dt:.1f} tok/s; a first run, which includes "
          "building the kernels if they are not built yet)")
    for c in comps[: min(3, len(comps))]:
        print(f"  {c.tenant}: admitted@t{c.admitted_tick} "
              f"finished@t{c.finished_tick} {c.tokens[:12]}")


if __name__ == "__main__":
    main()
