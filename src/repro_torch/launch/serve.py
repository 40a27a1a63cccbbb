"""Serving launcher: the multi-tenant continuous-batching engine CLI.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
      --no-reduced --tenants 4 --prompt-len 32 --gen 32 --horizon 8 \\
      [--temperature 0.8 --top-k 20]

Each tenant gets its own randomly initialized base block (a stand-in for
per-client personalization) and all share tenant 0's modular block.
Runs on the card; ``--device cpu`` runs on the CPU. ``--reduced`` (the
default) serves the CPU-sized variant of the arch, ``--no-reduced`` its
full width. ``--horizon auto`` reads the serve-plan autotuner's file.

Decoder-only archs go through ``repro_torch.serve.ServeEngine``.
Encoder-decoder archs (seamless-m4t) go through the fixed-batch
``generate`` path, as in the JAX package: the lanes carry no
per-request cross caches.
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
from repro_torch.models.transformer import (
    build_cross_caches,
    encoder_forward,
    init_decode_cache,
    init_lm,
    lm_decode_step,
    lm_prefill,
)
from repro_torch.serve import CompositionStore, Request, ServeEngine, prng


def generate(params, cfg: ModelConfig, prompts: torch.Tensor, gen: int,
             cross_kvs=None, greedy: bool = True,
             seed: int = 0) -> torch.Tensor:
    """prompts (B, P) int on the params' device -> (B, P + gen) tokens:
    one batched cached prefill (``lm_prefill``), then ``gen`` decode
    steps. Greedy takes the argmax; otherwise each token is
    ``categorical`` of the logits under a key split from
    ``PRNGKey(seed)``, as the JAX package's ``generate`` draws it."""
    B, P = prompts.shape
    with torch.no_grad():
        cache = init_decode_cache(cfg, B, P + gen, device=prompts.device)
        logits, cache = lm_prefill(params, cfg, cache, prompts, cross_kvs)
        out = [prompts]
        key = prng.prng_key(seed, prompts.device)
        for g in range(gen):
            if greedy:
                nxt = logits[:, -1].argmax(dim=-1, keepdim=True)
            else:
                key, sub = prng.split(key)
                nxt = prng.categorical(sub, logits[:, -1])[:, None]
            out.append(nxt)
            logits, cache = lm_decode_step(params, cfg, cache, nxt, P + g,
                                           cross_kvs)
    return torch.cat(out, dim=1)


def _serve_encdec(cfg: ModelConfig, args, dev: torch.device) -> None:
    """The fixed-batch path of an encoder-decoder: one model (tenant 0's
    init), ``--tenants`` rows of frames from ``default_rng(0)`` through
    the encoder, greedy ``generate`` through their cross caches."""
    params = init_lm(cfg, generator=tenant_generator(args.seed, 0, dev),
                     device=dev)
    frames = torch.from_numpy(np.random.default_rng(0).normal(
        size=(args.tenants, cfg.enc_seq_len, cfg.d_model)
    ).astype(np.float32)).to(dev)
    with torch.no_grad():
        enc_out = encoder_forward(params["base"]["encoder"], cfg, frames)
        cross_kvs = build_cross_caches(params, cfg, enc_out)
    prompts = SyntheticLM(cfg.vocab_size, seed=args.seed).sample(
        args.tenants, args.prompt_len, step=0)
    t0 = time.perf_counter()
    out = generate(params, cfg, torch.from_numpy(prompts).to(dev), args.gen,
                   cross_kvs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    total_new = args.tenants * args.gen
    print(f"generated {tuple(out.shape)} in {dt:.2f}s "
          f"({total_new / dt:.1f} tok/s incl. prefill; a first run)")
    print("sample continuation:", out[0, args.prompt_len:].cpu().tolist()[:16])


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
                  stagger: int, seed: int = 0, temperature: float = 0.0,
                  top_k: int = 0) -> List[Request]:
    """One request per tenant (greedy unless ``temperature`` > 0),
    prompts from ``SyntheticLM``, arrivals ``stagger`` ticks apart."""
    prompts = SyntheticLM(cfg.vocab_size, seed=seed).sample(
        n, prompt_len, step=0)
    return [Request(rid=i, tenant=f"tenant{i}",
                    prompt=[int(t) for t in prompts[i]],
                    max_new_tokens=gen, arrival=i * stagger,
                    temperature=temperature, top_k=top_k, seed=seed)
            for i in range(n)]


def _horizon(text: str):
    if text == "auto":
        return text
    try:
        h = int(text)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--horizon takes an integer or 'auto', got {text!r}")
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
                    help="fused decode ticks per engine step, or 'auto' "
                         "to read the serve-plan autotuner's file")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy argmax; > 0 samples at this "
                         "temperature inside the lane step")
    ap.add_argument("--top-k", type=int, default=0,
                    help="restrict sampling to the k largest logits "
                         "(0 = full vocab; needs --temperature > 0)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    if cfg.is_encdec:
        print(f"== serving {cfg.name} on {dev}: tenants={args.tenants} "
              f"prompt={args.prompt_len} gen={args.gen} ==")
        print("(enc-dec arch: fixed-batch generate path)")
        _serve_encdec(cfg, args, dev)
        return
    print(f"== serving {cfg.name} on {dev}: tenants={args.tenants} "
          f"width={args.width} prompt={args.prompt_len} gen={args.gen} "
          f"horizon={args.horizon} temperature={args.temperature} "
          f"top_k={args.top_k} ==")
    store = build_demo_store(cfg, args.arch, args.tenants, args.seed,
                             reduced=args.reduced, device=dev)
    engine = ServeEngine(store, width=args.width,
                         cache_len=args.prompt_len + args.gen,
                         horizon=args.horizon, device=dev)
    reqs = demo_requests(cfg, args.tenants, args.prompt_len, args.gen,
                         args.stagger, args.seed, args.temperature,
                         args.top_k)
    t0 = time.perf_counter()
    comps = engine.run(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    total_new = sum(len(c.tokens) for c in comps)
    print(f"served {len(comps)} requests / {total_new} new tokens in "
          f"{dt:.2f}s over {engine.tick} ticks at horizon {engine.horizon} "
          f"({total_new / dt:.1f} tok/s; a first run, which includes "
          "building the kernels if they are not built yet)")
    for c in comps[: min(3, len(comps))]:
        print(f"  {c.tenant}: admitted@t{c.admitted_tick} "
              f"finished@t{c.finished_tick} {c.tokens[:12]}")


if __name__ == "__main__":
    main()
