"""The twin of ``benchmarks/serving_bench.py`` on the port: serving-plane
throughput of the continuous-batching engine.

    python -m repro_torch.benchmarks.serving_bench --smoke --check
        [--device cpu]

Three arms per (lane width W, tenant count T) grid point, all on the
smoke-config composition store (``api.spmd.smoke_model_config``; one
personalized base block per tenant sharing one modular block):

  sequential — a width-1 engine, requests back to back (no batching).
  horizon=1  — the continuous-batching engine, one host sync per token.
  fused      — the same engine at ``--horizon S`` (default 8): S decode
               ticks a step with the stop state on the device, one
               coalesced transfer a step, and bucketed batch prefill at
               horizon boundaries.

Every arm is timed on a ``fresh_clone`` after a first run, the card
synchronized before each clock read, and every served continuation is
checked bitwise against its fixed-batch oracle. Per-token latency is
attributed by the step clock: each Completion stamps every token with
its tick, the harness times each engine step, and a token's latency is
the wall duration of the step (``tick // horizon``) that emitted it.

``--check`` exits nonzero unless (a) parity holds on every arm, (b)
every batched arm at >= 8 tenants strictly beats sequential, and (c)
the fused arm beats horizon=1 by >= ``--min-speedup`` (1.5x) at the
W=8, T>=8 grid point: the reference's gate, unchanged
(``check_failures``).

``--load`` switches to trace-driven open-loop load
(``core.rounds.ArrivalTrace`` arrivals at each offered rate of
``--rates``, requests/tick/tenant): delivered tok/s, p50/p99 per-token
latency and queue depth against offered load, with no gate.
``--autotune`` runs the serve-plan autotuner (``ServeEngine.autotune``)
first and uses its persisted (horizon, bucket edges). ``--device``
defaults to the card. Results land in ``results/torch/BENCH_serving.json``
(``--out``; never the repo root's ``BENCH_serving.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch.api.spmd import smoke_model_config
from repro_torch.core.rounds import parse_trace
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.serve import build_demo_store
from repro_torch.serve import Request, ServeEngine

__all__ = ["run", "check_failures"]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _requests(args, n_tenants: int, stagger: int):
    stream = SyntheticLM(smoke_model_config().vocab_size, seed=args.seed)
    prompts = stream.sample(n_tenants, args.prompt_len, step=0)
    return [
        Request(rid=i, tenant=f"tenant{i}",
                prompt=[int(t) for t in prompts[i]],
                max_new_tokens=args.gen, arrival=i * stagger)
        for i in range(n_tenants)
    ]


def _timed_run(engine: ServeEngine, requests):
    """Drive the engine step by step, timing each step on the card's
    clock (synchronized). Returns (completions, per-step wall seconds,
    total wall seconds)."""
    for r in requests:
        engine.submit(r)
    step_wall, comps = [], []
    _sync(engine.device)
    t0 = time.perf_counter()
    while engine.inflight > 0:
        s = time.perf_counter()
        comps.extend(engine.step())
        _sync(engine.device)
        step_wall.append(time.perf_counter() - s)
    total = time.perf_counter() - t0
    return sorted(comps, key=lambda c: c.rid), step_wall, total


def _token_latencies(comps, step_wall, horizon: int):
    """Map every emitted token to the wall duration of the engine step
    (``tick // horizon``) that emitted it."""
    lat = []
    for c in comps:
        lat.extend(step_wall[t // horizon] for t in c.token_ticks)
    return lat


def _serve(store, requests, width: int, cache_len: int, horizon: int,
           bucket_edges, device):
    """A first run, then the timed run on a fresh clone; returns the
    first engine (for oracles) and the timed run's measurements."""
    warm = ServeEngine(store, width=width, cache_len=cache_len,
                       horizon=horizon, bucket_edges=bucket_edges,
                       device=device)
    warm.run(list(requests))
    hot = warm.fresh_clone()
    comps, step_wall, total = _timed_run(hot, list(requests))
    return warm, comps, step_wall, total


def run_arm(args, store, width: int, n_tenants: int, horizon: int,
            seq_baseline, h1_tok_per_s=None):
    cache_len = args.prompt_len + args.gen
    requests = _requests(args, n_tenants, args.stagger)
    warm, comps, step_wall, total = _serve(
        store, requests, width, cache_len, horizon, args.bucket_edges,
        args.device)
    new_tokens = sum(len(c.tokens) for c in comps)
    lat = _token_latencies(comps, step_wall, horizon)
    parity = all(
        comps[i].tokens == warm.oracle(r).tokens
        for i, r in enumerate(requests)
    )
    tok_per_s = new_tokens / max(total, 1e-9)
    arm = {
        "width": width, "tenants": n_tenants, "horizon": horizon,
        "new_tokens": new_tokens, "steps": len(step_wall),
        "wall_s": total,
        "tok_per_s": tok_per_s,
        "p50_token_s": float(np.percentile(lat, 50)),
        "p99_token_s": float(np.percentile(lat, 99)),
        "seq_tok_per_s": seq_baseline["tok_per_s"],
        "speedup_vs_sequential":
            tok_per_s / max(seq_baseline["tok_per_s"], 1e-9),
        "parity_exact": parity,
    }
    if h1_tok_per_s is not None:
        arm["h1_tok_per_s"] = h1_tok_per_s
        arm["speedup_vs_h1"] = tok_per_s / max(h1_tok_per_s, 1e-9)
    extra = (f", x{arm['speedup_vs_h1']:.2f} vs h=1"
             if h1_tok_per_s is not None else "")
    print(f"W={width:>3} T={n_tenants:>3} S={horizon:>2}: "
          f"{tok_per_s:8.1f} tok/s "
          f"(seq {arm['seq_tok_per_s']:8.1f}, "
          f"x{arm['speedup_vs_sequential']:.2f}{extra}), "
          f"p50 {arm['p50_token_s'] * 1e3:.2f} ms "
          f"p99 {arm['p99_token_s'] * 1e3:.2f} ms, "
          f"parity {'exact' if parity else 'BROKEN'}", flush=True)
    return arm


def run_sequential(args, store, n_tenants: int):
    """The per-request baseline: the same requests, no batching: a
    width-1 engine serves them back to back (arrivals zeroed, so it never
    idles waiting on the stagger)."""
    cache_len = args.prompt_len + args.gen
    requests = [
        Request(rid=r.rid, tenant=r.tenant, prompt=r.prompt,
                max_new_tokens=r.max_new_tokens, arrival=0)
        for r in _requests(args, n_tenants, args.stagger)
    ]
    _, comps, step_wall, total = _serve(store, requests, 1, cache_len, 1,
                                        None, args.device)
    new_tokens = sum(len(c.tokens) for c in comps)
    lat = _token_latencies(comps, step_wall, 1)
    base = {
        "tenants": n_tenants, "new_tokens": new_tokens,
        "wall_s": total,
        "tok_per_s": new_tokens / max(total, 1e-9),
        "p50_token_s": float(np.percentile(lat, 50)),
        "p99_token_s": float(np.percentile(lat, 99)),
    }
    print(f"seq T={n_tenants:>3}: {base['tok_per_s']:8.1f} tok/s "
          f"(width-1, back to back)", flush=True)
    return base


# ------------------------------------------------ trace-driven load


def trace_requests(args, n_tenants: int, rate: float, n_requests: int):
    """Open-loop arrivals: one ArrivalTrace clock per tenant at ``rate``
    requests/tick, streamed until ``n_requests`` exist. The trace's
    float times become engine ticks (floor)."""
    trace = parse_trace(args.trace.format(rate=rate))
    rng = np.random.default_rng(args.seed)
    cur = trace.cursor(n_tenants, rng)
    stream = SyntheticLM(smoke_model_config().vocab_size, seed=args.seed)
    prompts = stream.sample(n_tenants, args.prompt_len, step=0)
    events, t_end = [], 0.0
    while len(events) < n_requests:
        t_end += 64.0
        events.extend(cur.pop_until(t_end, rng))
    events = events[:n_requests]
    return [
        Request(rid=i, tenant=f"tenant{slot}",
                prompt=[int(x) for x in prompts[slot]],
                max_new_tokens=args.gen, arrival=int(t))
        for i, (t, slot) in enumerate(events)
    ]


def run_load_point(args, store, width: int, n_tenants: int,
                   horizon: int, rate: float):
    """One offered-load point: ``--load-requests`` trace-driven arrivals
    through the engine; delivered throughput, per-token latency and queue
    depth (sampled once a step)."""
    cache_len = args.prompt_len + args.gen
    requests = trace_requests(args, n_tenants, rate, args.load_requests)
    warm = ServeEngine(store, width=width, cache_len=cache_len,
                       horizon=horizon, bucket_edges=args.bucket_edges,
                       device=args.device)
    warm.run(list(requests))          # the first run
    hot = warm.fresh_clone()
    for r in requests:
        hot.submit(r)
    step_wall, comps, depth = [], [], []
    _sync(hot.device)
    t0 = time.perf_counter()
    while hot.inflight > 0:
        s = time.perf_counter()
        comps.extend(hot.step())
        _sync(hot.device)
        step_wall.append(time.perf_counter() - s)
        depth.append(hot.queue_depth())
    total = time.perf_counter() - t0
    comps.sort(key=lambda c: c.rid)
    new_tokens = sum(len(c.tokens) for c in comps)
    lat = _token_latencies(comps, step_wall, horizon)
    wait = [c.admitted_tick - c.arrival for c in comps]
    point = {
        "rate": rate, "width": width, "tenants": n_tenants,
        "horizon": horizon, "requests": len(comps),
        "offered_tok_per_tick": rate * n_tenants * args.gen,
        "new_tokens": new_tokens, "wall_s": total,
        "tok_per_s": new_tokens / max(total, 1e-9),
        "p50_token_s": float(np.percentile(lat, 50)),
        "p99_token_s": float(np.percentile(lat, 99)),
        "mean_queue_depth": float(np.mean(depth)),
        "max_queue_depth": int(np.max(depth)),
        "p50_admit_wait_ticks": float(np.percentile(wait, 50)),
        "p99_admit_wait_ticks": float(np.percentile(wait, 99)),
    }
    print(f"load rate={rate:g}: {point['tok_per_s']:8.1f} tok/s, "
          f"p99 {point['p99_token_s'] * 1e3:.2f} ms, "
          f"queue mean {point['mean_queue_depth']:.1f} "
          f"max {point['max_queue_depth']}, "
          f"admit wait p99 {point['p99_admit_wait_ticks']:.0f} ticks",
          flush=True)
    return point


def check_failures(result, min_speedup: float):
    """The reference's ``--check`` gate on a sweep's result: the failed
    conditions' messages (empty when all hold)."""
    arms = result["arms"]
    failures = []
    if not all(a["parity_exact"] for a in arms):
        failures.append("served output != fixed-batch oracle "
                        "(bitwise contract broken)")
    batched = [a for a in arms
               if a["tenants"] >= 8 and a["width"] > 1
               and a["horizon"] > 1]
    if not batched:
        failures.append("no fused batched arm at >= 8 tenants to "
                        "check (widen --tenants/--widths)")
    for a in batched:
        if a["tok_per_s"] <= a["seq_tok_per_s"]:
            failures.append(
                f"engine does not beat sequential at W={a['width']} "
                f"T={a['tenants']}: {a['tok_per_s']:.1f} <= "
                f"{a['seq_tok_per_s']:.1f} tok/s")
    gate = [a for a in arms
            if a["width"] == 8 and a["tenants"] >= 8
            and a.get("speedup_vs_h1") is not None]
    if not gate:
        failures.append("no W=8, T>=8 fused arm for the horizon "
                        "gate (widen --widths/--tenants)")
    for a in gate:
        if a["speedup_vs_h1"] < min_speedup:
            failures.append(
                f"fused horizon {a['horizon']} only "
                f"x{a['speedup_vs_h1']:.2f} over horizon=1 at "
                f"W={a['width']} T={a['tenants']} "
                f"(need >= x{min_speedup:g})")
    return failures


def run(args):
    args.device = resolve_device(args.device)
    cfg = smoke_model_config()
    max_t = max(args.tenants)
    store = build_demo_store(cfg, cfg.name, max_t, seed=args.seed,
                             reduced=False, device=args.device)
    cache_len = args.prompt_len + args.gen

    if args.autotune:
        eng = ServeEngine(store, width=max(args.widths),
                          cache_len=cache_len, device=args.device)
        plan = eng.autotune(_requests(args, min(max_t, 8), args.stagger),
                            force=args.autotune == "force")
        print(f"serve plan: {plan}")
        if plan:
            args.horizon = plan["horizon"]
            args.bucket_edges = plan["bucket_edges"]

    result = {
        "widths": sorted(args.widths), "tenants": sorted(args.tenants),
        "prompt_len": args.prompt_len, "gen": args.gen,
        "stagger": args.stagger, "seed": args.seed, "smoke": args.smoke,
        "horizon": args.horizon, "arch": cfg.name,
        "device": (torch.cuda.get_device_name(args.device)
                   if args.device.type == "cuda" else "cpu"),
    }

    if args.load:
        print(f"trace-driven load sweep: trace {args.trace!r}, rates "
              f"{args.rates}, W={max(args.widths)} T={max_t}, "
              f"horizon {args.horizon}")
        result["load"] = [
            run_load_point(args, store, max(args.widths), max_t,
                           args.horizon, rate)
            for rate in args.rates
        ]
    else:
        print(f"serving sweep: widths {sorted(args.widths)} x tenants "
              f"{sorted(args.tenants)}, prompt {args.prompt_len} + gen "
              f"{args.gen}, stagger {args.stagger} ticks, fused horizon "
              f"{args.horizon}, on {result['device']}")
        arms, baselines = [], {}
        for t in sorted(args.tenants):
            baselines[t] = run_sequential(args, store, t)
            for w in sorted(args.widths):
                h1 = run_arm(args, store, w, t, 1, baselines[t])
                arms.append(h1)
                arms.append(run_arm(args, store, w, t, args.horizon,
                                    baselines[t], h1["tok_per_s"]))
        result["sequential"] = [baselines[t] for t in sorted(args.tenants)]
        result["arms"] = arms

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {args.out}")

    if args.check and not args.load:
        failures = check_failures(result, args.min_speedup)
        if failures:
            for msg in failures:
                print(f"CHECK FAILED: {msg}")
            raise SystemExit(1)
        print("all serving acceptance checks passed")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--widths", type=int, nargs="+", default=[2, 4, 8],
                    help="lane widths W to sweep")
    ap.add_argument("--tenants", type=int, nargs="+", default=[8, 16],
                    help="concurrent tenant counts T to sweep")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--stagger", type=int, default=2,
                    help="ticks between consecutive arrivals")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--horizon", type=int, default=8,
                    help="fused decode ticks per engine step")
    ap.add_argument("--bucket-edges", type=int, nargs="+", default=None,
                    help="prompt-length bucket edges for batch prefill")
    ap.add_argument("--min-speedup", type=float, default=1.5,
                    help="--check: required fused/h1 tok/s ratio at "
                         "the W=8, T>=8 grid point")
    ap.add_argument("--smoke", action="store_true",
                    help="seconds-long mode: one batched width, 8 "
                         "tenants, short generations")
    ap.add_argument("--nightly", action="store_true",
                    help="the full W x T grid at longer generations")
    ap.add_argument("--check", action="store_true",
                    help="exit nonzero unless every arm is bitwise "
                         "equal to its oracle, batched arms at >= 8 "
                         "tenants beat sequential, and the fused arm "
                         "beats horizon=1 by >= --min-speedup at W=8")
    ap.add_argument("--load", action="store_true",
                    help="trace-driven open-loop load sweep instead of "
                         "the W x T grid")
    ap.add_argument("--trace", default="poisson({rate})",
                    help="ArrivalTrace spec with a {rate} placeholder "
                         "(per-tenant requests/tick)")
    ap.add_argument("--rates", type=float, nargs="+",
                    default=[0.01, 0.03, 0.1],
                    help="--load: offered per-tenant request rates")
    ap.add_argument("--load-requests", type=int, default=32,
                    help="--load: requests per offered-load point")
    ap.add_argument("--autotune", nargs="?", const=True, default=False,
                    help="run the serve-plan autotuner first (pass "
                         "'force' to retune over a cached plan)")
    ap.add_argument("--device", default=None,
                    help="where the engine serves (default: the card)")
    ap.add_argument("--out", default="results/torch/BENCH_serving.json")
    args = ap.parse_args(argv)
    if args.smoke:
        # Decode-bound lengths: prefill costs the same in both arms, so
        # short generations understate the batching win.
        args.widths = [8]
        args.tenants = [8]
        args.gen = 48
    elif args.nightly:
        args.widths = [2, 4, 8]
        args.tenants = [8, 16]
        args.gen = 48
    return run(args)


if __name__ == "__main__":
    main()
