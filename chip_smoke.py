"""Chip smoke test of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py [--profile]

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version on the card, serves
full-width qwen1.5-0.5b to 4 tenants through the port's serving engine
(the path a user runs with ``python -m repro_torch.launch.serve
--no-reduced``), checks the served streams, and times each kernel at the
shapes that path gives it. ``--profile`` adds a torch.profiler breakdown
of one more warm serving run (device busy share, top kernels and host
ops); it is a diagnostic, not a check, and is off by default. Every phase checks its result and raises on
failure; nothing is caught. It needs a card: without one (or without the
repo's ``src/`` beside it) it exits non-zero and prints no result.

The line before the last is a JSON object with one entry per kernel
(launches on the main path, error against the plain version, device
times and the least time the card could take); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and dense bf16 FLOP/s.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip smoke failed: {msg}")


def graph_time_ms(calls, reps: int = 50) -> float:
    """Device time of one call, in ms. The calls are captured once into a
    CUDA graph, so they run back to back with no host launch gaps; the
    graph is replayed ``reps`` times, each replay timed with CUDA events;
    the median replay is divided by the number of calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture stream
        for c in calls:
            c()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for c in calls:
            c()
    for _ in range(3):
        graph.replay()
    marks = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        marks.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in marks) / len(calls)


def profile_run(engine, reqs, top: int = 8) -> None:
    """Where the time of one warm serving run goes: wall time (with
    the profiler on), the device's busy share (the sum of its kernel and
    copy times over the wall time), the kernels that take the most
    device time and the ops that take the most host time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        engine.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = prof.key_averages()
    # Device rows are the kernels and copies themselves; the aten rows
    # above them carry the same device time again.
    dev_rows = [r for r in rows if r.device_type == DeviceType.CUDA]
    busy = sum(r.self_device_time_total for r in dev_rows) / 1e6
    print(f"[profile] warm run {wall:.3f}s wall, device busy {busy:.3f}s "
          f"({100 * busy / wall:.1f}%, idle {100 * (1 - busy / wall):.1f}%)")
    for label, key, rs in (("device", "self_device_time_total", dev_rows),
                           ("host", "self_cpu_time_total", rows)):
        for r in sorted(rs, key=lambda r: -getattr(r, key))[:top]:
            print(f"[profile {label}] {getattr(r, key) / 1e3:9.1f} ms "
                  f"{r.count:7d}x {r.key[:90]}")


def decode_inputs(gen, B, L, KVH, G, hd, dtype, lengths):
    """Random q/k/v on the card and a decode-like validity mask: row b
    has its first lengths[b] cache rows live (0 = fully masked)."""
    dev = "cuda"
    q = torch.randn((B, 1, KVH, G, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, L, KVH, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, L, KVH, hd), generator=gen, device=dev).to(dtype)
    valid = (torch.arange(L, device=dev)[None, :]
             < torch.tensor(lengths, device=dev)[:, None])
    return q, k, v, valid


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one more warm serving run")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        sys.exit(2)

    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops, ref
    from repro_torch.launch.serve import build_demo_store, demo_requests
    from repro_torch.models.modules import tree_map
    from repro_torch.models.transformer import (
        composed_decode_step,
        init_composed_cache,
    )
    from repro_torch.serve import ServeEngine

    # -- 1. the card ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"[build] {sorted(libs)} in {time.perf_counter() - t0:.1f}s",
          flush=True)
    for name, path in libs.items():
        log = path.with_suffix(".log")
        lines = log.read_text().splitlines() if log.exists() else []
        regs = [int(x.split("Used ")[1].split()[0]) for x in lines
                if "Used " in x]
        spills = [x.strip() for x in lines
                  if "spill" in x and "0 bytes spill stores" not in x]
        print(f"[ptxas {name}] {len(regs)} instantiations, registers "
              f"{min(regs, default=0)}..{max(regs, default=0)}, "
              f"{len(spills)} spilling: {spills}")

    # -- 3. kernel vs plain on the card -----------------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, L, KVH, G, hd = 4, 64, 16, 1, 64   # the slice: W = 4, cache 64
    slice_in = decode_inputs(gen, B, L, KVH, G, hd, torch.bfloat16,
                             [64, 40, 33, 17])
    got = ops.cached_attn_decode(*slice_in)
    want = ref.cached_attn_decode_ref(*slice_in)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want)  # bf16 defaults
    err_bf16 = float((got.float() - want.float()).abs().max())
    gqa_in = decode_inputs(gen, 3, 40, 2, 4, 128, torch.float32, [40, 7, 0])
    got = ops.cached_attn_decode(*gqa_in)
    want = ref.cached_attn_decode_ref(*gqa_in)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    check(bool(torch.all(got[2] == 0)), "fully masked row is not zero")
    err_fp32 = float((got - want).abs().max())
    print(f"[kernel] flash_decode vs plain: bf16 (B={B} L={L} KVH={KVH} "
          f"G={G} hd={hd}) max|err| {err_bf16:.3e}; fp32 GQA (G=4 hd=128 "
          f"L=40, masked row) max|err| {err_fp32:.3e}", flush=True)

    # -- 4. full-width serve (the main path) ------------------------------
    arch = "qwen1.5-0.5b"
    cfg = get_config(arch)
    t0 = time.perf_counter()
    store = build_demo_store(cfg, arch, 4, seed=0, reduced=False,
                             device="cuda")
    engine = ServeEngine(store, width=4, cache_len=64, horizon=8,
                         device="cuda")
    reqs = demo_requests(cfg, 4, prompt_len=32, gen=32, stagger=2, seed=0)
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name} full width ({cfg.num_layers} layers, d "
          f"{cfg.d_model}, vocab {cfg.vocab_size}, {cfg.compute_dtype}): "
          f"store of 4 tenants built in {time.perf_counter() - t0:.1f}s",
          flush=True)
    ops.flash_decode.launches = 0
    t0 = time.perf_counter()
    comps = engine.run(reqs)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = ops.flash_decode.launches
    steps = sum(lane.composed_steps for lane in engine.lanes())
    check(launches == cfg.num_layers * steps,
          f"flash_decode launches {launches} != {cfg.num_layers} layers x "
          f"{steps} composed steps")
    check(len(comps) == 4 and all(len(c.tokens) == 32 for c in comps),
          "not every request completed with 32 tokens")
    check(all(0 <= t < cfg.vocab_size for c in comps for t in c.tokens),
          "token out of vocab")
    for r, c in zip(reqs, comps):
        check(engine.oracle(r).tokens == c.tokens,
              f"request {r.rid}: served != oracle")
    warm = engine.fresh_clone()
    t0 = time.perf_counter()
    warm_comps = warm.run(reqs)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    check([c.tokens for c in warm_comps] == [c.tokens for c in comps],
          "warm run differs from the first")
    n_tok = sum(len(c.tokens) for c in comps)
    print(f"[serve] 4 requests x 32 tokens, engine == oracle bitwise; "
          f"{steps} composed steps, {launches} flash_decode launches "
          f"({launches // steps} per step); first run {cold_s:.2f}s, warm run "
          f"{warm_s:.3f}s = {n_tok / warm_s:.1f} tok/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB", flush=True)
    print(f"[serve] tenant0 tokens {comps[0].tokens[:12]}", flush=True)
    if args.profile:
        profile_run(engine.fresh_clone(), reqs)
    del engine, warm, store

    # -- 4b. the card against the CPU on the reduced config (fp32) --------
    small = cfg.reduced()
    cpu_store = build_demo_store(small, arch, 3, seed=1, reduced=True,
                                 device="cpu")
    small_reqs = demo_requests(small, 3, prompt_len=12, gen=10, stagger=1,
                               seed=1)
    streams = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(cpu_store, width=2, cache_len=32, horizon=4,
                          device=dev)
        streams[dev] = [c.tokens for c in eng.run(small_reqs)]
    check(streams["cuda"] == streams["cpu"],
          f"reduced config: card streams {streams['cuda']} != CPU "
          f"{streams['cpu']}")
    e0 = cpu_store.entry("tenant0")
    logits = {}
    for dev in ("cpu", "cuda"):
        base = tree_map(lambda a: a.to(dev), e0.base)
        mod = tree_map(lambda a: a.to(dev), cpu_store.modular(e0.arch))
        cache = init_composed_cache(small, small, 2, 16, device=dev)
        tok = torch.tensor([[3], [5]], device=dev)
        for t in range(4):
            out, cache = composed_decode_step(
                base, small, mod, small, cache, tok,
                torch.full((2,), t, device=dev))
        logits[dev] = out.cpu()
    lerr = float((logits["cuda"] - logits["cpu"]).abs().max())
    check(bool(torch.isfinite(logits["cuda"]).all()) and lerr <= 1e-4,
          f"reduced config: card logits differ from CPU by {lerr}")
    print(f"[serve] reduced {small.name} fp32: card streams == CPU streams; "
          f"logits max|card - cpu| {lerr:.2e}", flush=True)

    # -- 5. times at the slice's shape ------------------------------------
    # 64 independent input sets (~1 MB of K/V each) cycle through the
    # 50 MB L2, as the cache of each layer arrives cold in a decode step.
    lengths = [64, 40, 33, 17]
    sets = [decode_inputs(gen, B, L, KVH, G, hd, torch.bfloat16, lengths)
            for _ in range(64)]
    kernel_ms = graph_time_ms(
        [lambda s=s: ops.cached_attn_decode(*s) for s in sets])
    plain_ms = graph_time_ms(
        [lambda s=s: ref.cached_attn_decode_ref(*s) for s in sets])
    sdpa = []
    for q, k, v, valid in sets:
        sdpa.append((q.reshape(B, KVH * G, 1, hd), k.transpose(1, 2),
                     v.transpose(1, 2), valid[:, None, None, :]))
    library_ms = graph_time_ms(
        [lambda a=a: torch.nn.functional.scaled_dot_product_attention(
            a[0], a[1], a[2], attn_mask=a[3]) for a in sdpa])
    # The least work this data needs: masked cache rows cannot change the
    # output, so only the live rows of K and V count.
    live = int(sets[0][3].sum())
    esz = 2  # bf16
    nbytes = (2 * live * KVH * hd * esz       # live K and V rows, read once
              + 2 * B * KVH * G * hd * esz    # q in, out
              + B * L)                        # valid
    flops = 4 * live * KVH * G * hd           # q.k and p.v
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"[time] flash_decode at B={B} L={L} KVH={KVH} G={G} hd={hd} bf16: "
          f"kernel {kernel_ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, "
          f"sdpa {library_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.3f} us "
          f"({nbytes} bytes, {live} of {B * L} cache rows live); {cfg.num_layers} launches per composed step",
          flush=True)

    kernels = [{
        "name": "flash_decode",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_attention.py:121",
        "launches": launches,
        "max_abs_err": err_bf16,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    }]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
