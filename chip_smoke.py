"""Chip smoke test of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py [--profile]

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version on the card, and drives the
port's two main paths through the entry points a user calls:

  * serving: full-width qwen1.5-0.5b to 4 tenants through the serving
    engine (``python -m repro_torch.launch.serve --no-reduced``), the
    path of the ``flash_decode`` kernel;
  * training: the paper's eager IFL round (Algorithm 1) at Table-II
    width, 4 heterogeneous clients, d_fusion 432, B 32, tau 10, lr 0.01,
    3 rounds each under ``int8_row`` and ``ef(int4)`` (``build_ifl`` +
    ``run_round``, as ``python -m repro_torch.launch.quickstart`` runs
    it), the path of the ``wire_encode`` / ``wire_encode_ef`` kernels.
    The one cut is the dataset: synthetic KMNIST at 4000 train / 1000
    test images instead of the paper's 60000 / 10000.

It checks each path's results, compares short runs on the card with the
same runs on the CPU, and times each kernel at the shapes its path gives
it. ``--profile`` adds a torch.profiler breakdown of one more warm
serving run and one more warm IFL round of each codec (device busy
share, top kernels and host ops); it is a diagnostic, not a check, and
is off by default. Every phase checks its result and raises on failure;
nothing is caught. It needs a card: without one (or without the
repo's ``src/`` beside it) it exits non-zero and prints no result.

The line before the last is a JSON object with one entry per kernel
(launches on the main path, error against the plain version, device
times and the least time the card could take); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16 FLOP/s and
# fp32 FLOP/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12

WIRE_SCHEMES = ("int8_row", "int4", "topk", "sketch")
# Tolerance of the wire kernels' float outputs against the plain version
# (values, sketch sums, scales, EF residual): both compute in fp32 with
# the same rounding, except the EF clip's two norms, which the kernel
# sums as a tree in the block.
WIRE_TOL = dict(rtol=1e-6, atol=1e-6)
# Card against CPU for the short IFL run: the same draws and init, but
# convolutions and products sum in other orders on the two devices, and
# a last-bit difference in z can flip an int4 code. One forced flip moves
# this run's losses by at most 3.5e-5 on the CPU
# (tests/test_torch_ifl.py::test_one_int4_code_flip_stays_within_chip_smoke_tolerance).
IFL_LOSS_TOL = 1e-4


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


def profile_run(label: str, run, top: int = 8) -> None:
    """Where the time of one warm run goes: wall time (with the profiler
    on), the device's busy share (the sum of its kernel and copy times
    over the wall time), the kernels that take the most device time and
    the ops that take the most host time. ``run`` is the work, a
    callable."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = prof.key_averages()
    # Device rows are the kernels and copies themselves; the aten rows
    # above them carry the same device time again.
    dev_rows = [r for r in rows if r.device_type == DeviceType.CUDA]
    busy = sum(r.self_device_time_total for r in dev_rows) / 1e6
    print(f"[profile {label}] warm run {wall:.3f}s wall, device busy "
          f"{busy:.3f}s ({100 * busy / wall:.1f}%, idle "
          f"{100 * (1 - busy / wall):.1f}%)")
    for where, key, rs in (("device", "self_device_time_total", dev_rows),
                           ("host", "self_cpu_time_total", rows)):
        for r in sorted(rs, key=lambda r: -getattr(r, key))[:top]:
            print(f"[profile {label} {where}] {getattr(r, key) / 1e3:9.1f} ms "
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


def wire_inputs(rows, d, seed, scale=2.0):
    """Fusion-output-like rows on the card: normal values, an all-zero
    row, dead-ReLU zeros and ties in |z|."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    z = torch.randn((rows, d), generator=gen, device="cuda") * scale
    z[min(3, rows - 1)] = 0.0
    z[0, : d // 3] = 0.0
    z[1 % rows, [5, 40, 77]] = torch.tensor([3.5, -3.5, 3.5], device="cuda")
    return z


def payload_err(got, want, label) -> float:
    """Integer leaves bitwise; float leaves within WIRE_TOL -> max |err|."""
    check(sorted(got) == sorted(want), f"{label}: leaves {sorted(got)}")
    err = 0.0
    for name, b in want.items():
        a = got[name]
        check(a.dtype == b.dtype and a.shape == b.shape,
              f"{label}/{name}: {a.dtype}{tuple(a.shape)} vs "
              f"{b.dtype}{tuple(b.shape)}")
        if a.dtype.is_floating_point:
            torch.testing.assert_close(a, b, **WIRE_TOL)
            err = max(err, float((a - b).abs().max()))
        else:
            check(torch.equal(a, b), f"{label}/{name}: codes differ")
    return err


def wire_checks(ops, ref, get_codec):
    """Each wire kernel against its plain version on the card, for every
    scheme at the path's (32, 432), an odd d and a (4096, 432) block,
    with a zero row; EF over 4 chained steps, each fed the plain e."""
    errs = {"wire_encode": 0.0, "wire_encode_ef": 0.0}
    for scheme in WIRE_SCHEMES:
        codec, ef = get_codec(scheme), get_codec(f"ef({scheme})")
        for rows, d in ((32, 432), (32, 433), (4096, 432)):
            z = wire_inputs(rows, d, seed=rows + d)
            got = ops.wire_encode(z, codec)
            want = ref.wire_encode_ref(z, codec)
            torch.cuda.synchronize()
            errs["wire_encode"] = max(errs["wire_encode"], payload_err(
                got, want, f"wire_encode {scheme} ({rows},{d})"))
            e = torch.zeros_like(z)
            for t in range(4):
                z = wire_inputs(rows, d, seed=10 * t + d, scale=1.0 + t)
                got, e_got = ops.wire_encode_ef(z, e, ef)
                want, e_want = ref.wire_encode_ef_ref(z, e, ef)
                torch.cuda.synchronize()
                label = f"wire_encode_ef {scheme} ({rows},{d}) step {t}"
                err = payload_err(got, want, label)
                torch.testing.assert_close(e_got, e_want, **WIRE_TOL)
                errs["wire_encode_ef"] = max(
                    errs["wire_encode_ef"], err,
                    float((e_got - e_want).abs().max()))
                e = e_want
    return errs


def wire_times(ops, ref, get_codec, rows, d=432):
    """Device times of each wire kernel and its plain version at (rows,
    d), per scheme, with the byte bound; 64 input sets per graph."""
    out = {}
    for scheme in WIRE_SCHEMES:
        codec, ef = get_codec(scheme), get_codec(f"ef({scheme})")
        zs = [wire_inputs(rows, d, seed=1000 + i) for i in range(64)]
        es = [0.1 * wire_inputs(rows, d, seed=2000 + i) for i in range(64)]
        sch = ops.scheme_for(codec, d)
        logd = math.log2(d)
        per_elt = {"int8_row": 8, "int4": 8, "topk": 2 + logd, "sketch": 3}
        for kname, kern, plain in (
                ("wire_encode", lambda z, e: ops.wire_encode(z, codec),
                 lambda z, e: ref.wire_encode_ref(z, codec)),
                ("wire_encode_ef", lambda z, e: ops.wire_encode_ef(z, e, ef),
                 lambda z, e: ref.wire_encode_ef_ref(z, e, ef))):
            is_ef = kname == "wire_encode_ef"
            k_ms = graph_time_ms([lambda z=z, e=e: kern(z, e)
                                  for z, e in zip(zs, es)])
            p_ms = graph_time_ms([lambda z=z, e=e: plain(z, e)
                                  for z, e in zip(zs, es)])
            nbytes = ops.wire_bytes_moved(sch, rows, ef=is_ef)
            flops = rows * d * (per_elt[scheme] + (7 if is_ef else 0))
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = flops / FP32_FLOPS * 1e3
            out[(kname, scheme)] = dict(
                ms=k_ms, plain_ms=p_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                nbytes=nbytes)
            print(f"[time] {kname} {scheme} at ({rows},{d}): kernel "
                  f"{k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us, bound "
                  f"{max(bytes_ms, ops_ms) * 1e3:.4f} us ({nbytes} bytes)",
                  flush=True)
    return out


def reset_counts(ops) -> None:
    for fn in (ops.flash_decode, ops.wire_encode, ops.wire_encode_ef):
        fn.launches = 0


def ifl_run(codec, rounds, *, device, tau=10, participation="full",
            report=True):
    """Drive the eager IFL path as the quickstart does: ``build_ifl`` over
    4 heterogeneous Table-II clients, then ``run_round`` x ``rounds``, on
    synthetic KMNIST cut to 4000 train / 1000 test images.
    Returns (trainer, spec, per-round wall seconds, data)."""
    from repro_torch.api import DataSpec, ExperimentSpec, build_ifl, load_data

    spec = ExperimentSpec(scheme="ifl", rounds=rounds, tau=tau, lr=0.01,
                          batch_size=32, d_fusion=432, codec=codec,
                          participation=participation, seed=0,
                          data=DataSpec(n_train=4000, n_test=1000))
    data = load_data(spec)
    trainer = build_ifl(spec, data, device=device)
    walls = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        rep = trainer.run_round()
        if trainer.device.type == "cuda":
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if report:
            print(f"[ifl {codec} {device}] round {rep.round}: base_loss "
                  f"{rep['base_loss']:.5f} mod_loss {rep['mod_loss']:.5f} "
                  f"participants {rep.participants} bytes "
                  f"{trainer.ledger.per_round[-1]} wall "
                  f"{walls[-1] * 1e3:.1f} ms", flush=True)
    return trainer, spec, walls, data


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one more warm serving run and one more "
                         "warm IFL round of each codec")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        sys.exit(2)

    from repro_torch.configs import get_config
    from repro_torch.core.codec import get_codec
    from repro_torch.kernels import build, ops, ref
    from repro_torch.launch.serve import build_demo_store, demo_requests
    from repro_torch.launch.quickstart import round_bytes_match
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
    wire_err = wire_checks(ops, ref, get_codec)
    print(f"[kernel] wire_encode / wire_encode_ef vs plain, schemes "
          f"{WIRE_SCHEMES} at (32,432), (32,433), (4096,432) with a zero "
          f"row, EF over 4 chained steps: codes, nibbles and indices "
          f"bitwise; float leaves and e' max|err| "
          f"{wire_err['wire_encode']:.3e} / {wire_err['wire_encode_ef']:.3e}",
          flush=True)

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
    reset_counts(ops)
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
        clone = engine.fresh_clone()
        profile_run("serve", lambda: clone.run(reqs))
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

    # -- 4c. the eager IFL round at Table-II width (the second main path) --
    ifl_launches = {}
    for codec, kern in (("int8_row", "wire_encode"),
                        ("ef(int4)", "wire_encode_ef")):
        reset_counts(ops)
        trainer, spec, walls, data = ifl_run(codec, 3, device="cuda")
        counts = {"wire_encode": ops.wire_encode.launches,
                  "wire_encode_ef": ops.wire_encode_ef.launches,
                  "flash_decode": ops.flash_decode.launches}
        n_part = sum(len(r.participants) for r in trainer.engine.history)
        check(counts[kern] == n_part and n_part > 0,
              f"ifl {codec}: {kern} launches {counts[kern]} != "
              f"{n_part} participants over the rounds")
        check(all(v == 0 for k, v in counts.items() if k != kern),
              f"ifl {codec}: other kernels launched {counts}")
        check(round_bytes_match(trainer, spec),
              f"ifl {codec}: measured bytes {trainer.ledger.per_round} != "
              f"analytic ifl_round_bytes in some round")
        for rep in trainer.engine.history:
            check(np.isfinite(rep["base_loss"]) and np.isfinite(
                rep["mod_loss"]), f"ifl {codec}: non-finite loss")
        accs = trainer.evaluate(data.test_x, data.test_y)
        check(all(0.0 <= a <= 1.0 for a in accs), f"accuracies {accs}")
        ifl_launches[kern] = counts[kern]
        if args.profile:
            profile_run(f"ifl {codec}", trainer.run_round)
        print(f"[ifl] {codec}: 3 rounds at Table-II width (4 clients, "
              f"d_fusion 432, B 32, tau 10, lr 0.01; dataset cut to 4000 "
              f"train / 1000 test); {kern} launches {counts[kern]} == "
              f"{n_part} participants; measured == analytic bytes every "
              f"round; losses finite; wall per round (ms) "
              f"{[round(w * 1e3, 1) for w in walls]}; accuracies "
              f"{[round(a, 3) for a in accs]}", flush=True)
        del trainer

    # -- 4d. the same short IFL run on the card and on the CPU ------------
    runs = {dev: ifl_run("ef(int4)", 2, device=dev, tau=2,
                         participation="k2", report=False)[0]
            for dev in ("cpu", "cuda")}
    h_cpu, h_gpu = runs["cpu"].engine.history, runs["cuda"].engine.history
    check([r.participants for r in h_gpu] == [r.participants for r in h_cpu],
          "card vs CPU: participants differ")
    check(runs["cuda"].ledger.per_round == runs["cpu"].ledger.per_round,
          "card vs CPU: ledger bytes differ")
    loss_err = max(abs(a[k] - b[k]) for a, b in zip(h_gpu, h_cpu)
                   for k in ("base_loss", "mod_loss"))
    check(loss_err <= IFL_LOSS_TOL,
          f"card vs CPU: losses differ by {loss_err} > {IFL_LOSS_TOL}")
    print(f"[ifl] card vs CPU, ef(int4), 2 rounds, tau 2, k2, same init: "
          f"participants {[r.participants for r in h_gpu]} and bytes "
          f"{runs['cuda'].ledger.per_round} equal; losses max|card - cpu| "
          f"{loss_err:.2e} (tolerance {IFL_LOSS_TOL})", flush=True)
    del runs

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

    wire_t = {}
    for rows in (32, 4096):
        wire_t[rows] = wire_times(ops, ref, get_codec, rows)

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
    # The IFL path's codecs at its shape (32, 432): int8_row through
    # wire_encode, ef(int4) through wire_encode_ef.
    for kname, scheme in (("wire_encode", "int8_row"),
                          ("wire_encode_ef", "int4")):
        t = wire_t[32][(kname, scheme)]
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/wire_encode.cu",
            "replaces": ("src/repro/kernels/wire_fused.py:370"
                         if kname == "wire_encode"
                         else "src/repro/kernels/wire_fused.py:389"),
            "launches": ifl_launches[kname],
            "max_abs_err": wire_err[kname],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": None,
        })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
