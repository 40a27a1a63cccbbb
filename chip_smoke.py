"""Chip smoke test of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py [--profile]

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version on the card, and drives the
port's main paths through the entry points a user calls:

  * serving: full-width qwen1.5-0.5b to 4 tenants through the serving
    engine (``python -m repro_torch.launch.serve --no-reduced``), the
    path of the ``flash_decode`` kernel;
  * training: the paper's eager IFL round (Algorithm 1) at Table-II
    width, 4 heterogeneous clients, d_fusion 432, B 32, tau 10, lr 0.01,
    3 rounds each under ``int8_row`` and ``ef(int4)`` (``build_ifl`` +
    ``run_round``, as ``python -m repro_torch.launch.quickstart`` runs
    it), the path of the ``wire_encode`` / ``wire_encode_ef`` kernels.
    The one cut is the dataset: synthetic KMNIST at 4000 train / 1000
    test images instead of the paper's 60000 / 10000;
  * LM training: IFL on full-width qwen1.5-0.5b, 4 clients, tau 2, B 2,
    S 512, 3 rounds, through ``python -m repro_torch.launch.train --arch
    qwen1.5-0.5b --mode ifl``, and 3 steps of ``--mode dp``, the path of
    the ``flash_attention`` / ``flash_attention_bwd`` kernels;
  * the fused wire path at the client boundary: Table-II clients 2, 3
    and 4 at B 32 on synthetic KMNIST run their base block up to the
    fusion FC, then ``ops.fusion_proj_encode`` (and, under int8_row,
    ``ops.fusion_proj_quant``) under int8_row and ef(int4); every payload
    goes through ``ops.decode_proj`` into each modular block's first FC
    and through the rest of the block by ``ops.fusion_proj``, the path
    of the ``fusion_proj`` / ``fusion_proj_quant`` /
    ``fusion_proj_encode`` / ``decode_proj`` kernels.

It checks each path's results, compares short runs on the card with the
same runs on the CPU, and times each kernel at the shapes its path gives
it. ``--profile`` adds a torch.profiler breakdown of one more warm
serving run, one more warm IFL round of each codec and one more warm
LM IFL round (device busy share, top kernels and host ops); it is a diagnostic, not a check, and
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
# What "agree" means for two payloads of one codec (numpy only), shared
# with the tests.
sys.path.insert(0, str(ROOT / "tests"))

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


# Flash attention against its plain version: (B, S, H, KVH, hd, window).
# The LM path's shape first; then hd 128 with GQA (G 2), a partial last
# tile (S 200) and a sliding window (48).
ATTN_CASES = [(2, 512, 16, 16, 64, -1), (2, 256, 8, 4, 128, -1),
              (2, 200, 16, 16, 64, -1), (2, 512, 16, 16, 64, 48)]
# Tolerance, as max |kernel - plain| over max(1, max |plain|): fp32 sums
# in another order; in bf16 the kernel rounds the unnormalized p of its
# online softmax to bf16 where the plain version rounds the normalized
# p, and the outputs are rounded to bf16.
ATTN_TOL = {torch.float32: {"fwd": 2e-5, "bwd": 1e-4},
            torch.bfloat16: {"fwd": 2e-2, "bwd": 3e-2}}


def attn_inputs(B, S, H, KVH, hd, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, S, KVH, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, S, KVH, hd), generator=gen, device="cuda").to(dtype)
    do = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dtype)
    return q, k, v, do


def rel_err(got, want) -> float:
    want = want.float()
    return float((got.float() - want).abs().max()
                 / max(1.0, float(want.abs().max())))


def attn_lse_ref(q, k, window):
    """Each row's softmax logsumexp, in fp32, from the plain scores."""
    B, S, H, hd = q.shape
    kf = k.float().repeat_interleave(H // k.shape[2], dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / math.sqrt(hd)
    i = torch.arange(S, device=q.device)
    mask = i[None, :] <= i[:, None]
    if window > 0:
        mask &= i[None, :] > i[:, None] - window
    return torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)


def attn_checks(ops, ref):
    """Both attention kernels against their plain versions at every case
    of ATTN_CASES in fp32 and bf16 -> max |err| of each kernel at the
    path's case (bf16, its dtype) and over all cases (relative)."""
    errs = {"path": {}, "all": {"fwd": 0.0, "bwd": 0.0}}
    for B, S, H, KVH, hd, window in ATTN_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = attn_inputs(B, S, H, KVH, hd, dtype, seed=S + hd)
            o, lse = ops.flash_attention_fwd(q, k, v, window=window)
            grads = ops.flash_attention_bwd(q, k, v, o, lse, do,
                                            window=window)
            o_ref = ref.flash_attention_ref(q, k, v, window=window)
            g_ref = ref.flash_attention_bwd_ref(q, k, v, do, window=window)
            torch.cuda.synchronize()
            label = (f"B {B} S {S} H {H} KVH {KVH} hd {hd} window {window} "
                     f"{str(dtype)[6:]}")
            tol = ATTN_TOL[dtype]
            fwd = rel_err(o, o_ref)
            lse_err = float((lse - attn_lse_ref(q, k, window)).abs().max())
            bwd = max(rel_err(a, b) for a, b in zip(grads, g_ref))
            check(all(g.dtype == dtype for g in grads), f"{label}: dtypes")
            check(fwd <= tol["fwd"] and lse_err <= 1e-4,
                  f"flash_attention {label}: err {fwd:.3e}, lse {lse_err:.3e}")
            check(bwd <= tol["bwd"], f"flash_attention_bwd {label}: err "
                  f"{bwd:.3e} > {tol['bwd']}")
            print(f"[kernel] attention {label}: fwd {fwd:.3e} (lse "
                  f"{lse_err:.3e}), bwd dq/dk/dv {bwd:.3e} (relative "
                  f"max|err|)", flush=True)
            errs["all"]["fwd"] = max(errs["all"]["fwd"], fwd)
            errs["all"]["bwd"] = max(errs["all"]["bwd"], bwd)
            if (B, S, H, KVH, hd, window) == ATTN_CASES[0] and \
                    dtype == torch.bfloat16:
                errs["path"] = {
                    "fwd": float((o.float() - o_ref.float()).abs().max()),
                    "bwd": max(float((a.float() - b.float()).abs().max())
                               for a, b in zip(grads, g_ref))}
    return errs


def event_time_ms(fn, reps: int = 20) -> float:
    """Device time of one eager call, in ms: ``reps`` calls back to back
    between two CUDA events (for calls through autograd, which the
    graph timer does not capture)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def attn_times(ops, ref):
    """Forward and backward times at the LM path's shape (bf16, causal):
    kernel, plain version, SDPA (``is_causal=True``) and the bound.
    Forwards are graph-replayed (16 input sets, ~8 MB each, so K/V come
    from HBM as in the model); backwards are timed eagerly with events
    (the plain and SDPA backwards run through autograd), each the
    backward alone on a forward done once."""
    B, S, H, KVH, hd, window = ATTN_CASES[0]
    sets = [attn_inputs(B, S, H, KVH, hd, torch.bfloat16, seed=100 + i)
            for i in range(16)]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t = {}
    t["fwd"] = graph_time_ms([lambda s=s: ops.flash_attention_fwd(
        s[0], s[1], s[2], window=window) for s in sets])
    t["fwd_plain"] = graph_time_ms([lambda s=s: ref.flash_attention_ref(
        s[0], s[1], s[2], window=window) for s in sets])
    bhsd = [tuple(x.transpose(1, 2) for x in s) for s in sets]
    t["fwd_sdpa"] = graph_time_ms([lambda a=a: sdpa(a[0], a[1], a[2],
                                                    is_causal=True)
                                   for a in bhsd])
    q, k, v, do = sets[0]
    o, lse = ops.flash_attention_fwd(q, k, v, window=window)
    t["bwd"] = event_time_ms(lambda: ops.flash_attention_bwd(
        q, k, v, o, lse, do, window=window))
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    o_ref = ref.flash_attention_ref(*leaves, window=window)
    t["bwd_plain"] = event_time_ms(lambda: torch.autograd.grad(
        o_ref, leaves, do, retain_graph=True))
    # SDPA in its own (B, H, S, hd) layout, contiguous.
    leaves_t = [x.transpose(1, 2).contiguous().requires_grad_() for x in
                (q, k, v)]
    do_t = do.transpose(1, 2).contiguous()
    o_sdpa = sdpa(*leaves_t, is_causal=True)
    t["bwd_sdpa"] = event_time_ms(lambda: torch.autograd.grad(
        o_sdpa, leaves_t, do_t, retain_graph=True))
    # The least work these inputs need: every (query, key) pair the mask
    # keeps, and each tensor moved once.
    pairs = S * (S + 1) // 2
    elt = B * S * H * hd * 2                 # one (B, S, H, hd) bf16 tensor
    kv = B * S * KVH * hd * 2
    lse_b = B * H * S * 4
    bytes_fwd = 2 * elt + 2 * kv + lse_b     # q, k, v in; o, lse out
    bytes_bwd = 4 * elt + 4 * kv + lse_b     # q, k, v, o, dO, lse in; dq, dk, dv out
    flops_fwd = 4 * B * H * hd * pairs       # q.k and p.v
    flops_bwd = 10 * B * H * hd * pairs      # q.k, dO.v, p^T dO, ds^T q, ds k
    for key, nb, fl in (("fwd", bytes_fwd, flops_fwd),
                        ("bwd", bytes_bwd, flops_bwd)):
        b_ms = nb / HBM_BYTES_PER_S * 1e3
        o_ms = fl / BF16_FLOPS * 1e3
        t[key + "_bound"] = max(b_ms, o_ms)
        t[key + "_bound_by"] = "bytes" if b_ms >= o_ms else "operations"
        print(f"[time] flash_attention {key} at B {B} S {S} H {H} hd {hd} "
              f"bf16 causal: kernel {t[key] * 1e3:.2f} us, plain "
              f"{t[key + '_plain'] * 1e3:.2f} us, sdpa "
              f"{t[key + '_sdpa'] * 1e3:.2f} us, bound "
              f"{t[key + '_bound'] * 1e3:.3f} us ({nb} bytes, {fl} flops)",
              flush=True)
    return t


def expected_attn_launches(cfg, *, steps_full, steps_mod, fwd_only):
    """Attention launches the code makes: each differentiated pass over a
    layer runs the forward kernel, again under remat (the backward
    recomputes the checkpointed forward), and the backward kernel once.
    ``steps_full``: passes through all layers with autograd;
    ``steps_mod``: through the modular layers only; ``fwd_only``: base
    forwards without autograd."""
    _, bp, bg, mp, mg = cfg._resolved_program()
    lb, lm = len(bp) * bg, len(mp) * mg
    recompute = 2 if cfg.remat in ("group", "layer") else 1
    fwd = (recompute * (steps_full * (lb + lm) + steps_mod * lm)
           + fwd_only * lb)
    bwd = steps_full * (lb + lm) + steps_mod * lm
    return fwd, bwd


def counted(ops):
    return (ops.flash_decode, ops.wire_encode, ops.wire_encode_ef,
            ops.flash_attention, ops.flash_attention_bwd, ops.fusion_proj,
            ops.fusion_proj_quant, ops.fusion_proj_encode, ops.decode_proj)


def reset_counts(ops) -> None:
    for fn in counted(ops):
        fn.launches = 0


def launch_counts(ops):
    return {fn.__name__: fn.launches for fn in counted(ops)}


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


LM_RUN = dict(arch="qwen1.5-0.5b", rounds=3, tau=2, n_clients=4, batch=2,
              seq=512)


def lm_train_phase(train_cli, ops, cfg, profile):
    """Drive full-width LM IFL and DP through ``launch.train.main`` as a
    user calls it, with the counts set to 0 just before each run; check
    launches against the count the code makes, losses and ledger bytes.
    Returns the IFL run's launches."""
    import tempfile

    r = LM_RUN
    n, tau, b, s = r["n_clients"], r["tau"], r["batch"], r["seq"]
    with tempfile.TemporaryDirectory() as out_dir:
        argv = ["--arch", r["arch"], "--mode", "ifl", "--rounds",
                str(r["rounds"]), "--tau", str(tau), "--n-clients", str(n),
                "--batch", str(b), "--seq", str(s), "--out", out_dir]
        torch.cuda.reset_peak_memory_stats()
        reset_counts(ops)
        t0 = time.perf_counter()
        out = train_cli.main(argv)
        total_s = time.perf_counter() - t0
        got = launch_counts(ops)
        fwd, bwd = expected_attn_launches(
            cfg, steps_full=r["rounds"] * n * tau,
            steps_mod=r["rounds"] * n * n, fwd_only=r["rounds"] * n)
        check(got["flash_attention"] == fwd
              and got["flash_attention_bwd"] == bwd,
              f"lm ifl: attention launches {got} != fwd {fwd}, bwd {bwd}")
        check(got["flash_decode"] == got["wire_encode"] ==
              got["wire_encode_ef"] == 0, f"lm ifl: other kernels {got}")
        for rec in out["history"]:
            check(np.isfinite(rec["base_loss"]) and
                  np.isfinite(rec["mod_loss"]), f"lm ifl: loss {rec}")
        # The reference's analytic ledger (train/loop.py:85-96): bf16 z
        # plus int32 tokens per client up, every entry to every client.
        up = n * (b * s * cfg.d_fusion * 2 + b * s * 4)
        check(out["ledger"].per_round ==
              [{"up": up, "down": n * up}] * r["rounds"],
              f"lm ifl: ledger {out['ledger'].per_round}")
        hist = json.loads((Path(out_dir) / f"{cfg.name}__ifl.json")
                          .read_text())
        check(hist == out["history"], "lm ifl: written history differs")
        walls = out["walls"]
        tokens = n * (tau + 1) * b * s
        warm = walls[1:]
        # The round's tokens come from the reference's numpy stream on the
        # host, inside each round's wall: time one round's draw alone.
        from repro_torch.data.synthetic import SyntheticLM
        from repro_torch.train.loop import _ifl_batch

        t0 = time.perf_counter()
        _ifl_batch(SyntheticLM(cfg.vocab_size, seed=0), cfg, n, tau, b, s,
                   r["rounds"], device="cpu")
        draw_s = time.perf_counter() - t0
        print(f"[lm ifl] {cfg.name} full width ({cfg.num_layers} layers, "
              f"{cfg.compute_dtype}, remat {cfg.remat}), N {n}, tau {tau}, "
              f"B {b}, S {s}: losses "
              f"{[(round(h['base_loss'], 4), round(h['mod_loss'], 4)) for h in out['history']]}; "
              f"attention launches fwd {fwd} bwd {bwd} == derived; ledger "
              f"== analytic ({up} B up a round); wall per round (s) "
              f"{[round(w, 3) for w in walls]}, warm mean "
              f"{statistics.mean(warm):.3f} s = "
              f"{tokens / statistics.mean(warm):.0f} tokens/s ({tokens} "
              f"tokens drawn a round; drawing them on the host alone takes "
              f"{draw_s:.3f} s); CLI total {total_s:.1f}s; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB",
              flush=True)
        launches = {k: got[k] for k in ("flash_attention",
                                        "flash_attention_bwd")}
        del out
        if profile:
            profile_lm_round(cfg, n, tau, b, s)

        steps = 3
        reset_counts(ops)
        out = train_cli.main(["--arch", r["arch"], "--mode", "dp",
                              "--rounds", str(steps), "--batch", str(b),
                              "--seq", str(s), "--out", out_dir])
        got = launch_counts(ops)
        fwd, bwd = expected_attn_launches(cfg, steps_full=steps,
                                          steps_mod=0, fwd_only=0)
        check(got["flash_attention"] == fwd
              and got["flash_attention_bwd"] == bwd,
              f"lm dp: attention launches {got} != fwd {fwd}, bwd {bwd}")
        check(all(np.isfinite(h["loss"]) for h in out["history"]),
              f"lm dp: {out['history']}")
        print(f"[lm dp] {cfg.name} full width, B {b}, S {s}, {steps} steps: "
              f"losses {[round(h['loss'], 4) for h in out['history']]}; "
              f"attention launches fwd {fwd} bwd {bwd} == derived; wall per "
              f"step (s) {[round(w, 3) for w in out['walls']]}", flush=True)
        del out
    return {"launches": launches}


def profile_lm_round(cfg, n, tau, b, s):
    """torch.profiler breakdown of one warm full-width LM IFL round."""
    from repro_torch.core.ifl_spmd import init_ifl_state, make_ifl_round_step
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.train.loop import _ifl_batch

    gen = torch.Generator(device="cuda").manual_seed(0)
    params, opt_state = init_ifl_state(cfg, n_clients=n, generator=gen,
                                       device="cuda")
    step = make_ifl_round_step(cfg, n_clients=n, tau=tau, lr_base=3e-3,
                               lr_modular=3e-3)
    stream = SyntheticLM(cfg.vocab_size, seed=0)
    batches = [_ifl_batch(stream, cfg, n, tau, b, s, r, device="cuda")
               for r in range(2)]

    def one_round(i):
        float(step(params, opt_state, batches[i])[2]["base_loss"])

    one_round(0)
    profile_run("lm ifl", lambda: one_round(1))
    del params, opt_state


# Card against CPU for the short LM IFL run at the reduced config: the same
# params and tokens, fp32 on both sides; the card runs the attention
# kernels, the CPU the reference's blocked path, and every product sums in
# another order. The limit is set from the readings (PERF.md).
LM_LOSS_TOL = 1e-4


def lm_card_vs_cpu(small):
    """Two IFL rounds of the reduced config (fp32, 2 layers) on the card
    and on the CPU from the same init (drawn on the CPU) and tokens."""
    from repro_torch.core.comm import tree_leaves
    from repro_torch.core.ifl_spmd import init_ifl_state, make_ifl_round_step
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models.modules import tree_map
    from repro_torch.train.loop import _ifl_batch

    n, tau, b, s = 2, 2, 2, 128
    gen = torch.Generator().manual_seed(0)
    init, _ = init_ifl_state(small, n_clients=n, generator=gen, device="cpu")
    stream = SyntheticLM(small.vocab_size, seed=0)
    losses, final = {}, {}
    for dev in ("cpu", "cuda"):
        params = [tree_map(lambda a: a.to(dev).clone(), p) for p in init]
        opt_state = [{"base": {}, "modular": {}} for _ in range(n)]
        step = make_ifl_round_step(small, n_clients=n, tau=tau,
                                   lr_base=3e-3, lr_modular=3e-3)
        losses[dev] = []
        for r in range(2):
            m = step(params, opt_state,
                     _ifl_batch(stream, small, n, tau, b, s, r,
                                device=dev))[2]
            losses[dev] += [float(m["base_loss"]), float(m["mod_loss"])]
        final[dev] = [a.cpu() for a in tree_leaves(params)]
    err = max(abs(a - c) for a, c in zip(losses["cuda"], losses["cpu"]))
    p_err = max(float((a - c).abs().max())
                for a, c in zip(final["cuda"], final["cpu"]))
    check(all(np.isfinite(losses["cuda"])) and err <= LM_LOSS_TOL,
          f"lm card vs CPU: losses {losses} differ by {err}")
    print(f"[lm ifl] card vs CPU, {small.name} (fp32, 2 layers), N {n}, tau "
          f"{tau}, B {b}, S {s}, 2 rounds, same init: losses "
          f"{[round(x, 5) for x in losses['cuda']]}; max|card - cpu| "
          f"{err:.2e} (tolerance {LM_LOSS_TOL}); params after the 2 rounds "
          f"max|card - cpu| {p_err:.2e}", flush=True)


# ------------------------------------------------- the fused wire path

# The fused wire path's kernels against their plain version (cuBLAS and
# the codec): fp32 floats within FUSED_TOL of the tensor's largest
# magnitude (the products sum in another order); bf16 outputs within
# 2^-7 (one bf16 rounding of values that may differ in their last fp32
# bits); integer codes within the JAX package's flip budget for these
# kernels (tests/test_wire_fused.py:215-233, tests/_wire_budget.py):
# fewer than 2% differ, each by one step; top-k decoded rows within one
# quantum. Kernel against kernel (csrc/fusion_proj.cu) is bitwise.
FUSED_TOL = 1e-5
BF16_TOL = 2.0 ** -7
D_FUSION = 432
# Table-II: the fusion FC of clients 2, 3, 4 (K -> 432, relu); the other
# FCs of the path (client 4's base, the modular blocks after their first).
FUSION_K = {2: 1568, 3: 784, 4: 512}
PATH_FCS = [(784, 1024), (1024, 512), (256, 128), (128, 64), (64, 10),
            (128, 10)]
LM_PROJ = (4096, 4096, 2048)


def proj_inputs(M, K, N, seed, dtype=torch.float32, zero_row=True):
    """x (M, K) with an all-zero row, w (K, N) at 1/sqrt(K), b (N,)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((M, K), generator=gen, device="cuda")
    if zero_row:
        x[min(3, M - 1)] = 0.0
    w = torch.randn((K, N), generator=gen, device="cuda") / math.sqrt(K)
    b = 0.1 * torch.randn((N,), generator=gen, device="cuda")
    return x.to(dtype), w.to(dtype), b


def same_payload(a, b, label):
    check(sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in b),
          f"{label}: not bitwise equal")


def decoded_err(codec, got, want, shape) -> float:
    return float((codec.decode(got, shape=shape)
                  - codec.decode(want, shape=shape)).abs().max())


def fused_checks(ops, ref, get_codec):
    """The four kernels against their plain versions and against each
    other (bitwise), at the path's shapes, the Fig-2 (1024, 432, 432), a
    ragged (33, 433, 433) and LM width for fusion_proj; every scheme, and
    ef(int8_row) / ef(int4) over 3 chained steps. -> max |err| of each
    kernel at the path's shapes, and the codes compared and flipped."""
    import _wire_budget as budget

    errs = dict.fromkeys(("fusion_proj", "fusion_proj_quant",
                          "fusion_proj_encode", "decode_proj"), 0.0)
    n_codes = n_flips = 0
    path = {(32, k, n) for k, n in PATH_FCS}
    cases = ([(32, k, n, "relu") for k, n in PATH_FCS]
             + [(32, k, D_FUSION, "relu") for k in FUSION_K.values()]
             + [(1024, 432, 432, "none"), (33, 433, 433, "silu"),
                (*LM_PROJ, "relu")])
    for M, K, N, act in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x, w, b = proj_inputs(M, K, N, seed=K + N, dtype=dtype)
            got = ops.fusion_proj(x, w, b, act)
            want = ref.fusion_proj_ref(x, w, b, act)
            torch.cuda.synchronize()
            check(got.dtype == dtype, f"fusion_proj dtype {got.dtype}")
            err = budget.floats_close(
                got.float(), want.float(), FUSED_TOL if dtype == torch.float32
                else BF16_TOL, f"fusion_proj ({M},{K},{N}) {act} "
                f"{str(dtype)[6:]}")
            if (M, K, N) in path and dtype == torch.float32:
                errs["fusion_proj"] = max(errs["fusion_proj"], err)
    enc_cases = [(32, k, D_FUSION, True) for k in FUSION_K.values()] + [
        (1024, 432, 432, False), (33, 433, 433, False)]
    for M, K, N, with_bias in enc_cases:
        on_path = (M, N) == (32, D_FUSION)
        x, w, b = proj_inputs(M, K, N, seed=M + K)
        b = b if with_bias else None   # no bias: the zero row of x stays zero
        y = ops.fusion_proj(x, w, b, "relu")
        for scheme in WIRE_SCHEMES:
            codec = get_codec(scheme)
            label = f"fusion_proj_encode {scheme} ({M},{K},{N})"
            p = ops.fusion_proj_encode(x, w, b, "relu", codec=codec)
            same_payload(p, ops.wire_encode(y, codec), label + " vs wire_encode")
            plain = ref.fusion_proj_encode_ref(x, w, b, "relu", codec=codec)
            flips = budget.payload_close(scheme, p, plain, N, FUSED_TOL,
                                         label)
            n_codes += flips.size
            n_flips += int(flips.sum())
            if on_path:
                errs["fusion_proj_encode"] = max(
                    errs["fusion_proj_encode"],
                    decoded_err(codec, p, plain, (M, N)))
            if scheme == "int8_row":
                q, s = ops.fusion_proj_quant(x, w, b, "relu")
                same_payload({"q": q, "scale": s}, p, "fusion_proj_quant")
                if on_path:
                    errs["fusion_proj_quant"] = max(
                        errs["fusion_proj_quant"],
                        decoded_err(codec, {"q": q, "scale": s}, plain,
                                    (M, N)))
        for scheme in ("int8_row", "int4"):
            ef = get_codec(f"ef({scheme})")
            e = torch.zeros((M, N), device="cuda")
            for t in range(3):
                xt, _, _ = proj_inputs(M, K, N, seed=100 * t + K)
                label = f"fusion_proj_encode ef({scheme}) ({M},{K},{N}) step {t}"
                p, e_got = ops.fusion_proj_encode(xt, w, b, "relu", codec=ef,
                                                  ef_state=e)
                want, e_want = ops.wire_encode_ef(
                    ops.fusion_proj(xt, w, b, "relu"), e, ef)
                same_payload(p, want, label + " vs wire_encode_ef")
                check(torch.equal(e_got, e_want), f"{label}: e' not bitwise")
                plain, e_plain = ref.fusion_proj_encode_ref(
                    xt, w, b, "relu", codec=ef, e=e)
                flips = budget.payload_close(scheme, p, plain, N, FUSED_TOL,
                                             label)
                budget.residual_close(e_got, e_plain, flips, FUSED_TOL,
                                      f"{label} e'")
                n_codes += flips.size
                n_flips += int(flips.sum())
                e = e_got
    dec_cases = [(32, 432, n) for n in (256, 128, 10)] + [
        (1024, 432, 432), (33, 433, 433)]
    for M, d, N in dec_cases:
        _, w, b = proj_inputs(1, d, N, seed=d + N)
        for scheme in WIRE_SCHEMES:
            codec = get_codec(scheme)
            p = codec.encode(wire_inputs(M, d, seed=M + N))
            label = f"decode_proj {scheme} ({M},{d})->{N}"
            got = ops.decode_proj(p, w, b, "relu", codec=codec, shape=(M, d))
            check(torch.equal(got, ops.fusion_proj(
                codec.decode(p, shape=(M, d)), w, b, "relu")),
                f"{label}: not fusion_proj of the decode, bitwise")
            err = budget.floats_close(got, ref.decode_proj_ref(
                p, w, b, "relu", codec=codec, shape=(M, d)), FUSED_TOL, label)
            if M == 32:
                errs["decode_proj"] = max(errs["decode_proj"], err)
    torch.cuda.synchronize()
    return errs, n_codes, n_flips


def boundary_forward(ops, small, models, cid, x, codec, e):
    """One client boundary: client ``cid``'s base block up to its fusion
    FC (convolutions in torch, FCs through ``ops.fusion_proj``), the
    fusion FC and the wire encode in ``ops.fusion_proj_encode``, and each
    modular block's first FC with the decode in ``ops.decode_proj``, the
    rest of the block through ``ops.fusion_proj``.
    -> (h, payload, e', logits of each modular block, calls by kernel)."""
    calls = dict.fromkeys(("fusion_proj", "fusion_proj_quant",
                           "fusion_proj_encode", "decode_proj"), 0)
    params = models[cid]
    h = x
    for p, d in zip(params["base"][:-1], small.CLIENT_ARCHS[cid]["base"][:-1]):
        if d[0] == "conv":
            h = small._conv_pool_relu(p, h)
        else:
            h = ops.fusion_proj(h.reshape(h.shape[0], -1), p["w"], p["b"],
                                "relu")
            calls["fusion_proj"] += 1
    h = h.reshape(h.shape[0], -1)
    last = params["base"][-1]
    out = ops.fusion_proj_encode(h, last["w"], last["b"], "relu", codec=codec,
                                 ef_state=e)
    calls["fusion_proj_encode"] += 1
    payload, e_new = out if e is not None else (out, None)
    if codec.name == "int8_row":
        q, s = ops.fusion_proj_quant(h, last["w"], last["b"], "relu")
        calls["fusion_proj_quant"] += 1
        same_payload({"q": q, "scale": s}, payload, f"client {cid} quant")
    logits = {}
    for mid, mp in models.items():
        layers = mp["modular"]
        acts = ["relu"] * (len(layers) - 1) + ["none"]
        y = ops.decode_proj(payload, layers[0]["w"], layers[0]["b"], acts[0],
                            codec=codec, shape=(x.shape[0], D_FUSION))
        calls["decode_proj"] += 1
        for p, act in zip(layers[1:], acts[1:]):
            y = ops.fusion_proj(y, p["w"], p["b"], act)
            calls["fusion_proj"] += 1
        logits[mid] = y
    return h, payload, e_new, logits, calls


def boundary_phase(ops, get_codec):
    """The fused wire path at the Table-II client boundary (the main path
    of this slice's kernels), counts set to 0 just before and read just
    after; then each result against the unfused path on the card
    (``client_base_apply`` -> the codec's encode / decode ->
    ``client_modular_apply``). -> launches of each kernel."""
    import _wire_budget as budget
    from repro_torch.data.images import make_synth_kmnist
    from repro_torch.device import resolve_device
    from repro_torch.models import small

    dev = resolve_device(None)      # fp32 products and convolutions in fp32
    B = 32
    images = make_synth_kmnist(n_train=2 * B, n_test=0, seed=0)[0]
    batches = [torch.from_numpy(images[i * B:(i + 1) * B]).to(dev)
               for i in range(2)]
    gen = torch.Generator().manual_seed(0)
    models = {cid: small.init_client_model(cid, generator=gen, device=dev)
              for cid in (1, 2, 3, 4)}
    runs = []
    calls = dict.fromkeys(("fusion_proj", "fusion_proj_quant",
                           "fusion_proj_encode", "decode_proj"), 0)
    torch.cuda.synchronize()
    reset_counts(ops)
    t0 = time.perf_counter()
    for name, steps in (("int8_row", 1), ("ef(int4)", 2)):
        codec = get_codec(name)
        for cid in FUSION_K:
            e = codec.init_state((B, D_FUSION), device=dev) \
                if codec.has_state else None
            for t in range(steps):
                h, payload, e_new, logits, c = boundary_forward(
                    ops, small, models, cid, batches[t], codec, e)
                for k, v in c.items():
                    calls[k] += v
                runs.append((name, cid, t, batches[t], e, payload, e_new,
                             logits))
                e = e_new
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = launch_counts(ops)
    check(all(got[k] == v for k, v in calls.items()) and all(
        v == 0 for k, v in got.items() if k not in calls),
        f"boundary: launches {got} != calls {calls}")
    logit_err = unfused_err = 0.0
    n_flips = n_codes = 0
    for name, cid, t, x, e, payload, e_new, logits in runs:
        codec = get_codec(name)
        kind = "int4" if name == "ef(int4)" else name
        label = f"boundary {name} client {cid} step {t}"
        check(codec.wire_bytes(payload) == codec.encoded_nbytes(
            (B, D_FUSION)), f"{label}: payload bytes")
        z = small.client_base_apply(models[cid], cid, x)
        if e is not None:
            plain, e_plain = codec.encode_with_state(z, e)
        else:
            plain, e_plain = codec.encode(z), None
        flips = budget.payload_close(kind, payload, plain, D_FUSION,
                                     FUSED_TOL, label)
        if e_new is not None:
            budget.residual_close(e_new, e_plain, flips, FUSED_TOL,
                                  f"{label} e'")
        ok = ~flips.any(axis=1)     # rows whose codes agree
        n_flips += int(flips.sum())
        n_codes += flips.size
        z_hat = codec.decode(payload, shape=(B, D_FUSION))
        z_plain = codec.decode(plain, shape=(B, D_FUSION))
        for mid, y in logits.items():
            check(bool(torch.isfinite(y).all()) and y.shape == (
                B, small.NUM_CLASSES), f"{label} -> {mid}: logits")
            # The same payload through the plain modular block.
            logit_err = max(logit_err, budget.floats_close(
                y, small.client_modular_apply(models[mid], mid, z_hat),
                FUSED_TOL, f"{label} -> {mid}"))
            # The unfused path end to end, on the rows whose codes agree.
            unfused = small.client_modular_apply(models[mid], mid, z_plain)
            unfused_err = max(unfused_err, budget.floats_close(
                y.cpu().numpy()[ok], unfused.cpu().numpy()[ok], FUSED_TOL,
                f"{label} -> {mid} unfused"))
    print(f"[boundary] Table-II clients 2, 3, 4 at B {B} (synthetic KMNIST), "
          f"int8_row (1 batch) and ef(int4) (2 chained batches), each "
          f"payload into the 4 modular blocks: launches {calls} == calls; "
          f"payload bytes == encoded_nbytes; codes vs the unfused path: "
          f"{n_flips} of {n_codes} differ; logits vs the plain modular block "
          f"on the same payload max|err| {logit_err:.3e}, vs the unfused "
          f"path (rows whose codes agree) {unfused_err:.3e} (tolerance "
          f"{FUSED_TOL} of max|logit|); wall {wall * 1e3:.1f} ms", flush=True)
    return calls


def fused_bound(nbytes, flops, rate):
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = flops / rate * 1e3
    return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations"


def fused_times(ops, ref, get_codec):
    """Device times of the four kernels, their plain versions, the one
    PyTorch call that computes #4 (``torch.addmm`` and the activation)
    and, for #3, #5 and #6, the unfused pair (cuBLAS and the codec /
    ``wire_encode``), with the bounds; distinct input sets per graph so w
    comes from HBM (32 sets at M 32). -> the JSON rows' numbers."""
    out = {}

    def time_proj(M, K, N, dtype, act="relu", sets=32):
        ins = [proj_inputs(M, K, N, seed=500 + i, dtype=dtype, zero_row=False)
               for i in range(sets)]
        k_ms = graph_time_ms([lambda a=a: ops.fusion_proj(*a, act)
                              for a in ins])
        p_ms = graph_time_ms([lambda a=a: ref.fusion_proj_ref(*a, act)
                              for a in ins])
        bb = [(x, w, b.to(dtype)) for x, w, b in ins]
        l_ms = graph_time_ms([lambda a=a: torch.relu_(torch.addmm(
            a[2], a[0], a[1])) for a in bb])
        esz = 2 if dtype == torch.bfloat16 else 4
        nbytes = (M * K + K * N + M * N) * esz + N * 4
        bound, by = fused_bound(nbytes, 2 * M * K * N, BF16_FLOPS
                                if dtype == torch.bfloat16 else FP32_FLOPS)
        print(f"[time] fusion_proj ({M},{K},{N}) {str(dtype)[6:]} {act}: "
              f"kernel {k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us, "
              f"addmm+relu {l_ms * 1e3:.2f} us, bound {bound * 1e3:.4f} us "
              f"({by}; {nbytes} bytes)", flush=True)
        return dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=bound,
                    bound_by=by)

    for k, n in PATH_FCS:
        out[("fusion_proj", k, n)] = time_proj(32, k, n, torch.float32)
    out["fusion_proj_1568"] = time_proj(32, 1568, D_FUSION, torch.float32)
    for dtype in (torch.float32, torch.bfloat16):
        out[("fusion_proj_lm", dtype)] = time_proj(*LM_PROJ, dtype, sets=2)

    def time_encode(M, K, name, quant=False, sets=32):
        codec = get_codec(name)
        inner = codec.inner if codec.has_state else codec
        N = D_FUSION
        ins = [proj_inputs(M, K, N, seed=700 + i, zero_row=False)
               for i in range(sets)]
        es = [0.1 * wire_inputs(M, N, seed=900 + i) for i in range(sets)]
        if quant:
            def kern(a, e):
                return ops.fusion_proj_quant(*a, "relu")

            def plain(a, e):
                return ref.fusion_proj_quant_ref(*a, "relu")
        else:
            def kern(a, e):
                return ops.fusion_proj_encode(*a, "relu", codec=codec,
                                              ef_state=e)

            def plain(a, e):
                return ref.fusion_proj_encode_ref(*a, "relu", codec=codec, e=e)

        def unfused(a, e):
            y = torch.relu_(torch.addmm(a[2], a[0], a[1]))
            return (ops.wire_encode_ef(y, e, codec) if codec.has_state
                    else ops.wire_encode(y, codec))

        es = es if codec.has_state else [None] * sets
        times = [graph_time_ms([lambda a=a, e=e: f(a, e)
                                for a, e in zip(ins, es)])
                 for f in (kern, plain, unfused)]
        sch = ops.scheme_for(inner, N)
        nbytes = ((M * K + K * N + N) * 4 + sch.payload_bytes(M)
                  + sch.table_bytes() + (2 * M * N * 4 if codec.has_state
                                         else 0))
        bound, by = fused_bound(nbytes, 2 * M * K * N, FP32_FLOPS)
        kname = "fusion_proj_quant" if quant else "fusion_proj_encode"
        print(f"[time] {kname} {name} ({M},{K},{N}) relu: kernel "
              f"{times[0] * 1e3:.2f} us, plain {times[1] * 1e3:.2f} us, "
              f"unfused addmm+relu+wire_encode {times[2] * 1e3:.2f} us, bound "
              f"{bound * 1e3:.4f} us ({by}; {nbytes} bytes)", flush=True)
        return dict(ms=times[0], plain_ms=times[1], unfused_ms=times[2],
                    bound_ms=bound, bound_by=by)

    out["fusion_proj_quant"] = time_encode(32, 1568, "int8_row", quant=True)
    out["fusion_proj_encode"] = time_encode(32, 1568, "int8_row")
    out["fusion_proj_encode_ef"] = time_encode(32, 1568, "ef(int4)")
    out["fusion_proj_encode_fig2"] = time_encode(1024, 432, "int8_row",
                                                 sets=8)

    def time_decode(N, name="int8_row", M=32, sets=32):
        codec, d = get_codec(name), D_FUSION
        ins = []
        for i in range(sets):
            _, w, b = proj_inputs(1, d, N, seed=1100 + i)
            ins.append((codec.encode(wire_inputs(M, d, seed=1200 + i)), w, b))
        shape = (M, d)
        times = [graph_time_ms([lambda a=a: f(*a) for a in ins]) for f in (
            lambda p, w, b: ops.decode_proj(p, w, b, "relu", codec=codec,
                                            shape=shape),
            lambda p, w, b: ref.decode_proj_ref(p, w, b, "relu", codec=codec,
                                                shape=shape),
            lambda p, w, b: torch.relu_(torch.addmm(
                b, codec.decode(p, shape=shape), w)))]
        sch = ops.scheme_for(codec, d)
        nbytes = (sch.payload_bytes(M) + (d * N + N + M * N) * 4
                  + (4 * (2 * d + sch.n) if name.startswith("sketch") else 0))
        bound, by = fused_bound(nbytes, 2 * M * d * N, FP32_FLOPS)
        print(f"[time] decode_proj {name} ({M},{d})->{N} relu: kernel "
              f"{times[0] * 1e3:.2f} us, plain {times[1] * 1e3:.2f} us, "
              f"unfused decode+addmm+relu {times[2] * 1e3:.2f} us, bound "
              f"{bound * 1e3:.4f} us ({by}; {nbytes} bytes)", flush=True)
        return dict(ms=times[0], plain_ms=times[1], unfused_ms=times[2],
                    bound_ms=bound, bound_by=by)

    for n in (256, 128, 10):
        out[("decode_proj", n)] = time_decode(n)
    return out


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

    attn_err = attn_checks(ops, ref)
    print(f"[kernel] flash_attention / flash_attention_bwd vs plain at "
          f"{len(ATTN_CASES)} cases x fp32, bf16: relative max|err| fwd "
          f"{attn_err['all']['fwd']:.3e}, bwd {attn_err['all']['bwd']:.3e}; "
          f"at the path's case (bf16) max|err| fwd "
          f"{attn_err['path']['fwd']:.3e}, bwd {attn_err['path']['bwd']:.3e}",
          flush=True)

    fused_err, n_codes, n_flips = fused_checks(ops, ref, get_codec)
    print(f"[kernel] fusion_proj / fusion_proj_quant / fusion_proj_encode / "
          f"decode_proj vs plain at the path's shapes, (1024,432,432), "
          f"(33,433,433) and {LM_PROJ} (fusion_proj, fp32 and bf16), schemes "
          f"{WIRE_SCHEMES}, ef(int8_row) / ef(int4) over 3 chained steps, a "
          f"zero row: fused payloads == wire_encode(fusion_proj) bitwise (e' "
          f"included), quant == the int8_row payload, decode_proj == "
          f"fusion_proj(decode) bitwise; against plain {n_flips} of "
          f"{n_codes} coded positions differ (an int8/int4 code by one "
          f"step, or top-k membership); max|err| at the path's "
          f"shapes {json.dumps({k: float(f'{v:.3e}') for k, v in fused_err.items()})}",
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

    # -- 4e. LM IFL at full width through the training CLI ---------------
    from repro_torch.launch import train as train_cli

    lm = lm_train_phase(train_cli, ops, cfg, args.profile)

    # -- 4f. the card against the CPU: LM IFL at the reduced config -------
    lm_card_vs_cpu(cfg.reduced())

    # -- 4g. the fused wire path at the Table-II client boundary ---------
    fused_launches = boundary_phase(ops, get_codec)

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
    at = attn_times(ops, ref)
    for kname, key, err, replaces in (
            ("flash_attention", "fwd", attn_err["path"]["fwd"],
             "src/repro/kernels/flash_attention.py:167"),
            # The JAX package has no backward kernel: jax.grad
            # differentiates its jnp path, so nothing is replaced.
            ("flash_attention_bwd", "bwd", attn_err["path"]["bwd"], None)):
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": replaces,
            "launches": lm["launches"][kname],
            "max_abs_err": err,
            "ms": at[key],
            "plain_ms": at[key + "_plain"],
            "bound_ms": at[key + "_bound"],
            "bound_by": at[key + "_bound_by"],
            "library_ms": at[key + "_sdpa"],
        })
    # The fused wire path at its shapes: fusion_proj at client 4's first
    # FC (32, 784, 1024), #5 and #6 at client 2's fusion FC (32, 1568,
    # 432) under int8_row, decode_proj into a 256-wide first modular FC.
    ft = fused_times(ops, ref, get_codec)
    for kname, key, replaces in (
            ("fusion_proj", ("fusion_proj", 784, 1024),
             "src/repro/kernels/fusion_proj.py:80"),
            ("fusion_proj_quant", "fusion_proj_quant",
             "src/repro/kernels/fusion_proj.py:144"),
            ("fusion_proj_encode", "fusion_proj_encode",
             "src/repro/kernels/fusion_proj.py:262"),
            ("decode_proj", ("decode_proj", 256),
             "src/repro/kernels/wire_fused.py:445")):
        t = ft[key]
        row = {
            "name": kname,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fusion_proj.cu",
            "replaces": replaces,
            "launches": fused_launches[kname],
            "max_abs_err": fused_err[kname],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t.get("library_ms"),
        }
        if "unfused_ms" in t:   # cuBLAS and the codec, two launches or more
            row["unfused_ms"] = t["unfused_ms"]
        kernels.append(row)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
