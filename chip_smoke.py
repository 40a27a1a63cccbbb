"""Chip smoke test of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py [--profile | --kernel-times]

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version on the card, and drives the
port's main paths through the entry points a user calls:

  * serving: full-width qwen1.5-0.5b to 4 tenants through the serving
    engine (``python -m repro_torch.launch.serve --no-reduced``), the
    path of the ``flash_decode`` kernel, greedy and sampled (temperature
    0.8, top-k 20, on the JAX package's threefry key chain, beside a
    greedy neighbour), and the serve-plan autotuner whose plan a
    ``horizon="auto"`` engine takes;
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
    ``fusion_proj_encode`` / ``decode_proj`` kernels;
  * RMSNorm: ``ops.rmsnorm``, the only entry point of the ``rmsnorm``
    kernel in either package (no model path calls it), at kernel_bench's
    (8192, 4096) fp32, the LM clients' (4096, 1024) bf16 rows with fp32
    params, and ragged shapes;
  * the front door: ``run_experiment`` of the eager IFL spec (Table-II
    width, ef(int4), k2, max_staleness 2) under the delta broadcast,
    4 rounds with evaluations, against the same spec under the full
    broadcast, and a run saved by ``save_trainer`` after 2 rounds and
    resumed by ``load_trainer`` in a fresh trainer;
  * the paper's baselines: ``run_experiment`` of FL-1, FL-2 and FSL at
    Table-II width (B 32, tau 10, lr 0.01, 3 rounds, 4000/1000 images)
    under ``full`` and ``k2``, which launch no kernel of the port, with
    a save/resume, the same runs card against CPU, and the Fig. 2 twin
    (``repro_torch.benchmarks.fig2_comm_efficiency``) over all four
    schemes at 20 rounds on the spec's default 20000/4000 images;
  * async rounds and population fleets: ``run_experiment`` of the eager
    IFL spec under ``mode='async'`` (pareto(1.2,0.5) arrivals, a server
    tick a simulated second, ef(int4), delta, 12 ticks at Table-II
    width, 6000/1500 images), where ``wire_encode_ef`` launches once an
    upload, with a resume and the same ticks card against CPU; a fleet
    of 10,000 Table-II clients with a cohort of 64 a round (ef(int4),
    max_staleness 4, 3 rounds, 4096/256 images) through
    ``build_trainer``, with a sparse resume; and the twins
    ``async_vs_sync``, ``fleet_scale --nightly`` and the Fig. 2 twin
    under ``--mode async``;
  * the SPMD IFL trainer (phase 4l): its masked round step
    (``make_ifl_round_step(partial_participation=True)`` with an
    ``SPMDFusionExchange``: ef(int4), max_staleness 1, delta) on
    full-width qwen1.5-0.5b at phase 4e's shapes, k2 masks from a
    ``RoundEngine`` and the ledger from ``account_round``, 1 round (3
    until phase 4r came; the stale cache is the smoke run's, below) on
    a (1, 1, 1) mesh of one NCCL rank, the
    path of ``wire_encode_ef`` over all 4096 x 1024 fusion rows at once
    and of the attention kernels; ``run_experiment(ifl_spmd)`` card
    against CPU on the smoke config (head dim 24, which the attention
    kernels run zero-padded to 32; under int8_row, then ef(int4) round by
    round in lockstep, flipped codes counted) and on the reduced
    qwen1.5-0.5b, with
    a save/resume, async ticks, a population of 1,000 with a cohort of 8
    and an int8_row run (``wire_encode``); the trained run exported by
    ``CompositionStore.from_spmd_trainer`` and served (``flash_decode``);
    and ``python -m repro_torch.examples.llm_ifl_train`` for 5 rounds;
  * the SPMD round on a mesh of ranks (phase 4r): 4 spawned ranks (NCCL
    with a card each where the machine has 4 cards, else gloo with all
    4 on cuda:0, CUDA tensors and the hand-written kernels on every
    rank), full-width qwen1.5-0.5b at phase 4l's shapes: one int8_row
    round on a (4, 1, 1) mesh, bitwise the same round in one process,
    and one ef(int4) round under a k2 mask on (2, 2, 1), within its
    tolerances; the launch counts of every rank, the bytes each hands
    to the fusion all-gather against the ledger, the gather's and the
    round's wall;
  * the recurrent mixers and cross-family composition (phase 4m):
    full-width xlstm-350m (24 layers of mLSTM and sLSTM, d 1024, vocab
    50,304, bf16) served to 4 tenants at W 4 (prompt 32, gen 32; no
    kernel of the port runs there: the mixers are plain PyTorch, as
    they are plain jnp in the JAX package); two cross-family lanes,
    olmo-1b base -> xlstm-350m modular and xlstm-350m base -> olmo-1b
    modular (olmo-1b at its published widths but d_fusion 1024, the
    two vendors' common fusion dim), 2 tenants and 6 requests a lane,
    the path of ``flash_decode`` (olmo-1b's 8 layers in either half);
    ``python -m repro_torch.launch.train --arch xlstm-350m`` at B 2 and
    its lr 3e-3 (1 DP step at S 512, 1 IFL round of N 4, tau 2 at S
    64) and the full-width gradient held to the first-order drop of
    its loss, fp32 and bf16; the reduced
    xlstm-350m, a small Mamba hybrid and the composition twin's four
    dense <-> xLSTM pairs card against CPU in fp32; and ``python -m
    repro_torch.examples.compose_inference --device cuda``;
  * MoE, MLA and MTP (phase 4n): deepseek-v3-671b at its published
    widths (d 7168, 128 MLA heads of q/k 192 and v 128, 256 routed
    experts top-8 and a shared one, vocab 129,280, bf16) cut to depth
    only (1 dense prefix layer, no base group, 1 modular MoE group, the
    MTP head), served to 2 tenants at W 4 (no kernel: MLA decodes in the
    absorbed form, plain as in the JAX package), and one ``lm_loss``
    forward and backward at B 1, S 512 on the attention kernels at MLA's
    head dims (launches == derived, experts' gradients zero exactly where
    no token arrived, aux == the routing's Switch loss, a first-order
    check over the LM and MTP heads in fp32); the reduced deepseek-v3 and
    a jamba period with its experts card against CPU in fp32 (expert
    choices compared); ``launch.train --reduced`` of deepseek-v3-671b
    and jamba-1.5-large-398b (one IFL round, one DP step);
  * the last attention variants (phase 4o): gemma3-27b at its widths
    (qk-norm, local windows of 1,024) cut to depth (2 local prefix
    layers, 1 modular group of 6), served to 2 tenants at W 4 and one
    ``lm_loss`` forward and backward at B 1, S 2048 with the LM head's
    first-order check; llama4-maverick at its widths (qk-norm, NoPE, 128
    experts) cut to a local dense base layer and a NoPE global MoE
    modular layer, served, and one ``lm_loss`` pass at B 1, S 512 with
    the routed experts held out of the gradient; qwen2-vl-2b at full
    depth (M-RoPE, 256 image rows) served with text prompts, one
    ``lm_loss`` pass and ``launch.train --mode dp``; seamless-m4t-large-v2
    at full depth (24 encoder layers over 1,024 frames on the attention
    kernels' non-causal mode, cross-attention in the decoder) through
    ``launch.train --mode dp`` and the serving CLI's fixed-batch
    ``generate`` through its cross caches; the new prefill paths in
    turns for PROBE_S seconds; the four reduced configs card against CPU
    (losses, logits, greedy tokens, an IFL round); ``launch.serve`` of
    the reduced seamless and the serve_demo twin on the card;
  * the dry-run (phase 4p): full-width qwen1.5-0.5b's DP step at B 2,
    S 512 and a W 4 composed decode step, each run on meta tensors and
    then on the card under ``roofline.accounting.Accounting``: the meta
    prediction equals the card's count in FLOPs, bytes and each kernel's
    launches, which equal the launch counters; each step's warm wall
    against its model FLOPs (``mfu``) and its roofline bound, with the
    card's name and power limit; and ``python -m
    repro_torch.launch.dryrun`` (deepseek-v3-671b at train_4k, and
    ``--all --accounting-only``) run beside the other phases on this
    machine's CPU;
  * launch plans keyed by the card and the last tooling twins (phase
    4q): the card's SM count (``ops.sm_count``) and every choice read
    from it (``decode_splits``' (S, chunk), ``fusion_proj.cu``'s tiles,
    ``rmsnorm.cu``'s grid) at phase 3's and 4's shapes and the timed
    shapes of #3-#7, equal to the rules at the H100 SXM's 132 SMs;
    ``ops.autotune_wire_plan`` of the wire encode's team and the fused
    encode's and the decode's tile (every candidate's time, each
    candidate's outputs bitwise the kernel rule's), then the wrappers
    launching with the tuned entries in a fresh read of the plan file;
    the ``serving_bench`` twin's ``--smoke`` on the card (parity exact
    on every arm; its speedup over horizon 1 printed); the
    ``perf_probe`` twin on meta and the ``gen_experiments`` twin over
    its files.

It checks each path's results, compares short runs on the card with the
same runs on the CPU, and times each kernel at the shapes its path gives
it. The attention kernels also run without the causal mask (the TPU
kernel's ``causal=False``, checked at ``ATTN_BIDIR_CASES``) and at head
dims other than 64 and 128
(every multiple of 8 up to 192, zero-padded to the instance's 32, 64,
128 or 192, with v's head dim apart from q's and k's), and at 64 and 128 their outputs are held bitwise to those of the
kernels before that change (sha256 digests in
``tests/data/attn_fingerprints_hd64_128.json``, computed by
``tests/_attn_fingerprints.py``). Each attention kernel also runs between
NaN guard bands at every checked shape (``guard_checks``), the stand-in
for compute-sanitizer, which does not run on the card's machine.

``--profile`` adds a torch.profiler breakdown of one more warm
serving run, one more warm IFL round of each codec, one more warm
LM IFL round, one more warm round of each baseline, one more async tick
with uploads and one more cohort round (device busy share, top kernels
and host ops); it is a diagnostic, not a check, and
is off by default. ``--kernel-times`` only builds and times, with no
checks and no result line: the launch floor, ``flash_decode``, the fused
encode (#5/#6), ``decode_proj`` beside ``fusion_proj`` on the decoded
input, and ``wire_encode`` / ``wire_encode_ef`` under every scheme at
(32, 432) and (4096, 432); a copy of this file at the root of another
checkout times that checkout's kernels the same way, so one card call
can time a parent beside a change. Every phase checks its result and raises on failure;
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
import os
import re
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

# The one timing harness (graph and event timers, each kernel's timed
# shapes and inputs) and the one count of a kernel's work: the
# ``kernel_bench`` twin and ``kernels/cost.py``.
from repro_torch.benchmarks.kernel_bench import (  # noqa: E402
    ATTN_BIDIR_TIMED,
    ATTN_HD_TIMED,
    ATTN_TIMED,
    BF16,
    D_FUSION,
    DECODE_SHAPES,
    F32,
    LM_PROJ,
    MLA_ATTN_TIMED,
    PATH_FCS,
    WIRE_SCHEMES,
    attn_inputs,
    attn_times,
    decode_inputs,
    decode_times,
    event_time_ms,
    fused_times,
    kernel_times,
    launch_floor_ms,
    proj_inputs,
    rms_inputs,
    rms_times,
    wire_inputs,
    wire_times,
)


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


def profile_run(label: str, run, top: int = 8, groups=()) -> None:
    """Where the time of one warm run goes: wall time (with the profiler
    on), the device's busy share (the sum of its kernel and copy times
    over the wall time), the kernels that take the most device time and
    the ops that take the most host time. ``run`` is the work, a
    callable; each of ``groups`` (a substring of kernel names) also
    prints the device time of the kernels whose names hold it."""
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
    for sub in groups:
        rs = [r for r in dev_rows if sub in r.key]
        t = sum(r.self_device_time_total for r in rs) / 1e3
        print(f"[profile {label} {sub}*] {t:9.1f} ms "
              f"{sum(r.count for r in rs):7d}x "
              f"({100 * t / 1e3 / busy:.1f}% of device busy)")
    for where, key, rs in (("device", "self_device_time_total", dev_rows),
                           ("host", "self_cpu_time_total", rows)):
        for r in sorted(rs, key=lambda r: -getattr(r, key))[:top]:
            print(f"[profile {label} {where}] {getattr(r, key) / 1e3:9.1f} ms "
                  f"{r.count:7d}x {r.key[:90]}")


# flash_decode against its plain version at the split's edges: (B, L,
# KVH, G, hd, dtype, lengths). One tile (S 1) at L 1; two splits at L
# 65; at L 4097 the splits of the path's heads (S 4) and of llama3-405b's
# head layout (G 16, hd 128, S 8), with rows whose later splits are
# wholly masked and a fully masked row (length 0), in both dtypes.
DECODE_SPLIT_CASES = [
    (4, 1, 2, 1, 64, torch.float32, [1, 1, 1, 0]),
    (4, 65, 2, 1, 64, torch.bfloat16, [65, 5, 64, 0]),
    (4, 4097, 16, 1, 64, torch.bfloat16, [4097, 1000, 5, 0]),
    (4, 4097, 16, 1, 64, torch.float32, [4097, 1000, 5, 0]),
    (4, 4097, 8, 16, 128, torch.bfloat16, [4097, 300, 2000, 0]),
    (4, 4097, 8, 16, 128, torch.float32, [4097, 300, 2000, 0]),
    (2, 300, 2, 4, 128, torch.float32, [300, 0]),
    # Head dims run zero-padded to the instance's HD: hd 24 on HD 32's
    # 128-row tiles (S 4 at L 4097), hd 48 and 96 with GQA on the bf16
    # tensor cores (HD 64, 128), hd 8, and hd 32's own instance with G 8
    # (bf16 on the SIMT path there).
    (4, 4097, 4, 1, 24, torch.bfloat16, [4097, 1000, 5, 0]),
    (4, 4097, 4, 1, 24, torch.float32, [4097, 130, 5, 0]),
    (2, 300, 2, 4, 48, torch.bfloat16, [300, 7]),
    (2, 300, 2, 4, 48, torch.float32, [300, 0]),
    (4, 257, 2, 16, 96, torch.bfloat16, [257, 100, 1, 0]),
    (3, 65, 2, 1, 8, torch.float32, [65, 3, 0]),
    (3, 129, 2, 8, 32, torch.bfloat16, [129, 64, 0]),
    (3, 129, 2, 8, 32, torch.float32, [129, 64, 0]),
    # olmo-1b's half of the cross-family lanes (phase 4m): G 1 at hd 128.
    (4, 64, 16, 1, 128, torch.bfloat16, [64, 40, 33, 17]),
]


def decode_split_checks(ops, ref, gen):
    """flash_decode at DECODE_SPLIT_CASES (fp32 within 1e-5, bf16 within
    the bf16 defaults, fully masked rows exactly zero, one launch a
    call), and a split call captured twice in one CUDA graph and
    replayed (the arrival counters are zero at every launch).
    -> max |err| over the fp32 cases."""
    err = 0.0
    for B, L, KVH, G, hd, dtype, lengths in DECODE_SPLIT_CASES:
        S, _ = ops.decode_splits(B, KVH, G, L, hd, ops.sm_count("cuda"))
        check(S > 1 or L <= ops.decode_tile_rows(hd),
              f"flash_decode L {L}: {S} split")
        ins = decode_inputs(gen, B, L, KVH, G, hd, dtype, lengths)
        before = ops.flash_decode.launches
        got = ops.cached_attn_decode(*ins)
        want = ref.cached_attn_decode_ref(*ins)
        torch.cuda.synchronize()
        check(ops.flash_decode.launches == before + 1,
              "flash_decode: not one launch a call")
        tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else {}
        torch.testing.assert_close(got, want, **tol)
        for b, n in enumerate(lengths):
            check(n > 0 or bool(torch.all(got[b] == 0)),
                  f"flash_decode {(B, L, KVH, G, hd)}: masked row not zero")
        if dtype == torch.float32:
            err = max(err, float((got - want).abs().max()))
    ins = decode_inputs(gen, 4, 4097, 16, 1, 64, torch.bfloat16,
                        [4097, 1000, 5, 0])
    want = ref.cached_attn_decode_ref(*ins)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.cached_attn_decode(*ins)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [ops.cached_attn_decode(*ins) for _ in range(2)]
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        for o in outs:
            torch.testing.assert_close(o, want)
            check(bool(torch.all(o[3] == 0)), "graph replay: masked row")
    return err


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


# The wire kernels' shapes against plain: the eager IFL path's (32, 432),
# an odd d, a (4096, 432) block (warp-a-row teams), the SPMD front door's
# (256, 128) on the reduced config and the SPMD full-width path's
# (4096, 1024), whose d picks the block-a-row team.
WIRE_SHAPES = ((32, 432), (32, 433), (4096, 432), (256, 128), (4096, 1024))


def wire_checks(ops, ref, get_codec):
    """Each wire kernel against its plain version on the card, for every
    scheme at each of ``WIRE_SHAPES``, with a zero row; EF over 4 chained
    steps, each fed the plain e."""
    errs = {"wire_encode": 0.0, "wire_encode_ef": 0.0}
    for scheme in WIRE_SCHEMES:
        codec, ef = get_codec(scheme), get_codec(f"ef({scheme})")
        for rows, d in WIRE_SHAPES:
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


# Flash attention against its plain version: (B, S, H, KVH, hd, window).
# The LM path's shape first; then hd 128 with GQA (G 2), a partial last
# tile (S 200) and a sliding window (48); then the edges of the bf16
# kernels' 64-row tiles (S 63, 64, 65, 129), windows of 1 and 65 keys,
# G 8 at hd 128 (H 16, KVH 2) and hd 128 at S 512.
ATTN_CASES = [(2, 512, 16, 16, 64, -1), (2, 256, 8, 4, 128, -1),
              (2, 200, 16, 16, 64, -1), (2, 512, 16, 16, 64, 48),
              (2, 63, 16, 16, 64, -1), (2, 64, 16, 16, 64, -1),
              (2, 65, 16, 16, 64, -1), (2, 129, 16, 16, 64, -1),
              (2, 512, 16, 16, 64, 1), (2, 512, 16, 16, 64, 65),
              (2, 512, 16, 2, 128, -1), (2, 512, 16, 16, 128, -1),
              # Head dims run zero-padded to the instance's 32, 64 or 128:
              # the smoke LM's 24 and the composition twin's 48 (GQA,
              # windows), 8 and 96 at tile edges, 32's own instance.
              (2, 200, 4, 2, 24, -1), (2, 129, 4, 4, 24, 48),
              (2, 512, 4, 4, 48, -1), (2, 65, 8, 2, 48, 65),
              (2, 64, 4, 1, 8, -1), (2, 200, 8, 4, 96, 1),
              (2, 256, 8, 2, 32, -1)]
# MLA's head dims, v's apart from q's and k's: (B, S, H, KVH, hd, hdv,
# window). Deepseek-v3's path shape (q/k 192 = nope 128 + rope 64, v 128,
# 128 heads, S 512) first; then the reduced config's (48, 32) with a
# window, (192, 128) at tile edges and a window, GQA, and hd 192 with v
# at its full 192.
MLA_ATTN_CASES = [(1, 512, 128, 128, 192, 128, -1),
                  (2, 512, 4, 4, 48, 32, -1), (2, 129, 4, 4, 48, 32, 65),
                  (1, 200, 8, 8, 192, 128, -1), (2, 65, 8, 8, 192, 128, 48),
                  (2, 130, 8, 2, 192, 128, -1), (1, 64, 4, 4, 192, 192, -1)]
# The kernels' non-causal mode (the TPU kernel's causal=False, every row
# sees every key, a window bounding keys from below), (B, S, H, KVH, hd,
# window): the seamless encoder's self-attention at full width (B 2, S
# 1024, 16 heads of 64) first; then S 100 and 1000 off the tile
# multiples, H = KVH and G > 1, hd 64 and 128, with and without a window,
# a padded head dim. Timed at the encoder's shape (the kernels line's
# bidir_* keys).
ATTN_BIDIR_CASES = [(2, 1024, 16, 16, 64, -1), (2, 100, 8, 8, 64, -1),
                    (1, 1000, 8, 2, 128, -1), (2, 100, 8, 2, 128, 48),
                    (1, 1000, 4, 4, 64, 65), (2, 100, 16, 2, 64, 1),
                    (1, 1000, 8, 8, 128, 300), (2, 65, 4, 4, 24, -1)]
# Tolerance, as max |kernel - plain| over max(1, max |plain|): fp32 sums
# in another order; in bf16 the kernel rounds the unnormalized p of its
# online softmax to bf16 where the plain version rounds the normalized
# p, and the outputs are rounded to bf16.
ATTN_TOL = {torch.float32: {"fwd": 2e-5, "bwd": 1e-4},
            torch.bfloat16: {"fwd": 2e-2, "bwd": 3e-2}}


def attn_cases():
    """ATTN_CASES, MLA_ATTN_CASES (causal) and ATTN_BIDIR_CASES
    (``causal=False``) as (B, S, H, KVH, hd, hdv, window, causal)."""
    return ([(*c[:5], c[4], c[5], True) for c in ATTN_CASES]
            + [(*c, True) for c in MLA_ATTN_CASES]
            + [(*c[:5], c[4], c[5], False) for c in ATTN_BIDIR_CASES])


def rel_err(got, want) -> float:
    want = want.float()
    return float((got.float() - want).abs().max()
                 / max(1.0, float(want.abs().max())))


def attn_lse_ref(q, k, window, causal=True):
    """Each row's softmax logsumexp, in fp32, from the plain scores."""
    B, S, H, hd = q.shape
    kf = k.float().repeat_interleave(H // k.shape[2], dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / math.sqrt(hd)
    i = torch.arange(S, device=q.device)
    mask = (i[None, :] <= i[:, None] if causal
            else torch.ones((S, S), dtype=torch.bool, device=q.device))
    if window > 0:
        mask &= i[None, :] > i[:, None] - window
    return torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)


def attn_checks(ops, ref):
    """Both attention kernels against their plain versions at every case
    of ATTN_CASES, MLA_ATTN_CASES and ATTN_BIDIR_CASES in fp32 and bf16
    -> max |err| of each kernel at the LM path's case, at MLA's and at
    the encoder's (bf16, their dtype) and over all cases (relative)."""
    errs = {"path": {}, "mla": {}, "enc": {},
            "all": {"fwd": 0.0, "bwd": 0.0}}
    cases = attn_cases()
    first = {cases[0]: "path", cases[len(ATTN_CASES)]: "mla",
             cases[len(ATTN_CASES) + len(MLA_ATTN_CASES)]: "enc"}
    for case in cases:
        B, S, H, KVH, hd, hdv, window, causal = case
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = attn_inputs(B, S, H, KVH, hd, dtype, seed=S + hd,
                                      hdv=hdv)
            kw = dict(causal=causal, window=window)
            o, lse = ops.flash_attention_fwd(q, k, v, **kw)
            grads = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
            o_ref = ref.flash_attention_ref(q, k, v, **kw)
            g_ref = ref.flash_attention_bwd_ref(q, k, v, do, **kw)
            torch.cuda.synchronize()
            label = (f"B {B} S {S} H {H} KVH {KVH} hd {hd}"
                     + (f" hdv {hdv}" if hdv != hd else "")
                     + f" window {window} {str(dtype)[6:]}"
                     + ("" if causal else " bidirectional"))
            tol = ATTN_TOL[dtype]
            fwd = rel_err(o, o_ref)
            lse_err = float((lse - attn_lse_ref(q, k, window, causal))
                            .abs().max())
            bwd = max(rel_err(a, b) for a, b in zip(grads, g_ref))
            check(all(g.dtype == dtype and g.shape == t.shape
                      for g, t in zip(grads, (q, k, v)))
                  and o.shape == (B, S, H, hdv), f"{label}: dtypes, shapes")
            check(fwd <= tol["fwd"] and lse_err <= 1e-4,
                  f"flash_attention {label}: err {fwd:.3e}, lse {lse_err:.3e}")
            check(bwd <= tol["bwd"], f"flash_attention_bwd {label}: err "
                  f"{bwd:.3e} > {tol['bwd']}")
            print(f"[kernel] attention {label}: fwd {fwd:.3e} (lse "
                  f"{lse_err:.3e}), bwd dq/dk/dv {bwd:.3e} (relative "
                  f"max|err|)", flush=True)
            errs["all"]["fwd"] = max(errs["all"]["fwd"], fwd)
            errs["all"]["bwd"] = max(errs["all"]["bwd"], bwd)
            key = first.get(case)
            if key and dtype == torch.bfloat16:
                errs[key] = {
                    "fwd": float((o.float() - o_ref.float()).abs().max()),
                    "bwd": max(float((a.float() - b.float()).abs().max())
                               for a, b in zip(grads, g_ref))}
    return errs


def fingerprint_check(ops) -> int:
    """The kernels' outputs at hd 64 and 128 are bitwise those of the
    kernels before the padded head dims (``_attn_fingerprints``) -> cases."""
    import _attn_fingerprints as fp

    want = json.loads(fp.FINGERPRINTS.read_text())
    got = fp.attn_fingerprints(ops)
    check(set(got) == set(want), "fingerprint cases differ from the file")
    diff = sorted(k for k in got if got[k] != want[k])
    check(not diff, f"hd 64/128 outputs not bitwise the parent's: {diff}")
    return len(got)


# Out-of-bounds and race probes of the attention kernels, the stand-in for
# compute-sanitizer (which does not run on the card's machine). Every
# input of a raw kernel call lies between two guard bands of NaN (mask
# bytes: True), every output and scratch buffer between two bands of NaN
# and the arrival counters between bands of -7; each band is at least the
# tensor's own size. A read of a band that reaches a result turns it NaN
# or other bits, a write into a band changes the band. Each case runs
# three times and must give the wrapper's bits every time (a
# shared-memory race, as a rule, would not).
GUARD_REPS = 3


def _banded(t, fill):
    """t's values between two guard bands of ``fill`` -> (view, buffer,
    band). Bands are whole 16-byte chunks, so the view keeps the
    kernels' alignment."""
    n = t.numel()
    band = max(4096, -(-n // 64) * 64)
    buf = torch.full((2 * band + n,), fill, dtype=t.dtype, device=t.device)
    view = buf[band:band + n].view(t.shape)
    view.copy_(t)
    return view, buf, band


def _bands_hold(banded) -> bool:
    view, buf, band = banded
    outer = torch.cat([buf[:band], buf[band + view.numel():]])
    if outer.dtype.is_floating_point:
        return bool(torch.isnan(outer).all())
    return bool((outer == buf[0]).all())


def guarded_decode(ops, q, k, v, valid) -> None:
    """flash_decode's C entry on banded copies of one case (q (B, 1, KVH,
    G, hd)): the wrapper's output bits, every band intact and the
    counters back at 0 after each of GUARD_REPS launches."""
    B, _, KVH, G, hd = q.shape
    L = k.shape[1]
    nan = float("nan")
    want = ops.cached_attn_decode(q, k, v, valid)[:, 0]
    S, chunk = ops.decode_splits(B, KVH, G, L, hd, ops.sm_count("cuda"))
    ins = [_banded(q[:, 0].contiguous(), nan), _banded(k, nan),
           _banded(v, nan), _banded(valid, True)]
    out = _banded(torch.empty_like(want), nan)
    bufs = [*ins, out]
    scratch = [None, None, None]
    if S > 1:
        scratch = [_banded(torch.empty((B * KVH, S, G, 2), device="cuda"),
                           nan),
                   _banded(torch.empty((B * KVH, S, G,
                                        ops.kernel_head_dim(hd)),
                                       device="cuda"), nan),
                   _banded(torch.zeros(B * KVH, dtype=torch.int32,
                                       device="cuda"), -7)]
        bufs += scratch
    fn = ops._c_fn("flash_decode", "flash_decode",
                   [ops._P] * 8 + [ops._I] * 8 + [ops._F, ops._P])
    label = f"guarded flash_decode {(B, L, KVH, G, hd, str(q.dtype)[6:])}"
    for _ in range(GUARD_REPS):
        rc = fn(*[b[0].data_ptr() for b in ins], out[0].data_ptr(),
                *[None if b is None else b[0].data_ptr() for b in scratch],
                B, L, KVH, G, hd, S, chunk, ops._DTYPE_CODE[q.dtype],
                1.0 / math.sqrt(hd), ops._stream(q.device))
        torch.cuda.synchronize()
        check(rc == 0, f"{label}: launch code {rc}")
        check(torch.equal(out[0], want), f"{label}: output not the "
              f"wrapper's bits")
        check(all(_bands_hold(b) for b in bufs), f"{label}: a guard band "
              f"changed")
        check(scratch[2] is None or bool((scratch[2][0] == 0).all()),
              f"{label}: arrival counters not back at 0")


def guarded_attention(ops, B, S, H, KVH, hd, hdv, window, dtype,
                      causal=True) -> None:
    """flash_attention_fwd and _bwd's C entries on banded copies of one
    case: the wrappers' bits (o, lse, dq, dk, dv), every band intact,
    after each of GUARD_REPS launches."""
    nan = float("nan")
    q, k, v, do = attn_inputs(B, S, H, KVH, hd, dtype, seed=S + hd + 1,
                              hdv=hdv)
    o, lse = ops.flash_attention_fwd(q, k, v, causal=causal, window=window)
    grads = ops.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                    window=window)
    ins = {n: _banded(t, nan) for n, t in
           (("q", q), ("k", k), ("v", v), ("o", o), ("do", do),
            ("lse", lse))}
    outs = {n: _banded(torch.empty_like(t), nan) for n, t in
            (("o", o), ("lse", lse), ("dsum", lse), ("dq", q), ("dk", k),
             ("dv", v))}
    want = {"o": o, "lse": lse, "dq": grads[0], "dk": grads[1],
            "dv": grads[2]}
    p = {n: b[0].data_ptr() for n, b in ins.items()}
    w = {n: b[0].data_ptr() for n, b in outs.items()}
    dims = (B, S, H, KVH, hd, hdv, int(window), int(causal),
            ops._DTYPE_CODE[dtype], 1.0 / math.sqrt(hd),
            torch.cuda.current_stream().cuda_stream)
    label = (f"guarded attention B {B} S {S} H {H} KVH {KVH} hd {hd} hdv "
             f"{hdv} window {window} {str(dtype)[6:]}"
             + ("" if causal else " bidirectional"))
    for _ in range(GUARD_REPS):
        ops._attn_call("flash_attention_fwd", p["q"], p["k"], p["v"],
                       w["o"], w["lse"], *dims)
        ops._attn_call("flash_attention_bwd", p["q"], p["k"], p["v"],
                       p["o"], p["do"], p["lse"], w["dsum"], w["dq"],
                       w["dk"], w["dv"], *dims)
        torch.cuda.synchronize()
        bad = [n for n, t in want.items() if not torch.equal(outs[n][0], t)]
        check(not bad, f"{label}: {bad} not the wrappers' bits")
        check(all(_bands_hold(b) for b in [*ins.values(), *outs.values()]),
              f"{label}: a guard band changed")


def guard_checks(ops, gen) -> int:
    """The guard-band probes at every DECODE_SPLIT_CASES case, the decode
    shapes of the serving lanes (W 4, cache 64, hd 24/48/64/128) and
    every ``attn_cases()`` case (the non-causal ones among them) in fp32
    and bf16 -> cases run."""
    n = 0
    decode = [(B, L, KVH, G, hd, dtype, lengths)
              for B, L, KVH, G, hd, dtype, lengths in DECODE_SPLIT_CASES]
    decode += [(4, 64, 16, 1, hd, torch.bfloat16, [64, 40, 33, 17])
               for hd in (24, 48, 64, 128)]
    for B, L, KVH, G, hd, dtype, lengths in decode:
        guarded_decode(ops, *decode_inputs(gen, B, L, KVH, G, hd, dtype,
                                           lengths))
        n += 1
    for case in attn_cases():
        for dtype in (torch.float32, torch.bfloat16):
            guarded_attention(ops, *case[:7], dtype, causal=case[7])
            n += 1
    torch.cuda.empty_cache()
    return n


def expected_attn_launches(cfg, *, steps_full, steps_mod, fwd_only):
    """Attention launches the code makes: each differentiated pass over a
    layer with attention runs the forward kernel, again under remat for
    the groups' layers (the backward recomputes the checkpointed group;
    prefix layers and the MTP head's layer are not checkpointed), and the
    backward kernel once. ``steps_full``: passes through all layers with
    autograd; ``steps_mod``: through the modular layers (and the MTP
    layer) only; ``fwd_only``: base forwards without autograd."""
    pre, bp, bg, mp, mg = cfg._resolved_program()

    def attn(specs):
        return sum(s.mixer == "attn" for s in specs)

    lp, lb, lm = attn(pre), attn(bp) * bg, attn(mp) * mg
    lt = 1 if cfg.use_mtp else 0
    recompute = 2 if cfg.remat in ("group", "layer") else 1
    fwd = (steps_full * (lp + recompute * (lb + lm) + lt)
           + steps_mod * (recompute * lm + lt) + fwd_only * (lp + lb))
    bwd = steps_full * (lp + lb + lm + lt) + steps_mod * (lm + lt)
    return fwd, bwd


def counted(ops):
    return (ops.flash_decode, ops.wire_encode, ops.wire_encode_ef,
            ops.flash_attention, ops.flash_attention_bwd, ops.fusion_proj,
            ops.fusion_proj_quant, ops.fusion_proj_encode, ops.decode_proj,
            ops.rmsnorm)


def reset_counts(ops) -> None:
    for fn in counted(ops):
        fn.launches = 0
    ops.flash_attention.bidir_launches = 0
    ops.flash_attention_bwd.bidir_launches = 0


def launch_counts(ops):
    return {fn.__name__: fn.launches for fn in counted(ops)}


def bidir_counts(ops):
    """The attention wrappers' ``causal=False`` launches since the last
    ``reset_counts``."""
    return {fn.__name__: fn.bidir_launches
            for fn in (ops.flash_attention, ops.flash_attention_bwd)}


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
    profile_run("lm ifl", lambda: one_round(1), groups=("attn_",))
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
# Table-II: the fusion FC of clients 2, 3, 4 (K -> 432, relu).
FUSION_K = {2: 1568, 3: 784, 4: 512}


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
    # bf16 on the tensor cores with structured inputs, where any wrong
    # fragment or lane map moves whole entries: x's rows are rows of the
    # identity, w[k, n] = (k N + n) % 256, so y[m] = w[m % K] exactly.
    for M, K, N in ((32, 784, 1024), LM_PROJ):
        x = torch.zeros((M, K), device="cuda")
        x[torch.arange(M), torch.arange(M) % K] = 1.0
        w = (torch.arange(K * N, device="cuda") % 256).float().reshape(K, N)
        got = ops.fusion_proj(x.bfloat16(), w.bfloat16())
        check(torch.equal(got.float(), w[torch.arange(M) % K]),
              f"fusion_proj bf16 ({M},{K},{N}) structured: not exact")
    # The encode's 8-row groups: M 33 ends in a group of 1, (32, 40,
    # 8192) has 512 column tiles a group and stages its rows one at a time.
    enc_cases = [(32, k, D_FUSION, True) for k in FUSION_K.values()] + [
        (1024, 432, 432, False), (1000, 432, 432, False),
        (33, 433, 433, False), (32, 40, 8192, False)]
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
    # bf16 on #4's tensor-core tiles: the fp32 projection is encoded, not
    # its bf16 rounding, so the plain version is that of the widened
    # inputs; codes within its budget.
    for M, K, N in ((32, FUSION_K[2], D_FUSION), (1000, 432, 432)):
        x, w, b = proj_inputs(M, K, N, seed=M + N, dtype=torch.bfloat16)
        for scheme in WIRE_SCHEMES:
            codec = get_codec(scheme)
            flips = budget.payload_close(
                scheme, ops.fusion_proj_encode(x, w, b, "relu", codec=codec),
                ref.fusion_proj_encode_ref(x.float(), w.float(), b, "relu",
                                           codec=codec), N,
                FUSED_TOL, f"fusion_proj_encode bf16 {scheme} ({M},{K},{N})")
            n_codes += flips.size
            n_flips += int(flips.sum())
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


# ------------------------------------------------------------- rmsnorm

# The op's calls in the rmsnorm phase: (M, D, x dtype, scale dtype,
# scale). kernel_bench's (8192, 4096) fp32 with ones and with a random
# scale; the four LM clients' B * S rows at qwen1.5-0.5b's d_model in
# bf16 with fp32 params; M off a multiple of 256, an odd D (rows not on
# 16 bytes), a long row, each in fp32 and in bf16.
RMS_CALLS = ([(8192, 4096, F32, F32, "ones"), (8192, 4096, F32, F32, "random"),
              (4096, 1024, BF16, F32, "random")]
             + [(M, D, xd, F32, "random") for M, D in ((1, 432), (1000, 432),
                                                      (37, 1023), (3, 8192))
                for xd in (F32, BF16)])
# Kernel against plain: fp32 within 2e-5 of max(1, max |plain|), the
# reference's fp32 tolerance (tests/test_kernels.py:188; the sums run in
# another order); bf16 within one bf16 rounding of the plain value.
RMS_FP32_TOL = 2e-5


def rmsnorm_phase(ops, ref):
    """The op ``ops.rmsnorm`` is the kernel's only path (no model path of
    either package calls it): its calls at RMS_CALLS and the scale
    invariance pair, counts set to 0 just before and read just after;
    then each output against the plain version. -> (launches, max |err|
    of the fp32 calls)."""
    ins = [rms_inputs(M, D, xd, sd, sc, seed=M + D + i)
           for i, (M, D, xd, sd, sc) in enumerate(RMS_CALLS)]
    inv_x = rms_inputs(16, 64, F32, F32, "ones", seed=7)
    torch.cuda.synchronize()
    reset_counts(ops)
    outs = [ops.rmsnorm(x, s) for x, s in ins]
    inv = [ops.rmsnorm(inv_x[0], inv_x[1]),
           ops.rmsnorm(3.7 * inv_x[0], inv_x[1])]
    torch.cuda.synchronize()
    got = launch_counts(ops)
    calls = len(outs) + len(inv)
    check(got["rmsnorm"] == calls and all(
        v == 0 for k, v in got.items() if k != "rmsnorm"),
        f"rmsnorm: launches {got} != {calls} calls")
    err32 = 0.0
    errs = []
    for (M, D, xd, sd, sc), (x, s), y in zip(RMS_CALLS, ins, outs):
        want = ref.rmsnorm_ref(x, s).float()
        check(y.dtype == xd and y.shape == (M, D), f"rmsnorm ({M},{D}) dtype")
        err = (y.float() - want).abs()
        label = f"rmsnorm ({M},{D}) x {str(xd)[6:]} scale {str(sd)[6:]} {sc}"
        if xd == F32:
            lim = RMS_FP32_TOL * max(1.0, float(want.abs().max()))
            check(float(err.max()) <= lim, f"{label}: max|err| "
                  f"{float(err.max()):.3e} > {lim:.3e}")
            err32 = max(err32, float(err.max()))
        else:
            check(bool((err <= BF16_TOL * want.abs()).all()),
                  f"{label}: beyond one bf16 rounding")
        errs.append(f"({M},{D}) {str(xd)[6:]}/{str(sd)[6:]} {sc}: "
                    f"{float(err.max()):.2e}")
    inv_err = float((inv[0] - inv[1]).abs().max())
    check(inv_err <= 1e-5, f"rmsnorm scale invariance: {inv_err}")
    print(f"[rmsnorm] {calls} calls of ops.rmsnorm (no model path in either "
          f"package), launches {got['rmsnorm']} == calls; max|kernel - "
          f"plain| {'; '.join(errs)} (fp32 within {RMS_FP32_TOL} of "
          f"max(1,|plain|), bf16 within one rounding); RMSNorm(3.7x) vs "
          f"RMSNorm(x) {inv_err:.2e}", flush=True)
    return got["rmsnorm"], err32


# ------------------------------------------------------- the front door

# Card against card (delta against full broadcast, a resumed run against
# the uninterrupted one): the same draws and the same decoded pairs, but
# two runs of the same rounds on the H100 are not bitwise equal: cuDNN's
# convolution backward may sum with atomics, in an order that changes
# from run to run (measured: the delta and full runs' parameters differ
# in their last bits, resumed losses by 1.2e-07; PERF.md). The
# phase prints whether they were bitwise equal.
IFL_CARD_TOL = 1e-4
FRONT_DOOR = dict(scheme="ifl", rounds=4, tau=10, lr=0.01, batch_size=32,
                  d_fusion=432, codec="ef(int4)", participation="k2",
                  max_staleness=2, broadcast="delta", eval_every=2, seed=0)


class round_walls:
    """Host wall of every ``run_round`` of the trainer classes (default
    ``IFLTrainer``) inside the block, ending in a device sync, as the
    quickstart's run would see it: the block yields the list of walls;
    ``by_trainer`` holds them per trainer, in the order the trainers ran."""

    def __init__(self, *classes):
        self.classes, self.walls, self.by_trainer = classes, [], {}

    def __enter__(self):
        if not self.classes:
            from repro_torch.core.ifl import IFLTrainer

            self.classes = (IFLTrainer,)
        self.orig = {cls: cls.run_round for cls in self.classes}

        def timed(trainer):
            t0 = time.perf_counter()
            rep = self.orig[type(trainer)](trainer)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            self.walls.append(wall)
            self.by_trainer.setdefault(trainer, []).append(wall)
            return rep

        for cls in self.classes:
            cls.run_round = timed
        return self.walls

    def __exit__(self, *exc):
        for cls, orig in self.orig.items():
            cls.run_round = orig


def same_reports(a, b, keys=("participants", "cache_size", "uplink_mb")):
    return all(x[k] == y[k] for x, y in zip(a, b) for k in keys)


def max_metric_diff(a, b, keys=("base_loss", "mod_loss")) -> float:
    return max(abs(x[k] - y[k]) for x, y in zip(a, b) for k in keys)


def front_door_phase(ops, round_bytes_match):
    """``run_experiment`` at Table-II width under the delta broadcast, the
    path a user calls (counts set to 0 just before, read just after),
    then the same spec under the full broadcast, and a run saved after 2
    rounds and resumed in a fresh trainer."""
    import tempfile

    from repro_torch.api import (DataSpec, ExperimentSpec, build_trainer,
                                 load_trainer, run_experiment, save_trainer)
    from repro_torch.core.comm import tree_leaves

    spec = ExperimentSpec(**FRONT_DOOR,
                          data=DataSpec(n_train=4000, n_test=1000))
    torch.cuda.synchronize()
    reset_counts(ops)
    with round_walls() as walls_delta:
        delta = run_experiment(spec, device="cuda", keep_trainer=True)
    got = launch_counts(ops)
    n_part = sum(len(r["participants"]) for r in delta.reports)
    check(got["wire_encode_ef"] == n_part and n_part > 0 and all(
        v == 0 for k, v in got.items() if k != "wire_encode_ef"),
        f"front door: launches {got} != {n_part} participants")
    tr = delta.trainer
    check(round_bytes_match(tr, spec),
          f"front door: ledger {tr.ledger.per_round} != the delta formula")
    check([r["round"] for r in delta.records] == [0, 2, 3] and all(
        "matrix" in r and "sd_per_base" in r for r in delta.records),
        f"front door: records {[sorted(r) for r in delta.records]}")
    for rep in delta.reports:
        check(np.isfinite(rep["base_loss"]) and np.isfinite(rep["mod_loss"]),
              f"front door: loss {rep}")

    with round_walls() as walls_full:
        full = run_experiment(spec.replace(broadcast="full"), device="cuda",
                              keep_trainer=True)
    check(same_reports(delta.reports, full.reports),
          "front door: delta and full differ in participants, cache or "
          "uplink")
    d_down = [r["down"] for r in tr.ledger.per_round]
    f_down = [r["down"] for r in full.trainer.ledger.per_round]
    check(all(a <= b for a, b in zip(d_down, f_down)),
          f"front door: delta downlink {d_down} above full's {f_down}")
    train_err = max_metric_diff(delta.reports, full.reports)
    acc_err = max(abs(a - b) for x, y in zip(delta.records, full.records)
                  for a, b in zip(x["accs"], y["accs"]))
    check(train_err <= IFL_CARD_TOL and acc_err <= IFL_CARD_TOL,
          f"front door: delta vs full losses {train_err}, accuracies "
          f"{acc_err} > {IFL_CARD_TOL}")
    bitwise = train_err == 0 and acc_err == 0 and all(
        torch.equal(a, b) for a, b in zip(
            tree_leaves([c.params for c in tr.clients]),
            tree_leaves([c.params for c in full.trainer.clients])))

    with tempfile.TemporaryDirectory() as tmp, round_walls() as walls_direct:
        first = build_trainer(spec, device="cuda")
        for _ in range(2):
            first.run_round()
        path = str(Path(tmp) / "trainer")
        save_trainer(path, first)
        resumed = load_trainer(path, build_trainer(spec, device="cuda"))
        tail = [resumed.run_round() for _ in range(2)]
    check(same_reports(tail, delta.reports[2:], ("round", "participants",
                                                  "cache_size",
                                                  "shipped_entries",
                                                  "uplink_mb", "downlink_mb"))
          and resumed.ledger.per_round == tr.ledger.per_round[2:],
          "front door: resumed rounds differ in participants or bytes")
    resume_err = max_metric_diff(tail, delta.reports[2:])
    check(resume_err <= IFL_CARD_TOL,
          f"front door: resumed losses differ by {resume_err}")
    print(f"[front door] run_experiment(ifl, 4 clients, d_fusion 432, B 32, "
          f"tau 10, ef(int4), k2, max_staleness 2, delta, 4 rounds, eval "
          f"every 2; 4000/1000 images) on the card: wire_encode_ef launches "
          f"{got['wire_encode_ef']} == {n_part} participants; ledger == "
          f"ifl_round_bytes(delta, shipped_entries) every round; shipped "
          f"{[r['shipped_entries'] for r in delta.reports]}; records carry "
          f"matrix and sd_per_base; final acc_mean "
          f"{delta.final['acc_mean']:.3f}", flush=True)
    print(f"[front door] delta vs full: participants, cache and uplink "
          f"equal; downlink {d_down} vs {f_down} bytes; losses max|diff| "
          f"{train_err:.2e}, accuracies {acc_err:.2e} (tolerance "
          f"{IFL_CARD_TOL}); bitwise equal on the card: {bitwise}; round "
          f"walls (ms) delta {[round(w * 1e3, 1) for w in walls_delta]}, "
          f"full {[round(w * 1e3, 1) for w in walls_full]}", flush=True)
    print(f"[front door] save_trainer after 2 rounds, load_trainer into a "
          f"fresh build_trainer, rounds 3-4: participants, shipped entries "
          f"and bytes == the uninterrupted run; losses max|diff| "
          f"{resume_err:.2e} (tolerance {IFL_CARD_TOL}); round walls (ms) of "
          f"these 4 rounds, run_round called directly: "
          f"{[round(w * 1e3, 1) for w in walls_direct]}", flush=True)


def front_door_card_vs_cpu():
    """One short ``run_experiment`` under delta on the CPU and on the
    card (ef(int4), k2, 2 rounds, tau 2): the same participants, shipped
    entries and bytes, losses within IFL_LOSS_TOL."""
    from repro_torch.api import DataSpec, ExperimentSpec, run_experiment

    spec = ExperimentSpec(**{**FRONT_DOOR, "rounds": 2, "tau": 2,
                             "eval_every": 0},
                          data=DataSpec(n_train=4000, n_test=1000))
    runs = {dev: run_experiment(spec, device=dev, keep_trainer=True)
            for dev in ("cpu", "cuda")}
    check(same_reports(runs["cuda"].reports, runs["cpu"].reports,
                       ("participants", "shipped_entries", "uplink_mb",
                        "downlink_mb"))
          and runs["cuda"].trainer.ledger.per_round
          == runs["cpu"].trainer.ledger.per_round,
          "front door card vs CPU: participants or bytes differ")
    err = max_metric_diff(runs["cuda"].reports, runs["cpu"].reports)
    check(err <= IFL_LOSS_TOL, f"front door card vs CPU: losses differ by "
          f"{err} > {IFL_LOSS_TOL}")
    print(f"[front door] card vs CPU, run_experiment under delta (ef(int4), "
          f"k2, 2 rounds, tau 2): participants "
          f"{[r['participants'] for r in runs['cuda'].reports]}, shipped "
          f"entries and bytes equal; losses max|card - cpu| {err:.2e} "
          f"(tolerance {IFL_LOSS_TOL})", flush=True)


# ------------------------------------- the baselines and the paper's figures

# The paper's baselines at Table-II width, as the IFL phases run it: FL-1,
# FL-2 (the fleet cloned from client 1's or client 2's model) and FSL
# (client 1's modular block as the shared server block).
BASELINE_RUN = dict(rounds=3, tau=10, lr=0.01, batch_size=32, d_fusion=432,
                    eval_every=0, seed=0)
BASELINES = ("fl1", "fl2", "fsl")


def baseline_round_bytes(trainer, scheme, rounds):
    """The analytic bytes of each round of ``rounds`` (reports)."""
    from repro_torch.core.comm import fl_round_bytes, fsl_round_bytes
    from repro_torch.models.small import model_bytes

    n = len(trainer.clients)
    if scheme == "fsl":
        return [fsl_round_bytes(n, 32, 432,
                                participating=len(r["participants"]))
                for r in rounds]
    mb = model_bytes(trainer.global_params)
    return [fl_round_bytes(n, mb, participating=len(r["participants"]))
            for r in rounds]


def baselines_phase(ops, profile):
    """``run_experiment`` of each baseline on the card under ``full`` and
    ``k2`` (counts set to 0 just before, read just after: the baselines
    launch no kernel of the port), the ledger against the analytic bytes
    every round, and a trainer saved after 2 rounds and resumed by
    ``load_trainer`` in a fresh trainer: its third round equals the
    saved trainer's own third round in participants and bytes, and in
    loss within IFL_CARD_TOL. (Against the run_experiment run, which
    started from the same init, the loss is not held: two FL-1 runs on
    the card part by 1.2e-4 in 3 rounds, cuDNN's nondeterministic
    convolution backward compounded by the trajectory; PERF.md.)
    ``profile`` adds a breakdown of one more warm round under ``full``."""
    import tempfile

    from repro_torch.api import (DataSpec, ExperimentSpec, build_trainer,
                                 load_trainer, run_experiment, save_trainer)
    from repro_torch.core import FLTrainer, FSLTrainer

    for scheme in BASELINES:
        for part in ("full", "k2"):
            spec = ExperimentSpec(scheme=scheme, participation=part,
                                  **BASELINE_RUN,
                                  data=DataSpec(n_train=4000, n_test=1000))
            torch.cuda.synchronize()
            reset_counts(ops)
            rw = round_walls(FLTrainer, FSLTrainer)
            with rw, tempfile.TemporaryDirectory() as tmp:
                res = run_experiment(spec, device="cuda", keep_trainer=True)
                first = build_trainer(spec, device="cuda")
                for _ in range(2):
                    first.run_round()
                path = str(Path(tmp) / "trainer")
                save_trainer(path, first)
                resumed = load_trainer(path, build_trainer(spec,
                                                           device="cuda"))
                want = first.run_round().to_dict()
                tail = resumed.run_round().to_dict()
            got = launch_counts(ops)
            check(all(v == 0 for v in got.values()),
                  f"{scheme} {part}: kernels launched {got}")
            tr = res.trainer
            check(tr.ledger.per_round == baseline_round_bytes(
                tr, scheme, res.reports),
                f"{scheme} {part}: ledger {tr.ledger.per_round} != analytic")
            check(all(np.isfinite(r["loss"]) for r in res.reports),
                  f"{scheme} {part}: loss {res.reports}")
            check(same_reports([tail], [want], ("round", "participants",
                                                 "uplink_mb", "downlink_mb"))
                  and same_reports([tail], res.reports[2:],
                                   ("round", "participants"))
                  and resumed.ledger.per_round == tr.ledger.per_round[2:],
                  f"{scheme} {part}: resumed round differs in participants "
                  f"or bytes")
            resume_err = max_metric_diff([tail], [want], ("loss",))
            drift = max_metric_diff(res.reports, [
                r.to_dict() for r in first.engine.history], ("loss",))
            check(resume_err <= IFL_CARD_TOL,
                  f"{scheme} {part}: resumed loss differs by {resume_err}")
            run_walls = rw.by_trainer[tr]
            print(f"[baselines] run_experiment({scheme}, {part}, 4 clients, "
                  f"B 32, tau 10, lr 0.01, 3 rounds; 4000/1000 images) on "
                  f"the card: every kernel count 0; ledger == "
                  f"{'fsl' if scheme == 'fsl' else 'fl'}_round_bytes every "
                  f"round {[r['up'] for r in tr.ledger.per_round]} up; "
                  f"losses {[round(r['loss'], 5) for r in res.reports]}; "
                  f"resumed round 3 == the saved trainer's own round 3 in "
                  f"participants and bytes, loss |diff| {resume_err:.2e} "
                  f"(tolerance {IFL_CARD_TOL}); a second run from the same "
                  f"init: losses max|diff| {drift:.2e}; round walls (ms) "
                  f"{[round(w * 1e3, 1) for w in run_walls]}; accuracy "
                  f"{res.final['acc_mean']:.3f}", flush=True)
            if profile and part == "full":
                profile_run(f"{scheme} full", tr.run_round)


def baselines_card_vs_cpu():
    """Each baseline for 2 rounds at tau 2 under k2 on the CPU and on the
    card, in lockstep: before each round the card trainer loads the CPU
    trainer's checkpoint, so both run the round from one state. The same
    participants and bytes, losses within IFL_LOSS_TOL (the baselines'
    trajectories are chaotic: one ReLU sign flip moves FL-1's loss by
    2e-3 in 3 rounds on the CPU; tests/test_torch_baselines.py)."""
    import tempfile

    from repro_torch.api import (DataSpec, ExperimentSpec, build_trainer,
                                 load_trainer, save_trainer)

    for scheme in BASELINES:
        spec = ExperimentSpec(scheme=scheme, participation="k2",
                              **{**BASELINE_RUN, "rounds": 2, "tau": 2},
                              data=DataSpec(n_train=4000, n_test=1000))
        cpu = build_trainer(spec, device="cpu")
        card = build_trainer(spec, device="cuda")
        errs = []
        with tempfile.TemporaryDirectory() as tmp:
            for r in range(spec.rounds):
                path = str(Path(tmp) / f"round{r}")
                save_trainer(path, cpu)
                load_trainer(path, card)
                rc, rg = cpu.run_round(), card.run_round()
                check(rg.participants == rc.participants
                      and card.ledger.per_round == cpu.ledger.per_round,
                      f"{scheme} card vs CPU: participants or bytes differ")
                errs.append(abs(rg["loss"] - rc["loss"]))
        err = max(errs)
        check(err <= IFL_LOSS_TOL, f"{scheme} card vs CPU: losses differ by "
              f"{err} > {IFL_LOSS_TOL}")
        print(f"[baselines] card vs CPU, {scheme} (k2, 2 rounds, tau 2, "
              f"each round from the CPU trainer's checkpoint): participants "
              f"{[r.participants for r in card.engine.history]} and bytes "
              f"{card.ledger.per_round} equal; losses max|card - cpu| "
              f"{err:.2e} (tolerance {IFL_LOSS_TOL})", flush=True)


FIG2_ROUNDS = 20


def fig2_phase(ops):
    """The Fig. 2 twin's ``run()`` on the card at the spec's default data
    (20,000 / 4,000 images, tau 10, lr 0.05, full participation) into a
    temporary cache: every scheme's cumulative uplink equals the analytic
    sum, IFL's per-round uplink is below a tenth of FL-1's, and no kernel
    of the port launches (the fp32 codec runs none)."""
    import tempfile

    from repro_torch.benchmarks import fig2_comm_efficiency as fig2
    from repro_torch.core import (FLTrainer, FSLTrainer, IFLTrainer,
                                  fl_round_bytes, fsl_round_bytes,
                                  ifl_round_bytes)
    from repro_torch.models.small import init_client_model, model_bytes

    torch.cuda.synchronize()
    reset_counts(ops)
    rw = round_walls(IFLTrainer, FLTrainer, FSLTrainer)
    t0 = time.perf_counter()
    with rw, tempfile.TemporaryDirectory() as tmp:
        rows = fig2.run(FIG2_ROUNDS, quiet=True, device="cuda",
                        cache_dir=tmp)
    phase_s = time.perf_counter() - t0
    got = launch_counts(ops)
    check(all(v == 0 for v in got.values()),
          f"fig2: kernels launched {got}")
    mb = {cid: model_bytes(init_client_model(
        cid, generator=torch.Generator().manual_seed(0))) for cid in (1, 2)}
    per_round = {"ifl": ifl_round_bytes(4, 32, 432)["up"],
                 "fsl": fsl_round_bytes(4, 32, 432)["up"],
                 "fl1": fl_round_bytes(4, mb[1])["up"],
                 "fl2": fl_round_bytes(4, mb[2])["up"]}
    uplink = {}
    for scheme, r, uplink_mb, acc in rows:
        check(uplink_mb == per_round[scheme] * (r + 1) / 1e6
              and 0.0 <= acc <= 1.0,
              f"fig2 {scheme} round {r}: uplink {uplink_mb} MB, acc {acc}")
        uplink[scheme] = uplink_mb
    check(sorted(uplink) == sorted(per_round)
          and per_round["ifl"] < per_round["fl1"] / 10,
          f"fig2: per-round uplink {per_round}")
    budget, hl = fig2.headline(rows)
    walls = dict(zip(("ifl", "fsl", "fl1", "fl2"), rw.by_trainer.values()))
    warm = {s: round(statistics.median(w[1:]) * 1e3, 1)
            for s, w in walls.items()}
    print(f"[fig2] fig2_comm_efficiency.run({FIG2_ROUNDS} rounds, eval every "
          f"round; 20000/4000 images, tau 10, lr 0.05, full) on the card in "
          f"{phase_s:.1f}s: every kernel count 0; cumulative uplink == the "
          f"analytic sum every round; per-round uplink (bytes) {per_round} "
          f"(ifl < fl1 / 10)", flush=True)
    print(f"[fig2] at IFL-90% uplink budget {budget:.2f} MB: "
          f"{json.dumps({k: round(v, 4) for k, v in hl.items()})}; "
          f"cumulative uplink MB after {FIG2_ROUNDS} rounds "
          f"{json.dumps(uplink)}; final accuracy "
          f"{json.dumps({s: round(a, 4) for s, _, _, a in rows})}; "
          f"warm round wall (ms, median of rounds 2-{FIG2_ROUNDS}) "
          f"{json.dumps(warm)}", flush=True)


# ---------------------------------- async rounds and population fleets

# The async IFL run: the async_vs_sync twin's trace, tick and data, at
# Table-II width under ef(int4) and the delta broadcast.
ASYNC_RUN = dict(scheme="ifl", mode="async", trace="pareto(1.2,0.5)",
                 tick=1.0, codec="ef(int4)", broadcast="delta", rounds=12,
                 tau=10, lr=0.01, batch_size=32, d_fusion=432, eval_every=4,
                 seed=0)
ASYNC_DATA = dict(n_train=6000, n_test=1500)
# The population run: a fleet of 10,000 Table-II clients (cycled), a
# cohort of 64 a round, at the fleet_scale twin's data. The eager modular
# update is O(C^2) steps, so C is 64, not the reference's headline 256.
POP_RUN = dict(scheme="ifl", codec="ef(int4)", max_staleness=4,
               participation="full", rounds=3, tau=1, lr=0.05,
               batch_size=32, d_fusion=432, eval_every=0, seed=0)
POP_FLEET = dict(n_population=10000, cohort=64)
POP_DATA = dict(n_train=4096, n_test=256)


# A resumed async trainer runs its ticks bit for bit with the trainer it
# was saved from once both run under cuDNN's deterministic algorithms
# (the default convolution backward sums with atomics); the gate allows
# one fp32 ulp of a unit loss.
ASYNC_RESUME_TOL = 1.2e-7


def async_ticks_match(a, b, keys=("round", "participants", "arrivals",
                                  "sim_time", "cache_size",
                                  "shipped_entries", "uplink_mb",
                                  "downlink_mb")) -> bool:
    return len(a) == len(b) and same_reports(a, b, keys)


def tick_loss_diff(a, b) -> float:
    """max |a - b| over the losses of the ticks that had participants
    (an empty tick's losses are NaN on both sides)."""
    return max((abs(x[k] - y[k]) for x, y in zip(a, b) if x["participants"]
                for k in ("base_loss", "mod_loss")), default=0.0)


def async_phase(ops, round_bytes_match, profile, device="cuda"):
    """``run_experiment`` of an async IFL spec (counts set to 0 just
    before, read just after): ``wire_encode_ef`` launches == the engine's
    coalesced uploads, every tick's ledger == ``ifl_round_bytes(delta,
    shipped)``, sim_time and uploads_per_sec in every report and record;
    then a trainer saved after 6 ticks and resumed by ``load_trainer`` in
    a fresh trainer: ticks 7-12 (both trainers under cuDNN's
    deterministic algorithms) equal the saved trainer's own in
    participants, arrivals and bytes, losses within ASYNC_RESUME_TOL."""
    import tempfile

    from repro_torch.api import (DataSpec, ExperimentSpec, build_trainer,
                                 load_trainer, run_experiment, save_trainer)

    spec = ExperimentSpec(**ASYNC_RUN, data=DataSpec(**ASYNC_DATA))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    reset_counts(ops)
    with round_walls() as walls:
        res = run_experiment(spec, device=device, keep_trainer=True)
    got = launch_counts(ops)
    tr = res.trainer
    eng = tr.engine
    n_up = sum(len(r["participants"]) for r in res.reports)
    check(got["wire_encode_ef"] == eng.total_uploads == n_up > 0 and all(
        v == 0 for k, v in got.items() if k != "wire_encode_ef"),
        f"async: launches {got} != {eng.total_uploads} uploads")
    check(round_bytes_match(tr, spec),
          f"async: ledger {tr.ledger.per_round} != the delta formula")
    check(all(r["sim_time"] == (i + 1) * spec.tick and "uploads_per_sec"
              in r and "arrivals" in r for i, r in enumerate(res.reports))
          and [r["round"] for r in res.records] == [0, 4, 8, 11]
          and all("sim_time" in r and "uploads_per_sec" in r
                  for r in res.records),
          f"async: reports or records lack the event clock")
    check(all(np.isfinite(r["base_loss"]) and np.isfinite(r["mod_loss"])
              for r in res.reports if r["participants"]),
          "async: a tick with uploads has a non-finite loss")

    with tempfile.TemporaryDirectory() as tmp:
        first = build_trainer(spec, device=device)
        for _ in range(6):
            first.run_round()
        path = str(Path(tmp) / "trainer")
        save_trainer(path, first)
        resumed = load_trainer(path, build_trainer(spec, device=device))
        with torch.backends.cudnn.flags(
                enabled=torch.backends.cudnn.enabled,
                benchmark=torch.backends.cudnn.benchmark,
                deterministic=True,
                allow_tf32=torch.backends.cudnn.allow_tf32):
            want = [first.run_round().to_dict() for _ in range(6)]
            tail = [resumed.run_round().to_dict() for _ in range(6)]
    check(async_ticks_match(tail, want)
          and resumed.ledger.per_round == first.ledger.per_round[6:]
          and async_ticks_match(tail, res.reports[6:],
                                ("participants", "arrivals", "uplink_mb")),
          "async: resumed ticks differ in participants, arrivals or bytes")
    resume_err = tick_loss_diff(tail, want)
    check(resume_err <= ASYNC_RESUME_TOL,
          f"async: resumed losses differ by {resume_err}")
    print(f"[async] run_experiment(ifl, mode async, trace "
          f"{spec.trace}, tick {spec.tick}, 4 clients, d_fusion 432, B "
          f"{spec.batch_size}, tau {spec.tau}, lr {spec.lr}, ef(int4), "
          f"delta, {spec.rounds} ticks, eval every {spec.eval_every}; "
          f"{ASYNC_DATA['n_train']}/{ASYNC_DATA['n_test']} images) on the "
          f"card: wire_encode_ef launches {got['wire_encode_ef']} == "
          f"{eng.total_uploads} coalesced uploads ({eng.total_arrivals} "
          f"arrivals); ledger == ifl_round_bytes(delta, shipped_entries) "
          f"every tick; participants "
          f"{[r['participants'] for r in res.reports]}; sim_time "
          f"{eng.sim_time} s, uploads/s "
          f"{res.reports[-1]['uploads_per_sec']:.4f}; accuracy at the records "
          f"{[round(r['acc_mean'], 4) for r in res.records]}; tick walls "
          f"(ms) {[round(w * 1e3, 1) for w in walls]}", flush=True)
    print(f"[async] save_trainer after 6 ticks, load_trainer into a fresh "
          f"build_trainer, ticks 7-12 under cudnn.deterministic on both "
          f"trainers: participants, arrivals, shipped "
          f"entries and bytes == the saved trainer's own; losses max|diff| "
          f"{resume_err:.2e} (tolerance {ASYNC_RESUME_TOL})", flush=True)
    if profile:
        while not len(tr.engine.participants()):
            tr.run_round()
        print(f"[profile async tick] participants "
              f"{list(tr.engine.participants())}", flush=True)
        reset_counts(ops)
        profile_run("async tick", tr.run_round)
        print(f"[profile async tick] launches {launch_counts(ops)}",
              flush=True)


def async_card_vs_cpu():
    """The async run for 4 ticks at tau 2 on the CPU and on the card, in
    lockstep: before each tick the card trainer loads the CPU trainer's
    checkpoint (the trace cursor included). The same participants,
    arrivals and bytes, losses within IFL_LOSS_TOL."""
    import tempfile

    from repro_torch.api import (DataSpec, ExperimentSpec, build_trainer,
                                 load_trainer, save_trainer)

    spec = ExperimentSpec(**{**ASYNC_RUN, "rounds": 4, "tau": 2,
                             "eval_every": 0}, data=DataSpec(**ASYNC_DATA))
    cpu = build_trainer(spec, device="cpu")
    card = build_trainer(spec, device="cuda")
    errs = []
    with tempfile.TemporaryDirectory() as tmp:
        for r in range(spec.rounds):
            path = str(Path(tmp) / f"tick{r}")
            save_trainer(path, cpu)
            load_trainer(path, card)
            rc, rg = cpu.run_round().to_dict(), card.run_round().to_dict()
            check(async_ticks_match([rg], [rc])
                  and card.ledger.per_round == cpu.ledger.per_round,
                  "async card vs CPU: participants, arrivals or bytes differ")
            errs.append(tick_loss_diff([rg], [rc]))
    err = max(errs)
    check(err <= IFL_LOSS_TOL, f"async card vs CPU: losses differ by {err} "
          f"> {IFL_LOSS_TOL}")
    print(f"[async] card vs CPU, {spec.rounds} ticks, tau {spec.tau}, each "
          f"tick from the CPU "
          f"trainer's checkpoint: participants "
          f"{[r.participants for r in card.engine.history]}, arrivals and "
          f"bytes equal; losses max|card - cpu| {err:.2e} (tolerance "
          f"{IFL_LOSS_TOL})", flush=True)


def population_phase(ops, profile, device="cuda"):
    """``build_trainer`` of a population spec (N 10,000, C 64, ef(int4),
    max_staleness 4, full) and 3 rounds, counts set to 0 just before each
    round and read just after: K == 64 and ``wire_encode_ef`` launches
    == 64 every round, ledger == analytic, at most 3 C clients built,
    live server slots (the fleet_scale twin's definition) at most
    C (max_staleness + 2), EF residuals held only for slots that
    uploaded within max_staleness rounds; then a sparse save after 2
    rounds, resumed in a fresh trainer: round 3 equal in participants
    and bytes, loss within IFL_CARD_TOL."""
    import tempfile

    from repro_torch.api import (DataSpec, ExperimentSpec, FleetSpec,
                                 build_trainer, load_trainer, save_trainer)
    from repro_torch.benchmarks.fleet_scale import live_server_slots
    from repro_torch.core import ifl_round_bytes

    spec = ExperimentSpec(**POP_RUN, data=DataSpec(**POP_DATA),
                          fleet=FleetSpec(**POP_FLEET))
    n, c, bound = POP_FLEET["n_population"], POP_FLEET["cohort"], \
        POP_RUN["max_staleness"]
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**20 if cuda else 0.0
    t0 = time.perf_counter()
    tr = build_trainer(spec, device=device)
    build_s = time.perf_counter() - t0
    walls, launches, slots = [], [], []
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "trainer")
        for r in range(spec.rounds):
            if r == 2:
                t0 = time.perf_counter()
                save_trainer(path, tr)
                save_s = time.perf_counter() - t0
            if cuda:
                torch.cuda.synchronize()
            reset_counts(ops)
            t0 = time.perf_counter()
            rep = tr.run_round()
            if cuda:
                torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            got = launch_counts(ops)
            launches.append(got["wire_encode_ef"])
            ex = tr.exchange
            window = {int(k) for h in tr.engine.history[-(bound + 1):]
                      for k in h.participants}
            slots.append(live_server_slots(tr))
            check(len(rep.participants) == c == got["wire_encode_ef"]
                  and all(v == 0 for k, v in got.items()
                          if k != "wire_encode_ef"),
                  f"population round {r}: {len(rep.participants)} "
                  f"participants, launches {got}")
            check(tr.ledger.per_round[r] == ifl_round_bytes(
                n, spec.batch_size, spec.d_fusion, codec=spec.codec,
                participating=c, broadcast_entries=rep["cache_size"])
                and rep["cache_size"] == c,
                f"population round {r}: ledger {tr.ledger.per_round[r]}")
            check(set(ex.ef_state) <= window
                  and set(ex._last_upload) == set(ex.ef_state),
                  f"population round {r}: EF residuals held for slots "
                  f"outside the staleness window")
            check(len(tr.clients.materialized) <= 3 * c
                  and slots[-1] <= c * (bound + 2),
                  f"population round {r}: {len(tr.clients.materialized)} "
                  f"clients built, {slots[-1]} live server slots")
            check(np.isfinite(rep["base_loss"]) and np.isfinite(
                rep["mod_loss"]), f"population round {r}: loss {rep}")
        resumed = load_trainer(path, build_trainer(spec, device=device))
        ckpt_mb = Path(path + ".npz").stat().st_size / 1e6
        tail = resumed.run_round().to_dict()
    want = tr.engine.history[2].to_dict()
    check(same_reports([tail], [want], ("round", "participants",
                                        "cache_size", "uplink_mb",
                                        "downlink_mb"))
          and resumed.ledger.per_round == tr.ledger.per_round[2:],
          "population: the resumed round differs in participants or bytes")
    resume_err = max_metric_diff([tail], [want])
    check(resume_err <= IFL_CARD_TOL,
          f"population: the resumed loss differs by {resume_err}")
    peak = torch.cuda.max_memory_allocated() / 2**20 if cuda else 0.0
    print(f"[population] build_trainer(ifl, FleetSpec(n_population {n}, "
          f"cohort {c}), ef(int4), max_staleness {bound}, full, tau "
          f"{spec.tau}, B {spec.batch_size}, lr {spec.lr}; "
          f"{POP_DATA['n_train']}/{POP_DATA['n_test']} images) on "
          f"the card in {build_s:.2f}s: K == {c} and wire_encode_ef launches "
          f"{launches} == {c} a round; ledger == ifl_round_bytes every "
          f"round ({tr.ledger.per_round[0]} bytes); clients built "
          f"{len(tr.clients.materialized)} (<= {3 * c}); live server slots "
          f"{slots} (<= {c * (bound + 2)}); EF residuals held "
          f"{len(tr.exchange.ef_state)}, all within the window; round walls "
          f"(ms) {[round(w * 1e3, 1) for w in walls]}; peak memory "
          f"{peak:.1f} MiB, {peak - held:.1f} MiB over the {held:.1f} MiB "
          f"that earlier phases still held when it began", flush=True)
    print(f"[population] sparse save_trainer after 2 rounds ({ckpt_mb:.1f} "
          f"MB, {save_s:.2f}s), load_trainer into a fresh build_trainer, "
          f"round 3: participants and bytes == the saved trainer's own; "
          f"losses max|diff| {resume_err:.2e} (tolerance {IFL_CARD_TOL})",
          flush=True)
    if profile:
        reset_counts(ops)
        profile_run("cohort round", tr.run_round)
        print(f"[profile cohort round] launches {launch_counts(ops)}",
              flush=True)


FIG2_ASYNC_ROUNDS = 20


def twins_phase(device="cuda"):
    """The async_vs_sync twin at its defaults (byte parity gated, the
    accuracies and simulated walls printed), the fleet_scale twin at
    --nightly (bytes flat in N, parity and bounded server slots gated,
    the wall ratio printed), and the Fig. 2 twin under --mode async at
    FIG2_ASYNC_ROUNDS rounds (every scheme's uplink == the analytic sum
    of its rounds)."""
    import tempfile

    from repro_torch.api import RunResult
    from repro_torch.benchmarks import async_vs_sync, fleet_scale
    from repro_torch.benchmarks import fig2_comm_efficiency as fig2
    from repro_torch.core import (fl_round_bytes, fsl_round_bytes,
                                  ifl_round_bytes)
    from repro_torch.models.small import init_client_model, model_bytes

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        avs = async_vs_sync.main(["--device", device, "--out",
                                  str(Path(tmp) / "avs.json")])
        avs_s = time.perf_counter() - t0
        check(avs["parity_exact"] and avs["async"]["matched_uplink"],
              f"async_vs_sync: parity {avs['parity_exact']}, matched "
              f"{avs['async']['matched_uplink']}")
        print(f"[twins] async_vs_sync at its defaults ({avs['rounds']} sync "
              f"rounds, trace {avs['trace']}, codec {avs['codec']}, "
              f"{avs['broadcast']}) in {avs_s:.1f}s: per-tick byte parity "
              f"exact over {avs['async']['ticks']} ticks; at matched uplink "
              f"({avs['sync']['uplink_mb']:.3f} / "
              f"{avs['async']['uplink_mb']:.3f} MB) accuracy sync "
              f"{avs['sync']['final_acc']:.4f}, async "
              f"{avs['async']['final_acc']:.4f}; simulated wall sync "
              f"{avs['sync']['wall_clock_s']:.1f}s, async "
              f"{avs['async']['wall_clock_s']:.1f}s; uploads/s "
              f"{avs['async']['uploads_per_sec']:.3f}", flush=True)

        t0 = time.perf_counter()
        fs = fleet_scale.main(["--nightly", "--device", device, "--out",
                               str(Path(tmp) / "fleet.json")])
        fs_s = time.perf_counter() - t0
        arms, half = fs["arms"], fs["half_cohort_arm"]
        bound = fs["cohort"] * (fs["max_staleness"] + 2)
        check(all(a["parity_exact"] for a in arms + [half])
              and len({(a["up_bytes_per_round"], a["down_bytes_per_round"])
                       for a in arms}) == 1
              and all(a["max_live_server_slots"] <= bound for a in arms)
              and half["up_bytes_per_round"] * 2 == arms[-1][
                  "up_bytes_per_round"],
              "fleet_scale: " + json.dumps([
                  {k: a[k] for k in ("n_population", "cohort",
                                     "parity_exact", "up_bytes_per_round",
                                     "down_bytes_per_round",
                                     "max_live_server_slots")}
                  for a in arms + [half]]))
        ratio = arms[-1]["mean_round_s"] / arms[0]["mean_round_s"]
        print(f"[twins] fleet_scale --nightly (N {fs['ns']}, C "
              f"{fs['cohort']}, and C {half['cohort']} at N "
              f"{half['n_population']}; {fs['rounds']} rounds, codec "
              f"{fs['codec']}) in {fs_s:.1f}s: parity exact; bytes a round "
              f"flat in N ({arms[0]['up_bytes_per_round']} up, "
              f"{arms[0]['down_bytes_per_round']} down), half at C/2; live "
              f"server slots {[a['max_live_server_slots'] for a in arms]} "
              f"(<= {bound}); mean round wall (ms) "
              f"{[round(a['mean_round_s'] * 1e3, 1) for a in arms + [half]]}"
              f"; N {fs['ns'][-1]} over N {fs['ns'][0]}: {ratio:.3f}x",
              flush=True)

        t0 = time.perf_counter()
        rows = fig2.run(FIG2_ASYNC_ROUNDS, quiet=True, mode="async",
                        device=device, cache_dir=tmp)
        f2_s = time.perf_counter() - t0
        mb = {cid: model_bytes(init_client_model(
            cid, generator=torch.Generator().manual_seed(0)))
            for cid in (1, 2)}
        per_round = {"fsl": fsl_round_bytes(4, 32, 432)["up"],
                     "fl1": fl_round_bytes(4, mb[1])["up"],
                     "fl2": fl_round_bytes(4, mb[2])["up"]}
        (ifl_json,) = Path(tmp).glob("ifl_*.json")
        ifl_res = RunResult.from_json(str(ifl_json))
        ifl_up, cum = [], 0
        for rep in ifl_res.reports:
            cum += ifl_round_bytes(4, 32, 432, participating=len(
                rep["participants"]))["up"]
            ifl_up.append(cum / 1e6)
        for scheme, r, uplink_mb, acc in rows:
            want = (ifl_up[r] if scheme == "ifl"
                    else per_round[scheme] * (r + 1) / 1e6)
            check(uplink_mb == want and 0.0 <= acc <= 1.0,
                  f"fig2 async {scheme} round {r}: uplink {uplink_mb} MB "
                  f"(analytic {want}), acc {acc}")
        budget, hl = fig2.headline(rows)
        print(f"[twins] fig2_comm_efficiency.run({FIG2_ASYNC_ROUNDS} rounds, "
              f"--mode async: IFL on pareto(1.2,0.5) ticks, the baselines "
              f"barriered; 20000/4000 images) in {f2_s:.1f}s: cumulative "
              f"uplink == the analytic sum every round; IFL uplink after "
              f"{FIG2_ASYNC_ROUNDS} ticks {ifl_up[-1]:.5f} MB; at IFL-90% "
              f"budget {budget:.2f} MB: "
              f"{json.dumps({k: round(v, 4) for k, v in hl.items()})}",
              flush=True)


# ------------------------------------------------ 4l: the SPMD trainer

# The slice's main path at full width: the SPMD trainer's masked round
# step on full-width qwen1.5-0.5b at phase 4e's shapes, the masks from a
# RoundEngine under k2, ef(int4), max_staleness 1, the delta broadcast,
# the ledger from the plane's account_round (what SPMDIFLTrainer composes;
# its front door reduces named configs, as the reference's does).
SPMD_RUN = dict(arch="qwen1.5-0.5b", rounds=1, tau=2, n_clients=4, batch=2,
                seq=512, codec="ef(int4)", participation="k2",
                max_staleness=1, broadcast="delta", lr=3e-3)
# The front door on the card. The smoke config's head dim (24) is outside
# the attention kernels' {64, 128}, so on the card the spec names a model:
# qwen1.5-0.5b, which the trainer reduces (2 layers, d 256, head dim 64,
# vocab 512, fp32) and runs at the spec's d_fusion.
SPMD_SPEC = dict(scheme="ifl_spmd", model="qwen1.5-0.5b", rounds=4, tau=1,
                 lr=0.05, batch_size=2, d_fusion=128, codec="ef(int4)",
                 participation="k2", max_staleness=2, broadcast="delta",
                 eval_every=0, seed=0)
SPMD_DATA = dict(dataset="synth_tokens", n_test=8)
# A resumed LM trainer against the one it was saved from, both under
# cuDNN's deterministic algorithms: two fp32 ulps of a loss near ln(512).
SPMD_RESUME_TOL = 1e-6


def spmd_attn_launches(cfg, tau, rounds, evals=0):
    """Attention launches of masked rounds, from the engine's draws: a
    round of K participants and V valid chunks runs K x tau full passes,
    K x V modular passes and K fusion forwards; ``evals`` whole-model
    forwards without autograd (``evaluate``) add one launch a layer."""
    _, bp, bg, mp, mg = cfg._resolved_program()
    fwd, bwd = expected_attn_launches(
        cfg, steps_full=sum(k * tau for k, _ in rounds),
        steps_mod=sum(k * v for k, v in rounds),
        fwd_only=sum(k for k, _ in rounds))
    return fwd + evals * (len(bp) * bg + len(mp) * mg), bwd


def spmd_full_width_phase(ops, cfg, smi):
    """Phase 4l (a): masked rounds at full width on a (1, 1, 1) mesh of
    this process alone (an NCCL group of one rank, destroyed after the
    phase; phase 4r runs several ranks), counts set to 0 just before and
    read just after. Checks: one ``wire_encode_ef`` launch (over
    all N x B x S rows) a round with a participant; attention launches ==
    the count derived from the participants and valid chunks drawn;
    cache_valid == account_round's valid entries; ledger ==
    ``ifl_round_bytes(delta, shipped)``; finite losses; absent clients'
    params, EF rows and cache slots bitwise as before their round; the
    participants' new cache slots and EF rows against the plain
    ``wire_encode_ef`` of the round's z (codes bitwise, floats within
    ``WIRE_TOL``), whose max |err| the result carries as ``ef_err``."""
    from repro_torch.core.comm import ifl_round_bytes, tree_leaves
    from repro_torch.core.exchange import SPMDFusionExchange
    from repro_torch.core.ifl_spmd import (init_ef_state, init_ifl_state,
                                           init_payload_cache,
                                           make_ifl_round_step)
    import tempfile

    import torch.distributed as dist

    from repro_torch.core.rounds import RoundEngine
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import ref
    from repro_torch.launch.mesh import IFL_AXES, make_mesh

    r = SPMD_RUN
    n, tau, b, s = r["n_clients"], r["tau"], r["batch"], r["seq"]
    store_dir = tempfile.TemporaryDirectory()
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(store_dir.name, "store"), 1), rank=0, world_size=1)
    mesh = make_mesh((1, 1, 1), IFL_AXES)
    plane = SPMDFusionExchange(r["codec"], n_clients=n,
                               max_staleness=r["max_staleness"],
                               broadcast=r["broadcast"], mesh=mesh)
    engine = RoundEngine(n, r["participation"], seed=0, exchange=plane)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params, opt_state = init_ifl_state(cfg, n_clients=n, generator=gen,
                                       device="cuda", mesh=mesh)
    step = make_ifl_round_step(cfg, mesh=mesh, n_clients=n, tau=tau,
                               lr_base=r["lr"], lr_modular=r["lr"],
                               partial_participation=True,
                               debug_return_zhat=True, exchange=plane)
    z_shape = (n, b, s, cfg.d_fusion)
    cache = init_payload_cache(plane.codec, z_shape, (n, b, s), device="cuda")
    ef = init_ef_state(plane.codec, z_shape, device="cuda")
    entry = plane.codec.encoded_nbytes(z_shape[1:]) + b * s * 4
    stream = SyntheticLM(cfg.vocab_size, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ops)
    walls, draws, drawn, ef_err = [], [], [], 0.0
    for rnd in range(r["rounds"]):
        parts = [int(k) for k in engine.participants()]
        absent = [k for k in range(n) if k not in parts]
        # Host copies of what an absent client owns, outside the wall.
        kept = {k: ([a.cpu() for a in tree_leaves(params[k])], ef[k].cpu(),
                    {name: v[k].cpu() for name, v in cache["payload"].items()})
                for k in absent}
        t0 = time.perf_counter()
        toks = np.zeros((n, tau + 1, b, s), np.int32)
        for k in parts:   # absent clients' rows are never read
            toks[k] = np.stack([stream.sample(b, s, step=rnd * (tau + 1) + t,
                                              client=k)
                                for t in range(tau + 1)])
        draws.append(time.perf_counter() - t0)
        mask = torch.zeros(n, dtype=torch.bool)
        mask[parts] = True
        e_prev = ef   # the step builds a new residual; this one stays
        params, opt_state, m, cache, ef = step(
            params, opt_state, {"tokens": torch.from_numpy(toks).cuda()},
            mask.cuda(), cache, ef)
        losses = (float(m["base_loss"]), float(m["mod_loss"]))
        valid = int(m["cache_valid"])
        walls.append(time.perf_counter() - t0)
        entries, shipped = plane.account_round(parts, rnd, entry)
        engine.end_round({"base_loss": losses[0], "mod_loss": losses[1],
                          "participants": parts, "cache_size": entries,
                          "shipped_entries": shipped})
        check(valid == entries, f"spmd full width round {rnd}: cache_valid "
              f"{valid} != account_round's {entries}")
        check(all(np.isfinite(losses)), f"spmd round {rnd}: losses {losses}")
        want = ifl_round_bytes(n, b * s, cfg.d_fusion, codec=r["codec"],
                               participating=len(parts),
                               broadcast_entries=entries, broadcast="delta",
                               delta_entries=shipped)
        check(engine.ledger.per_round[-1] == want,
              f"spmd round {rnd}: ledger {engine.ledger.per_round[-1]} != "
              f"analytic {want}")
        if parts:
            # The round's one encode against its plain version on the
            # same z (absent clients' rows are zeros), participants' rows.
            want, e_want = ref.wire_encode_ef_ref(m["z"].float(), e_prev,
                                                  plane.codec)
            got = {name: v[parts] for name, v in cache["payload"].items()}
            ef_err = max(ef_err, payload_err(
                got, {name: v[parts] for name, v in want.items()},
                f"spmd full width round {rnd} payload"))
            torch.testing.assert_close(ef[parts], e_want[parts], **WIRE_TOL)
            ef_err = max(ef_err,
                         float((ef[parts] - e_want[parts]).abs().max()))
            del want, e_want
        del e_prev, m
        for k, (ps, e, slot) in kept.items():
            check(all(torch.equal(a, c.cpu()) for a, c in
                      zip(ps, tree_leaves(params[k])))
                  and torch.equal(e, ef[k].cpu())
                  and all(torch.equal(v, cache["payload"][name][k].cpu())
                          for name, v in slot.items()),
                  f"spmd round {rnd}: absent client {k} moved")
        drawn.append((parts, valid, losses, shipped, absent))
    got = launch_counts(ops)
    fwd, bwd = spmd_attn_launches(cfg, tau, [(len(p), v) for p, v, *_ in
                                             drawn])
    with_part = sum(1 for p, *_ in drawn if p)
    check(got["wire_encode_ef"] == with_part and with_part > 0,
          f"spmd full width: wire_encode_ef launches {got['wire_encode_ef']} "
          f"!= {with_part} rounds with a participant")
    check(got["flash_attention"] == fwd and got["flash_attention_bwd"] == bwd,
          f"spmd full width: attention launches {got} != fwd {fwd}, bwd {bwd}")
    check(all(got[k] == 0 for k in got if k not in (
        "wire_encode_ef", "flash_attention", "flash_attention_bwd")),
          f"spmd full width: other kernels launched {got}")
    gathered = [g["payload"] + g["labels"] + g["age"] for g in plane.gathered]
    dist.destroy_process_group()
    store_dir.cleanup()
    print(f"[spmd] full width {cfg.name} ({cfg.num_layers} layers, d "
          f"{cfg.d_model}, vocab {cfg.vocab_size}, {cfg.compute_dtype}) on a "
          f"(1, 1, 1) mesh of one NCCL rank (bytes handed to the all-gather "
          f"a round {gathered}), N "
          f"{n}, tau {tau}, B {b}, S {s}, {r['codec']} over "
          f"{n * b * s} x {cfg.d_fusion} rows, {r['participation']} masks, "
          f"max_staleness {r['max_staleness']}, delta, {r['rounds']} rounds: "
          f"participants {[p for p, *_ in drawn]}, cache_valid "
          f"{[v for _, v, *_ in drawn]} == account_round's valid entries, "
          f"shipped {[d[3] for d in drawn]}; wire_encode_ef launches "
          f"{got['wire_encode_ef']} == {with_part} rounds with a participant; "
          f"attention launches fwd {fwd} bwd {bwd} == derived; ledger == "
          f"analytic every round ({engine.ledger.per_round}); losses "
          f"{[tuple(round(x, 4) for x in d[2]) for d in drawn]}; absent "
          f"clients {[d[4] for d in drawn]} bitwise frozen (params, EF rows, "
          f"cache slots); participants' payloads and EF rows vs the plain "
          f"wire_encode_ef of the round's z: codes bitwise, max|err| "
          f"{ef_err:.3e}; round walls (s) {[round(w, 3) for w in walls]}, "
          f"host draw of the participants' tokens (s) "
          f"{[round(d, 3) for d in draws]}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card {smi}",
          flush=True)
    del params, opt_state, cache, ef
    torch.cuda.empty_cache()
    out = {k: got[k] for k in ("wire_encode_ef", "flash_attention",
                               "flash_attention_bwd")}
    out["ef_err"] = ef_err
    return out


def spmd_card_vs_cpu(ops, spec):
    """``run_experiment(spec)`` (scheme ifl_spmd) on the card and on the
    CPU from the same slot inits: participants and bytes equal, losses
    within LM_LOSS_TOL, launches on the card == derived.
    -> (runs by device, the slot inits)."""
    from repro_torch.api import build_trainer, run_experiment

    init = [tree_numpy(p) for p in build_trainer(spec, device="cpu").params]
    runs = {}
    for dev in ("cpu", "cuda"):
        if dev == "cuda":
            torch.cuda.synchronize()
            reset_counts(ops)
        runs[dev] = run_experiment(spec, device=dev, params=init,
                                   keep_trainer=True)
    got = launch_counts(ops)
    card, cpu = runs["cuda"].trainer, runs["cpu"].trainer
    hist = card.engine.history
    cfg = card.model_cfg
    fwd, bwd = spmd_attn_launches(
        cfg, spec.tau, [(len(h.participants), h["cache_size"]) for h in hist],
        evals=spec.fleet.n_clients)
    with_part = sum(1 for h in hist if h.participants)
    wire = "wire_encode_ef" if spec.codec.startswith("ef(") else "wire_encode"
    check(got[wire] == with_part
          and got["flash_attention"] == fwd
          and got["flash_attention_bwd"] == bwd,
          f"spmd front door: launches {got} != {wire} {with_part}, "
          f"fwd {fwd}, bwd {bwd}")
    check(same_reports(runs["cuda"].reports, runs["cpu"].reports,
                       ("participants", "cache_size", "shipped_entries",
                        "uplink_mb", "downlink_mb"))
          and card.ledger.per_round == cpu.ledger.per_round,
          "spmd front door: participants or bytes differ card vs CPU")
    loss_err = max_metric_diff(runs["cuda"].reports, runs["cpu"].reports)
    check(loss_err <= LM_LOSS_TOL,
          f"spmd front door: card vs CPU losses differ by {loss_err}")
    print(f"[spmd] run_experiment(ifl_spmd, model {spec.model} -> "
          f"{cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, head dim "
          f"{cfg.resolved_head_dim}, {cfg.compute_dtype}; d_fusion "
          f"{spec.d_fusion}, B {spec.batch_size}, S {card.seq}, tau "
          f"{spec.tau}, {spec.codec}, {spec.participation}, max_staleness "
          f"{spec.max_staleness}, delta, {spec.rounds} rounds) card vs CPU "
          f"from the same slot inits: participants "
          f"{[h.participants for h in hist]} and bytes "
          f"{card.ledger.per_round} equal; losses max|card - cpu| "
          f"{loss_err:.2e} (tolerance {LM_LOSS_TOL}); launches on the card "
          f"{wire} {with_part}, attention fwd {fwd} bwd {bwd} == "
          f"derived (evaluation included); accuracies card "
          f"{[round(a, 4) for a in runs['cuda'].final['accs']]} cpu "
          f"{[round(a, 4) for a in runs['cpu'].final['accs']]}", flush=True)
    return runs, init, got


def spmd_lockstep(ops, spec):
    """``spec`` (scheme ifl_spmd, an int4 or int8_row codec, EF or not)
    on the card and on the CPU in lockstep: before each round the card
    trainer takes the CPU trainer's state (its snapshot, moved to the
    card), so each round compares one round's arithmetic. Per round:
    participants and bytes equal, one encode launch a round with a
    participant, the payload codes of the cache within the codec's flip
    budget (``_wire_budget``: each side encodes a z whose sums ran in
    another order, so fewer than 2% of the codes may differ, each by one
    step), and the losses within LM_LOSS_TOL where both sides decode the
    same codes (below); the differing codes are counted. -> (max gated
    |loss diff|, differing codes per round, codes a round, per-round
    (|base_loss diff|, |mod_loss diff|))."""
    import _wire_budget as budget
    from repro_torch.api import build_trainer
    from repro_torch.models.modules import tree_map

    cpu = build_trainer(spec, device="cpu")
    card = build_trainer(spec, device="cuda",
                         params=[tree_numpy(p) for p in cpu.params])
    kind = "int8_row" if "int8_row" in spec.codec else "int4"
    wire = "wire_encode_ef" if spec.codec.startswith("ef(") else "wire_encode"
    diffs, flips, n_codes = [], [], 0
    for r in range(spec.rounds):
        tree, aux = cpu.snapshot()
        card.restore(tree_map(lambda t: t.to("cuda"), tree),
                     json.loads(json.dumps(aux)))
        reset_counts(ops)
        got = card.run_round().to_dict()
        want = cpu.run_round().to_dict()
        torch.cuda.synchronize()
        label = f"spmd lockstep {spec.codec} round {r}"
        check(getattr(ops, wire).launches == (1 if got["participants"]
                                              else 0),
              f"{label}: {wire} launches {getattr(ops, wire).launches}")
        check(same_reports([got], [want], ("participants", "cache_size",
                                           "shipped_entries", "uplink_mb",
                                           "downlink_mb")),
              f"{label}: participants or bytes differ")
        a = budget.codes(kind, card.cache["payload"], spec.d_fusion)
        b = budget.codes(kind, cpu.cache["payload"], spec.d_fusion)
        flips.append(int(budget.codes_close(a, b, label).sum()))
        n_codes = a.size
        diffs.append((abs(got["base_loss"] - want["base_loss"]),
                      abs(got["mod_loss"] - want["mod_loss"])))
    # The base loss of every round, and the modular loss of every round in
    # which both sides decode the same codes, within LM_LOSS_TOL; in a
    # round with a flipped code the modular block trains on a z element
    # one code step apart, and the codes are held to the budget instead.
    err = max(max(d[0] for d in diffs),
              max((d[1] for d, f in zip(diffs, flips) if not f), default=0))
    check(err <= LM_LOSS_TOL, f"spmd lockstep {spec.codec}: losses differ "
          f"by {err}")
    return err, flips, n_codes, diffs


def spmd_front_door_phase(ops):
    """Phase 4l (b) and (c): ``run_experiment(ifl_spmd)`` on the card and
    on the CPU from the same slot inits, on the reduced qwen1.5-0.5b and
    on the smoke config (head dim 24, on the padded attention kernels); a
    save/resume on the card; async ticks; a population of 1,000 with a
    cohort of 8; an int8_row run; the trained card run exported by
    ``from_spmd_trainer`` and served."""
    import tempfile

    from repro_torch.api import (DataSpec, ExperimentSpec, FleetSpec,
                                 build_trainer, load_trainer, save_trainer)
    from repro_torch.serve import CompositionStore, ServeEngine
    from repro_torch.serve.types import Request

    # The smoke config (head dim 24) end to end under int8_row, then under
    # ef(int4), the codec of the rest of this phase, in lockstep: at its
    # d_fusion 32 a last-bit change of z can flip an int4 code (a step of
    # 1/7 of a row's max), and in a free run the flipped code moves every
    # later round, so each round starts on both sides from the CPU's state
    # and the flipped codes are counted against the codec's budget.
    smoke = ExperimentSpec(**{**SPMD_SPEC, "model": "", "d_fusion": 32,
                              "codec": "int8_row"},
                           data=DataSpec(**SPMD_DATA))
    _, _, smoke_got = spmd_card_vs_cpu(ops, smoke)
    ef_smoke = smoke.replace(codec="ef(int4)")
    lock_err, lock_flips, lock_codes, lock_diffs = spmd_lockstep(ops,
                                                                 ef_smoke)
    print(f"[spmd] smoke config (head dim 24), ef(int4), {ef_smoke.rounds} "
          f"rounds card vs CPU in lockstep (each round from the CPU's "
          f"state): participants and bytes equal, one wire_encode_ef launch "
          f"a round with a participant; int4 codes that differ per round "
          f"{lock_flips} of {lock_codes} (budget: < 2%, one step each); "
          f"|base_loss|, |mod_loss| card - cpu per round "
          f"{[(float(f'{a:.3g}'), float(f'{b:.3g}')) for a, b in lock_diffs]}"
          f": base every round and mod in rounds with no differing code "
          f"within {LM_LOSS_TOL} (max {lock_err:.2e})", flush=True)
    spec = ExperimentSpec(**SPMD_SPEC, data=DataSpec(**SPMD_DATA))
    runs, init, _ = spmd_card_vs_cpu(ops, spec)
    card = runs["cuda"].trainer
    cfg = card.model_cfg

    with tempfile.TemporaryDirectory() as tmp:
        first = build_trainer(spec, device="cuda", params=init)
        for _ in range(2):
            first.run_round()
        path = str(Path(tmp) / "trainer")
        save_trainer(path, first)
        resumed = load_trainer(path, build_trainer(spec, device="cuda"))
        with torch.backends.cudnn.flags(
                enabled=torch.backends.cudnn.enabled,
                benchmark=torch.backends.cudnn.benchmark,
                deterministic=True,
                allow_tf32=torch.backends.cudnn.allow_tf32):
            want = [first.run_round().to_dict() for _ in range(2)]
            tail = [resumed.run_round().to_dict() for _ in range(2)]
        check(same_reports(tail, want, ("participants", "cache_size",
                                        "shipped_entries", "uplink_mb",
                                        "downlink_mb"))
              and same_reports(tail, runs["cuda"].reports[2:],
                               ("participants", "uplink_mb", "downlink_mb")),
              "spmd resume: participants or bytes differ")
        resume_err = max_metric_diff(tail, want)
        check(resume_err <= SPMD_RESUME_TOL,
              f"spmd resume: losses differ by {resume_err}")

        # (c) the trained card run, exported and served on the card.
        store = CompositionStore.from_spmd_trainer(card)
        art = str(Path(tmp) / "artifact.npz")
        store.save(art)
        reqs = [Request(rid=i, tenant=t, prompt=[1 + i, 2, 3, 4],
                        max_new_tokens=8)
                for i, t in enumerate(store.tenants())]
        engine = ServeEngine(store, width=2, cache_len=32, horizon=4,
                             device="cuda")
        reset_counts(ops)
        comps = engine.run(reqs)
        torch.cuda.synchronize()
        decode_launches = ops.flash_decode.launches
        steps = sum(lane.composed_steps for lane in engine.lanes())
        check(decode_launches == cfg.num_layers * steps and steps > 0,
              f"spmd serve: flash_decode launches {decode_launches} != "
              f"{cfg.num_layers} layers x {steps} composed steps")
        served = [c.tokens for c in comps]
        check(served == [engine.oracle(q).tokens for q in reqs],
              "spmd serve: engine != oracle")
        cpu_eng = ServeEngine(CompositionStore.load(art, device="cpu"),
                              width=2, cache_len=32, horizon=4, device="cpu")
        check(served == [c.tokens for c in cpu_eng.run(reqs)],
              "spmd serve: card tokens != the plain version's on the CPU")
    fusion = sum(store.entry(t).fusion is not None for t in store.tenants())
    print(f"[spmd] save_trainer after 2 rounds, load_trainer into a fresh "
          f"trainer, rounds 3-4 under cudnn.deterministic: participants and "
          f"bytes == the saved trainer's; losses max|diff| {resume_err:.2e} "
          f"(tolerance {SPMD_RESUME_TOL})", flush=True)
    print(f"[spmd serve] from_spmd_trainer of the trained card run: "
          f"{len(store)} tenants ({fusion} with the valid cache slot's "
          f"decoded fusion state), saved and served: {len(reqs)} requests x 8 "
          f"tokens, {steps} composed steps, flash_decode launches "
          f"{decode_launches} == {cfg.num_layers} layers x {steps}; engine == "
          f"oracle == the plain version on the CPU (artifact reloaded there); "
          f"tokens {served}", flush=True)

    # Async ticks: one wire_encode_ef launch a tick with an upload.
    aspec = spec.replace(mode="async", trace="pareto(1.2,0.5)",
                         participation="full", rounds=6)
    reset_counts(ops)
    tr = build_trainer(aspec, device="cuda", params=init)
    ticks = [tr.run_round() for _ in range(aspec.rounds)]
    uploads = sum(1 for t in ticks if t.participants)
    check(ops.wire_encode_ef.launches == uploads,
          f"spmd async: wire_encode_ef launches {ops.wire_encode_ef.launches}"
          f" != {uploads} ticks with an upload")
    print(f"[spmd async] {aspec.rounds} ticks of {aspec.trace}: participants "
          f"{[t.participants for t in ticks]}, arrivals "
          f"{[t['arrivals'] for t in ticks]}; wire_encode_ef launches "
          f"{uploads} == ticks with an upload", flush=True)

    # A population of 1,000 slots, a cohort of 8 a round.
    pspec = spec.replace(participation="full", rounds=3, max_staleness=1,
                         fleet=FleetSpec(n_population=1000, cohort=8))
    reset_counts(ops)
    tr = build_trainer(pspec, device="cuda")
    walls = []
    for _ in range(pspec.rounds):
        t0 = time.perf_counter()
        rep = tr.run_round()
        walls.append(time.perf_counter() - t0)
        live = sum(r is not None for r in tr.exchange._last_upload)
        check(len(rep.participants) == 8
              and live <= 8 * (pspec.max_staleness + 1)
              and len(tr.ef_store) <= 8 * (pspec.max_staleness + 1),
              f"spmd cohort round {rep.round}: K {len(rep.participants)}, "
              f"live slots {live}, EF residuals {len(tr.ef_store)}")
        check(tr.ledger.per_round[-1]["up"] == 8 * tr._entry_bytes,
              f"spmd cohort: uplink {tr.ledger.per_round[-1]}")
    check(ops.wire_encode_ef.launches == pspec.rounds,
          f"spmd cohort: wire_encode_ef launches {ops.wire_encode_ef.launches}")
    print(f"[spmd cohort] N 1000, C 8, {pspec.codec}, max_staleness "
          f"{pspec.max_staleness}, {pspec.rounds} rounds: K == 8 every round, "
          f"live server slots {live} <= {8 * (pspec.max_staleness + 1)}, EF "
          f"residuals {len(tr.ef_store)}, slots materialized {len(tr.store)}; "
          f"wire_encode_ef launches {pspec.rounds}; ledger {tr.ledger.per_round};"
          f" round walls (ms) {[round(w * 1e3, 1) for w in walls]}",
          flush=True)

    # int8_row once: wire_encode, one launch a round with a participant.
    ispec = spec.replace(codec="int8_row", rounds=2)
    reset_counts(ops)
    tr = build_trainer(ispec, device="cuda", params=init)
    reps = [tr.run_round() for _ in range(ispec.rounds)]
    with_part = sum(1 for r in reps if r.participants)
    check(ops.wire_encode.launches == with_part
          and ops.wire_encode_ef.launches == 0,
          f"spmd int8_row: wire_encode launches {ops.wire_encode.launches} != "
          f"{with_part}")
    print(f"[spmd int8_row] {ispec.rounds} rounds: wire_encode launches "
          f"{with_part} == rounds with a participant", flush=True)
    return {"wire_encode": with_part, "flash_decode": decode_launches,
            "smoke_attention": smoke_got["flash_attention"],
            "smoke_attention_bwd": smoke_got["flash_attention_bwd"]}


def llm_twin_phase(ops):
    """The twin of examples/llm_ifl_train.py for 5 rounds on the card
    (olmo-100m, fp32): finite losses, attention launches == derived."""
    from repro_torch.examples import llm_ifl_train

    reset_counts(ops)
    t0 = time.perf_counter()
    out = llm_ifl_train.main(["--rounds", "5"])
    wall = time.perf_counter() - t0
    cfg, h = llm_ifl_train.olmo_100m(), out["history"]
    fwd, bwd = expected_attn_launches(cfg, steps_full=5 * 4 * 4,
                                      steps_mod=5 * 4 * 4, fwd_only=5 * 4)
    got = launch_counts(ops)
    check(all(np.isfinite(x["base_loss"]) and np.isfinite(x["mod_loss"])
              for x in h), f"llm twin: losses {h}")
    check(got["flash_attention"] == fwd and got["flash_attention_bwd"] == bwd,
          f"llm twin: attention launches {got} != fwd {fwd}, bwd {bwd}")
    print(f"[llm twin] python -m repro_torch.examples.llm_ifl_train --rounds "
          f"5 ({out['n_params'] / 1e6:.1f}M params): base loss "
          f"{h[0]['base_loss']:.3f} -> {h[-1]['base_loss']:.3f}, modular "
          f"{h[0]['mod_loss']:.3f} -> {h[-1]['mod_loss']:.3f}; attention "
          f"launches fwd {fwd} bwd {bwd} == derived; {wall:.1f} s, round walls "
          f"(s) {[round(w, 3) for w in out['walls']]}", flush=True)


# ---------------------------------------- 4r: the round on a mesh of ranks

# Phase 4r: phase 4l's model and shapes (full-width qwen1.5-0.5b, N 4,
# tau 2, B 2, S 512, lr 3e-3) on MESH_RANKS spawned ranks, one round per
# mesh: full participation under int8_row on (4, 1, 1), where each rank
# holds one client, and ef(int4) under the first k2 mask of a
# RoundEngine (max_staleness 1) on (2, 2, 1), where each rank holds two
# clients and one row of their minibatches. Each is held to the same
# round in one process on the card. The tokens are a numpy draw
# (phase 4l runs the host's SyntheticLM draw; here it would only add
# time). Both sides run under torch's deterministic algorithms.
MESH_RANKS = 4
MESH_SEED = 0
MESH_RUNS = (
    dict(shape=(4, 1, 1), codec="int8_row", participation="full"),
    dict(shape=(2, 2, 1), codec="ef(int4)", participation="k2"),
)
# (2, 2, 1) against one process: each gradient is the mean of two
# one-row gradients, whose bf16 products sum in other orders than the
# two-row ones, so params, and with them the bf16 fusion outputs z,
# drift by bf16 roundings. Losses within MESH_LOSS_TOL; each client's
# params within MESH_UPDATE_TOL of its largest update in the one-process
# round; z within MESH_Z_TOL of the one-process z's largest magnitude
# (1.754e-2 on an H100 80GB HBM3, both sides under deterministic
# algorithms). The codes are a function of z: a rank's new cache slots
# and EF rows are held to the plain ``wire_encode_ef`` of its own z
# (codes bitwise, floats within WIRE_TOL). The share of int4 codes that
# differ from the one-process round's is printed, not held: with z
# itself apart by bf16 roundings it is 2.6%, past the 2% flip budget of
# tests/_wire_budget.py, which bounds two summation orders of one
# projection on the same inputs. Ages and labels exact; absent clients
# bitwise.
MESH_LOSS_TOL = 1e-2
MESH_UPDATE_TOL = 0.05
MESH_Z_TOL = 0.02


def mesh_state(cfg, run, device, mesh=None):
    """Phase 4r's init, plane, step and carried state for one mesh run
    (``mesh`` None: the one-process round)."""
    from repro_torch.core.exchange import SPMDFusionExchange
    from repro_torch.core.ifl_spmd import (init_ef_state, init_ifl_state,
                                           init_payload_cache,
                                           make_ifl_round_step)

    r, n = SPMD_RUN, SPMD_RUN["n_clients"]
    gen = torch.Generator(device=device).manual_seed(MESH_SEED)
    params, opt_state = init_ifl_state(cfg, n_clients=n, generator=gen,
                                       device=device, mesh=mesh)
    plane = SPMDFusionExchange(run["codec"], n_clients=n, max_staleness=1,
                               mesh=mesh)
    plane.time_gather = mesh is not None
    masked = run["participation"] != "full"
    step = make_ifl_round_step(cfg, mesh=mesh, n_clients=n, tau=r["tau"],
                               lr_base=r["lr"], lr_modular=r["lr"],
                               partial_participation=masked,
                               debug_return_zhat=True, exchange=plane)
    lay = plane.layout
    per = n if lay is None else lay.per
    rows = r["batch"] if lay is None else r["batch"] // lay.n_data
    z_shape = (per, rows, r["seq"], cfg.d_fusion)
    ef = init_ef_state(plane.codec, z_shape, device=device)
    cache = (init_payload_cache(plane.codec, z_shape, z_shape[:3],
                                device=device) if masked else None)
    return params, opt_state, plane, step, ef, cache


def mesh_batch(cfg, device):
    r = SPMD_RUN
    toks = np.random.default_rng(MESH_SEED).integers(
        0, cfg.vocab_size, size=(r["n_clients"], r["tau"] + 1, r["batch"],
                                 r["seq"])).astype(np.int32)
    return {"tokens": torch.from_numpy(toks).to(device)}


def mesh_round(cfg, run, mask, device, mesh=None):
    """One phase 4r round -> (params, metrics, cache, ef, wall s, plane)."""
    params, opt_state, plane, step, ef, cache = mesh_state(cfg, run, device,
                                                           mesh)
    args = [params, opt_state, mesh_batch(cfg, device)]
    if mask is not None:
        args += [torch.tensor(mask, device=device), cache]
    if plane.codec.has_state:
        args.append(ef)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = step(*args)
    m = out[2]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if mask is not None:
        cache = out[3]
    if plane.codec.has_state:
        ef = out[-1]
    return out[0], m, cache, ef, wall, plane


def mesh_rank(rank, world, backend, store_path, out_dir, masks, refs):
    """One rank of phase 4r: joins the world, runs each MESH_RUNS round on
    its mesh, holds its clients' results to the one-process ``refs``
    (CUDA tensors shared by the parent), checks its launch counts, and
    writes what it saw to ``out_dir/rank<r>.json``."""
    import warnings

    import torch.distributed as dist

    from _wire_budget import codes
    from repro_torch.configs import get_config
    from repro_torch.core.comm import tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import wire_encode_ef_ref
    from repro_torch.launch.mesh import IFL_AXES, make_mesh

    # The parent frees the blocks it shared into ``refs`` only once every
    # rank has dropped its handles, and a spawned rank leaves through
    # ``os._exit``, which runs no destructor: move them out of the
    # argument list, so they die when this function returns.
    refs, shared = list(refs), refs
    shared.clear()
    torch.cuda.set_device(rank % torch.cuda.device_count())
    dev = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    warnings.simplefilter("ignore")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        cfg = get_config(SPMD_RUN["arch"])
        tau, d = SPMD_RUN["tau"], cfg.d_fusion
        result = {"rank": rank, "device": str(dev), "runs": []}
        for run, mask, ref in zip(MESH_RUNS, masks, refs):
            mesh = make_mesh(run["shape"], IFL_AXES)
            reset_counts(ops)
            params, m, cache, ef, wall, plane = mesh_round(cfg, run, mask,
                                                           dev, mesh)
            counts = launch_counts(ops)
            lay = plane.layout
            mine, rows = lay.clients, lay.rows(SPMD_RUN["batch"])
            act = [i for i, k in enumerate(mine) if mask is None or mask[k]]
            losses = [float(m["base_loss"]), float(m["mod_loss"])]
            valid = (SPMD_RUN["n_clients"] if mask is None
                     else int(m["cache_valid"]))
            fwd, bwd = expected_attn_launches(
                cfg, steps_full=len(act) * tau, steps_mod=len(act) * valid,
                fwd_only=len(act))
            kern = "wire_encode_ef" if plane.codec.has_state else "wire_encode"
            check(counts[kern] == (1 if act else 0)
                  and counts["flash_attention"] == fwd
                  and counts["flash_attention_bwd"] == bwd
                  and all(v == 0 for k, v in counts.items() if k not in (
                      kern, "flash_attention", "flash_attention_bwd")),
                  f"mesh {run['shape']} rank {rank}: launches {counts} != "
                  f"{kern} {1 if act else 0}, fwd {fwd}, bwd {bwd}")
            rec = {"shape": run["shape"], "codec": run["codec"],
                   "clients": mine, "active": [mine[i] for i in act],
                   "losses": losses, "wall_s": wall, "launches": counts,
                   "gathered": plane.gathered}
            exact = run["participation"] == "full"
            if exact:
                check(losses == ref["losses"]
                      and torch.equal(m["z_hat"], ref["z_hat"][:, rows].to(dev))
                      and all(torch.equal(a, b.to(dev))
                              for i, k in enumerate(mine)
                              for a, b in zip(tree_leaves(params[i]),
                                              tree_leaves(ref["params"][k]))),
                      f"mesh {run['shape']} rank {rank}: not bitwise the "
                      f"one-process round (losses {losses} vs "
                      f"{ref['losses']})")
            else:
                loss_err = max(abs(a - b) for a, b in zip(losses,
                                                          ref["losses"]))
                upd = []
                for i, k in enumerate(mine):
                    err = max(float((a - b.to(dev)).abs().max())
                              for a, b in zip(tree_leaves(params[i]),
                                              tree_leaves(ref["params"][k])))
                    if k in rec["active"]:
                        upd.append(err / ref["update"][k])
                    else:   # absent: bitwise its init, as in one process
                        check(err == 0.0, f"mesh rank {rank}: absent client "
                              f"{k} moved by {err}")
                # The codes against the plain encode of this rank's z
                # (the first round's EF residual is zeros).
                z_err = wire_err = 0.0
                if act:
                    z_ref = ref["z"][mine][:, rows].to(dev).float()[act]
                    z_err = (float((m["z"].float()[act] - z_ref).abs().max())
                             / float(z_ref.abs().max()))
                    plain, e_plain = wire_encode_ef_ref(
                        m["z"].float(), torch.zeros_like(ef), plane.codec)
                    wire_err = payload_err(
                        {k: v[act] for k, v in cache["payload"].items()},
                        {k: v[act] for k, v in plain.items()},
                        f"mesh rank {rank} cache")
                    torch.testing.assert_close(ef[act], e_plain[act],
                                               **WIRE_TOL)
                    wire_err = max(wire_err, float(
                        (ef[act] - e_plain[act]).abs().max()))
                want = {name: v[mine][:, rows].to(dev)
                        for name, v in ref["cache"]["payload"].items()}
                flips = codes("int4", cache["payload"], d) != codes(
                    "int4", want, d)
                check(torch.equal(cache["age"],
                                  ref["cache"]["age"][mine].to(dev))
                      and torch.equal(cache["tokens"], ref["cache"]["tokens"][
                          mine][:, rows].to(dev))
                      and loss_err <= MESH_LOSS_TOL
                      and max(upd, default=0.0) <= MESH_UPDATE_TOL
                      and z_err <= MESH_Z_TOL,
                      f"mesh {run['shape']} rank {rank}: loss err "
                      f"{loss_err}, params/update {upd}, z err {z_err}")
                rec.update(loss_err=loss_err, update_err=max(upd, default=0),
                           z_err=z_err, flips=float(flips.mean()),
                           wire_err=wire_err)
            result["runs"].append(rec)
            del params, cache, ef, m
            torch.cuda.empty_cache()
            dist.barrier()
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()


def mesh_phase(ops, smi):
    """Phase 4r: the MESH_RUNS rounds on MESH_RANKS spawned ranks (NCCL,
    one card each, where the machine has that many; else gloo, every
    rank on cuda:0, CUDA tensors and the kernels on every rank), each
    held to the same round in one process; the kernels the earlier
    phases built are loaded, not rebuilt. -> the launches of #1, #2, #8
    and #8b summed over the ranks."""
    import tempfile
    import warnings

    import torch.multiprocessing as mp

    from repro_torch.configs import get_config
    from repro_torch.core.codec import get_codec
    from repro_torch.core.comm import tree_leaves
    from repro_torch.core.rounds import RoundEngine
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    mem0 = torch.cuda.memory_allocated()
    cfg = get_config(SPMD_RUN["arch"])
    n = SPMD_RUN["n_clients"]
    masks = []
    for run in MESH_RUNS:
        if run["participation"] == "full":
            masks.append(None)
            continue
        parts = {int(k) for k in RoundEngine(
            n, run["participation"], seed=MESH_SEED).participants()}
        masks.append([k in parts for k in range(n)])
    # The one-process rounds, kept on the card for the ranks.
    refs = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for run, mask in zip(MESH_RUNS, masks):
                params, m, cache, ef, wall, _ = mesh_round(cfg, run, mask,
                                                           "cuda")
                ref = {"losses": [float(m["base_loss"]),
                                  float(m["mod_loss"])],
                       "z_hat": m["z_hat"], "params": params,
                       "cache": cache, "wall_s": wall,
                       "z": m["z"]}
                if mask is not None:
                    # Each client's largest update, against its init drawn
                    # again (the init is a function of the seed alone).
                    init = mesh_state(cfg, run, "cuda")[0]
                    ref["update"] = [max(float((a - b).abs().max()) for a, b
                                         in zip(tree_leaves(p),
                                                tree_leaves(q)))
                                     for p, q in zip(params, init)]
                    del init
                    ref["z_hat"] = None
                refs.append(ref)
                del m
                torch.cuda.empty_cache()
        finally:
            torch.use_deterministic_algorithms(False)
    ref_s = time.perf_counter() - t0
    ref_walls = [ref.pop("wall_s") for ref in refs]
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= MESH_RANKS else "gloo"
    built = sorted(p.name for p in build.BUILD_DIR.iterdir())
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        ctx = mp.start_processes(
            mesh_rank, args=(MESH_RANKS, backend, os.path.join(tmp, "store"),
                             tmp, masks, refs),
            nprocs=MESH_RANKS, join=False, start_method="spawn")
        deadline = time.monotonic() + 600
        try:
            while not ctx.join(timeout=1.0):
                check(time.monotonic() < deadline,
                      "mesh ranks still running after 600 s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        ranks_s = time.perf_counter() - t1
        res = []
        for r in range(MESH_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                res.append(json.load(f))
    check(sorted(p.name for p in build.BUILD_DIR.iterdir()) == built,
          "mesh ranks built kernels again")
    # The references went to the ranks through CUDA IPC: their blocks are
    # freed once collected here (after each rank dropped its handles),
    # not when the last name goes.
    del refs, ref, params, cache, ef
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    check(torch.cuda.memory_allocated() <= mem0,
          f"mesh phase kept {torch.cuda.memory_allocated() - mem0} bytes on "
          f"the card")
    out = {"wire_encode": 0, "wire_encode_ef": 0, "flash_attention": 0,
           "flash_attention_bwd": 0}
    how = (f"NCCL, one card a rank ({cards} cards)" if backend == "nccl" else
           f"gloo, all {MESH_RANKS} ranks sharing cuda:0 ({cards} card"
           f"{'s' if cards > 1 else ''})")
    print(f"[mesh] phase 4r: {MESH_RANKS} ranks over {how}; {cfg.name} at "
          f"its widths, N {n}, tau {SPMD_RUN['tau']}, B {SPMD_RUN['batch']}, "
          f"S {SPMD_RUN['seq']}, lr {SPMD_RUN['lr']}; the kernels loaded, "
          f"not rebuilt ({len(built)} files in the build directory before "
          f"and after)", flush=True)
    for j, run in enumerate(MESH_RUNS):
        recs = [r["runs"][j] for r in res]
        for rec in recs:
            for k in out:
                out[k] += rec["launches"][k]
        handed = [sum(v for k, v in g.items() if k != "seconds")
                  for rec in recs for g in rec["gathered"]]
        secs = [g["seconds"] for rec in recs for g in rec["gathered"]]
        entry = (get_codec(run["codec"]).encoded_nbytes(
            (SPMD_RUN["batch"], SPMD_RUN["seq"], cfg.d_fusion))
            + SPMD_RUN["batch"] * SPMD_RUN["seq"] * 4)
        if run["participation"] == "full":
            check(sum(handed) == n * entry,
                  f"mesh {run['shape']}: {sum(handed)} bytes handed to the "
                  f"collective != the ledger's uplink {n} x {entry}")
            note = (f"bitwise the one-process round (losses "
                    f"{recs[0]['losses']}, every rank's params and decoded "
                    f"chunks); bytes handed to the all-gather {handed} "
                    f"(sum {sum(handed)} == the ledger's uplink {n} x "
                    f"{entry})")
        else:
            part = sum(masks[j])
            ages = run["shape"][1] * n * 4
            check(sum(handed) == n * entry + ages,
                  f"mesh {run['shape']}: {sum(handed)} bytes handed to the "
                  f"collective != the whole cache {n} x {entry} + {ages}")
            note = (f"mask {masks[j]}: losses {recs[0]['losses']} vs one "
                    f"process {[round(x, 6) for x in recs[0]['losses']]}"
                    f", max |loss err| {max(r['loss_err'] for r in recs):.2e}"
                    f" (tol {MESH_LOSS_TOL}), params max|err| / the "
                    f"client's largest update "
                    f"{max(r['update_err'] for r in recs):.3e} (tol "
                    f"{MESH_UPDATE_TOL}), z max|err| / max|z| "
                    f"{max(r['z_err'] for r in recs):.3e} (tol "
                    f"{MESH_Z_TOL}); the participants' cache slots and EF "
                    f"rows vs the plain wire_encode_ef of the rank's own z: "
                    f"codes bitwise, floats max|err| "
                    f"{max(r['wire_err'] for r in recs):.2e}; int4 codes "
                    f"that differ from the one-process round's "
                    f"{max(r['flips'] for r in recs):.2e}; ages, "
                    f"labels and absent clients exact; bytes handed "
                    f"{handed} (the whole cache: {n} entries of {entry} == "
                    f"{n * entry}, plus {ages} of int32 ages, where the "
                    f"ledger counts "
                    f"{part} fresh uploads)")
        print(f"[mesh] {run['shape']} {run['codec']}: {note}; round wall per "
              f"rank (s) {[round(r['wall_s'], 3) for r in recs]} (one "
              f"process {ref_walls[j]:.3f}); all-gather wall per rank (s) "
              f"{[round(s, 4) for s in secs]}; launches per rank "
              f"{[{k: r['launches'][k] for k in out} for r in recs]} == "
              f"derived; card {smi}", flush=True)
    print(f"[mesh] phase 4r took {time.perf_counter() - t0:.1f}s (one-process "
          f"references {ref_s:.1f}s, ranks {ranks_s:.1f}s)", flush=True)
    return out

# Phase 4m: the recurrent mixers and cross-family composition. olmo-1b
# runs at its published widths but for d_fusion: the two vendors share
# xlstm-350m's 1024 as their common fusion dim (olmo-1b's own is 2048).
CROSS_D_FUSION = 1024
# The IFL run's sequence is cut to 64: sLSTM is an eager loop over time
# (plain PyTorch, ~20 launches a step a layer, three passes under remat),
# so a full-width DP step at S 512 takes ~10-18 s on the card and an IFL
# round (N 4, tau 2: 8 full and 16 modular passes) would take ~300 s (at
# S 128 up to 63.5 s, the phase's largest step).
# Both runs use the CLI's lr 3e-3. At init xlstm-350m's gradient is large
# (|g| ~1e2, printed by the gradient check), so one SGD step at 3e-3 is
# far past the first-order regime and a batch's loss after three steps may
# sit above or below where it started; that the gradient is right at full
# width is checked directly, by the first-order drop of the loss along it
# (``full_width_grad_check``).
RECUR_RUN = dict(arch="xlstm-350m", tau=2, n_clients=4, batch=2, seq=512,
                 ifl_seq=64, dp_steps=1, ifl_rounds=1, lr=3e-3)
# The gradient check's step: eps = GRAD_DROP / |g|^2 along -g lowers the
# loss by GRAD_DROP to first order (~1e3 times the fp32 loss's rounding,
# and ~1e-3 of the 3e-3 step); the measured drop must be within
# GRAD_TOL of the prediction. The bf16 forward at init within BF16_LOSS_TOL
# of the fp32 one (relative).
GRAD_DROP = 0.01
GRAD_TOL = 0.1
BF16_LOSS_TOL = 1e-3


def full_width_grad_check(cfg, batch, seq):
    """xlstm-350m's gradient at full width, held to its own loss on the
    card. From the DP run's init (seed 0) and first batch: g32, the fp32
    gradient, and g16, the bf16 one (the config's compute dtype). A step
    of eps = GRAD_DROP / |g|^2 along -g must lower the fp32 loss by
    eps * (g32 . g) within GRAD_TOL of it, for g = g32 (the exact first
    order) and g = g16 (the bf16 gradient as a descent direction of the
    fp32 loss); the bf16 loss within BF16_LOSS_TOL of the fp32 one.
    -> the numbers printed."""
    from repro_torch.core.ifl_spmd import value_and_grad
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models import modules as nn
    from repro_torch.models.transformer import init_lm, lm_loss

    c32 = cfg.replace(compute_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = nn.tree_map(lambda a: a.to(nn.dtype_of(cfg.param_dtype)),
                         init_lm(cfg, generator=gen, device="cuda"))
    b = {"tokens": torch.from_numpy(SyntheticLM(cfg.vocab_size, seed=0)
                                    .sample(batch, seq, step=0)).cuda()}
    l32, g32 = value_and_grad(lm_loss, params, c32, b)
    l16, g16 = value_and_grad(lm_loss, params, cfg, b)
    l32, l16 = float(l32), float(l16)

    def leaves(t):
        return ([x for v in t.values() for x in leaves(v)]
                if isinstance(t, dict) else [t])

    def dot(a, c):
        return float(sum((x.double() * y.double()).sum()
                         for x, y in zip(leaves(a), leaves(c))))

    def stepped(t, g, eps):
        if isinstance(t, dict):
            return {k: stepped(t[k], g[k], eps) for k in t}
        return t - eps * g.to(t.dtype)

    n32, n16, cross = dot(g32, g32), dot(g16, g16), dot(g32, g16)
    out = {"loss32": l32, "loss16": l16, "grad_norm": n32 ** 0.5,
           "cos": cross / (n32 * n16) ** 0.5}

    def named(t, pre=""):
        if isinstance(t, dict):
            return {k2: v2 for k, v in t.items()
                    for k2, v2 in named(v, f"{pre}/{k}" if pre else k).items()}
        return {pre: t}

    # The three largest leaves of g32, each with its share of |g32|^2 and
    # the cosine of the bf16 gradient's leaf to it.
    f32, f16 = named(g32), named(g16)
    sq = {k: float((v.double() ** 2).sum()) for k, v in f32.items()}
    out["leaves"] = [
        (k, sq[k] / n32, float((f32[k].double() * f16[k].double()).sum())
         / (sq[k] * float((f16[k].double() ** 2).sum())) ** 0.5)
        for k in sorted(sq, key=sq.get, reverse=True)[:3]]
    for name, g, n in (("g32", g32, n32), ("g16", g16, n16)):
        eps = GRAD_DROP / n
        with torch.no_grad():
            drop = l32 - float(lm_loss(stepped(params, g, eps), c32, b))
        want = eps * cross if name == "g16" else GRAD_DROP
        out[name] = (drop, want)
        check(want > 0 and abs(drop - want) <= GRAD_TOL * want,
              f"xlstm gradient check {name}: the fp32 loss fell {drop:.5f} "
              f"along -g, first order says {want:.5f}")
    check(abs(l16 - l32) <= BF16_LOSS_TOL * l32,
          f"xlstm bf16 loss {l16} vs fp32 {l32}")
    del params, g32, g16
    torch.cuda.empty_cache()
    return out


def zero_launches(ops, what):
    got = launch_counts(ops)
    check(all(v == 0 for v in got.values()), f"{what}: kernels launched {got}")


def recurrent_serve_phase(ops):
    """xlstm-350m at full width through the serving engine, as ``python
    -m repro_torch.launch.serve --arch xlstm-350m --no-reduced`` builds
    it (4 tenants, W 4, prompt 32, gen 32): no kernel of the port runs
    on this path (the recurrent mixers are plain PyTorch, as in the JAX
    package); engine == oracle bitwise."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_demo_store, demo_requests
    from repro_torch.serve import ServeEngine

    cfg = get_config("xlstm-350m")
    store = build_demo_store(cfg, "xlstm-350m", 4, seed=0, reduced=False,
                             device="cuda")
    engine = ServeEngine(store, width=4, cache_len=64, horizon=8,
                         device="cuda")
    reqs = demo_requests(cfg, 4, prompt_len=32, gen=32, stagger=2, seed=0)
    torch.cuda.synchronize()
    reset_counts(ops)
    t0 = time.perf_counter()
    comps = engine.run(reqs)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    zero_launches(ops, "xlstm serve")
    steps = sum(lane.composed_steps for lane in engine.lanes())
    check(len(comps) == 4 and all(len(c.tokens) == 32 for c in comps)
          and all(0 <= t < cfg.vocab_size for c in comps for t in c.tokens),
          "xlstm serve: a request did not complete in vocab")
    for r, c in zip(reqs, comps):
        check(engine.oracle(r).tokens == c.tokens,
              f"xlstm serve: request {r.rid} != oracle")
    warm = engine.fresh_clone()
    t0 = time.perf_counter()
    warm_comps = warm.run(reqs)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    check([c.tokens for c in warm_comps] == [c.tokens for c in comps],
          "xlstm serve: warm run differs")
    n_tok = sum(len(c.tokens) for c in comps)
    print(f"[recurrent serve] {cfg.name} full width ({cfg.num_layers} "
          f"layers: mLSTM x {3 * cfg.num_layers // 4}, sLSTM x "
          f"{cfg.num_layers // 4}; d {cfg.d_model}, vocab {cfg.vocab_size}, "
          f"{cfg.compute_dtype}), 4 tenants, W 4, 4 requests x 32 tokens: "
          f"engine == oracle bitwise; no kernel launched; {steps} composed "
          f"steps; first run {cold_s:.2f}s, warm {warm_s:.3f}s = "
          f"{n_tok / warm_s:.1f} tok/s ({warm_s / steps * 1e3:.2f} ms a "
          f"composed step); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return {"warm_s": warm_s, "steps": steps}


def attn_layers(cfg, half) -> int:
    """Layers with attention in the base or the modular half of cfg."""
    pre, bp, bg, mp, mg = cfg._resolved_program()
    specs = pre + bp * bg if half == "base" else mp * mg
    return sum(s.mixer == "attn" for s in specs)


def cross_family_store(device="cuda"):
    """olmo-1b (d_fusion 1024) and xlstm-350m, each with one shared
    modular block (its tenant 0's) and two tenants whose base routes to
    the OTHER family's modular block."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import tenant_generator
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve import CompositionStore

    store = CompositionStore()
    names = {"olmo-1b": store.add_arch("olmo-1b", reduced=False,
                                       d_fusion=CROSS_D_FUSION),
             "xlstm-350m": store.add_arch("xlstm-350m", reduced=False)}
    bases = {}
    for i, arch in enumerate(names):
        cfg = store.cfg(arch)
        for k in range(2):
            p = init_lm(cfg, generator=tenant_generator(i, k, device),
                        device=device)
            if k == 0:
                store.set_modular(arch, p["modular"])
            bases[(arch, k)] = p["base"]
            del p
    other = {"olmo-1b": "xlstm-350m", "xlstm-350m": "olmo-1b"}
    for (arch, k), base in bases.items():
        store.add_tenant(f"{arch}-t{k}", arch, base, modular_arch=other[arch])
    return store


def cross_family_phase(ops, profile):
    """Two lanes: olmo-1b base -> xlstm-350m modular and xlstm-350m base ->
    olmo-1b modular, 2 tenants each, W 4, 6 requests a lane (so evicted
    slots are admitted again): engine == oracle bitwise; flash_decode
    launches == 8 (olmo-1b's layers in either half) x composed steps."""
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.types import Request

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    store = cross_family_store()
    build_s = time.perf_counter() - t0
    vocab = store.cfg("olmo-1b").vocab_size   # xlstm-350m's too
    prompts = SyntheticLM(vocab, seed=3).sample(12, 32, step=0)
    reqs = []
    for i in range(12):
        tenant = store.tenants()[i % 4]
        n = 8 + 8 * (i % 3)   # prompt lengths 8, 16, 24: two buckets
        reqs.append(Request(rid=i, tenant=tenant,
                            prompt=[int(t) for t in prompts[i][:n]],
                            max_new_tokens=12, arrival=i // 4))
    engine = ServeEngine(store, width=4, cache_len=64, horizon=4,
                         device="cuda")
    torch.cuda.synchronize()
    reset_counts(ops)
    t0 = time.perf_counter()
    comps = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = launch_counts(ops)
    lanes = {(l.base_cfg.name, l.mod_cfg.name): l for l in engine.lanes()}
    steps = {k: l.composed_steps for k, l in lanes.items()}
    check(set(steps) == {("olmo-1b", "xlstm-350m"), ("xlstm-350m", "olmo-1b")},
          f"cross lanes: {sorted(steps)}")
    # A composed step launches flash_decode once a layer with attention:
    # olmo-1b's 8 in either half.
    per_step = {k: attn_layers(l.base_cfg, "base") + attn_layers(l.mod_cfg,
                                                                 "modular")
                for k, l in lanes.items()}
    want = sum(per_step[k] * steps[k] for k in steps)
    check(got["flash_decode"] == want and all(
        v == 0 for k, v in got.items() if k != "flash_decode"),
        f"cross lanes: launches {got}, flash_decode != {per_step} x {steps}")
    check(all(len(c.tokens) == 12 for c in comps), "cross lanes: lengths")
    for r, c in zip(reqs, comps):
        check(engine.oracle(r).tokens == c.tokens,
              f"cross lanes: request {r.rid} ({r.tenant}) != oracle")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[cross lanes] olmo-1b (16 layers, d 2048, 16 heads of 128, vocab "
          f"50304; d_fusion {CROSS_D_FUSION}) <-> xlstm-350m: lanes "
          f"{sorted(steps)}, 2 tenants each, W 4, 6 requests a lane (prompts "
          f"8/16/24, 12 tokens; 6 requests through 4 slots, so evicted slots "
          f"are admitted again): engine == oracle bitwise; composed steps "
          f"{steps}; flash_decode launches {got['flash_decode']} == "
          f"{per_step} attention layers x steps; store built in "
          f"{build_s:.1f}s; served in "
          f"{wall:.2f}s ({12 * 12 / wall:.1f} tok/s, a first run); peak "
          f"memory {peak:.2f} GiB", flush=True)
    if profile:
        clone = engine.fresh_clone()
        profile_run("cross lanes", lambda: clone.run(reqs))
    del engine, store
    torch.cuda.empty_cache()
    return {"flash_decode": got["flash_decode"], "steps": steps,
            "peak_gib": peak}


def recurrent_train_phase(train_cli, ops):
    """xlstm-350m through the training CLI at B 2 and its lr 3e-3: one DP
    step at S 512 and one IFL round (N 4, tau 2) at S 64, the counts set
    to 0 before each run; then the full-width gradient check. No
    attention kernel, and no wire kernel: the LM IFL CLI ships z in fp32
    (phase 4e counts none either). Losses finite."""
    import tempfile

    from repro_torch.configs import get_config

    r = RECUR_RUN
    cfg = get_config(r["arch"])
    walls = {}
    with tempfile.TemporaryDirectory() as out_dir:
        common = ["--arch", r["arch"], "--batch", str(r["batch"]), "--lr",
                  str(r["lr"]), "--out", out_dir]
        torch.cuda.reset_peak_memory_stats()
        reset_counts(ops)
        dp = train_cli.main(common + ["--mode", "dp", "--rounds",
                                      str(r["dp_steps"]), "--seq",
                                      str(r["seq"])])
        torch.cuda.synchronize()
        zero_launches(ops, "xlstm dp")
        losses = [h["loss"] for h in dp["history"]]
        check(all(np.isfinite(losses)), f"xlstm dp: losses {losses}")
        dp_peak = torch.cuda.max_memory_allocated() / 2**30
        walls["dp"] = dp["walls"]
        del dp
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(ops)
        ifl = train_cli.main(common + [
            "--mode", "ifl", "--rounds", str(r["ifl_rounds"]), "--tau",
            str(r["tau"]), "--n-clients", str(r["n_clients"]), "--seq",
            str(r["ifl_seq"])])
        torch.cuda.synchronize()
        zero_launches(ops, "xlstm ifl")
        h = ifl["history"]
        check(all(np.isfinite(x["base_loss"]) and np.isfinite(x["mod_loss"])
                  for x in h), f"xlstm ifl: losses {h}")
        walls["ifl"] = ifl["walls"]
        ifl_peak = torch.cuda.max_memory_allocated() / 2**30
        del ifl
        torch.cuda.empty_cache()
    print(f"[recurrent train] launch.train --arch {cfg.name} "
          f"({cfg.num_layers} layers, d {cfg.d_model}, {cfg.compute_dtype}), "
          f"B {r['batch']}, lr {r['lr']}: --mode dp at S {r['seq']}, "
          f"{r['dp_steps']} steps, losses {[round(x, 4) for x in losses]} "
          f"(finite), step walls (s) {[round(w, 3) for w in walls['dp']]}, "
          f"peak {dp_peak:.2f} GiB; --mode ifl at S {r['ifl_seq']}, "
          f"{r['ifl_rounds']} rounds (N {r['n_clients']}, tau {r['tau']}): "
          f"losses "
          f"{[(round(x['base_loss'], 4), round(x['mod_loss'], 4)) for x in h]}"
          f", round walls (s) {[round(w, 3) for w in walls['ifl']]}, peak "
          f"{ifl_peak:.2f} GiB; no kernel launched (no attention layer; the "
          f"LM IFL CLI ships z in fp32)", flush=True)
    t0 = time.perf_counter()
    g = full_width_grad_check(cfg, r["batch"], r["seq"])
    print(f"[recurrent grad] {cfg.name} at full width, the DP run's init and "
          f"first batch (B {r['batch']}, S {r['seq']}): loss fp32 "
          f"{g['loss32']:.5f}, bf16 {g['loss16']:.5f} (within "
          f"{BF16_LOSS_TOL} relative); |g32| {g['grad_norm']:.2f}, cos(g32, "
          f"g16) {g['cos']:.5f}; along -g32 the fp32 loss fell "
          f"{g['g32'][0]:.5f} (first order {g['g32'][1]:.5f}), along -g16 "
          f"{g['g16'][0]:.5f} (first order {g['g16'][1]:.5f}), each within "
          f"{GRAD_TOL:.0%}; largest leaves (share of |g32|^2, cos to g16) "
          f"{[(k, round(a, 4), round(c, 4)) for k, a, c in g['leaves']]}; "
          f"an lr {r['lr']} step along -g32 lowers it by "
          f"{r['lr'] * g['grad_norm'] ** 2:.1f} to first order; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return walls


def hybrid_config():
    """A small Mamba hybrid: Jamba's layer pattern cut to one period of 4
    (mamba, mamba, mamba, attn) with dense FFNs (MoE is not ported yet),
    at jamba-1.5-large-398b's reduced widths with d_model 128
    (``tests/test_torch_mamba.py``'s config)."""
    from repro_torch.config import LayerSpec
    from repro_torch.configs import get_config

    pat = tuple(LayerSpec(mixer="attn" if i == 3 else "mamba", ffn="dense",
                          use_rope=False) for i in range(4))
    return get_config("jamba-1.5-large-398b").reduced().replace(
        name="jamba-hybrid-smoke", num_layers=8, num_experts=0,
        num_experts_per_tok=0, base_pattern=pat, mod_pattern=pat,
        d_model=128).validate()


def greedy_tokens(base, bcfg, mod, mcfg, prompts, n, device):
    """Greedy continuation of (B, P) prompts, n tokens, by the composed
    prefill and decode steps."""
    from repro_torch.models.transformer import (composed_decode_step,
                                                composed_prefill_ragged,
                                                init_composed_cache)

    B, P = prompts.shape
    cache = init_composed_cache(bcfg, mcfg, B, P + n, device=device)
    toks = torch.from_numpy(prompts).to(device)
    last, cache = composed_prefill_ragged(
        base, bcfg, mod, mcfg, cache, toks,
        torch.full((B,), P, device=device))
    out = [last.argmax(-1)]
    for t in range(n - 1):
        logits, cache = composed_decode_step(
            base, bcfg, mod, mcfg, cache, out[-1][:, None],
            torch.full((B,), P + t, device=device))
        out.append(logits[:, -1].argmax(-1))
    return torch.stack(out, 1).cpu().tolist()


def recurrent_card_vs_cpu():
    """fp32, the same params (drawn on the CPU) and tokens on the card
    and the CPU: lm_loss, logits and 8 greedy tokens of the reduced
    xlstm-350m and the Mamba hybrid, and logits of the composition
    twin's four dense <-> xLSTM pairs (the dense half's head dim 48 on
    the padded attention kernels)."""
    from repro_torch.configs import get_config
    from repro_torch.examples import compose_inference as twin
    from repro_torch.models.modules import tree_map
    from repro_torch.models.transformer import (base_forward, init_lm,
                                                lm_apply, lm_loss,
                                                modular_forward)

    rng = np.random.default_rng(7)
    report = {}
    with torch.no_grad():
        for cfg in (get_config("xlstm-350m").reduced(), hybrid_config()):
            params = init_lm(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
            toks = rng.integers(0, cfg.vocab_size, (2, 64))
            res = {}
            for dev in ("cpu", "cuda"):
                p = tree_map(lambda a: a.to(dev), params)
                batch = {"tokens": torch.from_numpy(toks).to(dev)}
                res[dev] = (float(lm_loss(p, cfg, batch)),
                            lm_apply(p, cfg, batch)[0].cpu(),
                            greedy_tokens(p["base"], cfg, p["modular"], cfg,
                                          toks[:, :16], 8, dev))
            (lc, gc, tc), (lg, gg, tg) = res["cpu"], res["cuda"]
            lerr = abs(lg - lc)
            gerr = float((gg - gc).abs().max() / max(1.0, gc.abs().max()))
            check(lerr <= LM_LOSS_TOL and gerr <= LM_LOSS_TOL and tg == tc
                  and bool(torch.isfinite(gg).all()),
                  f"{cfg.name} card vs CPU: loss {lerr}, logits {gerr}, "
                  f"tokens {tg} vs {tc}")
            report[cfg.name] = (lerr, gerr)
        dense, recur = twin.llm_configs()
        vendors = [(n, c, init_lm(c, generator=torch.Generator().manual_seed(
            s), device="cpu")) for s, (n, c) in enumerate(
                (("dense", dense), ("xlstm", recur)))]
        toks = rng.integers(0, 512, (2, 32))
        perr = 0.0
        for bname, bcfg, bp in vendors:
            out = {}
            for dev in ("cpu", "cuda"):
                batch = {"tokens": torch.from_numpy(toks).to(dev)}
                z, _ = base_forward(tree_map(lambda a: a.to(dev),
                                             bp["base"]), bcfg, batch)
                out[dev] = [modular_forward(
                    tree_map(lambda a: a.to(dev), mp["modular"]), mcfg,
                    z)[0].cpu() for _, mcfg, mp in vendors]
            for a, b in zip(out["cuda"], out["cpu"]):
                perr = max(perr, float((a - b).abs().max()
                                       / max(1.0, b.abs().max())))
        check(perr <= LM_LOSS_TOL, f"twin pairs card vs CPU: {perr}")
    print(f"[recurrent card vs cpu] fp32, same params and tokens: "
          + "; ".join(f"{n}: loss |diff| {a:.2e}, logits {b:.2e} of max "
                      f"|logit|, 8 greedy tokens equal"
                      for n, (a, b) in report.items())
          + f"; the twin's four dense <-> xLSTM pairs (d 192, head dim 48 "
          f"on the padded attention kernels): logits {perr:.2e} (tolerance "
          f"{LM_LOSS_TOL})", flush=True)


def compose_twin_phase():
    """``python -m repro_torch.examples.compose_inference --device cuda``:
    the Table-II composition matrix after 10 IFL rounds and the four
    cross-family LLM pairs."""
    from repro_torch.examples import compose_inference as twin

    t0 = time.perf_counter()
    out = twin.main(["--device", "cuda"])
    wall = time.perf_counter() - t0
    mat = np.asarray(out["matrix"], float)
    check(mat.shape == (4, 4) and np.all((mat >= 0) & (mat <= 1)),
          f"compose twin: matrix {mat}")
    check(len(out["llm"]) == 4 and all(
        tuple(v.shape) == (2, 32, 512) and bool(torch.isfinite(v).all())
        for v in out["llm"].values()), "compose twin: LLM pairs")
    print(f"[compose twin] python -m repro_torch.examples.compose_inference "
          f"--device cuda in {wall:.1f}s: 4 x 4 composition matrix (diagonal "
          f"{[round(float(mat[i, i]), 3) for i in range(4)]}), 4 LLM pairs "
          f"finite", flush=True)


# -- phase 4n: MoE, MLA and MTP ---------------------------------------------
#
# deepseek-v3-671b (arXiv:2412.19437) at its published widths: d 7168, 128
# heads, q LoRA 1536, kv LoRA 512, nope 128, rope 64, v 128, 256 routed
# experts top-8 plus 1 shared, moe_d_ff 2048, dense d_ff 18432, vocab
# 129,280, d_fusion 4096, bf16, random weights drawn leaf by leaf in bf16.
# One cut, depth: the 3 dense prefix layers become 1, the base groups 29
# -> 0 and the modular groups 29 -> 1, with the MTP head on. A lane holds
# W copies of a tenant's base, so the routed experts sit in the shared
# modular block: base 1.54e9 parameters (3.1 GB), modular 13.05e9 (26.1
# GB, 11.27e9 of them routed experts).
DS_ARCH = "deepseek-v3-671b"
# The requests of the configs served at their widths, cut to depth
# (phases 4n and 4o).
CUT_SERVE = dict(tenants=2, width=4, prompt_len=32, gen=32, horizon=8)
DS_TRAIN = dict(batch=1, seq=512)
# The first-order check at full width (tolerances written in PERF.md
# before the first run): a step eps = GRAD_DROP / |g|^2 along -g lowers
# the fp32 loss by eps * (g32 . g) within HEAD_GRAD_TOL, for g = g32 and
# g = g16 (the bf16 loss's gradient). 80 GB holds the bf16 model and its
# bf16 gradient, not an fp32 copy of either (58 GB each for deepseek-v3),
# so the check is over the leaves above the trunk, the LM head and the
# MTP head (1.5e9 parameters, held in fp32), with the trunk's output
# computed once in fp32 and held fixed.
HEAD_GRAD_TOL = {"g32": 0.1, "g16": 0.2}


def deepseek_cut():
    from repro_torch.configs import get_config

    cfg = get_config(DS_ARCH)
    return cfg.replace(name=DS_ARCH + "-depth-cut", num_layers=2,
                       prefix_pattern=cfg.prefix_pattern[:1], base_groups=0,
                       mod_groups=1).validate()


def jamba_moe_period():
    """Jamba's 8-layer period with its MoE FFNs (attention at position 3,
    Mamba elsewhere, MoE on odd positions), cut at the middle, at
    jamba-1.5-large-398b's reduced widths with d_model 128
    (``tests/test_torch_mla_mtp.py``'s config)."""
    from repro_torch.config import LayerSpec
    from repro_torch.configs import get_config

    pat = tuple(LayerSpec(mixer="attn" if i == 3 else "mamba",
                          ffn="moe" if i % 2 else "dense", use_rope=False)
                for i in range(8))
    return get_config("jamba-1.5-large-398b").reduced().replace(
        name="jamba-moe-period-smoke", num_layers=8, base_pattern=pat[:4],
        mod_pattern=pat[4:], d_model=128).validate()


class RoutingLog:
    """Records (probs, idx) of every MoE routing while active: the
    harness wraps ``models.moe.route``, which every MoE layer calls."""

    def __enter__(self):
        from repro_torch.models import moe

        self.calls, self._moe, self._route = [], moe, moe.route

        def record(p, cfg, x):
            out = self._route(p, cfg, x)
            self.calls.append((out[0].detach(), out[2].detach()))
            return out

        moe.route = record
        return self

    def __exit__(self, *exc):
        self._moe.route = self._route


def switch_aux(cfg, probs, idx) -> float:
    """E * sum_e f_e * p_e * coef of one routing."""
    E = cfg.num_experts
    f = torch.bincount(idx.reshape(-1), minlength=E).float() / idx.numel()
    return E * float((f * probs.mean(0)).sum()) * cfg.router_aux_coef


def deepseek_serve_phase(ops, cfg):
    """The cut deepseek-v3 served to 2 tenants at W 4 (prompt 32, gen 32)
    through the store and engine: engine == oracle bitwise, no kernel
    launched (MLA decodes in the absorbed form and MoE routes each row
    alone, both plain PyTorch as in the JAX package)."""
    cut_serve_phase(ops, cfg, f"{cfg.name}: {DS_ARCH} at its widths cut to "
                    f"depth (1 dense prefix layer of 3, base groups 0 of 29, "
                    f"modular groups 1 of 29, MTP on), bf16",
                    "deepseek serve")


def _tree_flat(t, pre=""):
    if isinstance(t, dict):
        return {k2: v2 for k, v in t.items()
                for k2, v2 in _tree_flat(v, f"{pre}/{k}" if pre
                                         else k).items()}
    return {pre: t}


def head_names(cfg):
    """The leaves above the trunk: the LM head, and the MTP head where
    the config has it."""
    return ("lm_head", "mtp") if cfg.use_mtp else ("lm_head",)


def head_first_order_check(cfg, params, b, g16) -> str:
    """The first-order check over the heads (``head_names``) in fp32 on
    the fp32 trunk's output, held fixed: a step eps = GRAD_DROP / |g|^2
    along -g lowers the fp32 loss (the heads' CE, + 0.3 x the MTP head's
    offset-2 CE, from position n_img on) by eps * (g32 . g) within
    HEAD_GRAD_TOL, for g = g32 and g = g16 (the bf16 loss's gradient of
    the heads) -> the numbers, as a line."""
    from repro_torch.core.ifl_spmd import value_and_grad
    from repro_torch.models import transformer as tf
    from repro_torch.models.modules import tree_map

    heads = head_names(cfg)
    c32 = cfg.replace(compute_dtype="float32")
    mod = params["modular"]
    with torch.no_grad():
        z, _ = tf.base_forward(params["base"], c32, b)
        h, _, positions = tf.modular_trunk(mod, c32, z)
        del z
    h32 = tree_map(lambda a: a.float(), {k: mod[k] for k in heads})
    toks, start = b["tokens"], cfg.num_image_tokens

    def head_loss(hp):
        m = dict(mod, **hp)
        loss = tf._next_token_ce(tf._head_logits(m, c32, h), toks, 1, start)
        if cfg.use_mtp:
            h2 = tf.mtp_hidden(m, c32, h, positions)
            loss = loss + 0.3 * tf._next_token_ce(
                tf._head_logits(m, c32, h2), toks, 2, start)
        return loss

    l32, g32 = value_and_grad(head_loss, h32)
    l32 = float(l32)
    f32, f16 = _tree_flat(g32), _tree_flat(g16)

    def dot(a, c):
        return float(sum((a[k].double() * c[k].double()).sum() for k in a))

    n32, n16, cross = dot(f32, f32), dot(f16, f16), dot(f32, f16)
    drops = {}
    for name, g, n in (("g32", g32, n32), ("g16", g16, n16)):
        eps = GRAD_DROP / n
        with torch.no_grad():
            stepped = {k: _step_tree(h32[k], g[k], eps) for k in heads}
            drop = l32 - float(head_loss(stepped))
            del stepped
        want = GRAD_DROP if name == "g32" else eps * cross
        drops[name] = (drop, want)
        check(want > 0 and abs(drop - want) <= HEAD_GRAD_TOL[name] * want,
              f"{cfg.name} head check {name}: the fp32 loss fell "
              f"{drop:.5f} along -g, first order says {want:.5f}")
    del h32, g32, h
    return (f"heads ({', '.join(heads)}: "
            f"{sum(v.numel() for v in f32.values()):,} parameters) in fp32 "
            f"on the fp32 trunk's output: loss {l32:.5f}, |g32| "
            f"{n32 ** 0.5:.3f}, cos(g32, g16) "
            f"{cross / (n32 * n16) ** 0.5:.4f}; along -g32 the loss fell "
            f"{drops['g32'][0]:.5f} (first order {drops['g32'][1]:.5f}, "
            f"within {HEAD_GRAD_TOL['g32']:.0%}), along -g16 "
            f"{drops['g16'][0]:.5f} (first order {drops['g16'][1]:.5f}, "
            f"within {HEAD_GRAD_TOL['g16']:.0%})")


def deepseek_grad_phase(ops, cfg):
    """One ``lm_loss`` forward and backward of the cut deepseek-v3 at B 1,
    S 512 (bf16): loss and every gradient finite; flash_attention /
    _bwd launches == the count derived from the checkpointing (the
    prefix and MTP layers once, the modular group again under remat
    'group': 4 and 3); a routed expert that received no token has an
    exactly zero gradient, one that did a nonzero one; aux == E * sum f
    p * coef from the phase's own routing; then the first-order check
    over the LM and MTP heads (HEAD_GRAD_TOL)."""
    from repro_torch.core.ifl_spmd import value_and_grad
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf

    r = DS_TRAIN
    torch.cuda.reset_peak_memory_stats()
    params = tf.init_lm(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda", dtype=torch.bfloat16)
    toks = torch.from_numpy(SyntheticLM(cfg.vocab_size, seed=0).sample(
        r["batch"], r["seq"], step=0)).cuda()
    b = {"tokens": toks}
    reset_counts(ops)
    with RoutingLog() as log:
        t0 = time.perf_counter()
        l16, g16 = value_and_grad(tf.lm_loss, params, cfg, b)
        l16 = float(l16)
        grad_s = time.perf_counter() - t0
    got = launch_counts(ops)
    fwd, bwd = expected_attn_launches(cfg, steps_full=1, steps_mod=0,
                                      fwd_only=0)
    check(got["flash_attention"] == fwd and got["flash_attention_bwd"] == bwd
          and all(v == 0 for k, v in got.items()
                  if not k.startswith("flash_attention")),
          f"deepseek grad: launches {got} != fwd {fwd}, bwd {bwd}")
    flat = _tree_flat(g16)
    check(np.isfinite(l16) and all(bool(torch.isfinite(g).all())
                                   for g in flat.values()),
          f"deepseek grad: loss {l16} or a gradient not finite")
    # The modular MoE layer routes once and again in the recompute.
    T = r["batch"] * r["seq"]
    _, idx = log.calls[0]
    check(len(log.calls) == 2 and torch.equal(idx, log.calls[1][1]),
          f"deepseek grad: {len(log.calls)} routings")
    e_flat = idx.reshape(-1)
    keep = moe.rank_in_expert(e_flat, cfg.num_experts) < moe._capacity(T, cfg)
    got_tok = torch.zeros(cfg.num_experts, dtype=torch.bool, device="cuda")
    got_tok[e_flat[keep]] = True
    ex = g16["modular"]["groups"]["l0"]["moe"]["experts"]
    amax = torch.stack([ex[k]["w"][0].flatten(1).abs().amax(1)
                        for k in ("w_gate", "w_up", "w_down")]).amax(0)
    check(bool((amax[~got_tok] == 0).all()) and bool((amax[got_tok] > 0)
                                                      .all()),
          f"deepseek grad: experts with tokens {int(got_tok.sum())}, "
          f"nonzero gradients {int((amax > 0).sum())}")
    n_drop = int((~keep).sum())
    del ex, amax
    # aux from a forward's own routing.
    with torch.no_grad(), RoutingLog() as log2:
        _, aux, mtp_logits = tf.lm_apply(params, cfg, b)
    aux_re = sum(switch_aux(cfg, p_, i_) for p_, i_ in log2.calls)
    check(mtp_logits is not None
          and abs(float(aux) - aux_re) <= 1e-6 * max(1.0, aux_re),
          f"deepseek grad: aux {float(aux)} != recomputed {aux_re}")
    del log, log2, mtp_logits
    # The first-order check over the heads: keep their bf16 gradient, drop
    # the rest, and hold the trunk's fp32 output fixed.
    g16h = {k: g16["modular"][k] for k in head_names(cfg)}
    del g16, flat
    torch.cuda.empty_cache()
    head_line = head_first_order_check(cfg, params, b, g16h)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[deepseek grad] {cfg.name} at B {r['batch']}, S {r['seq']} "
          f"(bf16, remat {cfg.remat}): lm_loss {l16:.5f} (aux included, "
          f"{float(aux):.5f}; recomputed from the routing {aux_re:.5f}), "
          f"loss and every gradient finite; flash_attention {fwd}, "
          f"flash_attention_bwd {bwd} == derived; {int(got_tok.sum())} of "
          f"{cfg.num_experts} routed experts received tokens ({n_drop} of "
          f"{e_flat.numel()} choices dropped at capacity "
          f"{moe._capacity(T, cfg)}): exactly their gradients nonzero; "
          f"forward+backward {grad_s:.2f}s; {head_line}; peak memory "
          f"{peak:.2f} GiB", flush=True)
    del params, g16h
    torch.cuda.empty_cache()
    return {"flash_attention": fwd, "flash_attention_bwd": bwd}


def _step_tree(t, g, eps):
    if isinstance(t, dict):
        return {k: _step_tree(t[k], g[k], eps) for k in t}
    return t - eps * g.float()


def moe_card_vs_cpu():
    """fp32, the same params (drawn on the CPU) and tokens on the card
    and the CPU: lm_loss, logits, 8 greedy tokens and every MoE layer's
    expert choices of the reduced deepseek-v3 and the jamba MoE period.
    Differing choices are counted and printed."""
    from repro_torch.configs import get_config
    from repro_torch.models.modules import tree_map
    from repro_torch.models.transformer import init_lm, lm_apply, lm_loss

    rng = np.random.default_rng(11)
    report = {}
    with torch.no_grad():
        for cfg in (get_config(DS_ARCH).reduced(), jamba_moe_period()):
            params = init_lm(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
            toks = rng.integers(0, cfg.vocab_size, (2, 64))
            res = {}
            for dev in ("cpu", "cuda"):
                p = tree_map(lambda a: a.to(dev), params)
                batch = {"tokens": torch.from_numpy(toks).to(dev)}
                with RoutingLog() as log:
                    loss = float(lm_loss(p, cfg, batch))
                    logits = lm_apply(p, cfg, batch)[0].cpu()
                res[dev] = (loss, logits, [i.cpu() for _, i in log.calls],
                            greedy_tokens(p["base"], cfg, p["modular"], cfg,
                                          toks[:, :16], 8, dev))
            (lc, gc, ic, tc), (lg, gg, ig, tg) = res["cpu"], res["cuda"]
            lerr = abs(lg - lc)
            gerr = float((gg - gc).abs().max() / max(1.0, gc.abs().max()))
            n_choice = sum(a.numel() for a in ic)
            n_diff = sum(int((a != b).sum()) for a, b in zip(ig, ic))
            check(len(ig) == len(ic) and n_choice > 0,
                  f"{cfg.name}: routings {len(ig)} vs {len(ic)}")
            check(lerr <= LM_LOSS_TOL and gerr <= LM_LOSS_TOL and tg == tc
                  and bool(torch.isfinite(gg).all()),
                  f"{cfg.name} card vs CPU: loss {lerr}, logits {gerr}, "
                  f"tokens {tg} vs {tc}")
            report[cfg.name] = (lerr, gerr, n_diff, n_choice)
    print("[moe card vs cpu] fp32, same params and tokens: "
          + "; ".join(f"{n}: loss |diff| {a:.2e}, logits {b:.2e} of max "
                      f"|logit|, 8 greedy tokens equal, expert choices "
                      f"differing {d} of {c}"
                      for n, (a, b, d, c) in report.items())
          + f" (tolerance {LM_LOSS_TOL})", flush=True)


def moe_train_phase(train_cli, ops):
    """``python -m repro_torch.launch.train --reduced`` on the card for
    deepseek-v3-671b and jamba-1.5-large-398b: one IFL round (N 2, tau 1)
    and one DP step at B 2, S 64; losses finite, the reference loop's
    ledger, attention launches == derived."""
    import tempfile

    from repro_torch.configs import get_config

    lines = []
    for arch in (DS_ARCH, "jamba-1.5-large-398b"):
        cfg = get_config(arch).reduced()
        with tempfile.TemporaryDirectory() as out_dir:
            common = ["--arch", arch, "--reduced", "--rounds", "1",
                      "--batch", "2", "--seq", "64", "--out", out_dir]
            reset_counts(ops)
            t0 = time.perf_counter()
            out = train_cli.main(common + ["--tau", "1", "--n-clients", "2"])
            ifl_s = time.perf_counter() - t0
            got = launch_counts(ops)
            fwd, bwd = expected_attn_launches(cfg, steps_full=2, steps_mod=4,
                                              fwd_only=2)
            check(got["flash_attention"] == fwd
                  and got["flash_attention_bwd"] == bwd,
                  f"{arch} ifl: launches {got} != {fwd}, {bwd}")
            h = out["history"][0]
            up = 2 * (2 * 64 * cfg.d_fusion * 2 + 2 * 64 * 4)
            check(np.isfinite(h["base_loss"]) and np.isfinite(h["mod_loss"])
                  and out["ledger"].per_round == [{"up": up, "down": 2 * up}],
                  f"{arch} ifl: {h}, ledger {out['ledger'].per_round}")
            reset_counts(ops)
            t0 = time.perf_counter()
            dp = train_cli.main(common + ["--mode", "dp"])
            dp_s = time.perf_counter() - t0
            got = launch_counts(ops)
            fwd_d, bwd_d = expected_attn_launches(cfg, steps_full=1,
                                                  steps_mod=0, fwd_only=0)
            check(got["flash_attention"] == fwd_d
                  and got["flash_attention_bwd"] == bwd_d
                  and np.isfinite(dp["history"][0]["loss"]),
                  f"{arch} dp: launches {got}, {dp['history']}")
        lines.append(f"{cfg.name}: IFL round losses ({h['base_loss']:.4f}, "
                     f"{h['mod_loss']:.4f}), attention {fwd}/{bwd} == "
                     f"derived, ledger == analytic, {ifl_s:.2f}s; DP step "
                     f"loss {dp['history'][0]['loss']:.4f}, attention "
                     f"{fwd_d}/{bwd_d}, {dp_s:.2f}s")
    print("[moe train] launch.train --reduced on the card, B 2, S 64, fp32: "
          + "; ".join(lines), flush=True)


# ---------------------------------- phase 4o: the last attention variants

GEMMA_ARCH = "gemma3-27b"
LLAMA4_ARCH = "llama4-maverick-400b-a17b"
QWEN2VL_ARCH = "qwen2-vl-2b"
SEAMLESS_ARCH = "seamless-m4t-large-v2"
# gemma3's S passes its local layers' 1,024-key window, so they mask.
GEMMA_TRAIN = dict(batch=1, seq=2048)
VARIANT_TRAIN = dict(batch=1, seq=512)
# Seconds of the prefill probe (ROADMAP section 3): the new prefill
# paths (qwen2-vl's lanes under M-RoPE, seamless's cross-cache decode)
# run again and again, each run synchronized.
PROBE_S = 10.0


def gemma3_cut():
    """gemma3-27b at its widths (d 5376, 32 heads of 128 on 16 KV heads,
    qk-norm, vocab 262,144, bf16) cut to depth: its 2 local prefix
    layers, base groups 5 -> 0, modular groups 5 -> 1 (5 local layers,
    window 1,024, and 1 global)."""
    from repro_torch.configs import get_config

    cfg = get_config(GEMMA_ARCH)
    return cfg.replace(name=GEMMA_ARCH + "-depth-cut",
                       num_layers=len(cfg.prefix_pattern)
                       + len(cfg.mod_pattern),
                       base_groups=0, mod_groups=1).validate()


def llama4_cut():
    """llama4-maverick at its widths (d 5120, 40 heads of 128 on 8 KV
    heads, qk-norm, 128 routed experts top-1 and a shared one, vocab
    202,048, bf16) cut to one local dense layer (RoPE, window 8,192) in
    the base and one NoPE global MoE layer in the modular block."""
    from repro_torch.configs import get_config

    cfg = get_config(LLAMA4_ARCH)
    local, nope = cfg.base_pattern[0], cfg.base_pattern[3]
    return cfg.replace(name=LLAMA4_ARCH + "-depth-cut", num_layers=2,
                       base_pattern=(local,), base_groups=1,
                       mod_pattern=(nope,), mod_groups=1).validate()


def variant_store(cfg, n):
    """n tenants in cfg.param_dtype: tenant 0's whole init (its modular
    block shared), the others' base blocks from inits of the base half
    alone (cfg cut at the fusion layer), so one modular block is held."""
    from repro_torch.launch.serve import tenant_generator
    from repro_torch.models.modules import dtype_of
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve import CompositionStore

    torch.cuda.reset_peak_memory_stats()
    store = CompositionStore()
    name = store.add_arch(cfg, reduced=False)
    base_cfg = cfg.replace(num_layers=cfg.fusion_cut_layer,
                           mod_groups=0).validate()
    for k in range(n):
        p = init_lm(cfg if k == 0 else base_cfg,
                    generator=tenant_generator(0, k, "cuda"), device="cuda",
                    dtype=dtype_of(cfg.param_dtype))
        if k == 0:
            store.set_modular(name, p["modular"])
        store.add_tenant(f"tenant{k}", name, p["base"])
        del p
    return store


def cut_serve_phase(ops, cfg, label, tag):
    """cfg, at its widths cut to depth, served from ``variant_store``
    (``variant_serve``); the store's build timed."""
    t0 = time.perf_counter()
    store = variant_store(cfg, CUT_SERVE["tenants"])
    torch.cuda.synchronize()
    print(f"[{tag}] {label}: store built in {time.perf_counter() - t0:.1f}s",
          flush=True)
    variant_serve(ops, store, cfg, label, tag)
    del store
    torch.cuda.empty_cache()


def variant_serve(ops, store, cfg, label, tag="variants serve"):
    """CUT_SERVE's requests through the engine: engine == oracle
    bitwise, flash_decode launches == attention layers x composed steps
    (none for MLA, which decodes in plain PyTorch) and no other kernel, a
    warm run timed -> the requests."""
    from repro_torch.launch.serve import demo_requests
    from repro_torch.serve import ServeEngine

    r = CUT_SERVE
    engine = ServeEngine(store, width=r["width"],
                         cache_len=r["prompt_len"] + r["gen"],
                         horizon=r["horizon"], device="cuda")
    reqs = demo_requests(cfg, r["tenants"], prompt_len=r["prompt_len"],
                         gen=r["gen"], stagger=2, seed=0)
    reset_counts(ops)
    t0 = time.perf_counter()
    comps = engine.run(reqs)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    got = launch_counts(ops)
    steps = sum(lane.composed_steps for lane in engine.lanes())
    n_attn = 0 if cfg.use_mla else sum(s.mixer == "attn"
                                       for s in cfg.layer_specs())
    check(got["flash_decode"] == n_attn * steps
          and all(v == 0 for k, v in got.items() if k != "flash_decode"),
          f"{label} serve: launches {got}, {n_attn} layers x {steps} steps")
    check(len(comps) == r["tenants"]
          and all(len(c.tokens) == r["gen"] for c in comps)
          and all(0 <= t < cfg.vocab_size for c in comps for t in c.tokens),
          f"{label} serve: a request did not complete in vocab")
    for q, c in zip(reqs, comps):
        check(engine.oracle(q).tokens == c.tokens,
              f"{label} serve: request {q.rid} != oracle")
    warm = engine.fresh_clone()
    del engine
    t0 = time.perf_counter()
    warm_comps = warm.run(reqs)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    check([c.tokens for c in warm_comps] == [c.tokens for c in comps],
          f"{label} serve: warm run differs")
    del warm
    n_tok = sum(len(c.tokens) for c in comps)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{tag}] {label}: {r['tenants']} tenants, W "
          f"{r['width']}, prompt {r['prompt_len']}, gen {r['gen']}: engine "
          f"== oracle bitwise; flash_decode {got['flash_decode']} == "
          f"{n_attn} layers x {steps} composed steps; first run "
          f"{cold_s:.2f}s, warm {warm_s:.3f}s = {n_tok / warm_s:.1f} tok/s "
          f"({warm_s / steps * 1e3:.2f} ms a composed step); peak memory "
          f"{peak:.2f} GiB", flush=True)
    return reqs


def _split(tree, path):
    """(tree without the subtree at ``path``, that subtree); the tree is
    copied along the path only."""
    if len(path) == 1:
        rest = dict(tree)
        return rest, rest.pop(path[0])
    rest, sub = _split(tree[path[0]], path[1:])
    return dict(tree, **{path[0]: rest}), sub


def _graft(tree, path, sub):
    if len(path) == 1:
        return dict(tree, **{path[0]: sub})
    return dict(tree, **{path[0]: _graft(tree[path[0]], path[1:], sub)})


def variant_batch(cfg, B, S, seed=0, device="cuda"):
    """SyntheticLM tokens and, where the config has them, numpy-drawn
    image rows or frames (normals of ``default_rng(seed)``)."""
    from repro_torch.data.synthetic import SyntheticLM

    b = {"tokens": torch.from_numpy(SyntheticLM(cfg.vocab_size, seed=0)
                                    .sample(B, S, step=seed)).to(device)}
    rng = np.random.default_rng(seed)
    if cfg.num_image_tokens:
        b["image_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
        ).to(device)
    if cfg.is_encdec:
        b["frame_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.enc_seq_len, cfg.d_model)).astype(np.float32)).to(device)
    return b


def enc_attn_launches(cfg) -> int:
    """The encoder's self-attention launches in one pass (the encoder is
    not checkpointed: each layer's forward and backward kernel once)."""
    return cfg.enc_layers if cfg.is_encdec else 0


def variant_grad(ops, cfg, label, *, batch, seq, frozen=None,
                 head_check=False):
    """One ``lm_loss`` forward and backward at (batch, seq) in the config's
    dtypes: loss and gradients finite, flash_attention / _bwd launches ==
    derived (the encoder's included). ``frozen``: the path of a subtree
    that takes no gradient (held outside the differentiated tree).
    ``head_check``: then the first-order check over the LM head."""
    from repro_torch.core.ifl_spmd import value_and_grad
    from repro_torch.models import transformer as tf
    from repro_torch.models.modules import dtype_of

    torch.cuda.reset_peak_memory_stats()
    params = tf.init_lm(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda",
        dtype=dtype_of(cfg.param_dtype))
    b = variant_batch(cfg, batch, seq)
    train, held = params, None
    if frozen:
        train, held = _split(params, frozen)

    def loss_fn(t, c, bb):
        return tf.lm_loss(t if held is None else _graft(t, frozen, held),
                          c, bb)

    reset_counts(ops)
    t0 = time.perf_counter()
    loss, grads = value_and_grad(loss_fn, train, cfg, b)
    loss = float(loss)
    grad_s = time.perf_counter() - t0
    got, bidir = launch_counts(ops), bidir_counts(ops)
    fwd, bwd = expected_attn_launches(cfg, steps_full=1, steps_mod=0,
                                      fwd_only=0)
    enc = enc_attn_launches(cfg)
    fwd, bwd = fwd + enc, bwd + enc
    check(got["flash_attention"] == fwd and got["flash_attention_bwd"] == bwd
          and all(v == enc for v in bidir.values())
          and all(v == 0 for k, v in got.items()
                  if not k.startswith("flash_attention")),
          f"{label} grad: launches {got} (causal=False {bidir}) != fwd "
          f"{fwd}, bwd {bwd} ({enc} each causal=False)")
    flat = _tree_flat(grads)
    check(np.isfinite(loss) and all(bool(torch.isfinite(g).all())
                                    for g in flat.values()),
          f"{label} grad: loss {loss} or a gradient not finite")
    n_grad = sum(g.numel() for g in flat.values())
    n_par = sum(p.numel() for p in _tree_flat(params).values())
    peak = torch.cuda.max_memory_allocated() / 2**30
    line = (f"[variants grad] {label} at B {batch}, S {seq} "
            f"({cfg.compute_dtype}, params {cfg.param_dtype}, remat "
            f"{cfg.remat}): lm_loss {loss:.5f}, loss and every gradient "
            f"finite ({n_grad:,} of {n_par:,} parameters take one"
            + (f"; {'/'.join(frozen)} held out" if frozen else "")
            + f"); flash_attention {fwd}, flash_attention_bwd {bwd} == "
            f"derived; forward+backward {grad_s:.2f}s; peak memory "
            f"{peak:.2f} GiB")
    g16 = grads["modular"]["lm_head"]
    del grads, flat
    torch.cuda.empty_cache()
    if head_check:
        line += "; " + head_first_order_check(cfg, params, b,
                                              {"lm_head": g16})
    print(line, flush=True)
    del params, train, held, g16
    torch.cuda.empty_cache()
    return {"flash_attention": fwd, "flash_attention_bwd": bwd}


def variant_dp_step(train_cli, ops, arch):
    """``python -m repro_torch.launch.train --arch <arch> --mode dp`` for
    one step at B 1, S 512 at full width (the loop's own image / frame
    draws): loss finite, attention launches == derived, and the
    wrappers' ``causal=False`` counts == the encoder's layers. -> (params,
    the measured causal=False launches of each attention wrapper)."""
    import tempfile

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    r = VARIANT_TRAIN
    with tempfile.TemporaryDirectory() as out_dir:
        reset_counts(ops)
        t0 = time.perf_counter()
        out = train_cli.main(["--arch", arch, "--mode", "dp", "--rounds",
                              "1", "--batch", str(r["batch"]), "--seq",
                              str(r["seq"]), "--out", out_dir])
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
    got, bidir = launch_counts(ops), bidir_counts(ops)
    fwd, bwd = expected_attn_launches(cfg, steps_full=1, steps_mod=0,
                                      fwd_only=0)
    enc = enc_attn_launches(cfg)
    check(got["flash_attention"] == fwd + enc
          and got["flash_attention_bwd"] == bwd + enc
          and all(v == enc for v in bidir.values())
          and np.isfinite(out["history"][0]["loss"]),
          f"{arch} dp: launches {got} (causal=False {bidir}) != "
          f"{fwd + enc}, {bwd + enc} ({enc} each causal=False); "
          f"{out['history']}")
    print(f"[variants train] launch.train --arch {arch} --mode dp at full "
          f"width ({cfg.num_layers} layers"
          + (f" and {cfg.enc_layers} encoder layers over "
             f"{cfg.enc_seq_len} frames" if cfg.is_encdec else "")
          + (f", {cfg.num_image_tokens} image rows" if cfg.num_image_tokens
             else "")
          + f"), B {r['batch']}, S {r['seq']}: loss "
          f"{out['history'][0]['loss']:.5f}; flash_attention "
          f"{fwd + enc}, flash_attention_bwd {bwd + enc} == derived"
          + (f" ({bidir['flash_attention']} and "
             f"{bidir['flash_attention_bwd']} of them causal=False, counted "
             f"by the wrappers, == {enc} encoder layers)" if enc else "")
          + f"; the step (draws and init included) {step_s:.2f}s", flush=True)
    return out["params"], bidir


def encdec_generate(params, cfg, frames, prompts, n, device):
    """Greedy continuation of (B, P) prompts by ``launch.serve.generate``
    (one ``lm_prefill``, then n decode steps) through the cross caches of
    the encoder's output on ``frames``, as the serving CLI's enc-dec path
    runs it. -> (the n new tokens of each row, the cross caches)."""
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as tf

    with torch.no_grad():
        enc = tf.encoder_forward(params["base"]["encoder"], cfg,
                                 frames.to(device))
        kv = tf.build_cross_caches(params, cfg, enc)
    out = generate(params, cfg, torch.from_numpy(prompts).to(device), n, kv)
    return out[:, prompts.shape[1]:].cpu().tolist(), kv


def seamless_decode_phase(ops, params, cfg):
    """seamless at full width (the DP step's params): ``generate`` through
    the cross caches of 1,024 frames (B 2, prompt 8, 16 tokens) in the
    config's bf16, twice, the same tokens in vocab, with the encoder's
    attention on #8's causal=False (one launch a layer, counted by the
    wrapper) and the decoder's self-attention on #9 (one launch a layer a
    composed step: 8 prefill and 16 decode steps); then in fp32
    ``lm_prefill``'s logits at each of the 8 prompt positions (a prefill
    of the first t tokens) against the full forward's. -> (frames,
    prompts, the first run's launch counts)."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.modules import tree_map

    rng = np.random.default_rng(21)
    frames = torch.from_numpy(rng.standard_normal(
        (2, cfg.enc_seq_len, cfg.d_model)).astype(np.float32))
    prompts = rng.integers(0, cfg.vocab_size, (2, 8))
    n_self = sum(s.mixer == "attn" for s in cfg.layer_specs())
    steps = prompts.shape[1] + 16
    reset_counts(ops)
    t0 = time.perf_counter()
    toks, _ = encdec_generate(params, cfg, frames, prompts, 16, "cuda")
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    got = dict(launch_counts(ops), **{
        k + "_bidir": v for k, v in bidir_counts(ops).items()})
    check(got["flash_attention"] == got["flash_attention_bidir"]
          == cfg.enc_layers and got["flash_decode"] == n_self * steps
          and all(v == 0 for k, v in got.items()
                  if k not in ("flash_attention", "flash_attention_bidir",
                               "flash_decode")),
          f"seamless generate: launches {got}, want {cfg.enc_layers} "
          f"causal=False and {n_self} layers x {steps} steps of flash_decode")
    t0 = time.perf_counter()
    again, _ = encdec_generate(params, cfg, frames, prompts, 16, "cuda")
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    check(toks == again and all(0 <= t < cfg.vocab_size for r in toks
                                for t in r),
          f"seamless generate: {toks} vs {again}")
    c32 = cfg.replace(compute_dtype="float32")
    p32 = tree_map(lambda a: a.float(), params)
    _, kv = encdec_generate(p32, c32, frames, prompts, 0, "cuda")
    tp = torch.from_numpy(prompts).cuda()
    seen = []
    with torch.no_grad():
        for t in range(1, prompts.shape[1] + 1):
            cache = tf.init_decode_cache(c32, 2, t, device="cuda")
            seen.append(tf.lm_prefill(p32, c32, cache, tp[:, :t], kv)[0])
        full = tf.lm_apply(p32, c32, {"tokens": tp,
                                      "frame_embeds": frames.cuda()})[0]
    seen = torch.cat(seen, 1)
    err = float((seen - full).abs().max() / max(1.0, full.abs().max()))
    check(err <= 1e-4, f"seamless lm_prefill vs forward (fp32): {err}")
    n_tok = 2 * 16
    print(f"[variants decode] {cfg.name} at full width: launch.serve."
          f"generate through the cross caches of {cfg.enc_seq_len} frames, "
          f"B 2, prompt 8, 16 tokens ({cfg.compute_dtype}): flash_attention "
          f"{got['flash_attention']} (causal=False, == {cfg.enc_layers} "
          f"encoder layers), flash_decode {got['flash_decode']} == {n_self} "
          f"layers x {steps} composed steps; first run {dec_s:.3f}s, warm "
          f"{warm_s:.3f}s = {n_tok / warm_s:.1f} tok/s (encoder and prefill "
          f"included); the same tokens twice, in vocab: {toks[0][:8]}; fp32 "
          f"lm_prefill logits at the prompt positions vs the full forward: "
          f"{err:.2e} of max |logit|", flush=True)
    del p32
    torch.cuda.empty_cache()
    return frames, prompts, got


def serving_clis_phase():
    """The serving entry points as a user runs them, on the card:
    ``python -m repro_torch.launch.serve --arch seamless-m4t-large-v2``
    (reduced: the fixed-batch ``generate`` path) and the serve_demo twin
    at 4 tenants, W 4, prompt 16, 12 tokens, horizon 8 (engine == oracle
    bitwise)."""
    import contextlib
    import io

    from repro_torch.examples import serve_demo
    from repro_torch.launch import serve as serve_cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_cli.main(["--arch", SEAMLESS_ARCH, "--tenants", "2",
                        "--prompt-len", "8", "--gen", "8"])
    out = buf.getvalue()
    check("fixed-batch generate path" in out and "generated (2, 16)" in out,
          f"launch.serve --arch {SEAMLESS_ARCH}: {out}")
    gen_line = next(x for x in out.splitlines() if x.startswith("generated"))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        demo = serve_demo.main(["--tenants", "4", "--width", "4",
                                "--prompt-len", "16", "--gen", "12",
                                "--horizon", "8"])
    out = buf.getvalue()
    check(demo["parity"] and demo["tokens"] == 48
          and "bitwise parity vs fixed-batch oracle: True" in out,
          f"serve_demo: {out}")
    print(f"[serving clis] launch.serve --arch {SEAMLESS_ARCH} (reduced) on "
          f"the card: {gen_line}; examples.serve_demo --tenants 4 --width 4 "
          f"--prompt-len 16 --gen 12 --horizon 8: engine == oracle bitwise, "
          f"{demo['tokens']} tokens, hot run {demo['hot_s']:.3f}s", flush=True)


def prefill_probe(engine_run, frames, prompts, params, cfg) -> int:
    """ROADMAP section 3's probe around the new prefill paths: the
    qwen2-vl lanes' M-RoPE prefill and seamless's cross-cache decode,
    in turns, each synchronized, for PROBE_S seconds -> iterations."""
    n, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < PROBE_S:
        engine_run()
        encdec_generate(params, cfg, frames, prompts, 4, "cuda")
        torch.cuda.synchronize()
        n += 1
    return n


def variant_card_vs_cpu(ops):
    """fp32, the same params (drawn on the CPU), tokens, image rows and
    frames on the card and the CPU, for the reduced gemma3, llama4,
    qwen2-vl and seamless: lm_loss and logits within LM_LOSS_TOL, 8
    greedy tokens equal (seamless through its cross caches), and one IFL
    round (N 2, tau 1, B 2, S 64; ``train_ifl_lm``'s init, draws and
    step) with losses within LM_LOSS_TOL."""
    from repro_torch.configs import get_config
    from repro_torch.core.ifl_spmd import init_ifl_state, make_ifl_round_step
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models.modules import tree_map
    from repro_torch.models.transformer import init_lm, lm_apply, lm_loss
    from repro_torch.train.loop import _ifl_batch

    rng = np.random.default_rng(13)
    report = {}
    for arch in (GEMMA_ARCH, LLAMA4_ARCH, QWEN2VL_ARCH, SEAMLESS_ARCH):
        cfg = get_config(arch).reduced()
        params = init_lm(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
        batch = variant_batch(cfg, 2, 64, seed=3, device="cpu")
        prompts = rng.integers(0, cfg.vocab_size, (2, 16))
        init, _ = init_ifl_state(cfg, n_clients=2,
                                 generator=torch.Generator().manual_seed(1),
                                 device="cpu")
        res = {}
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda a: a.to(dev), params)
            b = {k: v.to(dev) for k, v in batch.items()}
            with torch.no_grad():
                loss = float(lm_loss(p, cfg, b))
                logits = lm_apply(p, cfg, b)[0].cpu()
                if cfg.is_encdec:
                    toks = encdec_generate(p, cfg, batch["frame_embeds"],
                                           prompts, 8, dev)[0]
                else:
                    toks = greedy_tokens(p["base"], cfg, p["modular"], cfg,
                                         prompts, 8, dev)
            cp = [tree_map(lambda a: a.to(dev).clone(), q) for q in init]
            m = make_ifl_round_step(cfg, n_clients=2, tau=1, lr_base=3e-3,
                                    lr_modular=3e-3)(
                cp, [{"base": {}, "modular": {}} for _ in range(2)],
                _ifl_batch(SyntheticLM(cfg.vocab_size, seed=0), cfg, 2, 1, 2,
                           64, 0, device=dev))[2]
            res[dev] = (loss, logits, toks,
                        [float(m["base_loss"]), float(m["mod_loss"])])
        (lc, gc, tc, rc), (lg, gg, tg, rg) = res["cpu"], res["cuda"]
        lerr = abs(lg - lc)
        gerr = float((gg - gc).abs().max() / max(1.0, gc.abs().max()))
        rerr = max(abs(a - c) for a, c in zip(rg, rc))
        check(lerr <= LM_LOSS_TOL and gerr <= LM_LOSS_TOL and tg == tc
              and rerr <= LM_LOSS_TOL and bool(torch.isfinite(gg).all())
              and all(np.isfinite(rg)),
              f"{cfg.name} card vs CPU: loss {lerr}, logits {gerr}, tokens "
              f"{tg} vs {tc}, IFL round losses {rg} vs {rc}")
        report[cfg.name] = (lerr, gerr, rerr)
    print("[variants card vs cpu] fp32, same params, tokens, image rows and "
          "frames: " + "; ".join(
              f"{n}: loss |diff| {a:.2e}, logits {b:.2e} of max |logit|, 8 "
              f"greedy tokens equal, IFL round losses |diff| {c:.2e}"
              for n, (a, b, c) in report.items())
          + f" (tolerance {LM_LOSS_TOL})", flush=True)


def variants_phase(ops, train_cli):
    """Phase 4o: qk-norm, M-RoPE with the image rows and the encoder with
    cross-attention at their widths (the non-causal kernels' checks run
    with the others, in ``attn_checks``), then the serving CLIs -> (the
    encoder's attention launches in seamless's training step, the
    launch counts of seamless's ``generate``)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_demo_store
    from repro_torch.serve import ServeEngine

    # gemma3 and llama4 at their widths, cut to depth.
    for cfg, label, grad_kw in (
            (gemma3_cut(), "gemma3-27b cut to depth (2 local prefix layers, "
             "base groups 0 of 5, modular groups 1 of 5: 8 of 62 layers)",
             dict(head_check=True, **GEMMA_TRAIN)),
            (llama4_cut(), "llama4-maverick cut to depth (1 local dense "
             "layer in the base, 1 NoPE global MoE layer in the modular "
             "block: 2 of 48 layers)",
             dict(frozen=("modular", "groups", "l0", "moe", "experts"),
                  **VARIANT_TRAIN))):
        torch.cuda.empty_cache()
        cut_serve_phase(ops, cfg, label, "variants serve")
        variant_grad(ops, cfg, label, **grad_kw)
    # qwen2-vl at full depth: lanes with text prompts, lm_loss with image
    # rows, one DP step through the CLI.
    qcfg = get_config(QWEN2VL_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    qstore = build_demo_store(qcfg, QWEN2VL_ARCH, CUT_SERVE["tenants"],
                              seed=0, reduced=False, device="cuda")
    qreqs = variant_serve(ops, qstore, qcfg, f"{QWEN2VL_ARCH} full depth")
    variant_grad(ops, qcfg, f"{QWEN2VL_ARCH} ({qcfg.num_image_tokens} "
                 f"image rows)", **VARIANT_TRAIN)
    variant_dp_step(train_cli, ops, QWEN2VL_ARCH)
    # seamless at full depth: one DP step through the CLI, then greedy
    # decoding through the cross caches, then the probe.
    scfg = get_config(SEAMLESS_ARCH)
    torch.cuda.empty_cache()
    sparams, enc_launches = variant_dp_step(train_cli, ops, SEAMLESS_ARCH)
    frames, prompts, gen_launches = seamless_decode_phase(ops, sparams, scfg)
    r = CUT_SERVE
    n_probe = prefill_probe(lambda: ServeEngine(
        qstore, width=r["width"], cache_len=r["prompt_len"] + r["gen"],
        horizon=r["horizon"], device="cuda").run(qreqs),
        frames, prompts, sparams, scfg)
    print(f"[variants probe] qwen2-vl lanes (M-RoPE ragged prefill) and "
          f"seamless cross-cache decoding in turns, each synchronized, for "
          f"{PROBE_S:.0f}s: {n_probe} iterations, no fault", flush=True)
    del qstore, sparams
    torch.cuda.empty_cache()
    variant_card_vs_cpu(ops)
    serving_clis_phase()
    return enc_launches, gen_launches


# ----------------------------- phase 4: sampling and the serve-plan tuner

# Phase 4's sampled requests: the greedy requests' prompts and arrivals.
SAMPLED = dict(temperature=0.8, top_k=20)


def warm_serve(engine, reqs):
    """A warm run: ``engine.fresh_clone()`` serves ``reqs``, the card
    synchronized before each clock read -> (completions, seconds,
    composed steps)."""
    warm = engine.fresh_clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    comps = warm.run(reqs)
    torch.cuda.synchronize()
    return (comps, time.perf_counter() - t0,
            sum(lane.composed_steps for lane in warm.lanes()))


def sampler_cost(V: int, W: int = 4):
    """One tick's sampling work in a lane of W rows over a vocab of V:
    the keys' split and ``sample_token`` (threshold top-k, temperature,
    ``categorical`` on the threefry bits). -> (device kernels launched,
    their device time in ms from the profiler, the eager call's time in
    ms between CUDA events, host launches included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import lanes, prng

    g = torch.Generator(device="cuda").manual_seed(5)
    logits = torch.randn((W, V), generator=g, device="cuda")
    keys = prng.split(prng.prng_key(3, "cuda"), W)
    temp = torch.tensor([0.8, 0.0, 0.8, 1.2][:W], device="cuda")
    top_k = torch.tensor([20, 0, 20, 0][:W], device="cuda")

    def step():
        nk = prng.split(keys)
        return lanes.sample_token(logits, nk[:, 1], temp, top_k)

    ms = event_time_ms(step)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    rows = [r for r in prof.key_averages()
            if r.device_type == DeviceType.CUDA]
    n = sum(r.count for r in rows)
    dev_ms = sum(r.self_device_time_total for r in rows) / 1e3
    return n, dev_ms, ms


def sampled_serve_phase(ops, cfg, store, reqs, greedy, greedy_warm_s):
    """Phase 4's sampled run on the full-width store: ``reqs`` at
    temperature 0.8 and top-k 20, plus a greedy neighbour (request 0's
    prompt under another rid), through the engine at W 4, horizon 8:
    flash_decode launches == layers x composed steps and no other
    kernel; engine == oracle bitwise for every request; the greedy
    neighbour's stream == request 0's in the all-greedy run; horizon 1
    gives the same streams; a warm run of the 4 sampled requests timed
    as the greedy one was. -> the counts and times."""
    import dataclasses

    from repro_torch.serve import ServeEngine

    sreqs = [dataclasses.replace(r, **SAMPLED) for r in reqs]
    neighbour = dataclasses.replace(reqs[0], rid=len(reqs), arrival=1)
    mixed = sreqs + [neighbour]
    engine = ServeEngine(store, width=4, cache_len=64, horizon=8,
                         device="cuda")
    reset_counts(ops)
    t0 = time.perf_counter()
    comps = engine.run(mixed)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    got = launch_counts(ops)
    steps = sum(lane.composed_steps for lane in engine.lanes())
    check(got["flash_decode"] == cfg.num_layers * steps
          and all(v == 0 for k, v in got.items() if k != "flash_decode"),
          f"sampled serve: launches {got}, {cfg.num_layers} layers x "
          f"{steps} composed steps")
    check(len(comps) == 5 and all(len(c.tokens) == 32 for c in comps)
          and all(0 <= t < cfg.vocab_size for c in comps for t in c.tokens),
          "sampled serve: a request did not complete in vocab")
    check(comps[-1].tokens == greedy[0].tokens,
          f"sampled serve: the greedy neighbour {comps[-1].tokens[:8]} != "
          f"its all-greedy stream {greedy[0].tokens[:8]}")
    n_moved = sum(c.tokens != g.tokens for c, g in zip(comps, greedy))
    check(n_moved == 4, f"sampled serve: {n_moved} of 4 streams left "
          "the greedy ones")
    for r, c in zip(mixed, comps):
        check(engine.oracle(r).tokens == c.tokens,
              f"sampled serve: request {r.rid} != oracle")
    h1 = ServeEngine(store, width=4, cache_len=64, horizon=1,
                     device="cuda").run(mixed)
    check([c.tokens for c in h1] == [c.tokens for c in comps],
          "sampled serve: horizon 1 streams != horizon 8's")
    warm_comps, warm_s, warm_steps = warm_serve(engine, sreqs)
    check([c.tokens for c in warm_comps] == [c.tokens for c in comps[:4]],
          "sampled serve: warm run differs")
    n_tok = sum(len(c.tokens) for c in warm_comps)
    n_k, dev_ms, eager_ms = sampler_cost(cfg.vocab_size)
    print(f"[serve sampled] 4 requests at temperature 0.8, top-k 20, and a "
          f"greedy neighbour, W 4, horizon 8: engine == oracle bitwise; "
          f"horizon 1 == 8; the neighbour == request 0's greedy stream; "
          f"flash_decode {got['flash_decode']} == {cfg.num_layers} layers x "
          f"{steps} composed steps; first run {cold_s:.2f}s; warm run of the "
          f"4 sampled requests {warm_s:.3f}s = {n_tok / warm_s:.1f} tok/s, "
          f"{warm_s / warm_steps * 1e3:.2f} ms a composed step (greedy "
          f"{greedy_warm_s:.3f}s = {n_tok / greedy_warm_s:.1f} tok/s); the "
          f"sampler at W 4, V {cfg.vocab_size}: {n_k} kernels a "
          f"composed step, {dev_ms:.4f} ms of device time, {eager_ms:.4f} ms "
          f"eager", flush=True)
    print(f"[serve sampled] tenant0 tokens {comps[0].tokens[:12]}",
          flush=True)
    return dict(launches=got["flash_decode"], steps=steps,
                warm_s=warm_s, warm_steps=warm_steps, sampler_kernels=n_k,
                sampler_ms=dev_ms, sampler_eager_ms=eager_ms)


def autotune_phase(ops, store, reqs, comps):
    """``ServeEngine.autotune`` on the full-width store (W 4, cache 64)
    over horizons 4 and 8 and the two default edge sets, into a plan
    file under a temporary directory; a ``horizon="auto"`` engine takes
    the plan and serves ``reqs`` to the integer-horizon engine's
    streams (``comps``). The tuning workload is the first two of
    ``reqs`` (their prompts and staggered arrivals) cut to 8 new tokens:
    each of the 4 candidates serves it twice. Horizon 1, where every
    arrival is its own 32-step prefill, took half the phase's time and is
    served in phases 4 (sampled) and 4q (``serving_bench``). -> the
    plan."""
    import dataclasses
    import os
    import tempfile

    from repro_torch.serve import ServeEngine

    env = "REPRO_TORCH_SERVE_PLAN_CACHE"
    old = os.environ.get(env)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "serve_plan.json")
        os.environ[env] = path
        ops._serve_cache_mem = None
        try:
            eng = ServeEngine(store, width=4, cache_len=64, device="cuda")
            t0 = time.perf_counter()
            plan = eng.autotune([dataclasses.replace(r, max_new_tokens=8)
                                 for r in reqs[:2]], horizons=(4, 8))
            tune_s = time.perf_counter() - t0
            with open(path) as f:
                on_disk = json.load(f)
            key = ops._serve_key(eng.plan_key(), "cuda")
            check(list(on_disk) == [key] and len(plan["candidates"]) == 4,
                  f"autotune: plan file {list(on_disk)}, {plan}")
            auto = ServeEngine(store, width=4, cache_len=64, horizon="auto",
                               device="cuda")
            check(auto.horizon == plan["horizon"]
                  and auto.bucket_edges == plan["bucket_edges"],
                  f"horizon='auto' took {auto.horizon}, "
                  f"{auto.bucket_edges}, not the plan {plan}")
            got = auto.run(reqs)
            check([c.tokens for c in got] == [c.tokens for c in comps],
                  "horizon='auto' streams != the integer horizon's")
        finally:
            if old is None:
                os.environ.pop(env, None)
            else:
                os.environ[env] = old
            ops._serve_cache_mem = None
    cands = "; ".join(f"h {c['horizon']} edges {c['bucket_edges']}: "
                      f"{c['seconds']:.4f}s" for c in plan["candidates"])
    print(f"[serve autotune] {key}: horizon {plan['horizon']}, edges "
          f"{plan['bucket_edges']}, {plan['seconds']:.4f}s (tuning took "
          f"{tune_s:.1f}s); candidates {cands}; horizon='auto' took the "
          f"plan, streams == the horizon-8 engine's", flush=True)
    return plan


# ------------------------------------------------- the dry-run (phase 4p)

# Phase 4p's steps on full-width qwen1.5-0.5b: one DP step at phase 4e's
# B 2, S 512 and one W 4 composed decode step over phase 4's cache of 64
# rows (at position 40); each step's warm wall time is the median of
# DRY_REPS runs between CUDA events.
DRY_DP = dict(batch=LM_RUN["batch"], seq=LM_RUN["seq"])
DRY_DECODE = dict(width=4, cache=64, pos=40)
DRY_REPS = 5
# The dry-run CLI's runs on this machine (meta tensors, no card), started
# in the background after the build and read in phase 4p.
DRY_CLI = (["--arch", "deepseek-v3-671b", "--shape", "train_4k"],
           ["--all", "--accounting-only"])


def start_dryrun_cli():
    """``python -m repro_torch.launch.dryrun`` for each of DRY_CLI, in the
    background (CPU and meta only), into a temporary directory; a run
    still going when the script exits (a failed phase) is killed. ->
    [(argv, process, start time, out dir)]."""
    import atexit
    import tempfile

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    runs = []
    for argv in DRY_CLI:
        out = tempfile.mkdtemp(prefix="dryrun_")
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
               "--out", out]
        runs.append((argv, subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), time.perf_counter(), out))
    atexit.register(lambda: [r[1].kill() for r in runs
                             if r[1].poll() is None])
    return runs


def finish_dryrun_cli(runs) -> None:
    """Wait for each background dry-run, check it ended with "all
    dry-runs OK", print its wall and its last lines; remove its files."""
    import shutil

    for argv, proc, t0, out in runs:
        text, _ = proc.communicate(timeout=600)
        wall = time.perf_counter() - t0
        shutil.rmtree(out, ignore_errors=True)
        lines = [x for x in text.splitlines() if x.startswith("[ok]")]
        done = re.search(r"all dry-runs OK in ([\d.]+)s", text)
        check(proc.returncode == 0 and done is not None,
              f"dryrun {' '.join(argv)}: exit {proc.returncode}\n"
              + text[-3000:])
        print(f"[dryrun cli] python -m repro_torch.launch.dryrun "
              f"{' '.join(argv)}: {len(lines)} rows, exit 0, "
              f"{done.group(1)} s (its own clock, beside phases 3-4o; "
              f"{wall:.1f} s from its start to this phase)", flush=True)
        print(f"[dryrun cli]   {lines[0][:300]}", flush=True)


def accounted(step, args, device, log):
    """``step(*args)`` once under an ``Accounting`` of ``device`` holding
    ``args`` -> its result."""
    from repro_torch.roofline.accounting import Accounting

    acc = Accounting(device=device, log=log)
    with acc:
        acc.hold(args)
        step(*args)
    if device == "cuda":
        torch.cuda.synchronize()
    return acc.result()


def _kernel_counts(r):
    return {k: (v["launches"], v["flops"], v["bytes"])
            for k, v in r["kernels"].items()}


def dryrun_phase(ops, cfg, smi):
    """Phase 4p: the dry-run's prediction against the card. Each of the
    two steps (DRY_DP, DRY_DECODE) runs once on meta tensors under the
    accounting (the dry-run's own path: ``configs.shapes.param_specs``,
    no memory behind it) and once on the card under the same accounting:
    FLOPs, bytes, the bytes of each op family and each kernel's launches,
    FLOPs and bytes must be equal, and the kernels' launches equal to the
    launch counters (attention: the layers times remat, derived; decode:
    24 a step). On a difference both op logs go to ``chiprun_out/``.
    Then each step's warm wall between CUDA events against its model
    FLOPs (``mfu``) and against the roofline's bound (``bound_step_s``),
    and the accounting's peak beside ``torch.cuda.max_memory_allocated``.
    -> {step: numbers}."""
    from repro_torch.configs.shapes import META, param_specs
    from repro_torch.core.ifl_spmd import make_dp_train_step, make_serve_step
    from repro_torch.launch.dryrun import _active_params, _block_params
    from repro_torch.models import modules as nn
    from repro_torch.models.transformer import init_decode_cache, init_lm
    from repro_torch.optim import make_optimizer
    from repro_torch.roofline.analysis import HW, model_flops, roofline_terms

    opt = make_optimizer("sgd")
    gen = torch.Generator(device="cuda").manual_seed(0)
    card_params = init_lm(cfg, generator=gen, device="cuda",
                          dtype=nn.dtype_of(cfg.param_dtype))
    meta_params = param_specs(cfg)
    B, S = DRY_DP["batch"], DRY_DP["seq"]
    W, L = DRY_DECODE["width"], DRY_DECODE["cache"]

    def tokens(shape, dev):
        if dev == "meta":
            return torch.empty(shape, dtype=torch.int32, device=META)
        return torch.randint(0, cfg.vocab_size, shape, generator=gen,
                             device="cuda", dtype=torch.int32)

    def dp_args(params, dev):
        return [params, opt.init(params), {"tokens": tokens((B, S), dev)}]

    def decode_args(params, dev):
        return [params, init_decode_cache(cfg, W, L, device=dev),
                tokens((W, 1), dev),
                torch.tensor(DRY_DECODE["pos"], device=dev)]

    fwd, bwd = expected_attn_launches(cfg, steps_full=1, steps_mod=0,
                                      fwd_only=False)
    a_base, a_mod = _active_params(cfg, *_block_params(cfg))
    out = {}
    for name, step, make, want, tok in (
            ("dp", make_dp_train_step(cfg), dp_args,
             {"flash_attention": fwd, "flash_attention_bwd": bwd}, B * S),
            ("decode", make_serve_step(cfg), decode_args,
             {"flash_decode": cfg.num_layers}, W)):
        logs = {"meta": [], "card": []}
        pred = accounted(step, make(meta_params, "meta"), "meta",
                         logs["meta"])
        args = make(card_params, "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(ops)
        card = accounted(step, args, "cuda", logs["card"])
        got = launch_counts(ops)
        peak = torch.cuda.max_memory_allocated()
        fams = {k: v for k, v in card["by_family"].items() if k != "host"}
        pfams = {k: v for k, v in pred["by_family"].items() if k != "host"}
        if (pred["flops"], pred["bytes"], pfams, _kernel_counts(pred)) != (
                card["flops"], card["bytes"], fams, _kernel_counts(card)):
            odir = ROOT / "chiprun_out"
            odir.mkdir(exist_ok=True)
            for dev, log in logs.items():
                (odir / f"phase4p_{name}_{dev}.txt").write_text(
                    "\n".join(f"{o}\t{f}\t{b}" for o, f, b in log))
            first = next((i for i, (a, b) in enumerate(zip(
                logs["meta"], logs["card"])) if a != b), None)
            check(False, f"dryrun {name}: meta {pred['flops']} FLOPs, "
                  f"{pred['bytes']} bytes, {pfams}, {pred['kernels']} != "
                  f"card {card['flops']}, {card['bytes']}, {fams}, "
                  f"{card['kernels']}; first differing op {first}: "
                  f"{logs['meta'][first] if first is not None else None} "
                  f"vs {logs['card'][first] if first is not None else None}"
                  f" (of {len(logs['meta'])} / {len(logs['card'])} ops)")
        check({k: v[0] for k, v in _kernel_counts(card).items()} == want
              and all(got[k] == want.get(k, 0) for k in got),
              f"dryrun {name}: kernels {card['kernels']}, counters {got}, "
              f"want {want}")
        # The warm wall: the step again, DRY_REPS times between events.
        step(*args)
        times = []
        for _ in range(DRY_REPS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            step(*args)
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b) / 1e3)
        wall = statistics.median(times)
        mf = model_flops("dp_train" if name == "dp" else "decode",
                         params_base=a_base, params_mod=a_mod, tokens=tok)
        terms = roofline_terms({"flops": card["flops"],
                                "bytes accessed": card["bytes"]},
                               cfg.compute_dtype, HW, model_flops_total=mf)
        peak_flops = HW.peak_flops(cfg.compute_dtype)
        out[name] = dict(
            flops=card["flops"], bytes=card["bytes"], wall_s=wall,
            walls_s=times, model_flops=mf,
            mfu=mf / (wall * peak_flops),
            roofline_share=terms["bound_step_s"] / wall,
            bound_step_s=terms["bound_step_s"], dominant=terms["dominant"],
            peak_accounted=card["peak_bytes"], peak_allocated=peak,
            kernels={k: v[0] for k, v in _kernel_counts(card).items()})
        o = out[name]
        print(f"[dryrun {name}] {cfg.name} full width, "
              + (f"make_dp_train_step at B {B}, S {S}" if name == "dp" else
                 f"make_serve_step at W {W}, cache {L}")
              + f": meta prediction == card: {card['flops']:.6e} FLOPs, "
              f"{card['bytes']:.6e} bytes ({len(logs['card'])} ops; "
              f"{ {k: int(v['bytes']) for k, v in fams.items()} }), kernels "
              f"{o['kernels']} == the counters; peak accounted "
              f"{o['peak_accounted'] / 2**30:.3f} GiB, "
              f"max_memory_allocated {peak / 2**30:.3f} GiB", flush=True)
        print(f"[dryrun {name}] {smi}: warm wall {wall * 1e3:.3f} ms "
              f"(median of {DRY_REPS}: "
              f"{[round(t * 1e3, 3) for t in times]}); mfu "
              f"{o['mfu']:.6f} (model {mf:.4e} FLOPs at "
              f"{peak_flops:.3g} FLOP/s), roofline share "
              f"{o['roofline_share']:.6f} (bound {o['bound_step_s'] * 1e3:.4f}"
              f" ms, {o['dominant']})", flush=True)
        del args
        torch.cuda.empty_cache()
    return out


# ------------------------------- phase 4q: launch plans and the tooling
#
# (a) The launch choices read from the card's SM count, held to the
# rules at the H100 SXM's 132 SMs (tests/_launch_rules.py) at phase 3's
# and 4's shapes and the timed shapes of #3-#7. (b) The wire plan's
# autotuner at PLAN_TUNE into a temporary plan file, then the wrappers in
# a fresh read of it. (c) The serving_bench twin's --smoke on the card.
# (d) The perf_probe twin on meta (this machine's CPU) and the
# gen_experiments twin over what it wrote.

PLAN_PROJ = ([(32, K, N) for K, N in PATH_FCS]
             + [(32, 1568, 432), (1024, 432, 432), (33, 433, 433),
                (32, 40, 8192), (1000, 432, 432), LM_PROJ])
PLAN_ENCODE = [(32, 1568, 432), (1024, 432, 432), (4096, 96, 432),
               (33, 433, 433), (4096, 1024, 1024)]
PLAN_DECODE = [(32, 432, 256), (32, 432, 128), (32, 432, 10),
               (1024, 432, 432), (33, 433, 433), (32, 8192, 40)]
# (kind, codec, rows, d) of the autotuner's runs; proj_encode's fresh-read
# launch is at client 2's fusion FC, K 1568.
PLAN_TUNE = [("encode", "int8_row", 32, 432), ("encode", "ef(int4)", 32, 432),
             ("encode", "int4", 4096, 1024), ("proj_encode", "int8_row", 32, 432),
             ("decode_proj", "int8_row", 32, 432)]
PLAN_PROJ_K = 1568
PROBE_ROW = ("qwen1.5-0.5b", "train_4k", "dp", ["remat_none", "ce_chunk"])


def plan_choices(ops) -> int:
    """Every choice the launch rules make from the card's SM count at the
    checked shapes, against the rule at 132 SMs -> the choices checked."""
    import _launch_rules as rules

    sms = ops.sm_count("cuda")
    n = 0
    decode = set(rules.DECODE_SPLITS_132) | {
        (B, KVH, G, L, hd) for B, L, KVH, G, hd, *_ in
        DECODE_SPLIT_CASES + DECODE_SHAPES}
    for shape in sorted(decode):
        got = ops.decode_splits(*shape, sms)
        want = rules.DECODE_SPLITS_132.get(shape,
                                           ops.decode_splits(*shape, 132))
        check(got == want, f"decode_splits{shape}: {got} at {sms} SMs, "
                           f"{want} at 132")
        n += 1
    for dt, name in ((F32, "float32"), (BF16, "bfloat16")):
        for M, K, N in PLAN_PROJ:
            got = ops.fused_tile("fusion_proj", M, K, N, dt)
            want = rules.proj_tile(M, N, name)
            check(got == want == ops.fused_tile("fusion_proj", M, K, N, dt,
                                                sms=132),
                  f"fusion_proj tile {(M, K, N, name)}: {got}, rule {want}")
            n += 1
        for M, K, N in PLAN_ENCODE:
            got = ops.fused_tile("proj_encode", M, K, N, dt)
            want = rules.encode_tile(M, N, name)
            check(got == want == ops.fused_tile("proj_encode", M, K, N, dt,
                                                sms=132),
                  f"fused encode tile {(M, K, N, name)}: {got}, rule {want}")
            n += 1
        for M, d, N in PLAN_DECODE:
            got = ops.fused_tile("decode_proj", M, d, N, dt)
            want = ops.fused_tile("decode_proj", M, d, N, dt, sms=132)
            check(got == want >= 0,
                  f"decode_proj tile {(M, d, N, name)}: {got}, at 132 {want}")
            n += 1
    for M, D, xd, _, _ in RMS_CALLS:
        aligned = D % (4 if xd == F32 else 8) == 0
        got = ops.rmsnorm_grid(M, D, xd)
        want = rules.rmsnorm_grid(M, D, aligned)
        check(got == want == ops.rmsnorm_grid(M, D, xd, sms=132),
              f"rmsnorm grid {(M, D, xd)}: {got}, rule {want}")
        n += 1
    return n


def _plan_launch(ops, get_codec, kind, codec, rows, d, tile):
    """One wrapper launch of ``kind`` on fixed inputs at the plan's
    shape, with ``tile`` (None: the card's plan) -> its outputs."""
    gen = torch.Generator(device="cuda").manual_seed(rows + d)
    c = get_codec(codec)
    z = torch.randn((rows, d), generator=gen, device="cuda")
    if kind == "encode":
        if c.name.startswith("ef("):
            e = 0.1 * torch.randn((rows, d), generator=gen, device="cuda")
            p, e_new = ops.wire_encode_ef(z, e, c, warps=tile)
            return {**p, "e'": e_new}
        return ops.wire_encode(z, c, warps=tile)
    if kind == "proj_encode":
        x, w, b = proj_inputs(rows, PLAN_PROJ_K, d, seed=7)
        return ops.fusion_proj_encode(x, w, b, "relu", codec=c, tile=tile)
    payload = ops.ref.wire_encode_ref(z, c)
    _, w, b = proj_inputs(rows, d, 256, seed=8)
    return {"y": ops.decode_proj(payload, w, b, "relu", codec=c,
                                 shape=(rows, d), tile=tile)}


def wire_plan_phase(ops, get_codec) -> dict:
    """autotune_wire_plan at PLAN_TUNE into a temporary plan file (every
    candidate's us, each admissible), then in a fresh read of the file
    each wrapper launches with the tuned team or tile (the value passed
    to the C entry), bitwise the kernel rule's outputs, one launch a
    call; the env and the plan cache put back after. -> {key: entry}."""
    import shutil
    import tempfile
    import _launch_rules as rules

    old = os.environ.get("REPRO_TORCH_WIRE_PLAN_CACHE")
    tmp = tempfile.mkdtemp(prefix="wire_plan_")
    path = os.path.join(tmp, "wire_plan.json")
    os.environ["REPRO_TORCH_WIRE_PLAN_CACHE"] = path
    ops._wire_cache_mem = None
    entries = {}
    try:
        for kind, codec, rows, d in PLAN_TUNE:
            t0 = time.perf_counter()
            entry = ops.autotune_wire_plan(codec, d, kind=kind, rows=rows,
                                           force=True)
            knob = "warps" if kind == "encode" else "tile"
            cands = entry["candidates"]
            check(len(cands) > 1 and all(c["admissible"] for c in cands),
                  f"autotune {kind} {codec} {(rows, d)}: {cands}")
            entries[(kind, codec, rows, d)] = entry
            print(f"[plan] autotune_wire_plan {kind} {codec} at ({rows}, "
                  f"{d}): " + ", ".join(f"{knob} {c[knob]} {c['us']:.3f} us"
                                        for c in cands)
                  + f"; winner {knob} {entry[knob]} ({entry['us']:.3f} us), "
                  f"the rule's {knob} {entry['default']}; every candidate "
                  f"bitwise the rule's ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
        ops._wire_cache_mem = None        # a fresh read of the file
        sms = ops.sm_count("cuda")
        for (kind, codec, rows, d), entry in entries.items():
            knob = "warps" if kind == "encode" else "tile"
            check(ops.wire_plan(get_codec(codec).name, d, kind, "cuda")
                  == {knob: entry[knob]}, f"wire_plan {kind} {codec}")
            want = _plan_launch(ops, get_codec, kind, codec, rows, d, -1)
            with rules.KnobSpy(ops) as spy:
                got = _plan_launch(ops, get_codec, kind, codec, rows, d, None)
            entry_name = {"encode": "wire_encode", "decode_proj":
                          "decode_proj"}.get(kind, "fusion_proj_encode")
            passed, passed_sms = spy.knob(entry_name)
            torch.cuda.synchronize()
            check(passed == entry[knob] and passed_sms in (None, sms),
                  f"{kind} {codec}: launched with {knob} {passed} (sms "
                  f"{passed_sms}), plan {entry[knob]}")
            check(spy.count(entry_name) == 1,
                  f"{kind} {codec}: {spy.count(entry_name)} launches")
            check(ops._first_differing(want, got) is None,
                  f"{kind} {codec}: tuned outputs differ from the rule's")
        print(f"[plan] fresh read of the plan file: every wrapper launched "
              f"with its tuned team or tile, one C launch a call, outputs "
              f"bitwise the kernel rule's", flush=True)
    finally:
        if old is None:
            os.environ.pop("REPRO_TORCH_WIRE_PLAN_CACHE", None)
        else:
            os.environ["REPRO_TORCH_WIRE_PLAN_CACHE"] = old
        ops._wire_cache_mem = None
        shutil.rmtree(tmp, ignore_errors=True)
    return entries


def serving_bench_phase() -> dict:
    """The serving_bench twin's --smoke on the card (W 8, T 8, gen 48):
    parity exact on every arm (a hard check); tok/s and the fused arm's
    speedup over horizon 1 printed beside the reference's 1.5x gate, a
    finding, not a check."""
    import shutil
    import tempfile
    from repro_torch.benchmarks import serving_bench

    tmp = tempfile.mkdtemp(prefix="serving_")
    t0 = time.perf_counter()
    res = serving_bench.main(["--smoke", "--out",
                              os.path.join(tmp, "BENCH_serving.json"),
                              "--device", "cuda"])
    shutil.rmtree(tmp, ignore_errors=True)
    arms = res["arms"]
    check(all(a["parity_exact"] for a in arms),
          "serving_bench --smoke: an arm differs from its oracle")
    fused = [a for a in arms if a.get("speedup_vs_h1") is not None]
    gate = serving_bench.check_failures(res, 1.5)
    print(f"[plan] serving_bench --smoke on the card: parity exact on "
          f"{len(arms)} arms + sequential; tok/s sequential "
          f"{res['sequential'][0]['tok_per_s']:.1f}, "
          + ", ".join(f"W {a['width']} S {a['horizon']} {a['tok_per_s']:.1f}"
                      for a in arms)
          + f"; fused over horizon 1 x{fused[0]['speedup_vs_h1']:.3f}; the "
          f"reference's gate (1.5x, batched > sequential) "
          f"{'holds' if not gate else 'does not hold: ' + '; '.join(gate)}"
          f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    return res


def probe_phase() -> None:
    """The perf_probe twin on meta (this machine's CPU) at PROBE_ROW,
    beside its baseline, then the gen_experiments twin over that
    directory: every variant file written and all five sections."""
    import shutil
    import tempfile
    from repro_torch.benchmarks import gen_experiments, perf_probe
    from repro_torch.launch import dryrun

    arch, shape, step, probes = PROBE_ROW
    out = tempfile.mkdtemp(prefix="probe_")
    t0 = time.perf_counter()
    dryrun.run_one(arch, shape, step_kind=step, n_clients=4, tau=2,
                   variant="", out_dir=out, force=True)
    rows = perf_probe.run(arch, shape, probes, step=step, out=out)
    names = sorted(os.listdir(out))
    want = [f"{arch}__{shape}__h100__{step}{'__' + v if v else ''}.json"
            for v in ["", *probes]]
    check(sorted(want) == names and [n for n, _ in rows]
          == ["baseline", *probes], f"perf_probe wrote {names}")
    # §Perf embeds PERF.md §5-§6 where the checkout has that log, and
    # says in one line that it is missing where it has not.
    log = ROOT / "PERF.md"
    log_text = log.read_text() if log.is_file() else ""
    md = gen_experiments.generate(os.path.join(out, "EXPERIMENTS.md"),
                                  dryrun_dir=out, perf=str(log))
    with open(md) as f:
        text = f.read()
    heads = ["## §Paper", "## §Dry-run", "## §Roofline",
             "## §IFL vs FL-equivalent", "## §Perf"]
    perf = text[text.find("## §Perf"):]
    has_log = "\n## 5." in log_text
    if has_log:
        embedded = "\n## 5." in perf and "\n## 7." not in perf
    else:
        embedded = ("_PERF.md not found_" in perf
                    or "_PERF.md has no §5_" in perf)
    check(all(h in text for h in heads) and embedded,
          f"gen_experiments: sections {[h for h in heads if h in text]}, "
          f"§Perf {perf[:200]!r} (PERF.md "
          f"{'present' if log_text else 'absent'})")
    print(f"[plan] perf_probe {arch} {shape} --step {step} --probe "
          f"{' '.join(probes)} on meta: " + "; ".join(
              f"{n} compute {r['roofline']['compute_s']:.3f} s memory "
              f"{r['roofline']['memory_s']:.3f} s temp "
              f"{r['memory']['temp_bytes'] / 1e9:.1f} GB" for n, r in rows)
          + f"; gen_experiments wrote {len(text.splitlines())} lines with "
          f"all five sections, PERF.md §5-§6 "
          f"{'embedded' if has_log else 'not in the checkout'}"
          f" ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    shutil.rmtree(out, ignore_errors=True)


def tooling_phase(ops, get_codec) -> dict:
    """Phase 4q: (a) the card's SM count and the choices read from it,
    (b) the wire plan, (c) serving_bench, (d) perf_probe and
    gen_experiments. -> the autotuner's entries."""
    sms = ops.sm_count("cuda")
    n = plan_choices(ops)
    print(f"[plan] {torch.cuda.get_device_name(0)}: multi_processor_count "
          f"{sms}; {n} launch choices (decode_splits' (S, chunk), "
          f"fusion_proj.cu's tiles of #3-#6, rmsnorm.cu's grid) at phase "
          f"3's and 4's shapes and the timed shapes equal the rules' at "
          f"132 SMs", flush=True)
    entries = wire_plan_phase(ops, get_codec)
    serving_bench_phase()
    probe_phase()
    return entries


def tree_numpy(tree):
    """A tree of tensors -> the same tree of numpy arrays."""
    if isinstance(tree, dict):
        return {k: tree_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one more warm serving run, one more warm "
                         "IFL round of each codec, one more warm round of "
                         "each baseline, an async tick and a cohort round")
    ap.add_argument("--kernel-times", action="store_true",
                    help="build, then only time the launch floor, "
                         "flash_decode, the fused encode, decode_proj and "
                         "the wire encodes at their timed shapes (no checks, "
                         "no result line)")
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
        # Each spill line under the kernel it belongs to: the mangled
        # name's identifier and template arguments ("IfLi128": float, 128).
        spills, entry = [], "?"
        for x in lines:
            if "Function properties for " in x:
                entry = x.split("Function properties for ")[1].strip()
                m = re.search(r"_cu_[0-9a-f]{8}(\d+)", entry)
                if m:
                    n = m.end() + int(m.group(1))
                    entry = entry[m.end():n] + entry[n:].split("EE")[0]
            elif "spill" in x and "0 bytes spill stores" not in x:
                spills.append(f"{entry}: {x.strip()}")
        print(f"[ptxas {name}] {len(regs)} instantiations, registers "
              f"{min(regs, default=0)}..{max(regs, default=0)}, "
              f"{len(spills)} spilling: {spills}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.kernel_times:
        kernel_times(ops, ref, get_codec, gen)
        return
    dryrun_cli = start_dryrun_cli()

    # -- 3. kernel vs plain on the card -----------------------------------
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
    split_err = decode_split_checks(ops, ref, gen)
    print(f"[kernel] flash_decode split-L at {len(DECODE_SPLIT_CASES)} cases "
          f"(L 1, 64, 65, 129, 257, 300, 4097; G 1, 4, 8, 16; hd 8, 24, 32, "
          f"48, 64, 96, 128; wholly masked splits, "
          f"fully masked rows zero; one launch a call) and a split call "
          f"twice in one CUDA graph, replayed 3 times: fp32 max|err| "
          f"{split_err:.3e}", flush=True)
    wire_err = wire_checks(ops, ref, get_codec)
    print(f"[kernel] wire_encode / wire_encode_ef vs plain, schemes "
          f"{WIRE_SCHEMES} at {WIRE_SHAPES} with a zero "
          f"row, EF over 4 chained steps: codes, nibbles and indices "
          f"bitwise; float leaves and e' max|err| "
          f"{wire_err['wire_encode']:.3e} / {wire_err['wire_encode_ef']:.3e}",
          flush=True)

    attn_err = attn_checks(ops, ref)
    n_fp = fingerprint_check(ops)
    n_guard = guard_checks(ops, gen)
    print(f"[kernel] flash_decode / flash_attention / flash_attention_bwd "
          f"between NaN guard bands at {n_guard} cases (every split-L and "
          f"attention case, MLA's head dims and causal=False among them, "
          f"the lanes' decode shapes), {GUARD_REPS} launches "
          f"each: the wrappers' bits every time, no band read into a result "
          f"or written, arrival counters back at 0", flush=True)
    print(f"[kernel] attention at hd 64 and 128: {n_fp} outputs (fwd o, lse; "
          f"bwd dq, dk, dv; decode) bitwise those of the kernels before the "
          f"padded head dims (attn_fingerprints_hd64_128.json)", flush=True)
    print(f"[kernel] flash_attention / flash_attention_bwd vs plain at "
          f"{len(ATTN_CASES)} cases, {len(MLA_ATTN_CASES)} with v's head "
          f"dim apart from q/k's (MLA: 48/32, 192/128, 192/192) and "
          f"{len(ATTN_BIDIR_CASES)} with causal=False (S 100 and 1000, H = "
          f"KVH and G > 1, hd 24, 64 and 128, windows 1, 48, 65, 300) x "
          f"fp32, bf16: relative max|err| fwd "
          f"{attn_err['all']['fwd']:.3e}, bwd {attn_err['all']['bwd']:.3e}; "
          f"at the path's case (bf16) max|err| fwd "
          f"{attn_err['path']['fwd']:.3e}, bwd {attn_err['path']['bwd']:.3e}; "
          f"at deepseek-v3's {MLA_ATTN_CASES[0]} (bf16) fwd "
          f"{attn_err['mla']['fwd']:.3e}, bwd {attn_err['mla']['bwd']:.3e}; "
          f"at the seamless encoder's {ATTN_BIDIR_CASES[0]} (bf16, "
          f"causal=False) fwd {attn_err['enc']['fwd']:.3e}, bwd "
          f"{attn_err['enc']['bwd']:.3e}", flush=True)

    fused_err, n_codes, n_flips = fused_checks(ops, ref, get_codec)
    print(f"[kernel] fusion_proj / fusion_proj_quant / fusion_proj_encode / "
          f"decode_proj vs plain at the path's shapes, (1024,432,432), "
          f"(33,433,433) and {LM_PROJ} (fusion_proj, fp32 and bf16; bf16 "
          f"exact on structured inputs at (32,784,1024) and {LM_PROJ}), schemes "
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
    del engine, warm
    sampled = sampled_serve_phase(ops, cfg, store, reqs, comps, warm_s)
    autotune_phase(ops, store, reqs, comps)
    del store

    # -- 4b. the card against the CPU on the reduced config (fp32) --------
    small = cfg.reduced()
    cpu_store = build_demo_store(small, arch, 3, seed=1, reduced=True,
                                 device="cpu")
    small_reqs = demo_requests(small, 3, prompt_len=12, gen=10, stagger=1,
                               seed=1)
    small_sampled = demo_requests(small, 3, prompt_len=12, gen=10,
                                  stagger=1, seed=1, **SAMPLED)
    streams, sampled_streams = {}, {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(cpu_store, width=2, cache_len=32, horizon=4,
                          device=dev)
        streams[dev] = [c.tokens for c in eng.run(small_reqs)]
        eng = ServeEngine(cpu_store, width=2, cache_len=32, horizon=4,
                          device=dev)
        sampled_streams[dev] = [c.tokens for c in eng.run(small_sampled)]
    check(streams["cuda"] == streams["cpu"],
          f"reduced config: card streams {streams['cuda']} != CPU "
          f"{streams['cpu']}")
    check(sampled_streams["cuda"] == sampled_streams["cpu"]
          and sampled_streams["cpu"] != streams["cpu"],
          f"reduced config, sampled: card streams {sampled_streams['cuda']} "
          f"!= CPU {sampled_streams['cpu']}")
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
    print(f"[serve] reduced {small.name} fp32: card streams == CPU streams, "
          f"greedy and sampled (temperature 0.8, top-k 20); logits "
          f"max|card - cpu| {lerr:.2e}", flush=True)

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
    front_door_card_vs_cpu()

    # -- 4e. LM IFL at full width through the training CLI ---------------
    from repro_torch.launch import train as train_cli

    lm = lm_train_phase(train_cli, ops, cfg, args.profile)

    # -- 4f. the card against the CPU: LM IFL at the reduced config -------
    lm_card_vs_cpu(cfg.reduced())

    # -- 4g. the fused wire path at the Table-II client boundary ---------
    fused_launches = boundary_phase(ops, get_codec)

    # -- 4h. rmsnorm: the op is the kernel's only path ---------------------
    rms_launches, rms_err = rmsnorm_phase(ops, ref)

    # -- 4i. the front door: run_experiment under delta, resume ----------
    front_door_phase(ops, round_bytes_match)

    # -- 4j. baselines and the paper's figures ---------------------------
    baselines_phase(ops, args.profile)
    baselines_card_vs_cpu()
    fig2_phase(ops)

    # -- 4k. async rounds and population fleets ---------------------------
    async_phase(ops, round_bytes_match, args.profile)
    async_card_vs_cpu()
    population_phase(ops, args.profile)
    twins_phase()

    # -- 4l. the SPMD IFL trainer, its front door and its export -----------
    t0 = time.perf_counter()
    spmd = spmd_full_width_phase(ops, cfg, smi)
    spmd.update(spmd_front_door_phase(ops))
    # #2's row holds the full-width path's own payloads too.
    wire_err["wire_encode_ef"] = max(wire_err["wire_encode_ef"],
                                     spmd.pop("ef_err"))
    llm_twin_phase(ops)
    print(f"[spmd] phase 4l took {time.perf_counter() - t0:.1f}s", flush=True)

    # -- 4r. the SPMD round on a mesh of ranks -----------------------------
    mesh_launches = mesh_phase(ops, smi)

    # -- 4m. the recurrent mixers and cross-family composition -----------
    t0 = time.perf_counter()
    recurrent_serve_phase(ops)
    cross = cross_family_phase(ops, args.profile)
    recurrent_train_phase(train_cli, ops)
    recurrent_card_vs_cpu()
    compose_twin_phase()
    print(f"[recurrent] phase 4m took {time.perf_counter() - t0:.1f}s",
          flush=True)

    # -- 4n. MoE, MLA and MTP: deepseek-v3-671b at its widths -------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    ds_cfg = deepseek_cut()
    deepseek_serve_phase(ops, ds_cfg)
    ds_grad = deepseek_grad_phase(ops, ds_cfg)
    moe_card_vs_cpu()
    moe_train_phase(train_cli, ops)
    print(f"[deepseek] phase 4n took {time.perf_counter() - t0:.1f}s",
          flush=True)

    # -- 4o. qk-norm, softcap, M-RoPE with images, the encoder -------------
    t0 = time.perf_counter()
    enc_launches, gen_launches = variants_phase(ops, train_cli)
    print(f"[variants] phase 4o took {time.perf_counter() - t0:.1f}s",
          flush=True)

    # -- 4p. the dry-run's prediction against the card -------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    dryrun_phase(ops, cfg, smi)
    finish_dryrun_cli(dryrun_cli)
    print(f"[dryrun] phase 4p took {time.perf_counter() - t0:.1f}s",
          flush=True)

    # -- 4q. launch plans keyed by the card, and the last tooling twins ----
    t0 = time.perf_counter()
    tooling_phase(ops, get_codec)
    print(f"[plan] phase 4q took {time.perf_counter() - t0:.1f}s",
          flush=True)

    # -- 5. times at the slice's shape ------------------------------------
    decode_t = []
    for Bt, Lt, KVHt, Gt, hdt, lengths, n_sets in DECODE_SHAPES:
        S, chunk = ops.decode_splits(Bt, KVHt, Gt, Lt, hdt,
                                     ops.sm_count("cuda"))
        decode_t.append(decode_times(ops, ref, gen, Bt, Lt, KVHt, Gt, hdt,
                                     lengths, n_sets,
                                     note=f"(S {S} x {chunk} rows)"))
        torch.cuda.empty_cache()
    dt = decode_t[0]   # the path's shape: the JSON row; the rest are lines
    print(f"[time] flash_decode: {cfg.num_layers} launches per composed step",
          flush=True)
    # The cross-family lanes' decode (olmo-1b: KVH 16, hd 128) and the
    # padded head dims at the serving path's W 4, cache 64.
    decode_hd = {hdt: decode_times(ops, ref, gen, 4, 64, 16, 1, hdt,
                                   [64, 40, 33, 17], 64,
                                   note=f"(hd {hdt})")
                 for hdt in (128, 24, 48)}

    launch_floor_ms()
    wire_t = {}
    for rows in (32, 4096):
        wire_t[rows] = wire_times(ops, ref, get_codec, rows)
    # The SPMD path's encode: all N x B x S = 4096 rows of full-width
    # qwen1.5-0.5b's fusion output (1024) in one launch.
    spmd_t = wire_times(ops, ref, get_codec, 4096, d=1024,
                        schemes=("int4",))[("wire_encode_ef", "int4")]

    kernels = [{
        "name": "flash_decode",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_attention.py:121",
        "launches": launches,
        "spmd_launches": spmd["flash_decode"],
        "max_abs_err": err_bf16,
        "ms": dt["ms"],
        "plain_ms": dt["plain_ms"],
        "bound_ms": dt["bound_ms"],
        "bound_by": dt["bound_by"],
        "library_ms": dt["library_ms"],
        "cross_launches": cross["flash_decode"],
        # Phase 4's sampled run and seamless's generate (phase 4o).
        "sampled_launches": sampled["launches"],
        "generate_launches": gen_launches["flash_decode"],
        **{f"hd{h}_{k}": decode_hd[h][k] for h in (128, 24, 48)
           for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
    }]
    # The IFL path's codecs at its shape (32, 432): int8_row through
    # wire_encode, ef(int4) through wire_encode_ef.
    for kname, scheme in (("wire_encode", "int8_row"),
                          ("wire_encode_ef", "int4")):
        t = wire_t[32][(kname, scheme)]
        row = {
            "name": kname,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/wire_encode.cu",
            "replaces": ("src/repro/kernels/wire_fused.py:370"
                         if kname == "wire_encode"
                         else "src/repro/kernels/wire_fused.py:389"),
            "launches": ifl_launches[kname],
            "spmd_launches": spmd[kname],
            # Phase 4r: summed over its ranks and rounds.
            "mesh_launches": mesh_launches[kname],
            "max_abs_err": wire_err[kname],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": None,
        }
        if kname == "wire_encode_ef":   # the SPMD path's (4096, 1024)
            row.update(spmd_ms=spmd_t["ms"], spmd_plain_ms=spmd_t["plain_ms"],
                       spmd_bound_ms=spmd_t["bound_ms"])
        kernels.append(row)
    at = attn_times(ops, ref, ATTN_TIMED[0])
    for shape in ATTN_TIMED[1:]:   # printed as [time] lines only
        attn_times(ops, ref, shape)
    at_hd = {h: attn_times(ops, ref, shape)
             for h, shape in ATTN_HD_TIMED.items()}
    at_mla = attn_times(ops, ref, MLA_ATTN_TIMED)
    at_bidir = attn_times(ops, ref, ATTN_BIDIR_TIMED, causal=False)
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
            "spmd_launches": spmd[kname],
            "mesh_launches": mesh_launches[kname],
            "smoke_launches": spmd["smoke_" + kname[6:]],
            "max_abs_err": err,
            "ms": at[key],
            "plain_ms": at[key + "_plain"],
            "bound_ms": at[key + "_bound"],
            "bound_by": at[key + "_bound_by"],
            "library_ms": at[key + "_sdpa"],
            **{f"hd{h}_{k}": at_hd[h][key + suffix] for h in at_hd
               for k, suffix in (("ms", ""), ("plain_ms", "_plain"),
                                 ("bound_ms", "_bound"),
                                 ("library_ms", "_sdpa"))},
            # deepseek-v3's MLA at its widths (phase 4n): launches in the
            # full-width lm_loss pass, error and times at its shape.
            "mla_launches": ds_grad[kname],
            "mla_max_abs_err": attn_err["mla"][key],
            **{f"mla_{k}": at_mla[key + suffix]
               for k, suffix in (("ms", ""), ("plain_ms", "_plain"),
                                 ("bound_ms", "_bound"),
                                 ("library_ms", "_sdpa"))},
            # causal=False, the seamless encoder's self-attention (phase
            # 4o): launches in its full-width training step, error and
            # times at its shape (SDPA non-causal beside them).
            "bidir_launches": enc_launches[kname],
            **({"generate_bidir_launches":
                gen_launches["flash_attention_bidir"]}
               if kname == "flash_attention" else {}),
            "bidir_max_abs_err": attn_err["enc"][key],
            **{f"bidir_{k}": at_bidir[key + suffix]
               for k, suffix in (("ms", ""), ("plain_ms", "_plain"),
                                 ("bound_ms", "_bound"),
                                 ("library_ms", "_sdpa"))},
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
            ("decode_proj", ("decode_proj", 32, 256),
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
    # rmsnorm at kernel_bench's (8192, 4096) fp32.
    t = rms_times(ops, ref)[(8192, 4096)]
    kernels.append({
        "name": "rmsnorm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:25",
        "launches": rms_launches,
        "max_abs_err": rms_err,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
    })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
