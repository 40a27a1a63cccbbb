"""Dry-run of the port on one H100 (the JAX package's
``repro/launch/dryrun.py``, for one card).

For every (arch x input shape x step) it answers what the reference's
dry-run answers: how many FLOPs and bytes one step costs, what the
roofline bounds it at, and how much memory it needs. The reference
lowers each step with ``ShapeDtypeStruct``s on TPU pod meshes and reads
XLA's memory and cost analyses and the HLO text. The port runs the same
step functions (``core.ifl_spmd`` ``make_ifl_round_step`` /
``make_dp_train_step`` / ``make_prefill_step`` / ``make_serve_step``)
once, eagerly, on meta tensors (``configs.shapes``) under
``roofline.accounting.Accounting``: every aten op's FLOPs and bytes,
every hand-written kernel at its own cost (``kernels/cost.py``), and
the peak live bytes, at full width with no memory behind them. Each
row's JSON goes under ``--out`` (default ``results/torch/dryrun``) with
the reference's keys where they apply (``memory``, ``cost``,
``roofline`` against ``h100-sxm``, ``client_boundary``, ``n_chips``:
1), plus ``kernels``: each kernel's launches and cost.

Step kinds per shape:
  train_4k     -> ifl_round_step (--step dp: the dense baseline;
                  --all runs both)
  prefill_32k  -> prefill_step
  decode_32k / long_500k -> serve_step (1 token vs seq_len cache)

IFL rows carry the reference's ``client_boundary`` section: the
analytic per-round bytes at the client boundary under ``--codec`` /
``--participation`` / ``--broadcast`` / ``--mode`` (``comm.
ifl_round_bytes``, the formula the trainers' ledgers are held to), with
the port's wire path (``ops.fused_wire_report``). ``--accounting-only``
prices only that section, in seconds, at any fleet size.

A partial-participation round reads its mask and its valid chunks on
the host (``core/ifl_spmd.py``), and a meta tensor has no values, so the
dry-run gives the round a host mask of max(1, round(E[K])) participants,
the first slots, and keeps the cache's ages on the host; the JSON
states the mask (``mask``).

Left out, with the reason: ``--multi-pod``, ``--both-meshes`` and
``--fsdp``. The meshes (``launch.mesh``) and the sharding rules
(``sharding.rules``) are in the port, and the IFL round runs on a
('client', 'data', 'model') mesh of ranks, but a dry-run row of a mesh
needs per-rank memory from the rules and the collectives' bytes counted
under ``roofline/accounting.py``: a later slice (ROADMAP item 1 (iii)).
``--fused`` is left out too (the port's wire path follows from the codec
and the shape alone, ``ops.fused_wire_report``).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--step ifl|dp]
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k \\
      --codec int8_row --participation k2 --broadcast delta
  python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \\
      --shape train_4k --accounting-only --n-population 10000 \\
      --cohort 256 --participation "zipf(1.1)"
"""

from __future__ import annotations

import argparse
import json
import os
import re
import time
import traceback

import numpy as np
import torch

from repro_torch.config import INPUT_SHAPES, ModelConfig
from repro_torch.configs import ARCH_IDS, get_config, supports_shape
from repro_torch.configs.shapes import (
    META,
    decode_specs,
    param_specs,
    prefill_batch_specs,
    train_batch_specs,
)
from repro_torch.core.codec import get_codec
from repro_torch.core.comm import ifl_round_bytes
from repro_torch.core.ifl_spmd import (
    init_ef_state,
    init_ifl_state,
    init_payload_cache,
    make_dp_train_step,
    make_ifl_round_step,
    make_prefill_step,
    make_serve_step,
)
from repro_torch.core.rounds import (
    FullParticipation,
    expected_async_participants,
    expected_cohort_participants,
    parse_participation,
    parse_trace,
)
from repro_torch.kernels import ops as kernel_ops
from repro_torch.optim import make_optimizer
from repro_torch.roofline.accounting import Accounting
from repro_torch.roofline.analysis import HW, model_flops, roofline_terms


def _params_count(tree) -> float:
    if isinstance(tree, dict):
        return float(sum(_params_count(v) for v in tree.values()))
    return float(np.prod(tree.shape))


def _block_params(cfg: ModelConfig):
    p = param_specs(cfg)
    return _params_count(p["base"]), _params_count(p["modular"])


def _active_params(cfg: ModelConfig, p_base: float, p_mod: float):
    """MoE: count only top-k + shared experts as active."""
    if not cfg.num_experts:
        return p_base, p_mod
    specs = cfg.layer_specs()
    dff = cfg.moe_d_ff or cfg.d_ff
    per_expert = 3 * cfg.d_model * dff
    cut = cfg.fusion_cut_layer
    dead_b = dead_m = 0.0
    active_frac = (cfg.num_experts_per_tok / cfg.num_experts)
    for i, s in enumerate(specs):
        if s.ffn == "moe":
            dead = cfg.num_experts * per_expert * (1 - active_frac)
            if i < cut:
                dead_b += dead
            else:
                dead_m += dead
    return p_base - dead_b, p_mod - dead_m


def _expected_async_delta_entries(trace: str, n_clients: int, tick: float,
                                  *, ticks: int = 256,
                                  seed: int = 0) -> float:
    """Mean delta-broadcast entries per server tick under ``trace``: the
    coalesced per-tick participant stream replayed through a real
    ``SPMDFusionExchange.account_round``, as the reference prices it."""
    from repro_torch.core.exchange import SPMDFusionExchange

    rng = np.random.default_rng(seed)
    cursor = parse_trace(trace, n_clients).cursor(n_clients, rng)
    plane = SPMDFusionExchange(None, n_clients=n_clients, broadcast="delta")
    total = 0
    for t in range(ticks):
        events = cursor.pop_until((t + 1) * tick, rng)
        parts = sorted({slot for _, slot in events})
        total += plane.account_round(parts, t, entry_bytes=0)[1]
    return total / max(ticks, 1)


def client_boundary_section(cfg: ModelConfig, shape, *, n_clients: int,
                            schedule, codec: str, broadcast: str,
                            mode: str, trace: str, tick: float,
                            n_population: int = 0, cohort: int = 0):
    """The analytic per-round client-boundary bytes (the reference's
    section, number for number), with the port's wire path: the kernel
    that encodes on the card, or why the plain path runs."""
    from repro_torch.core.exchange import expected_delta_entries

    fleet_n = (n_population or n_clients) if cohort else n_clients
    width = cohort or n_clients
    rows_per_client = (shape.global_batch // width) * shape.seq_len
    arrivals_exp = None
    if mode == "async":
        k_exp, arrivals_exp = expected_async_participants(
            trace, fleet_n, tick)
        if cohort:
            k_exp = min(k_exp, float(cohort))
    elif cohort:
        k_exp = expected_cohort_participants(schedule, fleet_n, cohort)
    else:
        k_exp = schedule.expected_participants(fleet_n)
    k_int = max(1, int(round(k_exp)))
    if broadcast != "delta":
        e_exp = None
    elif mode == "async":
        e_exp = _expected_async_delta_entries(trace, fleet_n, tick)
    else:
        e_exp = expected_delta_entries(schedule, fleet_n,
                                       cohort=cohort or None)
    bcast_entries = k_int if cohort else fleet_n
    per_round = ifl_round_bytes(
        fleet_n, rows_per_client, cfg.d_fusion, codec=codec,
        participating=k_int, broadcast_entries=bcast_entries,
        broadcast=broadcast,
        delta_entries=(max(1, int(round(e_exp)))
                       if e_exp is not None else None),
    )
    full_down = ifl_round_bytes(
        fleet_n, rows_per_client, cfg.d_fusion, codec=codec,
        participating=k_int, broadcast_entries=bcast_entries,
    )["down"]
    wire_path = kernel_ops.fused_wire_report(
        codec, (rows_per_client, cfg.d_fusion))
    return {
        "codec": get_codec(codec).name,
        "wire_path": wire_path,
        "participation": schedule.name,
        "broadcast": broadcast,
        "mode": mode,
        "trace": (parse_trace(trace, fleet_n).name
                  if mode == "async" else None),
        "tick": tick if mode == "async" else None,
        "n_population": fleet_n if cohort else None,
        "cohort": cohort or None,
        "expected_participants": k_exp,
        "expected_arrivals_per_tick": arrivals_exp,
        "expected_delta_entries": e_exp,
        "per_round_bytes": per_round,
        "full_broadcast_down_bytes": full_down,
        "downlink_saving_x": full_down / max(per_round["down"], 1),
    }


def _ifl_inputs(cfg, shape, *, width, tau, codec, partial, k_exp):
    """The IFL round step's meta inputs: N params and states, the
    batch, and with ``partial`` a host mask of the first
    max(1, round(k_exp)) slots and the payload cache (ages on the
    host); an ``ef(...)`` codec's residual last. -> (args, mask list or
    None)."""
    params, opt_state = init_ifl_state(cfg, n_clients=width,
                                       generator=None, device=META)
    batch = train_batch_specs(cfg, shape, n_clients=width, tau=tau)
    args = [params, opt_state, batch]
    bc = shape.global_batch // width
    z_shape = (width, bc, shape.seq_len, cfg.d_fusion)
    mask = None
    if partial:
        k = min(width, max(1, int(round(k_exp))))
        mask = [i < k for i in range(width)]
        args += [torch.tensor(mask),
                 init_payload_cache(codec, z_shape,
                                    (width, bc, shape.seq_len),
                                    device=META, age_device="cpu")]
    if get_codec(codec).has_state:
        args.append(init_ef_state(codec, z_shape, device=META))
    return args, mask


def run_one(arch: str, shape_name: str, *, step_kind: str, n_clients: int,
            tau: int, variant: str, out_dir: str, force: bool = False,
            cfg_override=None, overrides=None, codec: str = "fp32",
            participation: str = "full", broadcast: str = "full",
            mode: str = "sync", trace: str = "", tick: float = 1.0,
            n_population: int = 0, cohort: int = 0,
            accounting_only: bool = False):
    mesh_name = "h100"
    tag = f"{arch}__{shape_name}__{mesh_name}__{step_kind}"
    # Non-default exchange axes key their own files, but only for the
    # IFL train step, the one program they change (the reference's
    # rule).
    shape_kind = INPUT_SHAPES[shape_name].kind
    if shape_kind == "train" and step_kind == "ifl":
        for prefix, value, default in (("c", codec, "fp32"),
                                       ("p", participation, "full"),
                                       ("b", broadcast, "full"),
                                       ("m", mode, "sync"),
                                       ("t", trace, ""),
                                       ("N", n_population, 0),
                                       ("C", cohort, 0)):
            if value != default:
                tag += "__" + prefix + re.sub(r"[^\w.]+", "-", str(value))
    if accounting_only:
        tag += "__acct"
    if variant:
        tag += f"__{variant}"
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(out_path) and not force:
        print(f"[skip existing] {tag}")
        with open(out_path) as f:
            return json.load(f)

    shape = INPUT_SHAPES[shape_name]
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides).validate()
    schedule = parse_participation(participation)
    ifl = shape.kind == "train" and step_kind == "ifl"

    def boundary():
        return client_boundary_section(
            cfg, shape, n_clients=n_clients, schedule=schedule, codec=codec,
            broadcast=broadcast, mode=mode, trace=trace, tick=tick,
            n_population=n_population, cohort=cohort)

    if accounting_only:
        if not ifl:
            raise ValueError("--accounting-only prices the IFL client "
                             "boundary only")
        cb = boundary()
        result = {"arch": arch, "shape": shape_name, "step": step_kind,
                  "accounting_only": True, "n_clients": n_clients,
                  "client_boundary": cb}
        with open(out_path, "w") as f:
            json.dump(result, f, indent=1)
        print(f"[ok] {tag}: accounting only, fleet N="
              f"{cb['n_population'] or n_clients} cohort C="
              f"{cb['cohort'] or '-'}: up "
              f"{cb['per_round_bytes']['up'] / 1e6:.2f}MB, down "
              f"{cb['per_round_bytes']['down'] / 1e6:.2f}MB/round")
        return result

    width = cohort or n_clients
    client_boundary = boundary() if ifl else None
    mask = None
    t0 = time.time()
    if ifl:
        # Async and cohort rounds always run the masked step: the tick's
        # participants are a runtime mask.
        partial = (cohort > 0 or mode == "async"
                   or not isinstance(schedule, FullParticipation))
        step = make_ifl_round_step(cfg, n_clients=width, tau=tau,
                                   codec=codec,
                                   partial_participation=partial)
        args, mask = _ifl_inputs(
            cfg, shape, width=width, tau=tau, codec=codec, partial=partial,
            k_exp=(client_boundary["expected_participants"]
                   if partial else width))
        grad = True
    elif shape.kind == "train":  # the dense baseline
        step = make_dp_train_step(cfg)
        params = param_specs(cfg)
        args = [params, make_optimizer("sgd").init(params),
                train_batch_specs(cfg, shape)]
        grad = True
    elif shape.kind == "prefill":
        step = make_prefill_step(cfg)
        args = [param_specs(cfg), prefill_batch_specs(cfg, shape)]
        grad = False
    else:  # decode
        step = make_serve_step(cfg)
        params = param_specs(cfg)
        dec = decode_specs(cfg, shape, params)
        args = [params, dec["cache"], dec["token"], dec["pos"],
                dec["cross_kvs"]]
        grad = False
    t_build = time.time() - t0

    t0 = time.time()
    acc = Accounting(device="meta")
    with acc, torch.set_grad_enabled(grad):
        acc.hold(args)
        held = acc.live
        step(*args)
    t_run = time.time() - t0
    counts = acc.result()
    cost = {"flops": counts["flops"], "bytes accessed": counts["bytes"]}

    p_base, p_mod = _block_params(cfg)
    a_base, a_mod = _active_params(cfg, p_base, p_mod)
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.kind != "decode" else 1)
    mf_kind = {"train": "ifl_round" if step_kind == "ifl" else "dp_train",
               "prefill": "prefill", "decode": "decode"}[shape.kind]
    mf = model_flops(mf_kind, params_base=a_base, params_mod=a_mod,
                     tokens=tokens, tau=tau, n_clients=width)
    terms = roofline_terms(cost, cfg.compute_dtype, HW,
                           model_flops_total=mf)

    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "step": step_kind if shape.kind == "train" else shape.kind,
        "variant": variant or "baseline",
        "n_chips": 1,
        "device": "meta",
        "tau": tau if ifl else None,
        "n_clients": width if step_kind == "ifl" else None,
        "mask": mask,
        "client_boundary": client_boundary,
        "memory": {
            "peak_bytes": counts["peak_bytes"],
            "argument_bytes": held,
            "temp_bytes": counts["peak_bytes"] - held,
        },
        "cost": cost,
        "by_family": counts["by_family"],
        "kernels": counts["kernels"],
        "roofline": terms,
        "timing": {"build_s": t_build, "run_s": t_run},
    }
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    launches = {k: v["launches"] for k, v in counts["kernels"].items()}
    print(f"[ok] {tag}: meta run {t_run:.1f}s, compute "
          f"{terms['compute_s'] * 1e3:.2f}ms / memory "
          f"{terms['memory_s'] * 1e3:.2f}ms / collective 0 -> "
          f"{terms['dominant']}-bound, peak "
          f"{counts['peak_bytes'] / 1e9:.2f}GB on one card; kernels "
          f"{launches}", flush=True)
    if client_boundary:
        cb = client_boundary
        regime = (f"async {cb['trace']} @tick {cb['tick']}"
                  if cb["mode"] == "async" else cb["participation"])
        print(f"     client boundary [{cb['codec']} / {regime} / "
              f"{cb['broadcast']}]: up "
              f"{cb['per_round_bytes']['up'] / 1e6:.2f}MB, down "
              f"{cb['per_round_bytes']['down'] / 1e6:.2f}MB/round "
              f"({cb['downlink_saving_x']:.2f}x below full broadcast)")
        wp = cb["wire_path"]
        print(f"     wire path: {wp['path']}"
              + (f" {wp['kernel']} encode_warps={wp['encode_warps']}"
                 if wp["fused"] else f" ({wp['fallback']})"))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true",
                    help="every (arch, shape) supports_shape allows; "
                         "train shapes under both steps unless --step")
    ap.add_argument("--step", choices=["ifl", "dp"], default=None,
                    help="train shapes: the IFL round (default) or the "
                         "dense DP step")
    ap.add_argument("--n-clients", type=int, default=4)
    ap.add_argument("--n-population", type=int, default=0,
                    help="fleet size N in the population regime "
                         "(requires --cohort; 0 = fixed fleet)")
    ap.add_argument("--cohort", type=int, default=0,
                    help="cohort width C: the step runs C client slots, "
                         "drawn C-of-N per round (0 = every client "
                         "every round)")
    ap.add_argument("--accounting-only", action="store_true",
                    help="skip the meta run; emit only the analytic "
                         "client_boundary section")
    ap.add_argument("--tau", type=int, default=2,
                    help="local base steps run per round (paper: 10)")
    ap.add_argument("--codec", default="fp32",
                    help="wire codec for the fusion exchange "
                         "(repro_torch.core.codec), e.g. int8_row, "
                         "ef(int4)")
    ap.add_argument("--participation", default="full",
                    help="client schedule (repro_torch.core.rounds, e.g. "
                         "k2): non-full runs the masked cached-payload "
                         "round step")
    ap.add_argument("--broadcast", default="full", choices=["full", "delta"],
                    help="downlink policy for the client-boundary "
                         "accounting")
    ap.add_argument("--mode", default="sync", choices=["sync", "async"],
                    help="round clocking: async runs the masked step and "
                         "prices the boundary per server tick from "
                         "--trace")
    ap.add_argument("--trace", default="",
                    help="async arrival trace, e.g. pareto(1.2,0.5); "
                         "required with --mode async")
    ap.add_argument("--tick", type=float, default=1.0,
                    help="async server fuse period in simulated seconds")
    ap.add_argument("--variant", default="",
                    help="tag of a perf experiment's files")
    ap.add_argument("--out", default="results/torch/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="config overrides, e.g. --set remat=layer")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        try:
            v = int(v)
        except ValueError:
            pass
        overrides[k] = v
    if args.mode == "async" and not args.trace:
        ap.error("--mode async requires --trace (e.g. pareto(1.2,0.5))")
    if args.n_population and not args.cohort:
        ap.error("--n-population requires --cohort")

    if args.all:
        combos = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES
                  if supports_shape(a, s)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        combos = [(args.arch, args.shape)]
    steps = ([args.step] if args.step else
             ["ifl", "dp"] if args.all and not args.accounting_only
             else ["ifl"])

    failures = []
    t0 = time.time()
    for arch, shape in combos:
        kinds = steps if INPUT_SHAPES[shape].kind == "train" else ["ifl"]
        if args.accounting_only and INPUT_SHAPES[shape].kind != "train":
            continue
        for step_kind in kinds:
            try:
                run_one(arch, shape, step_kind=step_kind,
                        n_clients=args.n_clients, tau=args.tau,
                        variant=args.variant, out_dir=args.out,
                        force=args.force, overrides=overrides,
                        codec=args.codec, participation=args.participation,
                        broadcast=args.broadcast, mode=args.mode,
                        trace=args.trace, tick=args.tick,
                        n_population=args.n_population, cohort=args.cohort,
                        accounting_only=args.accounting_only)
            except Exception as e:  # noqa: BLE001
                failures.append((arch, shape, step_kind, repr(e)))
                print(f"[FAIL] {arch} {shape} {step_kind}: {e}")
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print(f"\nall dry-runs OK in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
