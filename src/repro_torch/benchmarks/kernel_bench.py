"""The twin of ``benchmarks/kernel_bench.py`` on the port: each
hand-written kernel at the shapes its path gives it.

    python -m repro_torch.benchmarks.kernel_bench [--device cpu]

On any device it prints ``kernels/cost.py``'s row of each kernel at
each of its timed shapes: the bytes it must move, the operations it
must do and the least time one H100 could take (``bound_ms``, by bytes
or by operations). On the card (the default; without one it raises,
unless ``--device cpu`` asks for the rows alone) it then builds the
kernels and times them beside their plain versions and, where one
exists, the one PyTorch call that computes the same function: the
launch floor, ``flash_decode``, the fused encode (#5/#6),
``decode_proj``, ``wire_encode`` / ``wire_encode_ef``, both attention
kernels (the backward also in a CUDA graph), ``fusion_proj`` and
``rmsnorm``.

These timing functions are the repo's one harness: ``chip_smoke.py``
imports them for its kernels line and its ``--kernel-times`` rows.
Forwards and the wire, decode and fused kernels are captured in a CUDA
graph over distinct input sets and replayed (``graph_time_ms``, the
median of 50 replays); calls through autograd are timed eagerly between
CUDA events (``event_time_ms``). The run prints the card's name and
power limit (``nvidia-smi``) before and after its times.
"""

from __future__ import annotations

import argparse
import math
import statistics
import subprocess

import torch

from repro_torch.kernels import cost

WIRE_SCHEMES = ("int8_row", "int4", "topk", "sketch")
D_FUSION = 432
# Table-II: the FCs of the path other than the fusion FC (client 4's
# base, the modular blocks after their first), and an LM-sized product.
PATH_FCS = [(784, 1024), (1024, 512), (256, 128), (128, 64), (64, 10),
            (128, 10)]
LM_PROJ = (4096, 4096, 2048)
F32, BF16 = torch.float32, torch.bfloat16

# flash_decode's timed shapes, (B, L, KVH, G, hd, live lengths, input
# sets): the serving path's (W 4, cache 64; 64 sets of ~1 MB of K/V
# cycle through the 50 MB L2, as each layer's cache arrives cold in a
# decode step), then a 4,096-row cache, Qwen1.5-0.5B's published
# 32,768-token context and llama3-405b's head layout (KVH 8, G 16, hd
# 128), every row live, with enough sets that their K and V exceed L2.
DECODE_SHAPES = [(4, 64, 16, 1, 64, [64, 40, 33, 17], 64),
                 (4, 4096, 16, 1, 64, [4096] * 4, 2),
                 (4, 32768, 16, 1, 64, [32768] * 4, 1),
                 (4, 4096, 8, 16, 128, [4096] * 4, 2)]


# Attention's timed shapes, (B, S, H, KVH, hd, window), bf16 causal: the
# LM path's and hd 128; the padded head dims 24 and 48; MLA's (B, S, H,
# KVH, q/k hd, v hd, window) at deepseek-v3's widths; the seamless
# encoder's shape without the causal mask.
ATTN_TIMED = [(2, 512, 16, 16, 64, -1), (2, 512, 16, 16, 128, -1)]
ATTN_HD_TIMED = {24: (2, 512, 16, 16, 24, -1), 48: (2, 512, 16, 16, 48, -1)}
MLA_ATTN_TIMED = (1, 512, 128, 128, 192, 128, -1)
ATTN_BIDIR_TIMED = (2, 1024, 16, 16, 64, -1)

# The fused encode's timed calls: (M, K, codec, quant, input sets). #5
# and #6 at client 2's fusion FC (32, 1568, 432), under int8_row,
# ef(int4) and top-k (its sort); #6 at fig2's (1024, 432, 432) and at
# (4096, 96, 432), where #4's larger tiles fill the card.
ENCODE_TIMED = {
    "fusion_proj_quant": (32, 1568, "int8_row", True, 32),
    "fusion_proj_encode": (32, 1568, "int8_row", False, 32),
    "fusion_proj_encode_ef": (32, 1568, "ef(int4)", False, 32),
    "fusion_proj_encode_topk": (32, 1568, "topk", False, 32),
    "fusion_proj_encode_fig2": (1024, 432, "int8_row", False, 8),
    "fusion_proj_encode_fig2_ef": (1024, 432, "ef(int4)", False, 8),
    "fusion_proj_encode_4096": (4096, 96, "int8_row", False, 4),
}


# decode_proj's timed calls: (M, N, input sets) of an int8_row payload of
# (M, 432) into a first modular FC of width N, relu. The boundary's three
# widths, and fig2's (1024, 432, 432).
DECODE_TIMED = [(32, 256, 32), (32, 128, 32), (32, 10, 32), (1024, 432, 8)]

# rmsnorm's timed calls: (M, D, x dtype, scale dtype, input sets), kernel
# _bench's (8192, 4096) fp32 and the LM clients' (4096, 1024) bf16 rows
# with fp32 params, with enough sets that the inputs come from HBM.
RMS_TIMED = ((8192, 4096, F32, F32, 2), (4096, 1024, BF16, F32, 8))


# ---------------------------------------------------------------- inputs


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


def attn_inputs(B, S, H, KVH, hd, dtype, seed, hdv=None):
    """q, k (head dim hd), v and dO (head dim hdv, default hd)."""
    hdv = hdv or hd
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, S, KVH, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, S, KVH, hdv), generator=gen, device="cuda").to(dtype)
    do = torch.randn((B, S, H, hdv), generator=gen, device="cuda").to(dtype)
    return q, k, v, do


def proj_inputs(M, K, N, seed, dtype=torch.float32, zero_row=True):
    """x (M, K) with an all-zero row, w (K, N) at 1/sqrt(K), b (N,)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((M, K), generator=gen, device="cuda")
    if zero_row:
        x[min(3, M - 1)] = 0.0
    w = torch.randn((K, N), generator=gen, device="cuda") / math.sqrt(K)
    b = 0.1 * torch.randn((N,), generator=gen, device="cuda")
    return x.to(dtype), w.to(dtype), b


def rms_inputs(M, D, xd, sd, scale, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = 2.0 * torch.randn((M, D), generator=gen, device="cuda")
    s = (torch.ones((D,), device="cuda") if scale == "ones"
         else torch.randn((D,), generator=gen, device="cuda"))
    return x.to(xd), s.to(sd)


# ---------------------------------------------------------------- timers


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


def launch_floor_ms() -> float:
    """The per-call time of a one-element ``add_`` in the graph harness:
    the least a kernel launch costs there."""
    t = torch.zeros(1, device="cuda")
    ms = graph_time_ms([lambda: t.add_(1.0)] * 64)
    print(f"[time] launch floor (one-element add_, 64 in a CUDA graph): "
          f"{ms * 1e3:.2f} us", flush=True)
    return ms


# ------------------------------------------------------- the kernels


def decode_times(ops, ref, gen, B, L, KVH, G, hd, lengths, n_sets, note=""):
    """flash_decode's device time at one bf16 shape over ``n_sets`` input
    sets, with its plain version, SDPA and the bound; ``note`` goes into
    the printed line. The kernel is first held to its plain version on
    the first set (the bf16 defaults). -> the JSON row's numbers."""
    sets = [decode_inputs(gen, B, L, KVH, G, hd, torch.bfloat16, lengths)
            for _ in range(n_sets)]
    torch.testing.assert_close(ops.cached_attn_decode(*sets[0]),
                               ref.cached_attn_decode_ref(*sets[0]))
    kernel_ms = graph_time_ms(
        [lambda s=s: ops.cached_attn_decode(*s) for s in sets])
    plain_ms = graph_time_ms(
        [lambda s=s: ref.cached_attn_decode_ref(*s) for s in sets])
    sdpa = []
    for q, k, v, valid in sets:
        sdpa.append((q.reshape(B, KVH * G, 1, hd), k.transpose(1, 2),
                     v.transpose(1, 2), valid[:, None, None, :]))
    gqa = {"enable_gqa": True} if G > 1 else {}
    library_ms = graph_time_ms(
        [lambda a=a: torch.nn.functional.scaled_dot_product_attention(
            a[0], a[1], a[2], attn_mask=a[3], **gqa) for a in sdpa])
    # The least work this data needs: masked cache rows cannot change the
    # output, so only the live rows of K and V count.
    live = int(sets[0][3].sum())
    c = cost.flash_decode(B, L, KVH, G, hd, torch.bfloat16, live=live)
    nbytes = c["bytes"]
    print(f"[time] flash_decode at B={B} L={L} KVH={KVH} G={G} hd={hd} bf16 "
          f"{note}: kernel {kernel_ms * 1e3:.2f} us, plain "
          f"{plain_ms * 1e3:.2f} us, sdpa {library_ms * 1e3:.2f} us, bound "
          f"{c['bound_ms'] * 1e3:.3f} us ({nbytes} bytes, {live} of "
          f"{B * L} cache rows live); {nbytes / kernel_ms / 1e9:.3f} TB/s",
          flush=True)
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=c["bound_ms"], bound_by=c["bound_by"])


def wire_times(ops, ref, get_codec, rows, d=432, schemes=WIRE_SCHEMES):
    """Device times of each wire kernel and its plain version at (rows,
    d), per scheme, with the byte bound; 64 input sets per graph."""
    out = {}
    for scheme in schemes:
        codec, ef = get_codec(scheme), get_codec(f"ef({scheme})")
        zs = [wire_inputs(rows, d, seed=1000 + i) for i in range(64)]
        es = [0.1 * wire_inputs(rows, d, seed=2000 + i) for i in range(64)]
        sch = ops.scheme_for(codec, d)
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
            c = cost.wire_encode(sch, rows, ef=is_ef)
            nbytes = c["bytes"]
            out[(kname, scheme)] = dict(
                ms=k_ms, plain_ms=p_ms, bound_ms=c["bound_ms"],
                bound_by=c["bound_by"], nbytes=nbytes)
            print(f"[time] {kname} {scheme} at ({rows},{d}): kernel "
                  f"{k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us, bound "
                  f"{c['bound_ms'] * 1e3:.4f} us ({nbytes} bytes)",
                  flush=True)
    return out


def attn_times(ops, ref, shape, causal=True):
    """Forward and backward times at ``shape`` (B, S, H, KVH, hd, window,
    or B, S, H, KVH, hd, hdv, window; bf16, causal or not): kernel, plain
    version, SDPA (``is_causal=causal``; no window: the timed shapes have
    none) and the bound. Forwards are graph-replayed (16 input sets, ~8
    MB each at hd 64, so K/V come from HBM as in the model); backwards
    are timed eagerly with events (the plain and SDPA backwards run
    through autograd), each the backward alone on a forward done once,
    and the kernel's backward also graph-replayed over the 16 sets
    (``bwd_graph``)."""
    B, S, H, KVH, hd, hdv, window = (shape if len(shape) == 7 else
                                     (*shape[:5], shape[4], shape[5]))
    sets = [attn_inputs(B, S, H, KVH, hd, torch.bfloat16, seed=100 + i,
                        hdv=hdv) for i in range(16)]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t = {}
    kw = dict(causal=causal, window=window)
    t["fwd"] = graph_time_ms([lambda s=s: ops.flash_attention_fwd(
        s[0], s[1], s[2], **kw) for s in sets])
    t["fwd_plain"] = graph_time_ms([lambda s=s: ref.flash_attention_ref(
        s[0], s[1], s[2], **kw) for s in sets])
    bhsd = [tuple(x.transpose(1, 2) for x in s) for s in sets]
    t["fwd_sdpa"] = graph_time_ms([lambda a=a: sdpa(a[0], a[1], a[2],
                                                    is_causal=causal)
                                   for a in bhsd])
    q, k, v, do = sets[0]
    o, lse = ops.flash_attention_fwd(q, k, v, **kw)
    t["bwd"] = event_time_ms(lambda: ops.flash_attention_bwd(
        q, k, v, o, lse, do, **kw))
    # The backward kernel alone also in a CUDA graph over the 16 sets,
    # as the forward is timed: its eager time swings from call to call.
    fwds = [ops.flash_attention_fwd(*s[:3], **kw) for s in sets]
    t["bwd_graph"] = graph_time_ms([
        lambda s=s, f=f: ops.flash_attention_bwd(*s[:3], *f, s[3], **kw)
        for s, f in zip(sets, fwds)])
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    o_ref = ref.flash_attention_ref(*leaves, **kw)
    t["bwd_plain"] = event_time_ms(lambda: torch.autograd.grad(
        o_ref, leaves, do, retain_graph=True))
    # SDPA in its own (B, H, S, hd) layout, contiguous.
    leaves_t = [x.transpose(1, 2).contiguous().requires_grad_() for x in
                (q, k, v)]
    do_t = do.transpose(1, 2).contiguous()
    o_sdpa = sdpa(*leaves_t, is_causal=causal)
    t["bwd_sdpa"] = event_time_ms(lambda: torch.autograd.grad(
        o_sdpa, leaves_t, do_t, retain_graph=True))
    # The least work these inputs need: every (query, key) pair the mask
    # keeps, and each tensor moved once (cost.py).
    args = (B, S, H, KVH, hd, hdv, window, causal, torch.bfloat16)
    for key, c in (("fwd", cost.flash_attention(*args)),
                   ("bwd", cost.flash_attention_bwd(*args))):
        nb, fl = c["bytes"], int(c["flops"])
        t[key + "_bound"] = c["bound_ms"]
        t[key + "_bound_by"] = c["bound_by"]
        print(f"[time] flash_attention {key} at B {B} S {S} H {H} KVH {KVH} "
              f"hd {hd} hdv {hdv} bf16 "
              f"{'causal' if causal else 'bidirectional'}: kernel "
              f"{t[key] * 1e3:.2f} us, plain "
              f"{t[key + '_plain'] * 1e3:.2f} us, sdpa "
              f"{t[key + '_sdpa'] * 1e3:.2f} us, bound "
              f"{t[key + '_bound'] * 1e3:.3f} us ({nb} bytes, {fl} flops)"
              + (f"; kernel in a CUDA graph {t['bwd_graph'] * 1e3:.2f} us"
                 if key == "bwd" else ""), flush=True)
    return t


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
        c = cost.fusion_proj(M, K, N, dtype)
        nbytes, bound, by = c["bytes"], c["bound_ms"], c["bound_by"]
        print(f"[time] fusion_proj ({M},{K},{N}) {str(dtype)[6:]} {act}: "
              f"kernel {k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us, "
              f"addmm+relu {l_ms * 1e3:.2f} us, bound {bound * 1e3:.4f} us "
              f"({by}; {nbytes} bytes); kernel / addmm+relu "
              f"{k_ms / l_ms:.2f}x", flush=True)
        return dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=bound,
                    bound_by=by)

    for k, n in PATH_FCS:
        out[("fusion_proj", k, n)] = time_proj(32, k, n, torch.float32)
    out["fusion_proj_1568"] = time_proj(32, 1568, D_FUSION, torch.float32)
    out["fusion_proj_bf16"] = time_proj(32, 784, 1024, torch.bfloat16)
    for dtype in (torch.float32, torch.bfloat16):
        out[("fusion_proj_lm", dtype)] = time_proj(*LM_PROJ, dtype, sets=2)

    for key, (M, K, name, quant, sets) in ENCODE_TIMED.items():
        out[key] = encode_times(ops, ref, get_codec, M, K, name, quant, sets)

    for M, N, sets in DECODE_TIMED:
        out[("decode_proj", M, N)] = decode_proj_times(ops, ref, get_codec,
                                                       M, N, sets=sets)
    return out


def decode_proj_times(ops, ref, get_codec, M, N, name="int8_row", sets=32):
    """Device times of ``decode_proj`` at an (M, 432) payload -> N, its
    plain version, the unfused decode + ``addmm`` + relu, and
    ``fusion_proj`` on the decoded input (the identity's right side,
    without the decode), with the bound. -> the JSON row's numbers."""
    codec, d = get_codec(name), D_FUSION
    ins = []
    for i in range(sets):
        _, w, b = proj_inputs(1, d, N, seed=1100 + i)
        ins.append((codec.encode(wire_inputs(M, d, seed=1200 + i)), w, b))
    shape = (M, d)
    decoded = [(codec.decode(p, shape=shape), w, b) for p, w, b in ins]
    times = [graph_time_ms([lambda a=a: f(*a) for a in ins]) for f in (
        lambda p, w, b: ops.decode_proj(p, w, b, "relu", codec=codec,
                                        shape=shape),
        lambda p, w, b: ref.decode_proj_ref(p, w, b, "relu", codec=codec,
                                            shape=shape),
        lambda p, w, b: torch.relu_(torch.addmm(
            b, codec.decode(p, shape=shape), w)))]
    proj_ms = graph_time_ms([lambda a=a: ops.fusion_proj(*a, "relu")
                             for a in decoded])
    c = cost.decode_proj(M, N, ops.scheme_for(codec, d), torch.float32)
    nbytes, bound, by = c["bytes"], c["bound_ms"], c["bound_by"]
    print(f"[time] decode_proj {name} ({M},{d})->{N} relu: kernel "
          f"{times[0] * 1e3:.2f} us, plain {times[1] * 1e3:.2f} us, "
          f"unfused decode+addmm+relu {times[2] * 1e3:.2f} us, fusion_proj "
          f"on the decoded input {proj_ms * 1e3:.2f} us, bound "
          f"{bound * 1e3:.4f} us ({by}; {nbytes} bytes)", flush=True)
    return dict(ms=times[0], plain_ms=times[1], unfused_ms=times[2],
                bound_ms=bound, bound_by=by)


def encode_times(ops, ref, get_codec, M, K, name, quant=False, sets=32):
    """Device times of the fused encode #6 (or, with ``quant``, #5) at
    (M, K, 432) relu under codec ``name``, its plain version and the
    unfused ``addmm`` + relu + ``wire_encode`` pair, with the bound,
    over ``sets`` distinct input sets. -> the JSON row's numbers."""
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
    c = cost.fusion_proj_encode(M, K, ops.scheme_for(inner, N),
                                codec.has_state, torch.float32)
    nbytes, bound, by = c["bytes"], c["bound_ms"], c["bound_by"]
    kname = "fusion_proj_quant" if quant else "fusion_proj_encode"
    print(f"[time] {kname} {name} ({M},{K},{N}) relu: kernel "
          f"{times[0] * 1e3:.2f} us, plain {times[1] * 1e3:.2f} us, "
          f"unfused addmm+relu+wire_encode {times[2] * 1e3:.2f} us, bound "
          f"{bound * 1e3:.4f} us ({by}; {nbytes} bytes)", flush=True)
    return dict(ms=times[0], plain_ms=times[1], unfused_ms=times[2],
                bound_ms=bound, bound_by=by)


def rms_times(ops, ref):
    """Device times at (8192, 4096) fp32 and (4096, 1024) bf16 x / fp32
    scale: kernel, plain, ``F.rms_norm`` (scale cast to x's dtype, the
    one PyTorch call for the function) and the byte bound. Enough input
    sets per graph that the inputs come from HBM (2 x 128 MB; 8 x 8 MB)."""
    out = {}
    for M, D, xd, sd, sets in RMS_TIMED:
        ins = [rms_inputs(M, D, xd, sd, "random", seed=300 + i)
               for i in range(sets)]
        k_ms = graph_time_ms([lambda a=a: ops.rmsnorm(*a) for a in ins])
        p_ms = graph_time_ms([lambda a=a: ref.rmsnorm_ref(*a) for a in ins])
        lib = [(x, s.to(xd)) for x, s in ins]
        l_ms = graph_time_ms([lambda a=a: torch.nn.functional.rms_norm(
            a[0], (D,), a[1], 1e-6) for a in lib])
        c = cost.rmsnorm(M, D, xd, sd)
        nbytes, bound, by = c["bytes"], c["bound_ms"], c["bound_by"]
        out[(M, D)] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                           bound_ms=bound, bound_by=by)
        print(f"[time] rmsnorm ({M},{D}) x {str(xd)[6:]} scale "
              f"{str(sd)[6:]}: kernel {k_ms * 1e3:.2f} us, plain "
              f"{p_ms * 1e3:.2f} us, F.rms_norm {l_ms * 1e3:.2f} us, bound "
              f"{bound * 1e3:.2f} us ({by}; {nbytes} bytes); kernel at "
              f"{nbytes / (k_ms * 1e-3) / 1e12:.2f} TB/s; kernel / F.rms_norm "
              f"{k_ms / l_ms:.2f}x", flush=True)
    return out



# ------------------------------------------------------------- the rows


def cost_rows():
    """``cost.py``'s row of each kernel at each of its timed shapes (the
    shapes of the timing functions above and of PERF.md's table of
    kernels): [{"kernel", "shape", "flops", "bytes", "bound_ms",
    "bound_by"}]."""
    from repro_torch.core.codec import get_codec
    from repro_torch.kernels import ops

    rows = []

    def add(kernel, shape, c):
        rows.append({"kernel": kernel, "shape": shape, **c})

    decode = [(B, L, KVH, G, hd, lengths)
              for B, L, KVH, G, hd, lengths, _ in DECODE_SHAPES]
    decode += [(4, 64, 16, 1, hd, [64, 40, 33, 17]) for hd in (128, 24, 48)]
    for B, L, KVH, G, hd, lengths in decode:
        live = sum(min(n, L) for n in lengths)
        add("flash_decode", f"B {B} L {L} KVH {KVH} G {G} hd {hd} bf16, "
            f"{live} rows live",
            cost.flash_decode(B, L, KVH, G, hd, BF16, live=live))
    for rows_, d, schemes in ((32, D_FUSION, WIRE_SCHEMES),
                              (4096, D_FUSION, WIRE_SCHEMES),
                              (4096, 1024, ("int4",))):
        for name in schemes:
            sch = ops.scheme_for(get_codec(name), d)
            add("wire_encode", f"({rows_}, {d}) {name}",
                cost.wire_encode(sch, rows_))
            add("wire_encode_ef", f"({rows_}, {d}) ef({name})",
                cost.wire_encode(sch, rows_, ef=True))
    attn = ([(*s[:5], s[4], s[5], True) for s in ATTN_TIMED]
            + [(*s[:5], s[4], s[5], True) for s in ATTN_HD_TIMED.values()]
            + [(*MLA_ATTN_TIMED, True),
               (*ATTN_BIDIR_TIMED[:5], ATTN_BIDIR_TIMED[4],
                ATTN_BIDIR_TIMED[5], False)])
    for B, S, H, KVH, hd, hdv, window, causal in attn:
        shape = (f"B {B} S {S} H {H} KVH {KVH} hd {hd} hdv {hdv} bf16"
                 f"{'' if causal else ' causal=False'}")
        args = (B, S, H, KVH, hd, hdv, window, causal, BF16)
        add("flash_attention", shape, cost.flash_attention(*args))
        add("flash_attention_bwd", shape, cost.flash_attention_bwd(*args))
    procs = ([(32, k, n, F32) for k, n in PATH_FCS]
             + [(32, 1568, D_FUSION, F32), (32, 784, 1024, BF16),
                (*LM_PROJ, F32), (*LM_PROJ, BF16)])
    for M, K, N, dt in procs:
        add("fusion_proj", f"({M}, {K}, {N}) {str(dt)[6:]}",
            cost.fusion_proj(M, K, N, dt))
    for M, K, name, quant, _ in ENCODE_TIMED.values():
        codec = get_codec(name)
        sch = ops.scheme_for(codec.inner if codec.has_state else codec,
                             D_FUSION)
        add("fusion_proj_quant" if quant else "fusion_proj_encode",
            f"({M}, {K}, {D_FUSION}) {name}",
            cost.fusion_proj_encode(M, K, sch, codec.has_state, F32))
    for M, N, _ in DECODE_TIMED:
        sch = ops.scheme_for(get_codec("int8_row"), D_FUSION)
        add("decode_proj", f"({M}, {D_FUSION}) int8_row -> {N}",
            cost.decode_proj(M, N, sch, F32))
    for M, D, xd, sd, _ in RMS_TIMED:
        add("rmsnorm", f"({M}, {D}) x {str(xd)[6:]} scale {str(sd)[6:]}",
            cost.rmsnorm(M, D, xd, sd))
    return rows


def print_rows(rows) -> None:
    print(f"{'kernel':<20} {'shape':<52} {'bytes':>12} {'flops':>15} "
          f"{'bound_ms':>11}  bound_by")
    for r in rows:
        print(f"{r['kernel']:<20} {r['shape']:<52} {r['bytes']:>12} "
              f"{r['flops']:>15.0f} {r['bound_ms']:>11.3g}  {r['bound_by']}")


def kernel_times(ops, ref, get_codec, gen) -> None:
    """``chip_smoke.py --kernel-times``: the launch floor, ``flash_decode``,
    the fused encode, ``decode_proj`` beside ``fusion_proj`` on the
    decoded input, and the wire encodes under every scheme at (32, 432)
    and (4096, 432)."""
    launch_floor_ms()
    for B, L, KVH, G, hd, lengths, n_sets in DECODE_SHAPES:
        decode_times(ops, ref, gen, B, L, KVH, G, hd, lengths, n_sets)
        torch.cuda.empty_cache()
    for M, K, name, quant, sets in ENCODE_TIMED.values():
        encode_times(ops, ref, get_codec, M, K, name, quant, sets)
    for M, N, sets in DECODE_TIMED:
        decode_proj_times(ops, ref, get_codec, M, N, sets=sets)
    for rows in (32, 4096):
        wire_times(ops, ref, get_codec, rows)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the rows, then the kernels timed on the "
                         "card; cpu: the rows alone")
    args = ap.parse_args(argv)
    print_rows(cost_rows())
    if args.device == "cpu":
        return
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_bench times the kernels on an NVIDIA card "
                           "and finds none (--device cpu prints the rows "
                           "alone)")
    from repro_torch.core.codec import get_codec
    from repro_torch.kernels import build, ops, ref

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    launch_floor_ms()
    for B, L, KVH, G, hd, lengths, n_sets in DECODE_SHAPES:
        decode_times(ops, ref, gen, B, L, KVH, G, hd, lengths, n_sets)
        torch.cuda.empty_cache()
    for rows in (32, 4096):
        wire_times(ops, ref, get_codec, rows)
    wire_times(ops, ref, get_codec, 4096, d=1024, schemes=("int4",))
    for shape in [*ATTN_TIMED, *ATTN_HD_TIMED.values(), MLA_ATTN_TIMED]:
        attn_times(ops, ref, shape)
    attn_times(ops, ref, ATTN_BIDIR_TIMED, causal=False)
    fused_times(ops, ref, get_codec)
    rms_times(ops, ref)
    print(f"[card] {smi}")


if __name__ == "__main__":
    main()
