"""Wrappers around the port's kernels: the model code's dispatch points.

Each op dispatches on the device of its tensors and nothing else: a CPU
tensor runs the plain PyTorch version (``ref.py``), a CUDA tensor
launches the hand-written kernel or raises. There is no fallback and no
flag that hides the kernel. Each kernel wrapper counts its launches in a
plain int attribute (``flash_decode.launches``, ``wire_encode.launches``,
``wire_encode_ef.launches``, ``flash_attention.launches``,
``flash_attention_bwd.launches``, ``fusion_proj.launches``,
``fusion_proj_quant.launches``, ``fusion_proj_encode.launches``,
``decode_proj.launches``, ``rmsnorm.launches``), so a run can show that
its main path went through the kernel. The attention wrappers also count
their ``causal=False`` launches apart (``flash_attention.bidir_launches``,
``flash_attention_bwd.bidir_launches``), so a run can show which mode ran.

Meta tensors (a dry-run, ``repro_torch.launch.dryrun``) take a third
branch in every kernel wrapper: the checks a CUDA tensor passes (but
the 16-byte alignment, which a meta tensor has no address for), then
empty outputs of the kernel's shapes and dtypes, with nothing built or
launched. Each such call counts in the wrapper's ``meta_launches``,
apart from ``launches``. A launch on the card and a meta call both
count, with the kernel's cost from ``cost.py``, in the active
accounting (``cost.launch``, ``repro_torch.roofline.accounting``); a
CPU call runs the plain version and counts no kernel.

``rmsnorm`` is the JAX package's ``repro.kernels.ops.rmsnorm``: no model
path of either package calls it (the models normalize inline), so the op
itself is its path.

Full-sequence attention (``flash_attention``) is a
``torch.autograd.Function`` on CUDA tensors: its forward launches the
forward kernel and its backward the backward kernel
(``csrc/flash_attention.cu``). The JAX package sends a sequence length
that is not a multiple of 256 to its jnp path
(``repro/models/attention.py:111 _pallas_eligible``); the port's kernel
masks a partial last tile instead, so on the card every
``blocked_attention`` call is a kernel launch, whatever S is.

The wire-encode wrappers have one more rule, the JAX package's own
(``repro/kernels/wire_fused.py:30-33``): a codec with no wire scheme
(fp32, bf16, fp16, int8, int8_channel) or a fusion dim above
``MAX_FUSED_D`` has no kernel at all, on any device; the wrappers then
return None and the caller encodes with the codec's plain ops. That is
which function the codec computes, decided from the codec and the shape
alone, not a way around a kernel that failed: a CUDA tensor of a codec
that has a scheme launches the kernel or raises.

The fused wire path at the client boundary (``fusion_proj``,
``fusion_proj_quant``, ``fusion_proj_encode``, ``decode_proj``;
``csrc/fusion_proj.cu``) keeps that rule: a codec with no wire scheme,
or a fusion dim above ``MAX_FUSED_D``, runs the plain composition (the
projection, then the codec's own encode or decode) on every device. The
JAX wrappers' TPU tiling conditions are not carried over (padded rows,
``N % min(256, N)`` in ``decode_proj``, an even d for int4): the port's
kernels mask partial tiles and take any shape. ``decode_proj`` of an
``ef(...)`` codec decodes with its inner codec's scheme (the EF wire
format is the inner one), where the JAX wrapper runs its jnp path.

The serve-plan autotuner (``serve_plan``, ``autotune_serve_plan``) is
the JAX package's: a wall-clock search of the serving engine's horizon
and prompt-length bucket edges, persisted to a JSON file of the port's
own, keyed by the card's name and the engine's geometry.

The launch choices that depend on the card read it, not a constant:
``flash_decode``'s split (``decode_splits``), ``fusion_proj.cu``'s tile
rule and ``rmsnorm.cu``'s grid take the card's SM count (``sm_count``,
read once a device). The wire kernels' launch plan (``wire_plan``,
``autotune_wire_plan``) is the JAX package's ``wire_blocks`` /
``autotune_wire_blocks`` on the card: the wire encode's team and the
fused encode's and the decode's tile, tuned per card and persisted;
untuned, every launch takes the kernel's own rule.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import codec as codec_mod
from repro_torch.kernels import build, cost, ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GROUP = 16


def head_dim_ok(hd: int) -> bool:
    """The attention kernels take any head dim that is a multiple of 8
    (a bf16 row is whole 16-byte chunks) from 8 to 128."""
    return hd % 8 == 0 and 8 <= hd <= 128


def kernel_head_dim(hd: int) -> int:
    """The head dim of the kernel instance that runs ``hd``: the next of
    32, 64 and 128 at or above it; columns hd .. HD - 1 run as zeros
    (``csrc/flash_attention.cu``, ``csrc/flash_decode.cu``)."""
    return 32 if hd <= 32 else 64 if hd <= 64 else 128


def attn_head_dims_ok(hd: int, hdv: int) -> bool:
    """The full-sequence attention kernels (``flash_attention``) take a
    q/k head dim ``hd`` that is a multiple of 8 from 8 to 192 and a v
    head dim ``hdv`` that is a multiple of 8 from 8 to ``hd`` (MLA: 192
    and 128)."""
    return (hd % 8 == 0 and 8 <= hd <= 192
            and hdv % 8 == 0 and 8 <= hdv <= hd)


# The card the launch choices below were measured on, and its SM count.
H100_SXM_SMS = 132
_SM_COUNT: Dict[int, int] = {}
_CARD_NAME: Dict[int, str] = {}


def _index(device) -> int:
    dev = torch.device(device)
    return dev.index if dev.index is not None else torch.cuda.current_device()


def sm_count(device) -> int:
    """The SM count of a CUDA device, read from the card once a device
    index (a launch reads a dict, not the card's properties)."""
    idx = _index(device)
    n = _SM_COUNT.get(idx)
    if n is None:
        n = _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return n


def card_name(device) -> str:
    """The card's name with spaces as '_', read once a device index;
    ``"cpu"`` for any other device (the plan files' keys)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    idx = _index(dev)
    name = _CARD_NAME.get(idx)
    if name is None:
        name = _CARD_NAME[idx] = torch.cuda.get_device_name(idx).replace(
            " ", "_")
    return name


# The split of the cache across blocks (csrc/flash_decode.cu). A tile is
# 4096 / HD cache rows (16 KB of K and V in bf16 at hd == HD), the
# kernel's Decode::TL, HD the instance's head dim (``kernel_head_dim``);
# a split is whole tiles; the kernel merges at most kMaxSplits partials.
# The C entry refuses a split of part tiles or more than kMaxSplits
# splits, so these two cannot drift from it unseen.
MAX_DECODE_SPLITS = 128


def decode_tile_rows(hd: int) -> int:
    """Cache rows a ``flash_decode`` block stages at once: 4096 / HD, a
    whole number at every head dim the kernel takes (hd 24 runs the HD
    32 instance's 128-row tiles, hd 48 the HD 64 one's 64)."""
    return 4096 // kernel_head_dim(hd)


def decode_splits(B: int, KVH: int, G: int, L: int, hd: int,
                  sms: int = H100_SXM_SMS) -> Tuple[int, int]:
    """(S, chunk): ``flash_decode`` splits each (row, KV head)'s L cache
    rows into S splits of ``chunk`` rows (the last may be shorter, none
    is empty), whole tiles a split. Aims at 4 blocks an SM over the B *
    KVH * S blocks, one wave (an SM holds more than 4), ``sms`` the
    card's SM count (the wrapper passes ``sm_count``): on the H100 SXM's
    132, 4 beat 2 and 8 at G 1 and tied 2 at G 16 (``PERF.md``), so G,
    which each block serves whole, does not enter. A card with another
    count gets other blocks (S and chunk), not another tolerance: the
    merge of any split is held to the plain version alike. S = 1 where
    the cache is one tile, as at the serving path's L 64."""
    tile = decode_tile_rows(hd)
    n_tiles = -(-L // tile)
    want = max(1, round(4 * sms / (B * KVH)))
    S = min(want, n_tiles, MAX_DECODE_SPLITS)
    per = -(-n_tiles // S)          # tiles a split
    return -(-n_tiles // per), per * tile


_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def _arrival_counters(dev: torch.device, n: int) -> torch.Tensor:
    """n int32 counters, all 0, for one launch of a kernel whose blocks
    count their arrivals (the last to arrive resets its counter to 0).
    Eager calls on one stream run in order, so they share one buffer per
    (device, stream); a call captured into a CUDA graph gets its own,
    zeroed in the graph, so no two streams or graphs share a live
    counter."""
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(n, dtype=torch.int32, device=dev)
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[key] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                           device=dev)
    return buf


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 valid: torch.Tensor,
                 scale: Optional[float] = None) -> torch.Tensor:
    """Launch the CUDA flash-decode kernel (``csrc/flash_decode.cu``),
    one launch, the cache split as ``decode_splits`` says.

    q: (B, KVH, G, hd); k, v: (B, L, KVH, hd), the cache in the model's
    layout; valid: (B, L) bool. All contiguous, on one CUDA device, q/k/v
    of one dtype (float32 or bfloat16) on 16 bytes, hd a multiple of 8
    from 8 to 128 (``head_dim_ok``), G <= 16. Returns (B, KVH, G, hd) in
    q's dtype. Raises on anything else.

    Meta tensors (a dry-run) are checked the same way and launch
    nothing: the output is an empty tensor of the kernel's shape, and
    the launch counts in ``flash_decode.meta_launches`` and in the
    active accounting (``cost.launch``), with every cache row live.
    """
    B, KVH, G, hd = q.shape
    L = k.shape[1]
    dev = q.device
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"flash_decode takes CUDA tensors, got {dev}")
    if any(t.device != dev for t in (k, v, valid)):
        raise ValueError("flash_decode: tensors on different devices")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_decode: dtypes {q.dtype}/{k.dtype}/{v.dtype}"
                         " (float32 or bfloat16, all equal)")
    if valid.dtype != torch.bool:
        raise ValueError(f"flash_decode: valid must be bool, got {valid.dtype}")
    if (k.shape != (B, L, KVH, hd) or v.shape != k.shape
            or valid.shape != (B, L)):
        raise ValueError(f"flash_decode: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} valid "
                         f"{tuple(valid.shape)}")
    if not head_dim_ok(hd) or G > _MAX_GROUP or L < 1:
        raise ValueError(f"flash_decode: hd {hd} not a multiple of 8 in "
                         f"[8, 128], or G {G} > {_MAX_GROUP}, or empty cache")
    if not all(t.is_contiguous() for t in (q, k, v, valid)):
        raise ValueError("flash_decode: tensors must be contiguous")
    def work():
        return cost.flash_decode(B, L, KVH, G, hd, q.dtype)

    if dev.type == "meta":
        with cost.launch("flash_decode", work):
            out = torch.empty_like(q)
        flash_decode.meta_launches += 1
        return out
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash_decode: q/k/v must be 16-byte aligned")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    S, chunk = decode_splits(B, KVH, G, L, hd, sm_count(dev))
    with cost.launch("flash_decode", work):
        out = torch.empty_like(q)
        part_ml = part_acc = count = None
        if S > 1:
            part_ml = torch.empty((B * KVH, S, G, 2), dtype=torch.float32,
                                  device=dev)
            part_acc = torch.empty((B * KVH, S, G, kernel_head_dim(hd)),
                                   dtype=torch.float32, device=dev)
            count = _arrival_counters(dev, B * KVH)
        fn = _c_fn("flash_decode", "flash_decode",
                   [_P] * 8 + [_I] * 8 + [_F, _P])
        with torch.cuda.device(dev):
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    valid.data_ptr(), out.data_ptr(), _nullable(part_ml),
                    _nullable(part_acc), _nullable(count), B, L, KVH, G, hd,
                    S, chunk, _DTYPE_CODE[q.dtype], scale, _stream(dev))
        if rc != 0:
            raise RuntimeError(f"flash_decode launch failed (code {rc})")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
flash_decode.meta_launches = 0


def cached_attn_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       valid: torch.Tensor,
                       scale: Optional[float] = None) -> torch.Tensor:
    """Single-token attention against a KV cache, the serving decode
    path's dispatch point.

    q: (B, 1, KVH, G, hd) grouped query; k, v: (B, L, KVH, hd) cache;
    valid: (B, L) bool live-row mask (causality and the ring-buffer
    window already folded in). Returns (B, 1, KVH, G, hd).

    CPU tensors run ``ref.cached_attn_decode_ref``; CUDA (and meta)
    tensors go to ``flash_decode``, directly on the cache, in its own
    layout.
    """
    if q.device.type == "cpu":
        return ref.cached_attn_decode_ref(q, k, v, valid, scale)
    B, _, KVH, G, hd = q.shape
    out = flash_decode(q.reshape(B, KVH, G, hd), k, v, valid, scale)
    return out.reshape(q.shape)


# ------------------------------------------------------------ wire encode

# The whole fusion row sits in one thread block's shared memory (the
# reference's VMEM bound, wire_fused.py:70).
MAX_FUSED_D = 8192

_SCHEME_CODE = {"int8_row": 0, "int4": 1, "topk": 2, "sketch": 3}


@dataclass(frozen=True)
class WireScheme:
    """One codec's wire format as the kernels compute it: ``kind`` is one
    of int8_row / int4 / topk / sketch, ``d`` the fusion dim, ``n`` the
    kept count k (topk) or bucket count w (sketch), ``seed`` the sketch
    tables' seed.

    The decode side (``decode_proj``) reads the payload leaves in the
    order of ``leaves`` and undoes them as the reference's
    ``decode_block`` does (``repro/kernels/wire_fused.py:144,174,208,
    250``): int8_row q * scale; int4 unpacks the low nibble to the even
    column and the high nibble to the odd one, u - 8, times the scale,
    dropping an odd d's pad column; topk scatters the values to their
    indices in a zero row; sketch gathers the bucket means sketch *
    inv_counts by the hash h and multiplies by the sign s. The tables are
    the port's own ``sketch_tables`` (``tables``)."""

    kind: str
    d: int
    n: int = 0
    seed: int = 0

    @property
    def leaves(self) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """Payload leaf name -> (per-row tail shape, dtype)."""
        if self.kind == "int8_row":
            return {"q": ((self.d,), torch.int8),
                    "scale": ((1,), torch.float32)}
        if self.kind == "int4":
            return {"q4": (((self.d + 1) // 2,), torch.uint8),
                    "scale": ((1,), torch.float32)}
        if self.kind == "topk":
            return {"values": ((self.n,), torch.float32),
                    "indices": ((self.n,), torch.int32)}
        return {"sketch": ((self.n,), torch.float32)}

    def payload_bytes(self, rows: int) -> int:
        return sum(rows * int(np.prod(tail)) * dt.itemsize
                   for tail, dt in self.leaves.values())

    def table_bytes(self) -> int:
        """Bytes of the sketch tables the encode reads (sign, hash and
        order over d, inv_counts over w, ptr over w + 1)."""
        return 4 * (3 * self.d + 2 * self.n + 1) if self.kind == "sketch" else 0

    def tables(self, device) -> Tuple[Optional[torch.Tensor], ...]:
        """The kernels' table arguments (sign, inv_counts, hash, order,
        ptr) on ``device``, made once per device; all None but for the
        sketch. The decode reads the first three."""
        if self.kind != "sketch":
            return (None,) * 5
        t = codec_mod.sketch_device_tables(self.d, self.n, self.seed,
                                           str(device))
        return tuple(t[k] for k in ("sign", "inv_counts", "hash", "order",
                                    "ptr"))

    def payload_rows(self, payload: dict, rows: int, device):
        """The payload leaves as contiguous (rows, tail) tensors in the
        kernels' order; raises on a leaf of another name, dtype, shape
        or device."""
        if sorted(payload) != sorted(self.leaves):
            raise ValueError(f"{self.kind} payload leaves {sorted(payload)}"
                             f" != {sorted(self.leaves)}")
        out = []
        for name, (tail, dt) in self.leaves.items():
            v = payload[name]
            if v.dtype != dt or v.device != device or v.numel() != rows * int(
                    np.prod(tail)) or tuple(v.shape[-len(tail):]) != tail:
                raise ValueError(f"{self.kind} payload leaf {name}: "
                                 f"{v.dtype}{tuple(v.shape)} on {v.device}, "
                                 f"want {dt} (..., {tail}) x {rows} rows "
                                 f"on {device}")
            if not v.is_contiguous():
                raise ValueError(f"{self.kind} payload leaf {name} is not "
                                 "contiguous")
            out.append(v.reshape(rows, *tail))
        return out


def scheme_for(codec, d: int) -> Optional[WireScheme]:
    """The wire scheme of ``codec`` at fusion dim ``d``, or None (no
    kernel for this codec, or d outside 1..MAX_FUSED_D). EF is not a
    scheme: ``wire_encode_ef`` wraps its inner codec's."""
    if d < 1 or d > MAX_FUSED_D:
        return None
    if isinstance(codec, codec_mod.Int8RowCodec):
        return WireScheme("int8_row", d)
    if isinstance(codec, codec_mod.Int4RowCodec):
        return WireScheme("int4", d)
    if isinstance(codec, codec_mod.TopKCodec):
        return WireScheme("topk", d, codec.k_of(d))
    if isinstance(codec, codec_mod.CountSketchCodec):
        return WireScheme("sketch", d, codec.w_of(d), codec.seed)
    return None


# The teams of csrc/wire_encode.cu: a warp a row, ENCODE_WARPS rows a
# block, or a block of 256 threads a row. A warp runs a row's passes one
# element after another, so it wins only where many rows hide that (on
# the H100 at 432 wide: 32 rows take 1.97 us on the block team and 4.0 on
# warps; 4096 rows 9.4 and 6.9; top-k, whose sort a block spreads over
# 256 threads, from about 1024 rows) and rows are short (from 768 wide
# the block is as fast or faster); a warp's top-k keys stay in registers
# up to 512 wide (PERF.md).
ENCODE_WARP_ROWS = 4096
ENCODE_WARP_ROWS_TOPK = 1024
ENCODE_WARP_MAX_D = 512
ENCODE_WARPS = 4


def encode_warps(rows: int, d: int, kind: str) -> int:
    """The team ``wire_encode`` runs at (rows, d) under scheme ``kind``:
    ENCODE_WARPS rows a block, a warp each, from ENCODE_WARP_ROWS rows
    (top-k: ENCODE_WARP_ROWS_TOPK) up to ENCODE_WARP_MAX_D wide, else 0,
    a block a row."""
    least = ENCODE_WARP_ROWS_TOPK if kind == "topk" else ENCODE_WARP_ROWS
    return ENCODE_WARPS if rows >= least and d <= ENCODE_WARP_MAX_D else 0


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _c_fn(lib: str, name: str, argtypes):
    fn = getattr(build.load(lib), name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _nullable(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _qparams(scheme: WireScheme):
    """(inv_qmax, qmax) of a row scheme as the kernels take them:
    float32(1 / qmax) rounded from the double, as the codec computes it."""
    qmax = 7 if scheme.kind == "int4" else 127
    return float(np.float32(1.0 / qmax)), float(qmax)


def _clip(max_ratio: Optional[float]):
    """(clip flag, max_ratio as float32) of the EF trust-region clip."""
    clip = max_ratio is not None and bool(np.isfinite(max_ratio))
    return int(clip), float(np.float32(max_ratio)) if clip else 0.0


def _check_rows(name: str, t: torch.Tensor, d: int) -> None:
    if t.device.type not in ("cuda", "meta"):
        raise ValueError(f"{name} takes CUDA tensors, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: fp32 input required, got {t.dtype}")
    if t.dim() < 1 or t.shape[-1] != d or t.numel() == 0:
        raise ValueError(f"{name}: shape {tuple(t.shape)} is not (..., {d})")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensors must be contiguous")


def _launch_wire(name: str, scheme: WireScheme, z: torch.Tensor,
                 e: Optional[torch.Tensor], max_ratio: Optional[float],
                 codec_name: str, warps: Optional[int]):
    """Launch ``csrc/wire_encode.cu`` on z (and e) -> (payload, e'),
    counted as ``name`` in the active accounting, on the team ``warps``
    (None: the card's plan for ``codec_name``, ``wire_plan``; -1 or an
    untuned plan: ``encode_warps``). On meta tensors nothing launches:
    the outputs are empty tensors of their shapes, and the call counts
    in ``<name>.meta_launches``."""
    d = scheme.d
    rows = z.numel() // d
    lead = tuple(z.shape[:-1])
    dev = z.device
    with cost.launch(name, lambda: cost.wire_encode(scheme, rows,
                                                    e is not None)):
        outs = {leaf: torch.empty((rows, *tail), dtype=dt, device=dev)
                for leaf, (tail, dt) in scheme.leaves.items()}
        e_out = torch.empty_like(z) if e is not None else None
        if dev.type != "meta":
            if warps is None:
                warps = wire_plan(codec_name, d, "encode", dev)["warps"]
            if warps < 0:
                warps = encode_warps(rows, d, scheme.kind)
            bufs = list(outs.values()) + [None] * (2 - len(outs))
            fn = _c_fn("wire_encode", "wire_encode",
                       [_I, _I, _P, _P, _I, _I, _I, _F, _F, _I, _F]
                       + [_P] * 8 + [_I, _P])
            with torch.cuda.device(dev):
                rc = fn(_SCHEME_CODE[scheme.kind], int(e is not None),
                        z.data_ptr(), _nullable(e), rows, d, scheme.n,
                        *_qparams(scheme), *_clip(max_ratio),
                        *(_nullable(t) for t in scheme.tables(dev)),
                        _nullable(bufs[0]), _nullable(bufs[1]),
                        _nullable(e_out), warps, _stream(dev))
            if rc != 0:
                raise RuntimeError(f"wire_encode launch failed (code {rc})")
    payload = {leaf: o.reshape(*lead, *o.shape[1:])
               for leaf, o in outs.items()}
    return payload, e_out


def wire_encode(z: torch.Tensor, codec, *,
                warps: Optional[int] = None) -> Optional[dict]:
    """Encode z with ``codec`` -> the payload dict, or None when the
    codec has no wire scheme at z's fusion dim (module docstring).

    A CPU tensor takes the plain version (``ref.wire_encode_ref``, the
    codec's own encode); a CUDA tensor launches ``csrc/wire_encode.cu``
    (z fp32 and contiguous, d <= MAX_FUSED_D) or raises, on the team
    ``warps`` (1, 2, 4 or 8 rows a block, 0 a block a row, -1
    ``encode_warps``; None the card's ``wire_plan``); a meta tensor is
    checked the same way and returns the payload's empty leaves
    (``_launch_wire``)."""
    scheme = scheme_for(codec, z.shape[-1])
    if scheme is None:
        return None
    if z.device.type == "cpu":
        return ref.wire_encode_ref(z, codec)
    _check_rows("wire_encode", z, scheme.d)
    payload, _ = _launch_wire("wire_encode", scheme, z, None, None,
                              codec.name, warps)
    if z.device.type == "meta":
        wire_encode.meta_launches += 1
    else:
        wire_encode.launches += 1
    return payload


wire_encode.launches = 0
wire_encode.meta_launches = 0


def wire_encode_ef(z: torch.Tensor, e: torch.Tensor, ef_codec, *,
                   warps: Optional[int] = None):
    """The EF21 encode of ``ef_codec`` (an ``EFCodec``) -> (payload, e'),
    or None when its inner codec has no wire scheme at z's fusion dim.

    c = z + e, the inner encode of c, z_hat = decode(payload) and the
    trust-region-clipped residual e' = c - z_hat, in one launch. A CPU
    tensor takes the plain version (``ref.wire_encode_ef_ref``); a CUDA
    tensor launches the kernel (z, e fp32, contiguous, one shape) or
    raises, on the team ``warps`` as ``wire_encode``'s; a meta tensor is
    checked the same way and launches nothing."""
    scheme = scheme_for(ef_codec.inner, z.shape[-1])
    if scheme is None:
        return None
    if z.device.type == "cpu" and e.device.type == "cpu":
        return ref.wire_encode_ef_ref(z, e, ef_codec)
    _check_rows("wire_encode_ef", z, scheme.d)
    _check_rows("wire_encode_ef", e, scheme.d)
    if e.shape != z.shape or e.device != z.device:
        raise ValueError(f"wire_encode_ef: e {tuple(e.shape)} on {e.device} "
                         f"vs z {tuple(z.shape)} on {z.device}")
    out = _launch_wire("wire_encode_ef", scheme, z, e, ef_codec.max_ratio,
                       ef_codec.name, warps)
    if z.device.type == "meta":
        wire_encode_ef.meta_launches += 1
    else:
        wire_encode_ef.launches += 1
    return out


wire_encode_ef.launches = 0
wire_encode_ef.meta_launches = 0


def fused_wire_report(codec, z_shape) -> dict:
    """Which wire path a codec runs for a z of ``z_shape`` on the card,
    for the dry-run's ``client_boundary`` (the JAX package's
    ``ops.fused_wire_report``, with the port's kernels): the encode
    kernel (``csrc/wire_encode.cu``; ``csrc/fusion_proj.cu`` where the
    fusion FC's epilogue encodes), the scheme, the team it runs (the
    card's ``wire_plan``, else ``encode_warps``'), the fused encode's
    plan (``proj_epilogue_plan``: its tile, -1 the kernel's rule; the
    reference's ``proj_epilogue_blocks``), the payload's leaves and
    bytes, and the bytes the kernel must
    move (``cost.wire_bytes_moved``) beside those of the plain
    composition, whose c and decoded z_hat make a round trip each under
    EF (the reference's count). A codec without a scheme at that dim
    runs the plain path, and the report says why."""
    codec = codec_mod.get_codec(codec)
    is_ef = isinstance(codec, codec_mod.EFCodec)
    d = int(z_shape[-1])
    rows = int(np.prod(z_shape[:-1]))
    scheme = scheme_for(codec.inner if is_ef else codec, d)
    if scheme is None:
        return {"fused": False, "path": "plain", "kernel": None,
                "fallback": f"no wire scheme for codec {codec.name!r} at "
                            f"d={d}"}
    ef = is_ef and codec.has_state
    fused = cost.wire_bytes_moved(scheme, rows, ef)
    warps = wire_plan(codec.name, d, "encode")["warps"]
    return {
        "fused": True,
        "path": "cuda",
        "kernel": f"wire_encode[{codec.name}]",
        "source": "src/repro_torch/kernels/csrc/wire_encode.cu",
        "proj_epilogue_source": "src/repro_torch/kernels/csrc/fusion_proj.cu",
        "scheme": scheme.kind,
        "encode_warps": (warps if warps >= 0
                         else encode_warps(rows, d, scheme.kind)),
        "proj_epilogue_plan": wire_plan(codec.name, d, "proj_encode"),
        "payload_leaves": list(scheme.leaves),
        "payload_bytes": scheme.payload_bytes(rows),
        "hbm_bytes_fused": fused,
        "hbm_bytes_unfused": fused + (4 * rows * d * 4 if ef else 0),
        "fallback": None,
    }


# ------------------------------------- fused projection and wire path

_ACT_CODE = {"none": 0, "relu": 1, "silu": 2}


def _act_code(act: str) -> int:
    if act not in _ACT_CODE:
        raise ValueError(f"act {act!r} not in {sorted(_ACT_CODE)}")
    return _ACT_CODE[act]


def _check_proj(name: str, x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor], dev: torch.device):
    """x (..., K) or None (decode_proj), w (K, N), b (N,) or None on one
    CUDA device, x and w of one dtype (float32 or bfloat16),
    contiguous -> b as a contiguous fp32 tensor (or None). Meta tensors
    pass the same checks (a dry-run)."""
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"{name} takes CUDA tensors, got {dev}")
    if w.device != dev or (b is not None and b.device != dev):
        raise ValueError(f"{name}: tensors on different devices")
    if w.dtype not in _DTYPE_CODE or (x is not None and x.dtype != w.dtype):
        raise ValueError(f"{name}: dtypes x {None if x is None else x.dtype}"
                         f" w {w.dtype} (float32 or bfloat16, equal)")
    if (w.dim() != 2 or w.numel() == 0 or (x is not None and (
            x.dim() < 1 or x.shape[-1] != w.shape[0] or x.numel() == 0))
            or (b is not None and tuple(b.shape) != (w.shape[1],))):
        raise ValueError(f"{name}: shapes x {None if x is None else tuple(x.shape)}"
                         f" w {tuple(w.shape)} b "
                         f"{None if b is None else tuple(b.shape)}")
    if not w.is_contiguous() or (x is not None and not x.is_contiguous()):
        raise ValueError(f"{name}: tensors must be contiguous")
    return None if b is None else b.float().contiguous()


def fusion_proj(x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor] = None,
                act: str = "none") -> torch.Tensor:
    """y = act(x @ w + b); x (..., K), w (K, N), b (N,) -> (..., N) in
    x's dtype, accumulated in fp32; act in {none, relu, silu}.

    A CPU tensor takes the plain version (``ref.fusion_proj_ref``); a
    CUDA tensor launches ``csrc/fusion_proj.cu`` (x and w fp32 or bf16,
    one dtype, contiguous, any M, K, N) or raises; a meta tensor is
    checked the same way and returns an empty y (``meta_launches``)."""
    code = _act_code(act)
    if x.device.type == "cpu":
        return ref.fusion_proj_ref(x, w, b, act)
    K, N = w.shape
    M = x.numel() // K
    with cost.launch("fusion_proj", lambda: cost.fusion_proj(
            M, K, N, x.dtype, b is not None)):
        bf = _check_proj("fusion_proj", x, w, b, x.device)
        y = torch.empty((*x.shape[:-1], N), dtype=x.dtype, device=x.device)
        if x.device.type == "meta":
            fusion_proj.meta_launches += 1
            return y
        fn = _c_fn("fusion_proj", "fusion_proj", [_P] * 4 + [_I] * 6 + [_P])
        with torch.cuda.device(x.device):
            rc = fn(x.data_ptr(), w.data_ptr(), _nullable(bf), y.data_ptr(),
                    M, K, N, _DTYPE_CODE[x.dtype], code, sm_count(x.device),
                    _stream(x.device))
        if rc != 0:
            raise RuntimeError(f"fusion_proj launch failed (code {rc})")
    fusion_proj.launches += 1
    return y


fusion_proj.launches = 0
fusion_proj.meta_launches = 0


def _encode_scratch(M: int, N: int, dev: torch.device):
    """The fused encode's scratch: y (M, N) fp32, which its tiles write
    and the last tile of each row group encodes, and the groups' arrival
    counters, one for each 8 rows (the smallest row group)."""
    return (torch.empty((M, N), dtype=torch.float32, device=dev),
            _arrival_counters(dev, -(-M // 8)))


def _encode_tile(codec_name: str, x: torch.Tensor, N: int) -> int:
    """The fused encode's tile from the card's plan for fp32 launches
    (bf16 ones sum on the tensor cores in an order the tile moves, so
    they keep the kernel's rule, -1)."""
    if x.dtype != torch.float32:
        return -1
    return wire_plan(codec_name, N, "proj_encode", x.device)["tile"]


def fusion_proj_quant(x: torch.Tensor, w: torch.Tensor,
                      b: Optional[torch.Tensor] = None, act: str = "none"):
    """The projection with the int8_row wire encode in one launch:
    x (..., K), w (K, N) -> (q int8 (..., N), scale fp32 (..., 1)); the
    fp32 activation goes only to a scratch the kernel reads back from
    L2 (``_encode_scratch``), on the tile of the card's int8_row plan
    (``fusion_proj_encode``'s).

    A CPU tensor, or N above ``MAX_FUSED_D`` on any device, takes the
    plain version (``ref.fusion_proj_quant_ref``); a CUDA tensor launches
    the kernel or raises; a meta tensor is checked the same way and
    returns empty codes and scales (``meta_launches``)."""
    code = _act_code(act)
    N = w.shape[-1]
    if x.device.type == "cpu" or scheme_for(codec_mod.CODECS["int8_row"],
                                            N) is None:
        return ref.fusion_proj_quant_ref(x, w, b, act)
    K = w.shape[0]
    M = x.numel() // K
    lead = tuple(x.shape[:-1])
    scheme = WireScheme("int8_row", N)
    with cost.launch("fusion_proj_quant", lambda: cost.fusion_proj_encode(
            M, K, scheme, False, x.dtype, b is not None)):
        bf = _check_proj("fusion_proj_quant", x, w, b, x.device)
        q = torch.empty((*lead, N), dtype=torch.int8, device=x.device)
        scale = torch.empty((*lead, 1), dtype=torch.float32, device=x.device)
        if x.device.type == "meta":
            fusion_proj_quant.meta_launches += 1
            return q, scale
        y, count = _encode_scratch(M, N, x.device)
        inv_qmax, _ = _qparams(scheme)
        fn = _c_fn("fusion_proj", "fusion_proj_quant",
                   [_P] * 5 + [_I] * 6 + [_F] + [_P] * 2 + [_I] * 2 + [_P])
        with torch.cuda.device(x.device):
            rc = fn(x.data_ptr(), w.data_ptr(), _nullable(bf), y.data_ptr(),
                    count.data_ptr(), count.numel(), M, K, N,
                    _DTYPE_CODE[x.dtype], code, inv_qmax, q.data_ptr(),
                    scale.data_ptr(), _encode_tile("int8_row", x, N),
                    sm_count(x.device), _stream(x.device))
        if rc != 0:
            raise RuntimeError(f"fusion_proj_quant launch failed (code {rc})")
    fusion_proj_quant.launches += 1
    return q, scale


fusion_proj_quant.launches = 0
fusion_proj_quant.meta_launches = 0


def fusion_proj_encode(x: torch.Tensor, w: torch.Tensor,
                       b: Optional[torch.Tensor] = None, act: str = "none",
                       *, codec, ef_state: Optional[torch.Tensor] = None,
                       tile: Optional[int] = None):
    """The projection with ``codec``'s wire encode (and the EF21 step)
    in one launch: x (..., K), w (K, N) -> the payload, or (payload, e')
    with ``ef_state``, the carried residual of an ``ef(...)`` codec,
    shaped like the output. The fp32 activation goes only to a scratch
    the kernel reads back from L2 (``_encode_scratch``); the payload
    (and e') are the outputs.

    A codec with no wire scheme at N (module docstring) runs the plain
    composition on every device; so does a CPU tensor
    (``ref.fusion_proj_encode_ref``). A CUDA tensor of a codec with a
    scheme launches the kernel (x, w fp32 or bf16, e fp32, contiguous)
    or raises, on ``tile`` (0 the 16 x 64 tile, 1 the 8 x 16 one, -1
    the kernel's rule; None the card's ``wire_plan`` for fp32 x, the
    rule for bf16); a meta tensor is checked the same way and returns
    the empty payload (and e') (``meta_launches``)."""
    code = _act_code(act)
    is_ef = isinstance(codec, codec_mod.EFCodec)
    if ef_state is not None and not is_ef:
        raise ValueError(f"fusion_proj_encode: ef_state needs an ef(...) "
                         f"codec, got {codec.name}")
    N = w.shape[-1]
    scheme = scheme_for(codec.inner if is_ef else codec, N)
    if scheme is None or x.device.type == "cpu":
        return ref.fusion_proj_encode_ref(x, w, b, act, codec=codec,
                                          e=ef_state)
    dev = x.device
    lead = tuple(x.shape[:-1])
    ef = ef_state is not None
    K = w.shape[0]
    M = x.numel() // K
    with cost.launch("fusion_proj_encode", lambda: cost.fusion_proj_encode(
            M, K, scheme, ef, x.dtype, b is not None)):
        bf = _check_proj("fusion_proj_encode", x, w, b, dev)
        if ef and (ef_state.device != dev or ef_state.dtype != torch.float32
                   or tuple(ef_state.shape) != (*lead, N)
                   or not ef_state.is_contiguous()):
            raise ValueError(f"fusion_proj_encode: ef_state "
                             f"{ef_state.dtype}{tuple(ef_state.shape)} on "
                             f"{ef_state.device}, want contiguous float32 "
                             f"{(*lead, N)} on {dev}")
        outs = {name: torch.empty((*lead, *tail), dtype=dt, device=dev)
                for name, (tail, dt) in scheme.leaves.items()}
        e_out = torch.empty_like(ef_state) if ef else None
        if dev.type == "meta":
            fusion_proj_encode.meta_launches += 1
            return (outs, e_out) if ef else outs
        bufs = list(outs.values()) + [None] * (2 - len(outs))
        y, count = _encode_scratch(M, N, dev)
        fn = _c_fn("fusion_proj", "fusion_proj_encode",
                   [_I, _I] + [_P] * 6 + [_I] * 7 + [_F, _F, _I, _F]
                   + [_P] * 8 + [_I] * 2 + [_P])
        with torch.cuda.device(dev):
            rc = fn(_SCHEME_CODE[scheme.kind], int(ef), x.data_ptr(),
                    w.data_ptr(), _nullable(bf), _nullable(ef_state),
                    y.data_ptr(), count.data_ptr(), count.numel(),
                    M, K, N, scheme.n, _DTYPE_CODE[x.dtype], code,
                    *_qparams(scheme),
                    *_clip(codec.max_ratio if is_ef else None),
                    *(_nullable(t) for t in scheme.tables(dev)),
                    _nullable(bufs[0]), _nullable(bufs[1]),
                    _nullable(e_out),
                    tile if tile is not None else _encode_tile(codec.name,
                                                               x, N),
                    sm_count(dev), _stream(dev))
        if rc != 0:
            raise RuntimeError(
                f"fusion_proj_encode launch failed (code {rc})")
    fusion_proj_encode.launches += 1
    return (outs, e_out) if ef else outs


fusion_proj_encode.launches = 0
fusion_proj_encode.meta_launches = 0


def decode_proj(payload: dict, w: torch.Tensor,
                b: Optional[torch.Tensor] = None, act: str = "none", *,
                codec, shape, tile: Optional[int] = None) -> torch.Tensor:
    """Decode as the prologue of the modular block's first FC:
    act(codec.decode(payload) @ w + b) in one launch, the fp32
    reconstruction held in shared memory. ``shape`` is z's shape (...,
    d); w (d, N); returns (*shape[:-1], N) fp32.

    A codec with no wire scheme at d runs the plain composition on every
    device; so does a payload on the CPU (``ref.decode_proj_ref``). A
    CUDA payload of a codec with a scheme launches the kernel (the
    scheme's leaves, contiguous; w fp32 or bf16) or raises, on ``tile``
    (0-2 ``fusion_proj``'s fp32 tiles, 3 the 16 x 8 one, -1 the
    kernel's rule; None the card's ``wire_plan`` for fp32 w, the rule
    for bf16); a meta payload is checked the same way and returns an
    empty y (``meta_launches``)."""
    code = _act_code(act)
    shape = tuple(int(s) for s in shape)
    d = shape[-1]
    scheme = scheme_for(codec.inner if isinstance(codec, codec_mod.EFCodec)
                        else codec, d)
    dev = next(iter(payload.values())).device
    if scheme is None or dev.type == "cpu":
        return ref.decode_proj_ref(payload, w, b, act, codec=codec,
                                   shape=shape)
    rows = int(np.prod(shape[:-1]))
    N = w.shape[-1]
    with cost.launch("decode_proj", lambda: cost.decode_proj(
            rows, N, scheme, w.dtype, b is not None)):
        bf = _check_proj("decode_proj", None, w, b, dev)
        if w.shape[0] != d:
            raise ValueError(f"decode_proj: w {tuple(w.shape)} is not "
                             f"({d}, N)")
        leaves = scheme.payload_rows(payload, rows, dev)
        y = torch.empty((rows, N), dtype=torch.float32, device=dev)
        if dev.type == "meta":
            decode_proj.meta_launches += 1
            return y.reshape(*shape[:-1], N)
        sign, inv_counts, hsh, _, _ = scheme.tables(dev)
        if tile is None:
            tile = (wire_plan(codec.name, d, "decode_proj", dev)["tile"]
                    if w.dtype == torch.float32 else -1)
        fn = _c_fn("fusion_proj", "decode_proj",
                   [_I] + [_P] * 5 + [_I] * 6 + [_P] * 3 + [_I] * 2 + [_P])
        with torch.cuda.device(dev):
            rc = fn(_SCHEME_CODE[scheme.kind], leaves[0].data_ptr(),
                    _nullable(leaves[1] if len(leaves) > 1 else None),
                    w.data_ptr(), _nullable(bf), y.data_ptr(), rows, d, N,
                    scheme.n, _DTYPE_CODE[w.dtype], code, _nullable(sign),
                    _nullable(inv_counts), _nullable(hsh), tile,
                    sm_count(dev), _stream(dev))
        if rc != 0:
            raise RuntimeError(f"decode_proj launch failed (code {rc})")
    decode_proj.launches += 1
    return y.reshape(*shape[:-1], N)


decode_proj.launches = 0
decode_proj.meta_launches = 0


# ---------------------------------------------------------------- rmsnorm


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim: x (..., D), scale (D,) -> x's shape and
    dtype, y = x * rsqrt(mean x^2 + eps) * scale in fp32 inside.

    A CPU tensor takes the plain version (``ref.rmsnorm_ref``) on the
    flattened (M, D) rows; a CUDA tensor launches ``csrc/rmsnorm.cu``
    (x fp32 or bf16, scale fp32 or bf16 independently, both contiguous,
    any M >= 1 and D >= 1) or raises; a meta tensor is checked the same
    way and returns an empty y (``meta_launches``)."""
    if x.dim() < 1:
        raise ValueError("rmsnorm: x is 0-d, want (..., D)")
    D = x.shape[-1]
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x.reshape(-1, D), scale, eps).reshape(x.shape)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"rmsnorm takes CUDA tensors, got {x.device}")
    if scale.device != x.device:
        raise ValueError(f"rmsnorm: scale on {scale.device}, x on {x.device}")
    if x.dtype not in _DTYPE_CODE or scale.dtype not in _DTYPE_CODE:
        raise ValueError(f"rmsnorm: dtypes x {x.dtype} scale {scale.dtype} "
                         "(float32 or bfloat16)")
    if x.numel() == 0 or tuple(scale.shape) != (D,):
        raise ValueError(f"rmsnorm: shapes x {tuple(x.shape)} scale "
                         f"{tuple(scale.shape)}, want (..., D) and (D,)")
    if not x.is_contiguous() or not scale.is_contiguous():
        raise ValueError("rmsnorm: tensors must be contiguous")
    with cost.launch("rmsnorm", lambda: cost.rmsnorm(
            x.numel() // D, D, x.dtype, scale.dtype)):
        y = torch.empty_like(x)
        if x.device.type == "meta":
            rmsnorm.meta_launches += 1
            return y
        fn = _c_fn("rmsnorm", "rmsnorm",
                   [_P] * 3 + [ctypes.c_longlong] + [_I] * 3 + [_F, _I, _P])
        with torch.cuda.device(x.device):
            rc = fn(x.data_ptr(), scale.data_ptr(), y.data_ptr(),
                    x.numel() // D, D, _DTYPE_CODE[x.dtype],
                    _DTYPE_CODE[scale.dtype], float(eps), sm_count(x.device),
                    _stream(x.device))
        if rc != 0:
            raise RuntimeError(f"rmsnorm launch failed (code {rc})")
    rmsnorm.launches += 1
    return y


rmsnorm.launches = 0
rmsnorm.meta_launches = 0


# ------------------------------------------------------ flash attention


def _check_attn(name: str, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> None:
    dev = q.device
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"{name} takes CUDA tensors, got {dev}")
    if k.device != dev or v.device != dev:
        raise ValueError(f"{name}: tensors on different devices")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: dtypes {q.dtype}/{k.dtype}/{v.dtype}"
                         " (float32 or bfloat16, all equal)")
    if (q.dim() != 4 or k.dim() != 4 or v.dim() != 4
            or v.shape[:3] != k.shape[:3]):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    B, S, H, hd = q.shape
    KVH = k.shape[2]
    if (k.shape[0] != B or k.shape[1] != S or k.shape[3] != hd
            or H % KVH or not attn_head_dims_ok(hd, v.shape[3]) or S < 1):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)} "
                         f"and v {tuple(v.shape)} are not (B, S, H, hd) / "
                         f"(B, S, KVH, hd) / (B, S, KVH, hdv) with H % KVH "
                         "== 0, hd a multiple of 8 in [8, 192], hdv one in "
                         "[8, hd], S >= 1")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError(f"{name}: tensors must be contiguous")
    if dev.type == "cuda" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name}: tensors must start on 16 bytes (the "
                         "bf16 kernels copy 16-byte chunks)")


def _attn_call(fn_name: str, *args) -> None:
    lib = build.load("flash_attention")
    fn = getattr(lib, fn_name)
    fn.restype = ctypes.c_int
    # pointers, then B, S, H, KVH, hd, hdv, window, causal, dtype, then
    # scale, stream
    fn.argtypes = ([ctypes.c_void_p] * (len(args) - 11)
                   + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{fn_name} launch failed (code {rc})")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = -1,
                        scale: Optional[float] = None):
    """Launch the forward kernel on CUDA tensors q (B, S, H, hd), k
    (B, S, KVH, hd), v (B, S, KVH, hdv) -> (o (B, S, H, hdv) in q's
    dtype, lse (B, H, S) fp32, each row's softmax logsumexp). Raises on
    anything the kernel does not take. ``causal=False`` lets every row
    see every key (the window, if any, still bounds keys from below).
    Counts in ``flash_attention.launches`` (and, with ``causal=False``,
    in ``flash_attention.bidir_launches``). Meta tensors are checked the
    same way and launch nothing: o and lse come back empty, counted in
    ``flash_attention.meta_launches``."""
    _check_attn("flash_attention", q, k, v)
    B, S, H, hd = q.shape
    KVH, hdv = k.shape[2], v.shape[3]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    with cost.launch("flash_attention", lambda: cost.flash_attention(
            B, S, H, KVH, hd, hdv, int(window), bool(causal), q.dtype)):
        o = torch.empty((B, S, H, hdv), dtype=q.dtype, device=q.device)
        lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        if q.device.type == "meta":
            flash_attention.meta_launches += 1
            return o, lse
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            _attn_call("flash_attention_fwd", q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), o.data_ptr(), lse.data_ptr(), B, S, H,
                       KVH, hd, hdv, int(window), int(bool(causal)),
                       _DTYPE_CODE[q.dtype], float(scale), stream)
    flash_attention.launches += 1
    if not causal:
        flash_attention.bidir_launches += 1
    return o, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True, window: int = -1,
                        scale: Optional[float] = None):
    """Launch the backward kernels (dQ with D = rowsum(dO * O), then dK
    and dV) on the forward's tensors and dO -> (dq, dk, dv) in the
    inputs' dtype. One call counts one launch of the backward (and one
    in ``flash_attention_bwd.bidir_launches`` with ``causal=False``; on
    meta tensors one in ``flash_attention_bwd.meta_launches``, and
    nothing launches)."""
    _check_attn("flash_attention_bwd", q, k, v)
    B, S, H, hd = q.shape
    KVH, hdv = k.shape[2], v.shape[3]
    if (o.shape != (B, S, H, hdv) or do.shape != o.shape
            or o.dtype != q.dtype
            or do.dtype != q.dtype or lse.shape != (B, H, S)
            or lse.dtype != torch.float32
            or not all(t.is_contiguous() and t.device == q.device
                       for t in (o, do, lse))
            or (q.device.type == "cuda"
                and (o.data_ptr() % 16 or do.data_ptr() % 16))):
        raise ValueError("flash_attention_bwd: o, dO must be (B, S, H, hdv) "
                         "in q's dtype and lse (B, H, S) fp32, all "
                         "contiguous on q's device, o and dO starting on "
                         "16 bytes")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    with cost.launch("flash_attention_bwd", lambda: cost.flash_attention_bwd(
            B, S, H, KVH, hd, hdv, int(window), bool(causal), q.dtype)):
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        if q.device.type == "meta":
            flash_attention_bwd.meta_launches += 1
            return dq, dk, dv
        dsum = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            _attn_call("flash_attention_bwd", q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), o.data_ptr(), do.data_ptr(),
                       lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
                       dk.data_ptr(), dv.data_ptr(), B, S, H, KVH, hd,
                       hdv, int(window), int(bool(causal)),
                       _DTYPE_CODE[q.dtype], float(scale), stream)
    flash_attention_bwd.launches += 1
    if not causal:
        flash_attention_bwd.bidir_launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.bidir_launches = 0
flash_attention_bwd.meta_launches = 0


class _FlashAttention(torch.autograd.Function):
    """Forward kernel in ``forward``, backward kernel in ``backward``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                     scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window, ctx.scale = causal, window, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         causal=ctx.causal, window=ctx.window,
                                         scale=ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = -1,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Causal (or, with ``causal=False``, bidirectional: the encoder's
    self-attention), optionally sliding-window attention over a full
    sequence, the training path's dispatch point.

    q: (B, S, H, hd); k: (B, S, KVH, hd); v: (B, S, KVH, hdv), the
    model's layout, GQA read directly (no repeated K/V); hdv may be
    smaller than hd (MLA). Returns (B, S, H, hdv). ``scale`` defaults to
    1 / sqrt(hd). CPU tensors run ``ref.flash_attention_ref``; CUDA
    (and meta) tensors run the kernels through a ``torch.autograd.Function``
    (contiguous and starting on 16 bytes, float32 or bfloat16, hd a
    multiple of 8 in [8, 192], hdv one in [8, hd]) or raise: bf16 on
    the tensor-core kernels, float32 on the SIMT ones (tensor cores
    would take it only as TF32).
    """
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       scale=scale)
    return _FlashAttention.apply(q, k, v, bool(causal), window, scale)


flash_attention.launches = 0
flash_attention.bidir_launches = 0
flash_attention.meta_launches = 0


# ------------------------------------------------- serve-plan autotuner
#
# Picks the serving engine's horizon S and the bucket edges of batch
# admission for one (device, arch pairs, lane width, cache_len), by
# timing a workload, and persists the winner to a JSON file, as the JAX
# package's tuner does. The read side (``serve_plan``) never times
# anything: ``ServeEngine(horizon="auto")`` consults it and falls back
# to its defaults when the geometry is untuned.

_serve_cache_mem: Optional[dict] = None


def _serve_cache_path() -> str:
    """The port's own plan file (the JAX package writes another), under
    ``REPRO_TORCH_SERVE_PLAN_CACHE`` if it is set."""
    return os.environ.get(
        "REPRO_TORCH_SERVE_PLAN_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                     "serve_plan.json"))


def _load_serve_cache(refresh: bool = False) -> dict:
    global _serve_cache_mem
    if _serve_cache_mem is None or refresh:
        try:
            with open(_serve_cache_path()) as f:
                _serve_cache_mem = json.load(f)
        except (OSError, ValueError):
            _serve_cache_mem = {}
    return _serve_cache_mem


def _serve_key(plan_key: str, device) -> str:
    """The card's name with spaces as '_' (``"cpu"`` on the CPU),
    ``|serve|`` and the engine's plan key."""
    return f"{card_name(device)}|serve|{plan_key}"


def serve_plan(plan_key: str, device) -> dict:
    """The tuned {"horizon", "bucket_edges", "seconds"} of one engine
    geometry on ``device``, or ``{}`` when untuned."""
    return dict(_load_serve_cache().get(_serve_key(plan_key, device), {}))


def autotune_serve_plan(plan_key: str, timer, device, *,
                        horizons=(1, 2, 4, 8, 16),
                        edge_sets=((8, 16, 32, 64, 128),),
                        force: bool = False) -> dict:
    """Grid search over (horizon, bucket edges) with
    ``timer(horizon, edges) -> seconds``, the winner persisted under
    (device, plan_key) so that later runs and other processes read it
    from ``serve_plan``. Returns the winning entry, with every
    candidate's seconds under "candidates" (also on a cache hit, unless
    ``force``). A timer that raises is not skipped, as the JAX package's
    tuner skips it: a failing kernel must not vanish into a plan."""
    key = _serve_key(plan_key, device)
    cache = _load_serve_cache(refresh=True)
    if key in cache and not force:
        return cache[key]
    best, candidates = None, []
    for edges in edge_sets:
        edges = [int(e) for e in edges]
        for h in horizons:
            t = float(timer(int(h), edges))
            candidates.append({"horizon": int(h), "bucket_edges": edges,
                               "seconds": t})
            if best is None or t < best["seconds"]:
                best = dict(candidates[-1])
    if best is None:
        return {}
    best["candidates"] = candidates
    cache[key] = best
    path = _serve_cache_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(cache, f, indent=1, sort_keys=True)
    return best


# -------------------------------------------------- the wire launch plan
#
# The JAX package's ``wire_blocks`` / ``autotune_wire_blocks`` on the
# card: the launch choice of each wire kernel, per (card, kind, codec,
# d), from a JSON file of the port's own. ``wire_plan`` is the read side
# and never times anything; an untuned key gives the kernel's own rule
# (-1), so tuning is an optimization, never a requirement. The knobs:
#   encode       (#1/#2, wire_encode.cu): the team, "warps" in
#                ENCODE_TEAMS (-1: ``encode_warps``);
#   proj_encode  (#5/#6, fusion_proj.cu): the fused encode's "tile", 0
#                the 16 x 64 tile, 1 the 8 x 16 one (-1: the rule);
#   decode_proj  (#3, fusion_proj.cu): the "tile", 0-2 ``fusion_proj``'s
#                fp32 tiles, 3 the 16 x 8 one (-1: the rule).
# An entry applies to the fp32 launches of its (kind, codec, d): a bf16
# fused encode sums on the tensor cores in an order the tile moves, so
# it keeps the rule; in fp32 every output is one fmaf chain, so a tile
# or a team moves no bit (the tuner checks that candidate by candidate).

ENCODE_TEAMS = (0, 1, 2, 4, 8)
# Launches a timed CUDA graph holds: one graph launch costs more than a
# wire kernel at the path's shapes, so a single call would time the graph.
_TUNE_CALLS = 16
_WIRE_TILES = {"proj_encode": 2, "decode_proj": 4}
_WIRE_PLAN_DEFAULTS = {
    "encode": {"warps": -1},
    "proj_encode": {"tile": -1},
    "decode_proj": {"tile": -1},
}
_wire_cache_mem: Optional[dict] = None


def _wire_cache_path() -> str:
    """The port's own plan file (the JAX package writes another), under
    ``REPRO_TORCH_WIRE_PLAN_CACHE`` if it is set."""
    return os.environ.get(
        "REPRO_TORCH_WIRE_PLAN_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                     "wire_plan.json"))


def _load_wire_cache(refresh: bool = False) -> dict:
    global _wire_cache_mem
    if _wire_cache_mem is None or refresh:
        try:
            with open(_wire_cache_path()) as f:
                _wire_cache_mem = json.load(f)
        except (OSError, ValueError):
            _wire_cache_mem = {}
    return _wire_cache_mem


def _plan_device(device) -> torch.device:
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


def _wire_key(codec_name: str, d: int, kind: str, device) -> str:
    return f"{card_name(device)}|{kind}|{codec_name}|d{d}"


def wire_plan(codec_name: str, d: int, kind: str = "encode",
              device=None) -> dict:
    """The launch plan of one wire kernel ``kind`` for ``codec_name`` at
    fusion dim ``d`` on ``device`` (None: the card if there is one):
    ``{"warps": w}`` (encode) or ``{"tile": t}`` (proj_encode,
    decode_proj), tuned if the plan file holds this card's entry, else
    -1, the kernel's own rule. Pure read side: the file is read once a
    process, and a lookup reads a dict."""
    knob = "warps" if kind == "encode" else "tile"
    entry = _load_wire_cache().get(
        _wire_key(codec_name, d, kind, _plan_device(device)))
    if entry and knob in entry:
        return {knob: int(entry[knob])}
    return dict(_WIRE_PLAN_DEFAULTS[kind])


def fused_tile(op: str, M: int, K: int, N: int, dtype=torch.float32,
               tile: int = -1, device="cuda",
               sms: Optional[int] = None) -> int:
    """The tile ``csrc/fusion_proj.cu`` takes (its index in the kernel's
    list, as the wrappers' ``tile`` counts them), or -1 where it takes
    none, for ``op`` "fusion_proj" (#4), "proj_encode" (#5/#6, N the
    fusion dim) or "decode_proj" (#3, K the fusion dim, dtype w's), on
    a card of ``sms`` SMs (None: ``device``'s). Launches nothing."""
    fn = _c_fn("fusion_proj", "fusion_proj_tile", [_I] * 7)
    return fn({"fusion_proj": 0, "proj_encode": 1, "decode_proj": 2}[op],
              M, K, N, _DTYPE_CODE[dtype], tile,
              sm_count(device) if sms is None else sms)


def rmsnorm_grid(rows: int, d: int, dtype=torch.float32, *,
                 aligned: bool = True, device="cuda",
                 sms: Optional[int] = None) -> int:
    """The blocks of ``csrc/rmsnorm.cu``'s launch at (rows, d) in
    ``dtype``, the rows all on 16 bytes or not, on a card of ``sms`` SMs
    (None: ``device``'s). Launches nothing."""
    fn = _c_fn("rmsnorm", "rmsnorm_grid", [ctypes.c_longlong] + [_I] * 3)
    fn.restype = ctypes.c_longlong
    ok = aligned and d % (16 // dtype.itemsize) == 0
    return int(fn(rows, d, int(ok), sm_count(device) if sms is None else sms))


def _wire_candidates(kind: str, scheme: WireScheme, M: int, K: int, N: int,
                     dev) -> list:
    """The knob values a launch takes: every team whose rows fit in
    shared memory, every fused-encode tile, every decode tile that holds
    its rows."""
    if kind == "encode":
        takes = _c_fn("wire_encode", "wire_encode_takes", [_I] * 4)
        return [{"warps": w} for w in ENCODE_TEAMS
                if takes(_SCHEME_CODE[scheme.kind], scheme.d, scheme.n, w)]
    return [{"tile": t} for t in range(_WIRE_TILES[kind])
            if fused_tile(kind, M, K, N, tile=t, device=dev) == t]


def _first_differing(a: dict, b: dict) -> Optional[str]:
    """The first leaf name whose bits differ between two output dicts,
    or None."""
    for k in a:
        x, y = a[k], b[k]
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            return k
    return None


def autotune_wire_plan(codec, d: int, *, kind: str = "encode",
                       rows: int = 512, reps: int = 3, candidates=None,
                       force: bool = False, device=None) -> dict:
    """Search one wire kernel's launch knob for (codec, d, kind) on the
    card and persist the winner keyed by (card name, kind, codec, d), so
    that later launches, and other processes, take it from
    ``wire_plan``. Returns the winning entry (also on a cache hit,
    unless ``force``): the knob, its "us", and every candidate's "us"
    with whether it is "admissible" and, if not, the first leaf that
    "differs".

    As the JAX package's tuner: fp32 inputs from seeded generators (z
    (rows, d); x (rows, 128) and w (128, d) for proj_encode; the codec's
    payload of z and w_d (d, 256) for decode_proj; e for an ``ef(...)``
    codec), each candidate timed best of ``reps`` (here: the
    ``kernel_bench`` twin's CUDA-graph timer over ``_TUNE_CALLS``
    launches on the same inputs). Each candidate's payload
    (and e', or y) must be bitwise the kernel rule's on the same inputs;
    one that differs is reported as not admissible and never chosen.
    Unlike the JAX package's tuner, which skips a candidate that raises,
    a launch that raises raises here: a kernel failure must not vanish
    into a plan. The entry applies to fp32 launches only (``wire_plan``).
    The plan never times anything on the CPU: without a card, or for a
    device that is not one, this raises. A codec with no wire scheme at
    d has no kernel: the defaults come back, with "us" None, and nothing
    is written."""
    from repro_torch.benchmarks.kernel_bench import graph_time_ms

    dev = _plan_device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise ValueError(f"autotune_wire_plan times launches on a card; "
                         f"got device {dev}")
    codec = codec_mod.get_codec(codec)
    if kind not in _WIRE_PLAN_DEFAULTS:
        raise ValueError(f"kind {kind!r} not in {sorted(_WIRE_PLAN_DEFAULTS)}")
    key = _wire_key(codec.name, d, kind, dev)
    cache = _load_wire_cache(refresh=True)
    if key in cache and not force:
        return cache[key]
    is_ef = isinstance(codec, codec_mod.EFCodec)
    inner = codec.inner if is_ef else codec
    scheme = scheme_for(inner, d)
    if scheme is None:
        return dict(_WIRE_PLAN_DEFAULTS[kind], us=None)
    knob = "warps" if kind == "encode" else "tile"

    def draw(seed, shape, scale=1.0):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(shape, generator=g, device=dev) * scale

    z = draw(0, (rows, d))
    e = draw(4, (rows, d), 0.1) if is_ef and codec.has_state else None
    K, N = {"encode": (d, d), "proj_encode": (128, d),
            "decode_proj": (d, 256)}[kind]
    if kind == "encode":
        def run(v):
            if e is not None:
                p, e_new = wire_encode_ef(z, e, codec, warps=v)
                return {**p, "e'": e_new}
            return wire_encode(z, inner, warps=v)
    elif kind == "proj_encode":
        x, w = draw(1, (rows, K)), draw(2, (K, N), 0.05)

        def run(v):
            out = fusion_proj_encode(x, w, codec=codec, ef_state=e, tile=v)
            return {**out[0], "e'": out[1]} if e is not None else out
    else:
        payload = ref.wire_encode_ref(z, inner)
        wd = draw(3, (K, N), 0.05)

        def run(v):
            return {"y": decode_proj(payload, wd, codec=codec,
                                     shape=(rows, d), tile=v)}

    counters = [f.launches for f in (wire_encode, wire_encode_ef,
                                     fusion_proj_encode, decode_proj)]
    try:
        want = run(-1)
        default = (encode_warps(rows, d, scheme.kind) if kind == "encode"
                   else fused_tile(kind, rows, K, N, device=dev))
        if candidates is None:
            candidates = _wire_candidates(kind, scheme, rows, K, N, dev)
        tried, best = [], None
        for cand in candidates:
            v = int(cand[knob])
            differs = _first_differing(want, run(v))
            us = 1e3 * min(graph_time_ms([lambda: run(v)] * _TUNE_CALLS)
                           for _ in range(reps))
            tried.append({knob: v, "us": round(us, 3),
                          "admissible": differs is None, "differs": differs})
            if differs is None and (best is None or us < best["us"]):
                best = {knob: v, "us": round(us, 3)}
    finally:
        for f, n in zip((wire_encode, wire_encode_ef, fusion_proj_encode,
                         decode_proj), counters):
            f.launches = n
    if best is None:
        return dict(_WIRE_PLAN_DEFAULTS[kind], us=None, candidates=tried)
    best.update(default=default, rows=rows, candidates=tried)
    cache[key] = best
    path = _wire_cache_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(cache, f, indent=1, sort_keys=True)
    return best
