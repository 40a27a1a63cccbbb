"""Wrappers around the port's kernels: the model code's dispatch points.

Each op dispatches on the device of its tensors and nothing else: a CPU
tensor runs the plain PyTorch version (``ref.py``), a CUDA tensor
launches the hand-written kernel or raises. There is no fallback and no
flag that hides the kernel. Each kernel wrapper counts its launches in a
plain int attribute (``flash_decode.launches``, ``wire_encode.launches``,
``wire_encode_ef.launches``), so a run can show that its main path went
through the kernel.

The wire-encode wrappers have one more rule, the JAX package's own
(``repro/kernels/wire_fused.py:30-33``): a codec with no wire scheme
(fp32, bf16, fp16, int8, int8_channel) or a fusion dim above
``MAX_FUSED_D`` has no kernel at all, on any device; the wrappers then
return None and the caller encodes with the codec's plain ops. That is
which function the codec computes, decided from the codec and the shape
alone, not a way around a kernel that failed: a CUDA tensor of a codec
that has a scheme launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import codec as codec_mod
from repro_torch.kernels import build, ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)  # every dense config the port builds
_MAX_GROUP = 16


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 valid: torch.Tensor,
                 scale: Optional[float] = None) -> torch.Tensor:
    """Launch the CUDA flash-decode kernel (``csrc/flash_decode.cu``).

    q: (B, KVH, G, hd); k, v: (B, L, KVH, hd), the cache in the model's
    layout; valid: (B, L) bool. All contiguous, on one CUDA device, q/k/v
    of one dtype (float32 or bfloat16), hd in {64, 128}, G <= 16.
    Returns (B, KVH, G, hd) in q's dtype. Raises on anything else.
    """
    B, KVH, G, hd = q.shape
    L = k.shape[1]
    dev = q.device
    if dev.type != "cuda":
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
    if hd not in _HEAD_DIMS or G > _MAX_GROUP or L < 1:
        raise ValueError(f"flash_decode: hd {hd} not in {_HEAD_DIMS}, or "
                         f"G {G} > {_MAX_GROUP}, or empty cache")
    if not all(t.is_contiguous() for t in (q, k, v, valid)):
        raise ValueError("flash_decode: tensors must be contiguous")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash_decode: k/v must be 16-byte aligned")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    lib = build.load("flash_decode")
    fn = lib.flash_decode
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(valid), _ptr(out),
                ctypes.c_int(B), ctypes.c_int(L), ctypes.c_int(KVH),
                ctypes.c_int(G), ctypes.c_int(hd),
                ctypes.c_int(_DTYPE_CODE[q.dtype]), ctypes.c_float(scale),
                ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"flash_decode launch failed (code {rc})")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def cached_attn_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       valid: torch.Tensor,
                       scale: Optional[float] = None) -> torch.Tensor:
    """Single-token attention against a KV cache, the serving decode
    path's dispatch point.

    q: (B, 1, KVH, G, hd) grouped query; k, v: (B, L, KVH, hd) cache;
    valid: (B, L) bool live-row mask (causality and the ring-buffer
    window already folded in). Returns (B, 1, KVH, G, hd).

    CPU tensors run ``ref.cached_attn_decode_ref``; CUDA tensors launch
    ``flash_decode`` directly on the cache, in its own layout.
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
    """One codec's encode as the kernel computes it: ``kind`` is one of
    int8_row / int4 / topk / sketch, ``d`` the fusion dim, ``n`` the
    kept count k (topk) or bucket count w (sketch), ``seed`` the sketch
    tables' seed."""

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
        """Bytes of the sketch tables the kernel reads (sign, hash and
        order over d, inv_counts over w, ptr over w + 1)."""
        return 4 * (3 * self.d + 2 * self.n + 1) if self.kind == "sketch" else 0


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


def wire_bytes_moved(scheme: WireScheme, rows: int, ef: bool) -> int:
    """The bytes one encode must move: z (and e) read once, the payload
    (and e') written once, the sketch tables read once."""
    z_bytes = rows * scheme.d * 4
    return (z_bytes * (3 if ef else 1) + scheme.payload_bytes(rows)
            + scheme.table_bytes())


_WIRE_ARGTYPES = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 2 + [
    ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [ctypes.c_int,
                                                ctypes.c_float] + [
    ctypes.c_void_p] * 9


def _check_rows(name: str, t: torch.Tensor, d: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: fp32 input required, got {t.dtype}")
    if t.dim() < 1 or t.shape[-1] != d or t.numel() == 0:
        raise ValueError(f"{name}: shape {tuple(t.shape)} is not (..., {d})")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensors must be contiguous")


def _launch_wire(scheme: WireScheme, z: torch.Tensor,
                 e: Optional[torch.Tensor],
                 max_ratio: Optional[float]):
    """Launch ``csrc/wire_encode.cu`` on z (and e) -> (payload, e')."""
    d = scheme.d
    rows = z.numel() // d
    lead = tuple(z.shape[:-1])
    dev = z.device
    outs = {name: torch.empty((rows, *tail), dtype=dt, device=dev)
            for name, (tail, dt) in scheme.leaves.items()}
    bufs = list(outs.values()) + [None] * (2 - len(outs))
    e_out = torch.empty_like(z) if e is not None else None
    if scheme.kind == "sketch":
        t = codec_mod.sketch_device_tables(scheme.d, scheme.n, scheme.seed,
                                           str(dev))
        tables = tuple(t[k] for k in ("sign", "inv_counts", "hash", "order",
                                      "ptr"))
    else:
        tables = (None,) * 5
    qmax = 7 if scheme.kind == "int4" else 127
    clip = max_ratio is not None and bool(np.isfinite(max_ratio))
    lib = build.load("wire_encode")
    fn = lib.wire_encode
    fn.restype = ctypes.c_int
    fn.argtypes = _WIRE_ARGTYPES

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(_SCHEME_CODE[scheme.kind], int(e is not None), ptr(z), ptr(e),
                rows, d, scheme.n, float(np.float32(1.0 / qmax)), float(qmax),
                int(clip), float(np.float32(max_ratio)) if clip else 0.0,
                *(ptr(t) for t in tables), ptr(bufs[0]), ptr(bufs[1]),
                ptr(e_out), stream)
    if rc != 0:
        raise RuntimeError(f"wire_encode launch failed (code {rc})")
    payload = {name: o.reshape(*lead, *o.shape[1:])
               for name, o in outs.items()}
    return payload, e_out


def wire_encode(z: torch.Tensor, codec) -> Optional[dict]:
    """Encode z with ``codec`` -> the payload dict, or None when the
    codec has no wire scheme at z's fusion dim (module docstring).

    A CPU tensor takes the plain version (``ref.wire_encode_ref``, the
    codec's own encode); a CUDA tensor launches ``csrc/wire_encode.cu``
    (z fp32 and contiguous, d <= MAX_FUSED_D) or raises."""
    scheme = scheme_for(codec, z.shape[-1])
    if scheme is None:
        return None
    if z.device.type == "cpu":
        return ref.wire_encode_ref(z, codec)
    _check_rows("wire_encode", z, scheme.d)
    payload, _ = _launch_wire(scheme, z, None, None)
    wire_encode.launches += 1
    return payload


wire_encode.launches = 0


def wire_encode_ef(z: torch.Tensor, e: torch.Tensor, ef_codec):
    """The EF21 encode of ``ef_codec`` (an ``EFCodec``) -> (payload, e'),
    or None when its inner codec has no wire scheme at z's fusion dim.

    c = z + e, the inner encode of c, z_hat = decode(payload) and the
    trust-region-clipped residual e' = c - z_hat, in one launch. A CPU
    tensor takes the plain version (``ref.wire_encode_ef_ref``); a CUDA
    tensor launches the kernel (z, e fp32, contiguous, one shape) or
    raises."""
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
    out = _launch_wire(scheme, z, e, ef_codec.max_ratio)
    wire_encode_ef.launches += 1
    return out


wire_encode_ef.launches = 0
