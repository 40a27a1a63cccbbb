"""Wrappers around the port's kernels: the model code's dispatch points.

Each op dispatches on the device of its tensors and nothing else: a CPU
tensor runs the plain PyTorch version (``ref.py``), a CUDA tensor
launches the hand-written kernel or raises. There is no fallback and no
flag that hides the kernel. Each kernel wrapper counts its launches in a
plain int attribute (``flash_decode.launches``), so a run can show that
its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

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
