"""What each of the port's kernels costs on one H100: the bytes it must
move and the operations it must do at given shapes, and from them the
least time the card could take (``bound_ms``, ``bound_by``).

This is the one count of a kernel's work. ``chip_smoke.py``'s kernels
line, the ``kernel_bench`` twin (``repro_torch.benchmarks``), the
``bound_ms`` column of PERF.md's table of kernels and the dry-run's
accounting (``repro_torch.roofline.accounting``, through ``launch``)
all read these functions.

Bytes: each input read once, each output written once, whatever the
kernel reads again. Operations: the kernel's own work (attention counts
the (query, key) pairs its mask keeps, ``attn_pairs``, over q/k's head
dim and v's own). The bound is the larger of bytes over the card's
memory rate and operations over its peak rate for their type
(``rate``): NVIDIA's data sheet of the H100 SXM, dense, at its 700 W
limit.

The module is the card's counterpart of the reference's TPU DMA
accounting of the fused wire path (``repro/kernels/wire_fused.py``
``encode_hbm_bytes``, ``proj_encode_hbm_bytes``, ``encode_spec``;
``Codec.fused_spec``). Those read a Pallas kernel's BlockSpecs, which
say how often each VMEM block enters; a CUDA kernel here reads through
L2 and shared memory as its design chooses, so the card's count is the
least its function must move, not a block schedule.
"""

from __future__ import annotations

import math
from contextlib import nullcontext
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16 FLOP/s on
# the tensor cores and fp32 FLOP/s outside them.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12


def rate(dtype: torch.dtype) -> float:
    """The peak rate of operations on ``dtype`` inputs: the tensor
    cores' for bf16 and fp16, fp32's outside them for anything else."""
    return BF16_FLOPS if dtype in (torch.bfloat16, torch.float16) \
        else FP32_FLOPS


def bound(nbytes: float, flops: float, peak: float) -> Tuple[float, str]:
    """(least ms, "bytes" or "operations"): the larger of ``nbytes`` over
    the memory rate and ``flops`` over ``peak``."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = flops / peak * 1e3
    return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations"


def _cost(nbytes: int, flops: float, peak: float) -> Dict:
    ms, by = bound(nbytes, flops, peak)
    return {"flops": float(flops), "bytes": int(nbytes), "bound_ms": ms,
            "bound_by": by}


def _esz(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


# ------------------------------------------------------------- attention


def attn_pairs(S: int, window: int, causal: bool) -> int:
    """(query, key) pairs the mask keeps over one head of S rows: row i
    sees keys from max(0, i - window + 1) (window <= 0: from 0) to i
    (``causal``) or to S - 1."""
    i = np.arange(S, dtype=np.int64)
    lo = np.maximum(0, i - window + 1) if window > 0 else np.zeros_like(i)
    hi = i if causal else np.full_like(i, S - 1)
    return int((hi - lo + 1).sum())


def _attn_bytes(B, S, H, KVH, hd, hdv, dtype):
    e = _esz(dtype)
    return (B * S * H * hd * e, B * S * KVH * hd * e, B * S * KVH * hdv * e,
            B * S * H * hdv * e, B * H * S * 4)


def flash_attention(B: int, S: int, H: int, KVH: int, hd: int, hdv: int,
                    window: int, causal: bool, dtype: torch.dtype) -> Dict:
    """#8: q, k, v in; o and the fp32 lse out; q.k over hd and p.v over
    hdv for every kept pair."""
    q, k, v, o, lse = _attn_bytes(B, S, H, KVH, hd, hdv, dtype)
    flops = 2 * B * H * attn_pairs(S, window, causal) * (hd + hdv)
    return _cost(q + k + v + o + lse, flops, rate(dtype))


def flash_attention_bwd(B: int, S: int, H: int, KVH: int, hd: int,
                        hdv: int, window: int, causal: bool,
                        dtype: torch.dtype) -> Dict:
    """#8b: q, k, v, o, dO and lse in; dq, dk, dv out; q.k, ds^T q and
    ds k over hd, dO.v and p^T dO over hdv for every kept pair."""
    q, k, v, o, lse = _attn_bytes(B, S, H, KVH, hd, hdv, dtype)
    flops = 2 * B * H * attn_pairs(S, window, causal) * (3 * hd + 2 * hdv)
    return _cost(2 * (q + k + v + o) + lse, flops, rate(dtype))


def flash_decode(B: int, L: int, KVH: int, G: int, hd: int,
                 dtype: torch.dtype, live: Optional[int] = None) -> Dict:
    """#9: the ``live`` cache rows of K and V (masked rows cannot change
    the output; None: all B * L), q in, out, the (B, L) bool mask;
    q.k and p.v over the live rows."""
    live = B * L if live is None else int(live)
    e = _esz(dtype)
    nbytes = 2 * live * KVH * hd * e + 2 * B * KVH * G * hd * e + B * L
    return _cost(nbytes, 4 * live * KVH * G * hd, rate(dtype))


# ------------------------------------------------------------ wire path

# Operations an element of an encode (fp32): max |z| and the row's
# scale, the rounding and the clamp; top-k's sort takes log2 d compares;
# the sketch a hash, a sign and a sum. EF adds the sum c = z + e, the
# decode and the residual with its clip norms (7).
def _wire_ops_per_element(kind: str, d: int) -> float:
    return {"int8_row": 8, "int4": 8, "topk": 2 + math.log2(d),
            "sketch": 3}[kind]


def wire_bytes_moved(scheme, rows: int, ef: bool) -> int:
    """The bytes one encode must move: z (and e) read once, the payload
    (and e') written once, the sketch tables read once. ``scheme`` is an
    ``ops.WireScheme``."""
    z_bytes = rows * scheme.d * 4
    return (z_bytes * (3 if ef else 1) + scheme.payload_bytes(rows)
            + scheme.table_bytes())


def wire_encode(scheme, rows: int, ef: bool = False) -> Dict:
    """#1 (``ef`` False) and #2 (True) over ``rows`` rows of z."""
    flops = rows * scheme.d * (_wire_ops_per_element(scheme.kind, scheme.d)
                               + (7 if ef else 0))
    return _cost(wire_bytes_moved(scheme, rows, ef), flops, FP32_FLOPS)


def fusion_proj(M: int, K: int, N: int, dtype: torch.dtype,
                bias: bool = True) -> Dict:
    """#4: x (M, K) and w (K, N) in x's dtype and the fp32 bias in, y
    (M, N) out; 2 M K N operations."""
    e = _esz(dtype)
    nbytes = (M * K + K * N + M * N) * e + (N * 4 if bias else 0)
    return _cost(nbytes, 2 * M * K * N, rate(dtype))


def fusion_proj_encode(M: int, K: int, scheme, ef: bool,
                       dtype: torch.dtype, bias: bool = True) -> Dict:
    """#5 (``scheme`` int8_row, no EF) and #6: x, w, the bias (and e) in,
    the payload (and e') out, the sketch tables read; the fp32
    activation stays on the chip. Its 2 M K N operations are timed at
    fp32's rate: the epilogue encodes the fp32 value of y."""
    e = _esz(dtype)
    N = scheme.d
    nbytes = ((M * K + K * N) * e + (N * 4 if bias else 0)
              + scheme.payload_bytes(M) + scheme.table_bytes()
              + (2 * M * N * 4 if ef else 0))
    return _cost(nbytes, 2 * M * K * N, FP32_FLOPS)


def decode_proj(M: int, N: int, scheme, w_dtype: torch.dtype,
                bias: bool = True) -> Dict:
    """#3: the (M, d) payload, w (d, N), the fp32 bias and the sketch's
    sign, hash and inv_counts in, y (M, N) fp32 out; 2 M d N operations
    (w is widened to fp32)."""
    d = scheme.d
    nbytes = (scheme.payload_bytes(M) + d * N * _esz(w_dtype)
              + (N * 4 if bias else 0) + M * N * 4
              + (4 * (2 * d + scheme.n) if scheme.kind == "sketch" else 0))
    return _cost(nbytes, 2 * M * d * N, FP32_FLOPS)


def rmsnorm(M: int, D: int, x_dtype: torch.dtype,
            scale_dtype: torch.dtype) -> Dict:
    """#7: x in, y out, the scale in; 4 operations an element."""
    nbytes = 2 * M * D * _esz(x_dtype) + D * _esz(scale_dtype)
    return _cost(nbytes, 4 * M * D, FP32_FLOPS)


# ------------------------------------------------------------ recording

# The accountings that count kernel launches
# (``repro_torch.roofline.accounting.Accounting`` enters itself here
# while it is active). Empty, ``launch`` costs one list test a call.
_SINKS: List = []


class _Launch:
    """The context of one launch while accountings are active."""

    __slots__ = ("name", "cost_fn", "sinks")

    def __init__(self, name: str, cost_fn: Callable[[], Dict], sinks):
        self.name, self.cost_fn, self.sinks = name, cost_fn, sinks

    def __enter__(self):
        for s in self.sinks:
            s.kernel_enter()

    def __exit__(self, exc_type, exc, tb):
        c = self.cost_fn() if exc_type is None else None
        for s in self.sinks:
            s.kernel_exit(self.name, c)
        return False


_NO_SINK = nullcontext()


def launch(name: str, cost_fn: Callable[[], Dict]):
    """Around one kernel wrapper's launch, or its stand-in on the meta
    device: every active accounting counts one launch of ``name`` with
    ``cost_fn()``'s cost, and not the aten ops the wrapper issues to
    allocate its outputs. Nothing is counted if the body raises. With no
    accounting active it is an empty context."""
    return _Launch(name, cost_fn, list(_SINKS)) if _SINKS else _NO_SINK
