"""Wrappers around the port's kernels: the model code's dispatch points.

Each op dispatches on the device of its tensors and nothing else: a CPU
tensor runs the plain PyTorch version (``ref.py``), a CUDA tensor
launches the hand-written kernel or raises. There is no fallback and no
flag that hides the kernel. Each kernel wrapper counts its launches in a
plain int attribute (``flash_decode.launches``, ``wire_encode.launches``,
``wire_encode_ef.launches``, ``flash_attention.launches``,
``flash_attention_bwd.launches``, ``fusion_proj.launches``,
``fusion_proj_quant.launches``, ``fusion_proj_encode.launches``,
``decode_proj.launches``), so a run can show that its main path went
through the kernel.

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


def wire_bytes_moved(scheme: WireScheme, rows: int, ef: bool) -> int:
    """The bytes one encode must move: z (and e) read once, the payload
    (and e') written once, the sketch tables read once."""
    z_bytes = rows * scheme.d * 4
    return (z_bytes * (3 if ef else 1) + scheme.payload_bytes(rows)
            + scheme.table_bytes())


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
    fn = _c_fn("wire_encode", "wire_encode",
               [_I, _I, _P, _P, _I, _I, _I, _F, _F, _I, _F] + [_P] * 9)
    with torch.cuda.device(dev):
        rc = fn(_SCHEME_CODE[scheme.kind], int(e is not None), z.data_ptr(),
                _nullable(e), rows, d, scheme.n, *_qparams(scheme),
                *_clip(max_ratio),
                *(_nullable(t) for t in scheme.tables(dev)),
                _nullable(bufs[0]), _nullable(bufs[1]), _nullable(e_out),
                _stream(dev))
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
    contiguous -> b as a contiguous fp32 tensor (or None)."""
    if dev.type != "cuda":
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
    one dtype, contiguous, any M, K, N) or raises."""
    code = _act_code(act)
    if x.device.type == "cpu":
        return ref.fusion_proj_ref(x, w, b, act)
    bf = _check_proj("fusion_proj", x, w, b, x.device)
    K, N = w.shape
    M = x.numel() // K
    y = torch.empty((*x.shape[:-1], N), dtype=x.dtype, device=x.device)
    fn = _c_fn("fusion_proj", "fusion_proj", [_P] * 4 + [_I] * 5 + [_P])
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), w.data_ptr(), _nullable(bf), y.data_ptr(), M, K,
                N, _DTYPE_CODE[x.dtype], code, _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"fusion_proj launch failed (code {rc})")
    fusion_proj.launches += 1
    return y


fusion_proj.launches = 0


def fusion_proj_quant(x: torch.Tensor, w: torch.Tensor,
                      b: Optional[torch.Tensor] = None, act: str = "none"):
    """The projection with the int8_row wire encode in one launch:
    x (..., K), w (K, N) -> (q int8 (..., N), scale fp32 (..., 1)), the
    fp32 activation never in device memory.

    A CPU tensor, or N above ``MAX_FUSED_D`` on any device, takes the
    plain version (``ref.fusion_proj_quant_ref``); a CUDA tensor launches
    the kernel or raises."""
    code = _act_code(act)
    N = w.shape[-1]
    if x.device.type == "cpu" or scheme_for(codec_mod.CODECS["int8_row"],
                                            N) is None:
        return ref.fusion_proj_quant_ref(x, w, b, act)
    bf = _check_proj("fusion_proj_quant", x, w, b, x.device)
    K = w.shape[0]
    lead = tuple(x.shape[:-1])
    q = torch.empty((*lead, N), dtype=torch.int8, device=x.device)
    scale = torch.empty((*lead, 1), dtype=torch.float32, device=x.device)
    inv_qmax, _ = _qparams(WireScheme("int8_row", N))
    fn = _c_fn("fusion_proj", "fusion_proj_quant",
               [_P] * 3 + [_I] * 5 + [_F] + [_P] * 3)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), w.data_ptr(), _nullable(bf), x.numel() // K, K,
                N, _DTYPE_CODE[x.dtype], code, inv_qmax, q.data_ptr(),
                scale.data_ptr(), _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"fusion_proj_quant launch failed (code {rc})")
    fusion_proj_quant.launches += 1
    return q, scale


fusion_proj_quant.launches = 0


def fusion_proj_encode(x: torch.Tensor, w: torch.Tensor,
                       b: Optional[torch.Tensor] = None, act: str = "none",
                       *, codec, ef_state: Optional[torch.Tensor] = None):
    """The projection with ``codec``'s wire encode (and the EF21 step)
    in one launch: x (..., K), w (K, N) -> the payload, or (payload, e')
    with ``ef_state``, the carried residual of an ``ef(...)`` codec,
    shaped like the output. The fp32 activation never reaches device
    memory; only the payload (and e') do.

    A codec with no wire scheme at N (module docstring) runs the plain
    composition on every device; so does a CPU tensor
    (``ref.fusion_proj_encode_ref``). A CUDA tensor of a codec with a
    scheme launches the kernel (x, w fp32 or bf16, e fp32, contiguous)
    or raises."""
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
    bf = _check_proj("fusion_proj_encode", x, w, b, dev)
    lead = tuple(x.shape[:-1])
    ef = ef_state is not None
    if ef and (ef_state.device != dev or ef_state.dtype != torch.float32
               or tuple(ef_state.shape) != (*lead, N)
               or not ef_state.is_contiguous()):
        raise ValueError(f"fusion_proj_encode: ef_state "
                         f"{ef_state.dtype}{tuple(ef_state.shape)} on "
                         f"{ef_state.device}, want contiguous float32 "
                         f"{(*lead, N)} on {dev}")
    K = w.shape[0]
    outs = {name: torch.empty((*lead, *tail), dtype=dt, device=dev)
            for name, (tail, dt) in scheme.leaves.items()}
    bufs = list(outs.values()) + [None] * (2 - len(outs))
    e_out = torch.empty_like(ef_state) if ef else None
    fn = _c_fn("fusion_proj", "fusion_proj_encode",
               [_I, _I] + [_P] * 4 + [_I] * 6 + [_F, _F, _I, _F] + [_P] * 9)
    with torch.cuda.device(dev):
        rc = fn(_SCHEME_CODE[scheme.kind], int(ef), x.data_ptr(),
                w.data_ptr(), _nullable(bf), _nullable(ef_state),
                x.numel() // K, K, N, scheme.n, _DTYPE_CODE[x.dtype], code,
                *_qparams(scheme), *_clip(codec.max_ratio if is_ef else None),
                *(_nullable(t) for t in scheme.tables(dev)),
                _nullable(bufs[0]), _nullable(bufs[1]), _nullable(e_out),
                _stream(dev))
    if rc != 0:
        raise RuntimeError(f"fusion_proj_encode launch failed (code {rc})")
    fusion_proj_encode.launches += 1
    return (outs, e_out) if ef else outs


fusion_proj_encode.launches = 0


def decode_proj(payload: dict, w: torch.Tensor,
                b: Optional[torch.Tensor] = None, act: str = "none", *,
                codec, shape) -> torch.Tensor:
    """Decode as the prologue of the modular block's first FC:
    act(codec.decode(payload) @ w + b) in one launch, the fp32
    reconstruction held in shared memory. ``shape`` is z's shape (...,
    d); w (d, N); returns (*shape[:-1], N) fp32.

    A codec with no wire scheme at d runs the plain composition on every
    device; so does a payload on the CPU (``ref.decode_proj_ref``). A
    CUDA payload of a codec with a scheme launches the kernel (the
    scheme's leaves, contiguous; w fp32 or bf16) or raises."""
    code = _act_code(act)
    shape = tuple(int(s) for s in shape)
    d = shape[-1]
    scheme = scheme_for(codec.inner if isinstance(codec, codec_mod.EFCodec)
                        else codec, d)
    dev = next(iter(payload.values())).device
    if scheme is None or dev.type == "cpu":
        return ref.decode_proj_ref(payload, w, b, act, codec=codec,
                                   shape=shape)
    bf = _check_proj("decode_proj", None, w, b, dev)
    if w.shape[0] != d:
        raise ValueError(f"decode_proj: w {tuple(w.shape)} is not ({d}, N)")
    rows = int(np.prod(shape[:-1]))
    leaves = scheme.payload_rows(payload, rows, dev)
    N = w.shape[1]
    y = torch.empty((rows, N), dtype=torch.float32, device=dev)
    sign, inv_counts, hsh, _, _ = scheme.tables(dev)
    fn = _c_fn("fusion_proj", "decode_proj",
               [_I] + [_P] * 5 + [_I] * 6 + [_P] * 4)
    with torch.cuda.device(dev):
        rc = fn(_SCHEME_CODE[scheme.kind], leaves[0].data_ptr(),
                _nullable(leaves[1] if len(leaves) > 1 else None),
                w.data_ptr(), _nullable(bf), y.data_ptr(), rows, d, N,
                scheme.n, _DTYPE_CODE[w.dtype], code, _nullable(sign),
                _nullable(inv_counts), _nullable(hsh), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"decode_proj launch failed (code {rc})")
    decode_proj.launches += 1
    return y.reshape(*shape[:-1], N)


decode_proj.launches = 0


# ------------------------------------------------------ flash attention


def _check_attn(name: str, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> None:
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors, got {dev}")
    if k.device != dev or v.device != dev:
        raise ValueError(f"{name}: tensors on different devices")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: dtypes {q.dtype}/{k.dtype}/{v.dtype}"
                         " (float32 or bfloat16, all equal)")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    B, S, H, hd = q.shape
    KVH = k.shape[2]
    if (k.shape[0] != B or k.shape[1] != S or k.shape[3] != hd
            or H % KVH or hd not in _HEAD_DIMS or S < 1):
        raise ValueError(f"{name}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} are not (B, S, H, hd) / "
                         f"(B, S, KVH, hd) with H % KVH == 0, hd in "
                         f"{_HEAD_DIMS}, S >= 1")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError(f"{name}: tensors must be contiguous")


def _attn_call(fn_name: str, *args) -> None:
    lib = build.load("flash_attention")
    fn = getattr(lib, fn_name)
    fn.restype = ctypes.c_int
    # pointers, then B, S, H, KVH, hd, window, dtype, then scale, stream
    fn.argtypes = ([ctypes.c_void_p] * (len(args) - 9)
                   + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{fn_name} launch failed (code {rc})")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, window: int = -1, scale: Optional[float] = None):
    """Launch the forward kernel on CUDA tensors q (B, S, H, hd), k, v
    (B, S, KVH, hd) -> (o (B, S, H, hd) in q's dtype, lse (B, H, S)
    fp32, each row's softmax logsumexp). Raises on anything the kernel
    does not take. Counts in ``flash_attention.launches``."""
    _check_attn("flash_attention", q, k, v)
    B, S, H, hd = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _attn_call("flash_attention_fwd", q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), o.data_ptr(), lse.data_ptr(), B, S, H,
                   k.shape[2], hd, int(window), _DTYPE_CODE[q.dtype],
                   float(scale), stream)
    flash_attention.launches += 1
    return o, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, window: int = -1, scale: Optional[float] = None):
    """Launch the backward kernels (dQ with D = rowsum(dO * O), then dK
    and dV) on the forward's tensors and dO -> (dq, dk, dv) in the
    inputs' dtype. One call counts one launch of the backward."""
    _check_attn("flash_attention_bwd", q, k, v)
    B, S, H, hd = q.shape
    if (o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype
            or do.dtype != q.dtype or lse.shape != (B, H, S)
            or lse.dtype != torch.float32
            or not all(t.is_contiguous() and t.device == q.device
                       for t in (o, do, lse))):
        raise ValueError("flash_attention_bwd: o, dO must match q and lse "
                         "be (B, H, S) fp32, all contiguous on q's device")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dsum = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _attn_call("flash_attention_bwd", q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), o.data_ptr(), do.data_ptr(),
                   lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
                   dk.data_ptr(), dv.data_ptr(), B, S, H, k.shape[2], hd,
                   int(window), _DTYPE_CODE[q.dtype], float(scale), stream)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Forward kernel in ``forward``, backward kernel in ``backward``."""

    @staticmethod
    def forward(ctx, q, k, v, window, scale):
        o, lse = flash_attention_fwd(q, k, v, window=window, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.window, ctx.scale = window, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         window=ctx.window, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = -1,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Causal (optionally sliding-window) attention over a full
    sequence, the training path's dispatch point.

    q: (B, S, H, hd); k, v: (B, S, KVH, hd), the model's layout, GQA
    read directly (no repeated K/V). Returns (B, S, H, hd). CPU tensors
    run ``ref.flash_attention_ref``; CUDA tensors run the kernels through
    a ``torch.autograd.Function`` (contiguous, float32 or bfloat16, hd
    in {64, 128}) or raise.
    """
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=True, window=window,
                                       scale=scale)
    return _FlashAttention.apply(q, k, v, window, scale)


flash_attention.launches = 0
