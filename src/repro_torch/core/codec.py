"""Fusion-payload wire codecs — the compression layer of the IFL boundary.

The port's copy of ``repro.core.codec``: the same registry, names,
payload leaves (names, dtypes, shapes) and byte accounting, over torch
tensors. Each codec exposes

  encode(z)                       -> payload (a dict of tensors: exactly
                                     the bytes that would be transmitted)
  decode(payload, shape=, dtype=) -> z_hat   (what the receiver trains on)
  wire_bytes(payload)             -> int     (measured payload bytes)
  encoded_nbytes(shape)           -> int     (analytic bytes; equals
                                              wire_bytes(encode(z)))

plus the optional state API (``init_state`` / ``encode_with_state``,
stateless by default; ``EFCodec`` carries the EF21 residual) and the
``fused_encode*`` capability, which routes the encode of the four wire
schemes (int8_row, int4, topk, sketch) through the hand-written kernels
in ``repro_torch.kernels.ops``.

Codecs: fp32 | bf16 | fp16 | int8 | int8_channel | int8_row | int4 |
topk<r> | sketch<r> | ef(<codec>).

Numerics kept from the reference, because the integer payloads must
equal its codes bitwise on the same fp32 input:

  * ``quantize_rows_sym`` computes ``absmax * f32(1/qmax)``, floors it at
    1e-12, pins an all-zero row's scale to 1, then ``y / scale``, then
    rounds half to even (``torch.round``), then clips.
  * top-k orders by descending |c| with ties broken by the lower index
    first, as ``lax.top_k`` does; ``torch.topk`` promises no tie order,
    so the port takes a stable descending sort.
  * the count-sketch sums each bucket's signed features in ascending
    feature order, starting from zero (a sequential scatter-add), and its
    tables come from numpy with the reference's seed formula.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.comm import nbytes

__all__ = [
    "Codec",
    "CODECS",
    "CountSketchCodec",
    "EFCodec",
    "Int4RowCodec",
    "Int8RowCodec",
    "TopKCodec",
    "available_codecs",
    "ef_residual_update",
    "get_codec",
    "quantize_rows_sym",
    "register",
    "sketch_tables",
]


def _rows(shape) -> int:
    return int(np.prod(shape[:-1])) if len(shape) > 1 else 1


class Codec:
    """Base wire codec. Subclasses define the representation of z."""

    name: str = "abstract"
    has_state: bool = False  # True for EF-style codecs carrying a residual

    def encode(self, z: torch.Tensor):
        raise NotImplementedError

    def decode(self, payload, *, shape: Optional[Tuple[int, ...]] = None,
               dtype=None) -> torch.Tensor:
        raise NotImplementedError

    # ---- optional state API (EF residuals); stateless by default ----

    def init_state(self, shape: Tuple[int, ...], dtype=torch.float32,
                   device=None):
        """Initial per-client codec state: none for stateless codecs."""
        return ()

    def encode_with_state(self, z: torch.Tensor, state):
        """Encode one round's z given carried state -> (payload, state')."""
        return self.encode(z), state

    # ---- the fused (kernel) encode path ------------------------------

    def fused_encode(self, z: torch.Tensor):
        """Encode z through the ``wire_encode`` kernel, or None when the
        codec has no wire scheme at this shape. The payload equals
        ``encode(z)`` (leaf names, shapes, dtypes; integer codes
        bitwise)."""
        from repro_torch.kernels import ops

        return ops.wire_encode(z, self)

    def fused_encode_with_state(self, z: torch.Tensor, state):
        """Stateful twin of ``fused_encode`` -> (payload, state') or
        None. Stateless codecs pass the state through."""
        payload = self.fused_encode(z)
        return None if payload is None else (payload, state)

    # ---- byte accounting ----

    def wire_bytes(self, payload) -> int:
        return nbytes(payload)

    def encoded_nbytes(self, shape: Tuple[int, ...]) -> int:
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.name!r})"


@dataclass(frozen=True, repr=False)
class IdentityCodec(Codec):
    """fp32 baseline: ship z exactly as produced."""

    name: str = "fp32"

    def encode(self, z):
        return {"z": z}

    def decode(self, payload, *, shape=None, dtype=None):
        z = payload["z"]
        return z if dtype is None else z.to(dtype)

    def encoded_nbytes(self, shape):
        return int(np.prod(shape)) * 4


@dataclass(frozen=True, repr=False)
class CastCodec(Codec):
    """Lossy dtype cast (bf16 / fp16): 2x fewer wire bytes, no sidecar."""

    name: str = "bf16"
    wire_dtype: str = "bfloat16"

    def encode(self, z):
        return {"z": z.to(getattr(torch, self.wire_dtype))}

    def decode(self, payload, *, shape=None, dtype=None):
        return payload["z"].to(dtype or torch.float32)

    def encoded_nbytes(self, shape):
        return int(np.prod(shape)) * getattr(torch, self.wire_dtype).itemsize


_INV_255 = float(np.float32(1.0 / 255.0))


@dataclass(frozen=True, repr=False)
class Int8AffineCodec(Codec):
    """Affine int8: q = round((z - min) / scale) - 128, with one fp32
    (scale, zero) pair per tensor, or per fusion feature
    (``per_channel``)."""

    name: str = "int8"
    per_channel: bool = False

    def encode(self, z):
        zf = z.float()
        if self.per_channel:
            axes = tuple(range(zf.dim() - 1))
            zmin, zmax = zf.amin(dim=axes), zf.amax(dim=axes)
        else:
            zmin, zmax = zf.min(), zf.max()
        # The reference divides by 255.0 in its source, but its exchange
        # runs the encode jitted, where XLA rewrites a division by a
        # constant into a multiply by its f32 reciprocal: the port writes
        # that multiply, so the codes match the reference's trainer.
        scale = torch.clamp_min((zmax - zmin) * _INV_255, 1e-12)
        q = torch.round((zf - zmin) / scale) - 128.0
        q = torch.clamp(q, -128, 127).to(torch.int8)
        return {"q": q, "scale": scale, "zero": zmin}

    def decode(self, payload, *, shape=None, dtype=None):
        q = payload["q"].float()
        z = (q + 128.0) * payload["scale"] + payload["zero"]
        return z.to(dtype or torch.float32)

    def encoded_nbytes(self, shape):
        sidecar = (shape[-1] if self.per_channel else 1) * 2 * 4
        return int(np.prod(shape)) * 1 + sidecar


def quantize_rows_sym(y: torch.Tensor, qmax: int = 127):
    """Symmetric per-row absmax quantization: q = round(y / (absmax/qmax)).

    The single definition of the symmetric row schemes (``int8_row``,
    ``int4``), in the reference's order of operations: ``absmax *
    f32(1/qmax)`` (the reciprocal rounded from the double, as the
    reference writes it), floored at 1e-12; an all-zero row's scale is
    1; then ``y / scale``, round half to even, clip.
    -> (q int8 in [-qmax, qmax], scale fp32 (..., 1))."""
    yf = y.float()
    absmax = yf.abs().amax(dim=-1, keepdim=True)
    inv_qmax = float(np.float32(1.0 / qmax))
    scale = torch.where(absmax > 0.0,
                        torch.clamp_min(absmax * inv_qmax, 1e-12),
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(yf / scale), -qmax, qmax).to(torch.int8)
    return q, scale


def ef_residual_update(zf: torch.Tensor, c: torch.Tensor,
                       z_hat: torch.Tensor,
                       max_ratio: Optional[float]) -> torch.Tensor:
    """EF21 residual e' = c - z_hat with the per-row trust-region clip
    ``min(1, max_ratio * ||z|| / max(||e'||, 1e-12))``."""
    e = c - z_hat
    if max_ratio is not None and np.isfinite(max_ratio):
        z_norm = torch.linalg.vector_norm(zf, dim=-1, keepdim=True)
        e_norm = torch.linalg.vector_norm(e, dim=-1, keepdim=True)
        e = e * torch.clamp_max(
            max_ratio * z_norm / torch.clamp_min(e_norm, 1e-12), 1.0)
    return e


@dataclass(frozen=True, repr=False)
class Int8RowCodec(Codec):
    """Symmetric per-row absmax int8 (see ``quantize_rows_sym``)."""

    name: str = "int8_row"

    def encode(self, z):
        q, scale = quantize_rows_sym(z)
        return {"q": q, "scale": scale}

    def decode(self, payload, *, shape=None, dtype=None):
        z = payload["q"].float() * payload["scale"]
        return z.to(dtype or torch.float32)

    def encoded_nbytes(self, shape):
        return int(np.prod(shape)) * 1 + _rows(shape) * 4


@dataclass(frozen=True, repr=False)
class TopKCodec(Codec):
    """Magnitude top-k along the fusion dim; values fp32 + int32 indices,
    in descending |z| order, ties by ascending index (``lax.top_k``'s)."""

    name: str = "topk"
    ratio: float = 0.25

    def k_of(self, d: int) -> int:
        return max(1, min(d, int(round(self.ratio * d))))

    def encode(self, z):
        zf = z.float()
        d = zf.shape[-1]
        k = self.k_of(d)
        flat = zf.reshape(-1, d)
        order = torch.sort(flat.abs(), dim=-1, descending=True,
                           stable=True).indices[:, :k]
        vals = torch.gather(flat, -1, order)
        lead = tuple(z.shape[:-1])
        return {"values": vals.reshape(*lead, k),
                "indices": order.to(torch.int32).reshape(*lead, k)}

    def decode(self, payload, *, shape=None, dtype=None):
        if shape is None:
            raise ValueError("topk decode requires the original z shape")
        vals, idx = payload["values"], payload["indices"]
        rows, k = _rows(shape), vals.shape[-1]
        flat = torch.zeros((rows, shape[-1]), dtype=torch.float32,
                           device=vals.device)
        flat.scatter_(1, idx.reshape(rows, k).long(), vals.reshape(rows, k))
        return flat.reshape(shape).to(dtype or torch.float32)

    def encoded_nbytes(self, shape):
        return _rows(shape) * self.k_of(shape[-1]) * (4 + 4)


@dataclass(frozen=True, repr=False)
class Int4RowCodec(Codec):
    """Packed symmetric per-row absmax int4 (qmax 7), two nibbles per byte
    (``u = q + 8``; low nibble = even column), fp32 scale per row. An odd
    d is padded with a zero column, which packs as nibble 8."""

    name: str = "int4"

    def encode(self, z):
        q, scale = quantize_rows_sym(z, qmax=7)
        if q.shape[-1] % 2:
            q = torch.nn.functional.pad(q, (0, 1))  # zero nibble
        u = (q + 8).to(torch.uint8)  # [-7,7] -> [1,15]; pad -> 8
        packed = u[..., 0::2] | (u[..., 1::2] << 4)
        return {"q4": packed, "scale": scale}

    def decode(self, payload, *, shape=None, dtype=None):
        if shape is None:
            raise ValueError("int4 decode requires the original z shape")
        packed, scale = payload["q4"], payload["scale"]
        lo = (packed & 0xF).to(torch.int32) - 8
        hi = (packed >> 4).to(torch.int32) - 8
        q = torch.stack([lo, hi], dim=-1).reshape(
            *packed.shape[:-1], packed.shape[-1] * 2)
        z = q[..., : shape[-1]].float() * scale
        return z.to(dtype or torch.float32)

    def encoded_nbytes(self, shape):
        rows = _rows(shape)
        return rows * ((shape[-1] + 1) // 2) + rows * 4


@functools.lru_cache(maxsize=256)
def sketch_tables(d: int, w: int, seed: int):
    """(hash, sign, 1/bucket-count, bucket order, bucket pointers) of a
    (d -> w) sketch, in numpy, from the reference's seed formula.

    ``order`` lists the feature indices bucket by bucket, ascending
    within a bucket, and bucket b owns ``order[ptr[b]:ptr[b + 1]]``: the
    order in which a sequential scatter-add sums them."""
    rng = np.random.default_rng(seed + 1_000_003 * d + w)
    h = rng.integers(0, w, size=d)
    s = (rng.integers(0, 2, size=d) * 2 - 1).astype(np.float32)
    raw_counts = np.bincount(h, minlength=w)
    inv_counts = (1.0 / np.maximum(raw_counts, 1)).astype(np.float32)
    order = np.argsort(h, kind="stable").astype(np.int32)
    ptr = np.concatenate([[0], np.cumsum(raw_counts)]).astype(np.int32)
    return h.astype(np.int32), s, inv_counts, order, ptr


@functools.lru_cache(maxsize=64)
def sketch_device_tables(d: int, w: int, seed: int, device: str):
    """``sketch_tables`` as tensors on ``device``, made once per device:
    sign, inv_counts (fp32), hash, order, ptr (int32), and ``slots``, the
    (w, max bucket size) int64 feature indices of each bucket, ascending,
    padded with ``d`` (a zero column appended to the signed features).
    Cached so that an encode on the card copies nothing from the host."""
    h, s, inv, order, ptr = sketch_tables(d, w, seed)
    counts = np.diff(ptr)
    slots = np.full((w, max(int(counts.max()), 1)), d, np.int64)
    for b in range(w):
        slots[b, : counts[b]] = order[ptr[b]: ptr[b + 1]]
    return {name: torch.from_numpy(a).to(device) for name, a in
            (("sign", s), ("inv_counts", inv), ("hash", h), ("order", order),
             ("ptr", ptr), ("slots", slots))}


@dataclass(frozen=True, repr=False)
class CountSketchCodec(Codec):
    """Count-sketch along the fusion dim: w = round(ratio * d) signed
    bucket sums per row; bucket-mean decode
    z_hat[i] = s(i) * sketch[h(i)] / |bucket h(i)|. The tables come from
    (d, w, shared seed), so nothing but the buckets crosses the wire."""

    name: str = "sketch"
    ratio: float = 0.25
    seed: int = 0x5EED

    def w_of(self, d: int) -> int:
        return max(1, min(d, int(round(self.ratio * d))))

    def encode(self, z):
        zf = z.float()
        d = zf.shape[-1]
        w = self.w_of(d)
        t = sketch_device_tables(d, w, self.seed, str(zf.device))
        flat = (zf * t["sign"]).reshape(-1, d)
        ext = torch.nn.functional.pad(flat, (0, 1))  # column d is zero
        # Sum each bucket in ascending feature order from +0.0, one
        # column of ``slots`` at a time: a sequential scatter-add's order
        # (adding the zero pad is exact).
        sk = torch.zeros((flat.shape[0], w), dtype=torch.float32,
                         device=zf.device)
        for j in range(t["slots"].shape[1]):
            sk = sk + ext[:, t["slots"][:, j]]
        return {"sketch": sk.reshape(*z.shape[:-1], w)}

    def decode(self, payload, *, shape=None, dtype=None):
        if shape is None:
            raise ValueError("sketch decode requires the original z shape")
        d = shape[-1]
        sk = payload["sketch"]
        t = sketch_device_tables(d, self.w_of(d), self.seed, str(sk.device))
        vals = sk * t["inv_counts"]  # bucket means
        zh = vals[..., t["hash"].long()] * t["sign"]
        return zh.reshape(shape).to(dtype or torch.float32)

    def encoded_nbytes(self, shape):
        return _rows(shape) * self.w_of(shape[-1]) * 4


@dataclass(frozen=True, repr=False)
class EFCodec(Codec):
    """EF21 error feedback around any inner codec.

    Per client, per round: c = z + e; payload = inner.encode(c);
    e' = c - inner.decode(payload), clipped per row to
    ``max_ratio * ||z||`` (``ef_residual_update``). The wire format is
    exactly the inner codec's, so byte accounting delegates."""

    inner: Codec = None
    name: str = ""
    max_ratio: float = 0.3
    has_state = True

    def __post_init__(self):
        if not self.name:
            object.__setattr__(self, "name", f"ef({self.inner.name})")

    def encode(self, z):
        return self.inner.encode(z)

    def decode(self, payload, *, shape=None, dtype=None):
        return self.inner.decode(payload, shape=shape, dtype=dtype)

    def init_state(self, shape, dtype=torch.float32, device=None):
        return torch.zeros(shape, dtype=dtype, device=device)

    def encode_with_state(self, z, state):
        zf = z.float()
        c = zf + state
        payload = self.inner.encode(c)
        z_hat = self.inner.decode(payload, shape=tuple(c.shape),
                                  dtype=torch.float32)
        return payload, ef_residual_update(zf, c, z_hat, self.max_ratio)

    # The stateless wire format IS the inner codec's; the stateful fused
    # encode is the EF21 epilogue kernel (``wire_encode_ef``).

    def fused_encode(self, z):
        return self.inner.fused_encode(z)

    def fused_encode_with_state(self, z, state):
        from repro_torch.kernels import ops

        return ops.wire_encode_ef(z, state, self)

    def encoded_nbytes(self, shape):
        return self.inner.encoded_nbytes(shape)


# ------------------------------------------------------------------ registry


CODECS: Dict[str, Codec] = {}


def register(codec: Codec) -> Codec:
    CODECS[codec.name] = codec
    return codec


register(IdentityCodec())
register(CastCodec("bf16", "bfloat16"))
register(CastCodec("fp16", "float16"))
register(Int8AffineCodec("int8", per_channel=False))
register(Int8AffineCodec("int8_channel", per_channel=True))
register(Int8RowCodec())
register(TopKCodec())
register(Int4RowCodec())
register(CountSketchCodec())


def available_codecs() -> Tuple[str, ...]:
    return tuple(sorted(CODECS))


def _ratio(spec: str, prefix: str) -> Optional[float]:
    try:
        r = float(spec[len(prefix):])
    except ValueError:
        return None
    return r if 0.0 < r <= 1.0 else None


def get_codec(codec: Union[str, Codec, None]) -> Codec:
    """Resolve a codec name (or pass a Codec through): a registered
    name, ``topk<r>``, ``sketch<r>``, or ``ef(<codec>)``."""
    if codec is None:
        return CODECS["fp32"]
    if isinstance(codec, Codec):
        return codec
    if codec in CODECS:
        return CODECS[codec]
    if codec.startswith("ef(") and codec.endswith(")"):
        return EFCodec(inner=get_codec(codec[len("ef("):-1]))
    if codec.startswith("topk") and _ratio(codec, "topk") is not None:
        return TopKCodec(name=codec, ratio=_ratio(codec, "topk"))
    if codec.startswith("sketch") and _ratio(codec, "sketch") is not None:
        return CountSketchCodec(name=codec, ratio=_ratio(codec, "sketch"))
    raise ValueError(
        f"unknown codec {codec!r}; available: {available_codecs()} "
        "(or 'topk<ratio>' e.g. topk0.1, 'sketch<ratio>' e.g. sketch0.25, "
        "or 'ef(<codec>)' e.g. ef(int4))"
    )
