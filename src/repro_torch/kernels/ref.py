"""Plain PyTorch versions of the port's kernels (the ground truth the
kernels are held against, and what the wrappers run on CPU tensors)."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.codec import quantize_rows_sym

# The mask value of the TPU kernel (kernels/flash_attention.py:25).
NEG = -1e30


def cached_attn_decode_ref(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, valid: torch.Tensor,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Single-token attention against a KV cache, the plain version of
    the ``flash_decode`` kernel.

    q: (B, 1, KVH, G, hd) grouped query (G = H / KVH); k, v: (B, L, KVH,
    hd) cache in the model's layout; valid: (B, L) bool, which cache rows
    are live for each batch row (causality and the ring-buffer window
    already folded in). Returns (B, 1, KVH, G, hd) in ``q.dtype``.

    Scores, probabilities and the weighted sum are fp32, and the sum is
    divided by the softmax denominator at the end, as the kernel does. A
    fully masked row gives **zeros**, as the TPU kernel
    ``flash_decode_pallas`` flushes them; the JAX package's jnp oracle
    returns the mean of v there instead. On the serving path such rows
    occur only in unoccupied or not-yet-admitted slots (every
    ``slot_pos`` still -1), whose outputs are discarded; an occupied
    slot always has its just-written row valid.
    """
    hd = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float()) * scale
    mask = valid[:, None, None, None, :]
    s = torch.where(mask, s, NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * mask
    denom = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgqs,bskh->bkgqh", p, v.float())
    out = acc / denom.clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


def flash_decode_split_ref(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, valid: torch.Tensor, *,
                           splits, tile: int,
                           scale: Optional[float] = None) -> torch.Tensor:
    """The ``flash_decode`` kernel's split-and-merge arithmetic in plain
    PyTorch, for the tests: the same function as
    ``cached_attn_decode_ref`` (same arguments and layout), summed in
    the kernel's order. ``splits`` is (S, chunk): split s takes cache
    rows [s * chunk, (s + 1) * chunk) and walks them ``tile`` rows at a
    time, keeping a running fp32 (m, l, acc) rescaled once a tile; the
    S partials merge as w_s = exp(m_s - max m), out = sum w_s acc_s /
    max(sum w_s l_s, 1e-30). A split with no live row has m = NEG, l = 0
    and merges as nothing; a fully masked row gives zeros."""
    B, _, KVH, G, hd = q.shape
    L = k.shape[1]
    S, chunk = splits
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qf = q[:, 0].float()                                 # (B, KVH, G, hd)
    parts = []
    for s in range(S):
        m = torch.full((B, KVH, G), NEG, device=q.device)
        l = torch.zeros((B, KVH, G), device=q.device)
        acc = torch.zeros((B, KVH, G, hd), device=q.device)
        for t0 in range(s * chunk, min(L, (s + 1) * chunk), tile):
            t1 = min(L, (s + 1) * chunk, t0 + tile)
            sc = torch.einsum("bkgh,bskh->bkgs", qf,
                              k[:, t0:t1].float()) * scale
            live = valid[:, None, None, t0:t1]
            m_new = torch.maximum(m, torch.where(live, sc, NEG).amax(-1))
            p = torch.where(live, torch.exp(sc - m_new[..., None]), 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgs,bskh->bkgh", p, v[:, t0:t1].float())
            m = m_new
        parts.append((m, l, acc))
    top = torch.stack([m for m, _, _ in parts]).amax(0)
    den = torch.zeros_like(top)
    num = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        w = torch.exp(m - top)
        den = den + w * l
        num = num + w[..., None] * acc
    out = num / den.clamp_min(1e-30)[..., None]
    return out[:, None].to(q.dtype)


def wire_encode_ref(z: torch.Tensor, codec) -> dict:
    """The plain version of the ``wire_encode`` kernel: the codec's own
    encode ops (``repro_torch.core.codec``), whose order of operations,
    top-k tie order and sketch sum order the kernel reproduces."""
    return codec.encode(z)


def wire_encode_ef_ref(z: torch.Tensor, e: torch.Tensor, ef_codec):
    """The plain version of the ``wire_encode_ef`` kernel: the EF codec's
    ``encode_with_state`` -> (payload, e')."""
    return ef_codec.encode_with_state(z, e)


def _bias_act(y: torch.Tensor, b: Optional[torch.Tensor],
              act: str) -> torch.Tensor:
    if b is not None:
        y = y + b.float()
    if act == "relu":
        return torch.relu(y)
    if act == "silu":
        return F.silu(y)
    if act != "none":
        raise ValueError(act)
    return y


def _proj(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
          act: str) -> torch.Tensor:
    """act(x @ w + b) in fp32: the product of the fp32-widened inputs."""
    return _bias_act(torch.matmul(x.float(), w.float()), b, act)


def fusion_proj_ref(x: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor] = None,
                    act: str = "none") -> torch.Tensor:
    """The fusion-layer projection act(x @ w + b), the plain version of
    the ``fusion_proj`` kernel (a port of ``repro/kernels/ref.py:12``).
    x: (..., K), w: (K, N), b: (N,); act in {none, relu, silu}. The
    product accumulates in fp32; the output takes x's dtype."""
    return _proj(x, w, b, act).to(x.dtype)


def fusion_proj_quant_ref(x: torch.Tensor, w: torch.Tensor,
                          b: Optional[torch.Tensor] = None,
                          act: str = "none"):
    """The projection with the int8_row encode, the plain version of the
    ``fusion_proj_quant`` kernel (``repro/kernels/ref.py:28``):
    ``quantize_rows_sym`` of the fp32 projection -> (q int8 (..., N),
    scale fp32 (..., 1))."""
    return quantize_rows_sym(_proj(x, w, b, act))


def fusion_proj_encode_ref(x: torch.Tensor, w: torch.Tensor,
                           b: Optional[torch.Tensor] = None,
                           act: str = "none", *, codec,
                           e: Optional[torch.Tensor] = None):
    """The projection, then the codec's own encode, the plain version of
    the ``fusion_proj_encode`` kernel (``repro/kernels/ref.py:50``): the
    fp32 activation is materialized and encoded by ``codec.encode``, or
    by ``codec.encode_with_state`` with the EF residual ``e``.
    -> payload, or (payload, e')."""
    y = fusion_proj_ref(x, w, b, act).float()
    if e is not None:
        return codec.encode_with_state(y, e)
    return codec.encode(y)


def decode_proj_ref(payload, w: torch.Tensor,
                    b: Optional[torch.Tensor] = None, act: str = "none", *,
                    codec, shape):
    """The codec's decode, then the projection, the plain version of the
    ``decode_proj`` kernel (``repro/kernels/ref.py:65``):
    act(codec.decode(payload) @ w + b) with the fp32 reconstruction
    materialized. ``shape`` is z's shape; -> (*shape[:-1], N) fp32."""
    z_hat = codec.decode(payload, shape=tuple(shape), dtype=torch.float32)
    return fusion_proj_ref(z_hat.reshape(-1, shape[-1]), w, b, act).reshape(
        *shape[:-1], w.shape[-1])


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = -1,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain causal (or bidirectional, ``causal=False``), optionally
    sliding-window softmax attention, the plain version of the
    ``flash_attention`` kernel (a port of ``repro/kernels/ref.py:79``
    that takes GQA K/V directly).

    q: (B, S, H, hd); k: (B, S, KVH, hd); v: (B, S, KVH, hdv) with
    H % KVH == 0, the model's layout; v's head dim may differ from q's
    and k's (MLA). Returns (B, S, H, hdv) in ``q.dtype``. ``scale``
    defaults to 1 / sqrt(hd).

    Scores, softmax and the weighted sum are fp32. The probabilities are
    rounded to v's dtype before the PV product, as the TPU kernel does;
    the rounding is straight-through for autograd, so the gradient is
    the one of the unrounded softmax, which is what the backward kernel
    computes (FlashAttention-2 recomputes P in fp32). A fully masked row
    gives zeros, as the TPU kernel flushes them.
    """
    B, S, H, hd = q.shape
    g = H // k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    qi = torch.arange(S, device=q.device)[:, None]
    ki = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window > 0:
        mask &= ki > qi - window
    s = torch.where(mask, s, NEG)
    m = s.amax(dim=-1, keepdim=True).detach()
    p = torch.exp(s - m) * mask
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    p = p / denom
    p = p + (p.to(v.dtype).float() - p).detach()
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    return out.to(q.dtype)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, do: torch.Tensor, *,
                            causal: bool = True, window: int = -1,
                            scale: Optional[float] = None):
    """The plain version of the ``flash_attention_bwd`` kernel: autograd
    of ``flash_attention_ref`` -> (dq, dk, dv) in the inputs' dtypes. dk
    and dv sum the G query heads that share a KV head."""
    with torch.enable_grad():
        qa, ka, va = (t.detach().requires_grad_() for t in (q, k, v))
        out = flash_attention_ref(qa, ka, va, causal=causal, window=window,
                                  scale=scale)
        return torch.autograd.grad(out, (qa, ka, va), do)


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim, the plain version of the ``rmsnorm``
    kernel (a port of ``repro/kernels/ref.py:121``): x (M, D), scale (D,)
    -> (M, D) in x's dtype. fp32 inside, in the order of the port's
    inline norm (``models/modules.py`` ``apply_norm``): x * rsqrt(mean
    x^2 + eps), then times the scale, rounded once at the end."""
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)
