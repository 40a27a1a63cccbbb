"""GQA self-attention: init, QKV projection, full-sequence causal
attention for training (``blocked_attention``, ``attn_forward``), the KV
cache and the single-token decode step. MLA, cross-attention and M-RoPE
wait for later slices.

Full-sequence attention dispatches on the device of its tensors: on the
CPU it is the reference's blocked path (a loop over ``q_block`` query
tiles with an fp32 softmax per tile, windowed layers slicing K/V to
``window + q_block``), so the CPU parity tests compare like with like;
on the card every call is the ``flash_attention`` kernel pair
(``kernels/ops.py``), forward and backward.

Every batch row carries its own position: where the JAX package vmaps a
B=1 step with a scalar ``pos`` over the W slots of a serving lane, the
port passes ``pos`` as a ``(B,)`` tensor. The cache write slot, the
cache's ``slot_pos`` (``(B, L)`` here, ``(L,)`` per B=1 slot in JAX),
the validity mask and the RoPE positions are therefore all per row.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.config import LayerSpec, ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import modules as nn
from repro_torch.models.rope import apply_rope


def init_attn(generator, cfg: ModelConfig, spec: LayerSpec, *, device=None,
              lead=()):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    kw = dict(device=device, lead=lead)
    return {
        "wq": nn.init_linear(generator, d, h * hd, bias=cfg.qkv_bias, **kw),
        "wk": nn.init_linear(generator, d, kvh * hd, bias=cfg.qkv_bias, **kw),
        "wv": nn.init_linear(generator, d, kvh * hd, bias=cfg.qkv_bias, **kw),
        "wo": nn.init_linear(generator, h * hd, d, **kw),
    }


def _project_qkv(p, cfg: ModelConfig, spec: LayerSpec, x, positions):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = nn.linear(p["wq"], x).reshape(B, S, cfg.num_heads, hd)
    k = nn.linear(p["wk"], x).reshape(B, S, cfg.num_kv_heads, hd)
    v = nn.linear(p["wv"], x).reshape(B, S, cfg.num_kv_heads, hd)
    if spec.use_rope and cfg.rope_type != "none":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


# The mask value of the reference's blocked path (attention.py:29).
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _gqa_block(q, k, v, q_idx, k_idx, *, window: int, scale: float):
    """One query block against a KV span, fp32 softmax.

    q: (B, qb, KVH, G, hd); k, v: (B, L, KVH, hd); q_idx: (qb,) and
    k_idx: (L,) the global token indices of the rows.
    """
    s = torch.einsum("bqkgh,bskh->bkgqs", q, k).float() * scale
    mask = k_idx[None, :] <= q_idx[:, None]
    if window > 0:
        mask &= k_idx[None, :] > q_idx[:, None] - window
    s = torch.where(mask[None, None, None], s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m.detach())
    p = p / (torch.sum(p, dim=-1, keepdim=True) + 1e-30)
    return torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype), v)


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      window: int = -1, q_block: int = 512,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Causal (optionally sliding-window) attention over a full
    sequence. q: (B, S, H, hd); k, v: (B, S, KVH, hd) -> (B, S, H, hd).

    CUDA tensors: the ``flash_attention`` kernels, for any S. CPU
    tensors: the reference's blocked path, which needs S divisible by
    ``min(q_block, S)``."""
    if q.device.type == "cuda":
        return kops.flash_attention(q.contiguous(), k.contiguous(),
                                    v.contiguous(), window=window,
                                    scale=scale)
    B, S, H, hd = q.shape
    kvh = k.shape[2]
    g = H // kvh
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qb = min(q_block, S)
    n_blocks = S // qb
    if n_blocks * qb != S:
        raise ValueError(f"seq {S} not divisible by q_block {qb}")
    qr = q.reshape(B, n_blocks, qb, kvh, g, hd)
    ar = torch.arange(S, device=q.device)
    outs = []
    for qi in range(n_blocks):
        q_start = qi * qb
        q_idx = ar[q_start:q_start + qb]
        if window > 0:
            L = min(S, window + qb)
            start = min(max(q_start + qb - L, 0), S - L)
            ks, vs, k_idx = (k[:, start:start + L], v[:, start:start + L],
                             ar[start:start + L])
        else:
            ks, vs, k_idx = k, v, ar
        outs.append(_gqa_block(qr[:, qi], ks, vs, q_idx, k_idx,
                               window=window, scale=scale))
    return torch.stack(outs, dim=1).reshape(B, S, H, -1)


def attn_forward(p, cfg: ModelConfig, spec: LayerSpec, x, positions):
    """Full-sequence causal self-attention. x: (B, S, d); positions:
    (B, S) int."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, cfg, spec, x, positions)
    out = blocked_attention(q, k, v, window=spec.window, q_block=cfg.q_block)
    return nn.linear(p["wo"], out.reshape(B, S, -1))


def init_attn_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                    cache_len: int, dtype, *, device=None, lead=()) -> dict:
    """Zeroed cache. Windowed layers get a ring buffer of len window.
    ``slot_pos`` (-1 = empty) records the position each slot holds."""
    L = min(cache_len, spec.window) if spec.window > 0 else cache_len
    shape = (*lead, batch, L, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "slot_pos": torch.full((*lead, batch, L), -1, dtype=torch.long,
                               device=device),
    }


def attn_decode(p, cfg: ModelConfig, spec: LayerSpec, x, cache, pos,
                live: Optional[torch.Tensor] = None):
    """One token per row. x: (B, 1, d); pos: (B,) int, each row's
    position; cache: {"k", "v": (B, L, KVH, hd), "slot_pos": (B, L)}.

    Writes this token's k, v and position into the cache **in place**
    (the JAX package returns a new cache; updating in place saves a copy
    of the cache per layer and token). Rows where ``live`` is False are
    not written, so a padded prefill step leaves their cache untouched.
    Returns y: (B, 1, d).
    """
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    q, k, v = _project_qkv(p, cfg, spec, x, pos[:, None])
    ck, cv, spos = cache["k"], cache["v"], cache["slot_pos"]
    L = ck.shape[1]
    # Ring buffer for windowed layers; a flat cache clamps at its end.
    slot = pos % L if spec.window > 0 else torch.clamp(pos, max=L - 1)
    rows = torch.arange(B, device=x.device)
    k1, v1, p1 = k[:, 0], v[:, 0], pos
    if live is not None:
        k1 = torch.where(live[:, None, None], k1, ck[rows, slot])
        v1 = torch.where(live[:, None, None], v1, cv[rows, slot])
        p1 = torch.where(live, p1, spos[rows, slot])
    ck[rows, slot] = k1
    cv[rows, slot] = v1
    spos[rows, slot] = p1
    g = cfg.num_heads // cfg.num_kv_heads
    qh = q.reshape(B, 1, cfg.num_kv_heads, g, hd)
    valid = (spos >= 0) & (spos <= pos[:, None])
    if spec.window > 0:
        valid &= spos > (pos - spec.window)[:, None]
    o = kops.cached_attn_decode(qh, ck, cv, valid)
    return nn.linear(p["wo"], o.reshape(B, 1, -1))
