"""GQA self-attention for decode: init, QKV projection, the KV cache,
and the single-token decode step. Full-sequence attention, MLA,
cross-attention and M-RoPE wait for later slices.

Every batch row carries its own position: where the JAX package vmaps a
B=1 step with a scalar ``pos`` over the W slots of a serving lane, the
port passes ``pos`` as a ``(B,)`` tensor. The cache write slot, the
cache's ``slot_pos`` (``(B, L)`` here, ``(L,)`` per B=1 slot in JAX),
the validity mask and the RoPE positions are therefore all per row.
"""

from __future__ import annotations

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
