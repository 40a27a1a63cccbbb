"""Attention: GQA (windowed, NoPE, biased, with gemma3's per-head
qk-norm, RoPE or qwen2-vl's M-RoPE), MLA (multi-head latent attention,
deepseek-v3 [arXiv:2412.19437]) and the encoder-decoder's bidirectional
attention: init, full-sequence causal attention for training
(``blocked_attention``, ``attn_forward``), the decode cache and the
single-token decode step; the encoder's self-attention
(``enc_self_attn_forward``) and the decoder's cross-attention over the
encoder output (``cross_attn_forward``, its per-layer K/V cache
``cross_attn_cache`` and ``cross_attn_decode``).

The encoder's self-attention has q and k of one length, so on the card
it runs on the ``flash_attention`` kernels in their non-causal mode (the
TPU kernel's ``causal=False``); on the CPU it is the reference's
``bidir_blocked_attention``. Cross-attention (S_dec queries against S_enc
keys, a shape the kernel does not take) is ``bidir_blocked_attention`` on
either device: plain PyTorch, as the reference's is plain ``jnp``.

MLA trains and prefills in the expanded form: q and k of head dim
nope + rope (192 at deepseek-v3's widths), v of its own head dim (128),
scale 1 / sqrt(nope + rope), through the same ``blocked_attention`` (on
the card the ``flash_attention`` kernels, which take v's head dim apart
from q's). It decodes in the absorbed form over the compressed
``{"ckv", "krope"}`` cache (kv_lora + rope = 576 values a token at full
width): an MQA over the latent that no kernel of the repo takes, plain
PyTorch here as it is plain ``jnp`` in the reference.

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
from repro_torch.models.rope import apply_mrope, apply_rope


def init_attn(generator, cfg: ModelConfig, spec: LayerSpec, *, device=None,
              lead=(), dtype=torch.float32):
    if cfg.use_mla:
        return _init_mla(generator, cfg, device=device, lead=lead,
                         dtype=dtype)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    kw = dict(device=device, lead=lead, dtype=dtype)
    p = {
        "wq": nn.init_linear(generator, d, h * hd, bias=cfg.qkv_bias, **kw),
        "wk": nn.init_linear(generator, d, kvh * hd, bias=cfg.qkv_bias, **kw),
        "wv": nn.init_linear(generator, d, kvh * hd, bias=cfg.qkv_bias, **kw),
        "wo": nn.init_linear(generator, h * hd, d, **kw),
    }
    if cfg.use_qk_norm:  # per-head RMSNorm of q and k, unit scales
        for name in ("q_norm", "k_norm"):
            p[name] = {"scale": torch.ones((*lead, hd), device=device,
                                           dtype=dtype)}
    return p


def init_cross_attn(generator, cfg: ModelConfig, *, device=None, lead=(),
                    dtype=torch.float32):
    """The encoder's self-attention and the decoder's cross-attention:
    H heads for q, k and v alike (no GQA), no bias."""
    d, hd, h = cfg.d_model, cfg.resolved_head_dim, cfg.num_heads
    kw = dict(device=device, lead=lead, dtype=dtype)
    return {name: nn.init_linear(generator, *dims, **kw)
            for name, dims in (("wq", (d, h * hd)), ("wk", (d, h * hd)),
                               ("wv", (d, h * hd)), ("wo", (h * hd, d)))}


def _project_qkv(p, cfg: ModelConfig, spec: LayerSpec, x, positions):
    """q, k, v of x (B, S, d): qk-norm per head (where the layer has it),
    then RoPE, M-RoPE (positions (3, B, S)) or none. positions: (B, S)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = nn.linear(p["wq"], x).reshape(B, S, cfg.num_heads, hd)
    k = nn.linear(p["wk"], x).reshape(B, S, cfg.num_kv_heads, hd)
    v = nn.linear(p["wv"], x).reshape(B, S, cfg.num_kv_heads, hd)
    if "q_norm" in p:
        q = nn.apply_norm(p["q_norm"], q, "rmsnorm")
        k = nn.apply_norm(p["k_norm"], k, "rmsnorm")
    if spec.use_rope and cfg.rope_type == "mrope":
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    elif spec.use_rope and cfg.rope_type != "none":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


# The mask value of the reference's blocked path (attention.py:29).
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _gqa_block(q, k, v, q_idx=None, k_idx=None, *, window: int = -1,
               scale: float, causal: bool = True):
    """One query block against a KV span, fp32 softmax.

    q: (B, qb, KVH, G, hd); k, v: (B, L, KVH, hd); q_idx: (qb,) and
    k_idx: (L,) the global token indices of the rows. ``causal=False``:
    no mask at all (the indices and the window are not read).
    """
    s = torch.einsum("bqkgh,bskh->bkgqs", q, k).float() * scale
    if causal:
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

    CUDA (and meta) tensors: the ``flash_attention`` kernels, for any
    S. CPU tensors: the reference's blocked path, which needs S
    divisible by ``min(q_block, S)``."""
    if q.device.type != "cpu":
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
    (B, S) int, or (3, B, S) under M-RoPE."""
    if cfg.use_mla:
        return _mla_forward(p, cfg, x, positions)
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, cfg, spec, x, positions)
    out = blocked_attention(q, k, v, window=spec.window, q_block=cfg.q_block)
    return nn.linear(p["wo"], out.reshape(B, S, -1))


def init_attn_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                    cache_len: int, dtype, *, device=None, lead=()) -> dict:
    """Zeroed cache. Windowed layers get a ring buffer of len window.
    ``slot_pos`` (-1 = empty) records the position each slot holds. An
    MLA layer caches the compressed latent and the rotated shared key
    instead, ``{"ckv": (B, L, kv_lora), "krope": (B, L, rope)}``, which
    a position indexes directly (no ``slot_pos``)."""
    if cfg.use_mla:
        return {
            "ckv": torch.zeros((*lead, batch, cache_len, cfg.kv_lora_rank),
                               dtype=dtype, device=device),
            "krope": torch.zeros((*lead, batch, cache_len,
                                  cfg.qk_rope_head_dim),
                                 dtype=dtype, device=device),
        }
    L = min(cache_len, spec.window) if spec.window > 0 else cache_len
    shape = (*lead, batch, L, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "slot_pos": torch.full((*lead, batch, L), -1, dtype=torch.long,
                               device=device),
    }


def attn_decode(p, cfg: ModelConfig, spec: LayerSpec, x, cache, pos,
                live: Optional[torch.Tensor] = None, positions=None):
    """One token per row. x: (B, 1, d); pos: (B,) int, each row's
    position; cache: {"k", "v": (B, L, KVH, hd), "slot_pos": (B, L)};
    ``positions`` the rotary ids when they are not ``pos`` (M-RoPE's
    (3, B, 1)).

    Writes this token's k, v and position into the cache **in place**
    (the JAX package returns a new cache; updating in place saves a copy
    of the cache per layer and token). Rows where ``live`` is False are
    not written, so a padded prefill step leaves their cache untouched.
    Returns y: (B, 1, d).
    """
    if cfg.use_mla:
        return _mla_decode(p, cfg, x, cache, pos, live)
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    q, k, v = _project_qkv(p, cfg, spec, x,
                           pos[:, None] if positions is None else positions)
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


# =========================================================================
# MLA (DeepSeek-V3) [arXiv:2412.19437]
# =========================================================================


def _init_mla(generator, cfg: ModelConfig, *, device=None, lead=(),
              dtype=torch.float32):
    d, h = cfg.d_model, cfg.num_heads
    qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    kw = dict(device=device, lead=lead, dtype=dtype)

    def norm(n):
        return {"scale": torch.ones((*lead, n), device=device, dtype=dtype)}

    p = {}
    if cfg.q_lora_rank > 0:
        p["wq_a"] = nn.init_linear(generator, d, cfg.q_lora_rank, **kw)
        p["q_a_norm"] = norm(cfg.q_lora_rank)
        p["wq_b"] = nn.init_linear(generator, cfg.q_lora_rank, h * qk, **kw)
    else:
        p["wq"] = nn.init_linear(generator, d, h * qk, **kw)
    p["wkv_a"] = nn.init_linear(generator, d,
                                cfg.kv_lora_rank + cfg.qk_rope_head_dim, **kw)
    p["kv_a_norm"] = norm(cfg.kv_lora_rank)
    p["wkv_b"] = nn.init_linear(
        generator, cfg.kv_lora_rank,
        h * (cfg.qk_nope_head_dim + cfg.v_head_dim), **kw)
    p["wo"] = nn.init_linear(generator, h * cfg.v_head_dim, d, **kw)
    return p


def _mla_q(p, cfg: ModelConfig, x):
    """x: (B, S, d) -> (q_nope (B, S, h, nope), q_rope (B, S, h, rope)),
    through the q LoRA (``wq_a``, rmsnorm, ``wq_b``) or plain ``wq``."""
    B, S, _ = x.shape
    qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    if "wq_a" in p:
        ql = nn.apply_norm(p["q_a_norm"], nn.linear(p["wq_a"], x), "rmsnorm")
        q = nn.linear(p["wq_b"], ql)
    else:
        q = nn.linear(p["wq"], x)
    q = q.reshape(B, S, cfg.num_heads, qk)
    return q[..., :cfg.qk_nope_head_dim], q[..., cfg.qk_nope_head_dim:]


def _mla_latent(p, cfg: ModelConfig, x, positions):
    """x: (B, S, d) -> (ckv (B, S, kv_lora) normed, krope (B, S, rope)
    rotated), both in x's dtype: what the decode cache holds."""
    kv = nn.linear(p["wkv_a"], x)
    ckv = nn.apply_norm(p["kv_a_norm"], kv[..., :cfg.kv_lora_rank],
                        "rmsnorm")
    krope = apply_rope(kv[..., cfg.kv_lora_rank:][:, :, None, :], positions,
                       cfg.rope_theta)[:, :, 0]
    return ckv.to(x.dtype), krope.to(x.dtype)


def mla_scale(cfg: ModelConfig) -> float:
    return 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


def _mla_forward(p, cfg: ModelConfig, x, positions):
    """Expanded (non-absorbed) MLA for training and full prefill: per
    head q, k of dim nope + rope, v of dim v_head_dim."""
    B, S, _ = x.shape
    h, nope, rope = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    qn, qr = _mla_q(p, cfg, x)
    qr = apply_rope(qr, positions, cfg.rope_theta)
    ckv, krope = _mla_latent(p, cfg, x, positions)
    kvb = nn.linear(p["wkv_b"], ckv).reshape(B, S, h, nope + cfg.v_head_dim)
    kn, v = kvb[..., :nope], kvb[..., nope:]
    q = torch.cat([qn, qr], dim=-1)
    k = torch.cat([kn, krope[:, :, None].expand(B, S, h, rope)], dim=-1)
    out = blocked_attention(q, k, v, q_block=cfg.q_block,
                            scale=mla_scale(cfg))
    return nn.linear(p["wo"], out.reshape(B, S, -1))


def _mla_decode(p, cfg: ModelConfig, x, cache, pos,
                live: Optional[torch.Tensor] = None):
    """Absorbed MLA decode, one token per row: scores and values live in
    the latent space, so a token costs O(L * (kv_lora + rope)) and the
    cache stays compressed. x: (B, 1, d); pos: (B,) int; cache:
    {"ckv": (B, L, kv_lora), "krope": (B, L, rope)}, written in place at
    each live row's position (clamped to L - 1, as the reference's
    ``dynamic_update_slice`` clamps). Returns y: (B, 1, d)."""
    B = x.shape[0]
    h, nope = cfg.num_heads, cfg.qk_nope_head_dim
    positions = pos[:, None]
    qn, qr = _mla_q(p, cfg, x)  # (B, 1, h, nope), (B, 1, h, rope)
    qr = apply_rope(qr, positions, cfg.rope_theta)
    ckv_t, krope_t = _mla_latent(p, cfg, x, positions)  # (B, 1, .)
    ckv, krope = cache["ckv"], cache["krope"]
    L = ckv.shape[1]
    slot = torch.clamp(pos, max=L - 1)
    rows = torch.arange(B, device=x.device)
    c1, r1 = ckv_t[:, 0], krope_t[:, 0]
    if live is not None:
        c1 = torch.where(live[:, None], c1, ckv[rows, slot])
        r1 = torch.where(live[:, None], r1, krope[rows, slot])
    ckv[rows, slot] = c1
    krope[rows, slot] = r1

    # (lora, h, nope + v), or (B, lora, h, nope + v) per row.
    w = p["wkv_b"]["w"]
    wkv_b = w.reshape(*w.shape[:-1], h, nope + cfg.v_head_dim).to(x.dtype)
    w_uk, w_uv = wkv_b[..., :nope], wkv_b[..., nope:]
    if wkv_b.dim() == 4:  # per-row weights (B, lora, h, .)
        q_lat = torch.einsum("bqhn,blhn->bqhl", qn, w_uk)
    else:
        q_lat = torch.einsum("bqhn,lhn->bqhl", qn, w_uk)  # absorb k up-proj
    s = torch.einsum("bqhl,bsl->bhqs", q_lat, ckv)
    s = s + torch.einsum("bqhr,bsr->bhqs", qr, krope)
    s = s.float() * mla_scale(cfg)
    valid = torch.arange(L, device=x.device)[None, :] <= pos[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    pr = torch.softmax(s, dim=-1).to(ckv.dtype)
    o_lat = torch.einsum("bhqs,bsl->bqhl", pr, ckv)
    if wkv_b.dim() == 4:
        o = torch.einsum("bqhl,blhv->bqhv", o_lat, w_uv)
    else:
        o = torch.einsum("bqhl,lhv->bqhv", o_lat, w_uv)  # absorb v up-proj
    return nn.linear(p["wo"], o.reshape(B, 1, -1))


# =========================================================================
# The encoder's self-attention and the decoder's cross-attention
# =========================================================================


def bidir_blocked_attention(q, k, v, *, q_block: int = 512):
    """Unmasked attention, plain PyTorch on any device: the reference's
    query-blocked loop, an fp32 softmax per block (its ``+ 1e-30``
    denominator included). q: (B, S, H, hd); k, v: (B, S_kv, KVH, hd)
    -> (B, S, H, hd). An S that ``min(q_block, S)`` does not divide runs
    as one block, as in the reference."""
    B, S, H, hd = q.shape
    kvh = k.shape[2]
    g = H // kvh
    scale = 1.0 / math.sqrt(hd)
    qb = min(q_block, S)
    n_blocks = max(S // qb, 1)
    if n_blocks * qb != S:  # ragged: one block
        qb, n_blocks = S, 1
    qr = q.reshape(B, n_blocks, qb, kvh, g, hd)
    outs = [_gqa_block(qr[:, i], k, v, scale=scale, causal=False)
            for i in range(n_blocks)]
    return torch.stack(outs, dim=1).reshape(B, S, H, -1)


def _bidir_qkv(p, cfg: ModelConfig, x, kv_in):
    B, S, _ = x.shape
    hd, h = cfg.resolved_head_dim, cfg.num_heads
    q = nn.linear(p["wq"], x).reshape(B, S, h, hd)
    k = nn.linear(p["wk"], kv_in).reshape(B, kv_in.shape[1], h, hd)
    v = nn.linear(p["wv"], kv_in).reshape(B, kv_in.shape[1], h, hd)
    return q, k, v


def enc_self_attn_forward(p, cfg: ModelConfig, x):
    """The encoder's bidirectional self-attention over x (B, S_enc, d):
    the ``flash_attention`` kernels with ``causal=False`` on CUDA (and
    meta) tensors, the reference's blocked path on the CPU."""
    B, S, _ = x.shape
    q, k, v = _bidir_qkv(p, cfg, x, x)
    if x.device.type != "cpu":
        o = kops.flash_attention(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal=False)
    else:
        o = bidir_blocked_attention(q, k, v, q_block=cfg.q_block)
    return nn.linear(p["wo"], o.reshape(B, S, -1))


def cross_attn_forward(p, cfg: ModelConfig, x, enc_out):
    """x: (B, S_dec, d) attends over enc_out (B, S_enc, d), unmasked;
    plain PyTorch on any device."""
    B, S, _ = x.shape
    q, k, v = _bidir_qkv(p, cfg, x, enc_out)
    o = bidir_blocked_attention(q, k, v, q_block=cfg.q_block)
    return nn.linear(p["wo"], o.reshape(B, S, -1))


def cross_attn_cache(p, cfg: ModelConfig, enc_out) -> dict:
    """The encoder output's K and V for one cross-attention layer,
    computed once for decoding: {"k", "v": (B, S_enc, H, hd)}."""
    B, Se, _ = enc_out.shape
    hd, h = cfg.resolved_head_dim, cfg.num_heads
    return {"k": nn.linear(p["wk"], enc_out).reshape(B, Se, h, hd),
            "v": nn.linear(p["wv"], enc_out).reshape(B, Se, h, hd)}


def cross_attn_decode(p, cfg: ModelConfig, x, ccache):
    """One token per row against the cross cache. x: (B, 1, d) ->
    (B, 1, d)."""
    B = x.shape[0]
    hd, h = cfg.resolved_head_dim, cfg.num_heads
    q = nn.linear(p["wq"], x).reshape(B, 1, h, hd)
    s = torch.einsum("bqhd,bshd->bhqs", q, ccache["k"]).float()
    s = s / math.sqrt(hd)
    pr = torch.softmax(s, dim=-1).to(ccache["v"].dtype)
    o = torch.einsum("bhqs,bshd->bqhd", pr, ccache["v"])
    return nn.linear(p["wo"], o.reshape(B, 1, -1))
