"""LM assembly: layer program -> {base, modular} params; the
full-sequence forward and losses that training runs (``base_forward``,
``modular_forward``, ``lm_loss``); the composed decode step and the
ragged cached prefill that serving runs.

The parameter tree is the JAX package's, key for key:

    base    = embed + prefix layers + base groups + fusion in-projection
    modular = fusion out-projection + modular groups + final norm + head

Repeated groups are stacked along a leading ``(num_groups,)`` dim and run
as a Python loop over it (``lax.scan`` in JAX). Decode caches are
stacked group-major too, ``(num_groups, B, ...)``, so one layer's K/V
cache is a contiguous ``(B, L, KVH, hd)`` block, the layout the decode
kernel reads.

The full-sequence forward checkpoints as the reference's
``jax.checkpoint`` does (``cfg.remat``: 'group' recomputes each group's
forward inside the backward, 'layer' each layer's, 'none' keeps every
activation), with ``torch.utils.checkpoint`` in its non-reentrant form.

This slice covers dense GQA decoders (the layer program with 'attn'
mixers and dense or no FFN, RoPE or NoPE, sliding windows, rmsnorm /
layernorm / nonparam_ln). Every other family raises NotImplementedError
naming the ROADMAP item that ports it. Those families are also the only
ones with an auxiliary loss (MoE routing) or extra inputs (images,
encoder frames, MTP), so the port's forward functions return just their
tensors where the reference returns ``(..., aux)`` with aux == 0 here.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.config import LayerSpec, ModelConfig
from repro_torch.models import modules as nn
from repro_torch.models.attention import (
    attn_decode,
    attn_forward,
    init_attn,
    init_attn_cache,
)
from repro_torch.models.mlp import init_mlp, mlp_forward

Params = Dict[str, Any]

_LM_FAMILIES = "ROADMAP.md queue 1, item 4a (LM model families)"


def check_supported(cfg: ModelConfig) -> ModelConfig:
    """Raise NotImplementedError for what this slice does not port."""
    missing = []
    for s in cfg.layer_specs():
        if s.mixer != "attn":
            missing.append(f"{s.mixer} mixer")
        if s.ffn == "moe":
            missing.append("MoE FFN")
        if s.cross_attn:
            missing.append("cross-attention")
    flags = {
        "encoder-decoder": cfg.is_encdec,
        "MLA": cfg.use_mla,
        "M-RoPE": cfg.rope_type == "mrope",
        "qk-norm": cfg.use_qk_norm,
        "logit softcap": cfg.logit_softcap > 0,
        "image-token frontend": cfg.num_image_tokens > 0,
        "MTP head": cfg.use_mtp,
    }
    missing += [name for name, on in flags.items() if on]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(sorted(set(missing)))} not ported to "
            f"repro_torch yet ({_LM_FAMILIES})")
    return cfg


# =========================================================================
# Single layer
# =========================================================================


def init_layer(generator, cfg: ModelConfig, spec: LayerSpec, *, device=None,
               lead=()) -> Params:
    def norm():
        return nn.tree_map(
            lambda a: a.expand(*lead, *a.shape).clone(),
            nn.init_norm(cfg.d_model, cfg.norm, device=device))

    p: Params = {"norm1": norm(),
                 "attn": init_attn(generator, cfg, spec, device=device,
                                   lead=lead)}
    if spec.ffn == "dense":
        p["norm2"] = norm()
        p["ffn"] = init_mlp(generator, cfg.d_model, cfg.d_ff, device=device,
                            lead=lead)
    return p


def apply_layer(p, cfg: ModelConfig, spec: LayerSpec, x, positions):
    """One layer over a full sequence. x: (B, S, d); positions: (B, S)."""
    h = nn.apply_norm(p["norm1"], x, cfg.norm)
    x = x + attn_forward(p["attn"], cfg, spec, h, positions)
    if spec.ffn == "dense":
        x = x + mlp_forward(p["ffn"], nn.apply_norm(p["norm2"], x, cfg.norm),
                            cfg.act)
    return x


def decode_layer(p, cfg: ModelConfig, spec: LayerSpec, x, lcache, pos,
                 live=None):
    h = nn.apply_norm(p["norm1"], x, cfg.norm)
    x = x + attn_decode(p["attn"], cfg, spec, h, lcache["mix"], pos, live)
    if spec.ffn == "dense":
        x = x + mlp_forward(p["ffn"], nn.apply_norm(p["norm2"], x, cfg.norm),
                            cfg.act)
    return x


def init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     cache_len: int, dtype, *, device=None, lead=()) -> Params:
    return {"mix": init_attn_cache(cfg, spec, batch, cache_len, dtype,
                                   device=device, lead=lead)}


def apply_group(p, cfg: ModelConfig, pattern, x, positions):
    for i, spec in enumerate(pattern):
        x = apply_layer(p[f"l{i}"], cfg, spec, x, positions)
    return x


def _remat(fn, *args):
    """``fn(*args)``, recomputed in the backward when autograd records
    (the reference's ``jax.checkpoint``)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def scan_groups(groups_p, cfg: ModelConfig, pattern, n_groups: int, x,
                positions):
    """The stacked groups over a full sequence, one after another
    (``lax.scan`` in JAX). remat='group' checkpoints each group's body,
    remat='layer' each layer, remat='none' nothing."""
    # One unbind per stacked leaf: its backward stacks the groups'
    # gradients once, where indexing each group would scatter every
    # group's gradient into a zeroed copy of the whole stack.
    per_group = nn.tree_map(lambda a: a.unbind(0), groups_p)
    for g in range(n_groups):
        gp = nn.tree_map(lambda t: t[g], per_group)
        if cfg.remat == "group":
            x = _remat(lambda p_, x_: apply_group(p_, cfg, pattern, x_,
                                                  positions), gp, x)
        elif cfg.remat == "layer":
            for i, spec in enumerate(pattern):
                x = _remat(lambda p_, x_, spec=spec: apply_layer(
                    p_, cfg, spec, x_, positions), gp[f"l{i}"], x)
        else:
            x = apply_group(gp, cfg, pattern, x, positions)
    return x


def _decode_groups(groups, caches, cfg: ModelConfig, pattern, n_groups: int,
                   x, pos, live):
    """The stacked groups, one after another (``lax.scan`` in JAX)."""
    for g in range(n_groups):
        gp, gc = nn.tree_index(groups, g), nn.tree_index(caches, g)
        for i, spec in enumerate(pattern):
            x = decode_layer(gp[f"l{i}"], cfg, spec, x, gc[f"l{i}"], pos,
                             live)
    return x


# =========================================================================
# Full LM
# =========================================================================


def init_lm(cfg: ModelConfig, *, generator: torch.Generator,
            device) -> Params:
    """Random params with the JAX package's shapes, keys and scales:
    N(0, 1/d_in) linears with zero biases, N(0, 0.02) embeddings, unit
    norm scales. The draws themselves differ from JAX's threefry; parity
    tests carry JAX's params across with ``params_from_numpy`` instead."""
    check_supported(cfg.validate())
    pre, bp, bg, mp, mg = cfg._resolved_program()
    kw = dict(device=device)
    base: Params = {"embed": nn.init_embedding(generator, cfg.vocab_size,
                                               cfg.d_model, **kw)}
    if pre:
        base["prefix"] = {f"l{i}": init_layer(generator, cfg, s, **kw)
                          for i, s in enumerate(pre)}
    if bg:
        base["groups"] = {f"l{i}": init_layer(generator, cfg, s, lead=(bg,),
                                              **kw)
                          for i, s in enumerate(bp)}
    base["fusion_in"] = nn.init_linear(generator, cfg.d_model, cfg.d_fusion,
                                       **kw)
    modular: Params = {"fusion_out": nn.init_linear(
        generator, cfg.d_fusion, cfg.d_model, **kw)}
    if mg:
        modular["groups"] = {f"l{i}": init_layer(generator, cfg, s,
                                                 lead=(mg,), **kw)
                             for i, s in enumerate(mp)}
    modular["final_norm"] = nn.init_norm(cfg.d_model, cfg.norm, **kw)
    # tie_embeddings is recorded in the configs, but the IFL partition
    # forces an untied head: embed lives in base, the head in modular.
    modular["lm_head"] = nn.init_linear(generator, cfg.d_model,
                                        cfg.vocab_size, **kw)
    return {"base": base, "modular": modular}


# =========================================================================
# Full-sequence forward and losses (training)
# =========================================================================


def _positions(cfg: ModelConfig, batch_size: int, seq: int, device):
    return torch.arange(seq, device=device)[None].expand(batch_size, seq)


def base_forward(base: Params, cfg: ModelConfig, batch) -> torch.Tensor:
    """-> z (B, S, d_fusion) in the compute dtype: the fusion-layer
    output that IFL shares, the only activation crossing the client
    boundary. batch: {"tokens": (B, S) int}."""
    pre, bp, bg, _, _ = cfg._resolved_program()
    tokens = batch["tokens"]
    B, S = tokens.shape
    cdt = nn.dtype_of(cfg.compute_dtype)
    x = nn.embedding(base["embed"], tokens, compute_dtype=cdt)
    positions = _positions(cfg, B, S, tokens.device)
    for i, spec in enumerate(pre):
        x = apply_layer(base["prefix"][f"l{i}"], cfg, spec, x, positions)
    if bg:
        x = scan_groups(base["groups"], cfg, bp, bg, x, positions)
    return nn.linear(base["fusion_in"], x).to(cdt)


def modular_trunk(mod: Params, cfg: ModelConfig, z) -> torch.Tensor:
    """z -> the final normed hidden state: everything above the fusion
    interface except the LM head."""
    _, _, _, mp, mg = cfg._resolved_program()
    B, S, _ = z.shape
    x = nn.linear(mod["fusion_out"], z.to(nn.dtype_of(cfg.compute_dtype)))
    if mg:
        x = scan_groups(mod["groups"], cfg, mp, mg, x,
                        _positions(cfg, B, S, z.device))
    return nn.apply_norm(mod["final_norm"], x, cfg.norm)


def _head_logits(mod: Params, cfg: ModelConfig, x) -> torch.Tensor:
    return nn.linear(mod["lm_head"], x).float()


def modular_forward(mod: Params, cfg: ModelConfig, z) -> torch.Tensor:
    """z: (B, S, d_fusion) -> logits (B, S, V) fp32."""
    return _head_logits(mod, cfg, modular_trunk(mod, cfg, z))


def chunked_ce(mod: Params, cfg: ModelConfig, h, tokens, *, offset: int,
               start: int) -> torch.Tensor:
    """Mean next-token CE without materializing the (tokens, vocab)
    logits: ``cfg.ce_chunk`` positions at a time, each chunk's head
    matmul and softmax recomputed in the backward."""
    B, S, _ = h.shape
    C = cfg.ce_chunk
    T = S - offset - start
    hs = h[:, start:start + T]
    tgt = tokens[:, start + offset:start + offset + T]

    def chunk_nll(hc, tc):
        lp = F.log_softmax(_head_logits(mod, cfg, hc), dim=-1)
        return -torch.gather(lp, -1, tc[..., None].long()).sum()

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, T, C):
        total = total + _remat(chunk_nll, hs[:, c0:c0 + C],
                               tgt[:, c0:c0 + C])
    return total / (B * T)


def lm_apply(params: Params, cfg: ModelConfig, batch) -> torch.Tensor:
    z = base_forward(params["base"], cfg, batch)
    return modular_forward(params["modular"], cfg, z)


def _next_token_ce(logits, tokens, offset: int, start: int) -> torch.Tensor:
    """Mean CE of predicting tokens[t + offset] from position t."""
    lp = F.log_softmax(logits[:, start:logits.shape[1] - offset], dim=-1)
    tgt = tokens[:, start + offset:]
    return -torch.gather(lp, -1, tgt[..., None].long()).mean()


def lm_loss(params: Params, cfg: ModelConfig, batch) -> torch.Tensor:
    if cfg.ce_chunk:
        z = base_forward(params["base"], cfg, batch)
        h = modular_trunk(params["modular"], cfg, z)
        return chunked_ce(params["modular"], cfg, h, batch["tokens"],
                          offset=1, start=0)
    return _next_token_ce(lm_apply(params, cfg, batch), batch["tokens"], 1, 0)


# =========================================================================
# Decode caches
# =========================================================================


def _cache_dtype(cfg: ModelConfig, dtype):
    return dtype or nn.dtype_of(cfg.compute_dtype)


def init_base_decode_cache(cfg: ModelConfig, batch: int, cache_len: int,
                           dtype=None, *, device=None) -> Params:
    """The base half's decode cache: prefix layers + base groups."""
    dtype = _cache_dtype(cfg, dtype)
    pre, bp, bg, _, _ = cfg._resolved_program()
    cache: Params = {}
    if pre:
        cache["prefix"] = {
            f"l{i}": init_layer_cache(cfg, s, batch, cache_len, dtype,
                                      device=device)
            for i, s in enumerate(pre)}
    if bg:
        cache["base"] = {
            f"l{i}": init_layer_cache(cfg, s, batch, cache_len, dtype,
                                      device=device, lead=(bg,))
            for i, s in enumerate(bp)}
    return cache


def init_modular_decode_cache(cfg: ModelConfig, batch: int, cache_len: int,
                              dtype=None, *, device=None) -> Params:
    """The modular half's decode cache: modular groups only."""
    dtype = _cache_dtype(cfg, dtype)
    _, _, _, mp, mg = cfg._resolved_program()
    cache: Params = {}
    if mg:
        cache["mod"] = {
            f"l{i}": init_layer_cache(cfg, s, batch, cache_len, dtype,
                                      device=device, lead=(mg,))
            for i, s in enumerate(mp)}
    return cache


def init_composed_cache(base_cfg: ModelConfig, mod_cfg: ModelConfig,
                        batch: int, cache_len: int, dtype=None, *,
                        device=None) -> Params:
    """Decode cache of a (possibly cross-arch) composition: the base
    half's layers from ``base_cfg``, the modular half's from
    ``mod_cfg``. The halves only have to agree on ``d_fusion``."""
    if base_cfg.d_fusion != mod_cfg.d_fusion:
        raise ValueError(
            f"fusion dim mismatch: base {base_cfg.d_fusion} != "
            f"modular {mod_cfg.d_fusion}")
    cache = init_base_decode_cache(base_cfg, batch, cache_len, dtype,
                                   device=device)
    cache.update(init_modular_decode_cache(mod_cfg, batch, cache_len, dtype,
                                           device=device))
    return cache


# =========================================================================
# Decode steps
# =========================================================================


def base_decode_step(base: Params, cfg: ModelConfig, cache: Params,
                     token: torch.Tensor, pos: torch.Tensor,
                     live: Optional[torch.Tensor] = None):
    """The base half of one decode step: embed -> prefix -> base groups
    -> fusion in-projection. token: (B, 1) int; pos: (B,) int.

    Returns (z (B, 1, d_fusion), cache); the cache is updated in place.
    ``z`` is the only activation crossing the client boundary.
    """
    pre, bp, bg, _, _ = cfg._resolved_program()
    cdt = nn.dtype_of(cfg.compute_dtype)
    x = nn.embedding(base["embed"], token, compute_dtype=cdt)
    for i, spec in enumerate(pre):
        x = decode_layer(base["prefix"][f"l{i}"], cfg, spec, x,
                         cache["prefix"][f"l{i}"], pos, live)
    if bg:
        x = _decode_groups(base["groups"], cache["base"], cfg, bp, bg, x,
                           pos, live)
    z = nn.linear(base["fusion_in"], x).to(cdt)
    return z, cache


def modular_decode_step(mod: Params, cfg: ModelConfig, cache: Params,
                        z: torch.Tensor, pos: torch.Tensor,
                        live: Optional[torch.Tensor] = None):
    """The modular half of one decode step: fusion out-projection ->
    modular groups -> final norm -> LM head. z: (B, 1, d_fusion).
    Returns (logits (B, 1, V) fp32, cache); the cache is updated in
    place."""
    _, _, _, mp, mg = cfg._resolved_program()
    x = nn.linear(mod["fusion_out"], z)
    if mg:
        x = _decode_groups(mod["groups"], cache["mod"], cfg, mp, mg, x, pos,
                           live)
    x = nn.apply_norm(mod["final_norm"], x, cfg.norm)
    logits = nn.linear(mod["lm_head"], x).float()
    return logits, cache


def composed_decode_step(base: Params, base_cfg: ModelConfig, mod: Params,
                         mod_cfg: ModelConfig, cache: Params,
                         token: torch.Tensor, pos: torch.Tensor,
                         live: Optional[torch.Tensor] = None):
    """One decode step of the composition f_m(f_b(.)): the base half
    under ``base_cfg``, the modular half under ``mod_cfg``, over the
    merged cache of ``init_composed_cache``.

    token: (B, 1) int; pos: (B,) int, each row's own position; ``live``
    (B,) bool leaves the cache of rows where it is False untouched.
    ``base`` may hold per-row weights (leading B dim, see
    ``modules.linear``), ``mod`` is shared by all rows.
    Returns (logits (B, 1, V) fp32, cache).
    """
    z, cache = base_decode_step(base, base_cfg, cache, token, pos, live)
    return modular_decode_step(mod, mod_cfg, cache, z, pos, live)


def composed_prefill_ragged(base: Params, base_cfg: ModelConfig,
                            mod: Params, mod_cfg: ModelConfig,
                            cache: Params, tokens: torch.Tensor,
                            lengths: torch.Tensor
                            ) -> Tuple[torch.Tensor, Params]:
    """Cached prefill of B rows padded to one bucket length P: the
    composed decode step at positions 0..P-1, where the steps at
    ``t >= lengths[b]`` are frozen for row b. A frozen step does not
    write the cache (the write is masked), and its logits are dropped,
    so each row's cache and last logits are what an unpadded prefill of
    its first ``lengths[b]`` tokens gives. (JAX computes the step and
    discards it with a whole-tree ``where``; masking the write gives the
    same result and is cheaper eagerly.) A row with length 0 is not
    touched at all.

    tokens: (B, P) int; lengths: (B,) int. The rows being filled must
    hold a fresh cache. Returns (last real position's logits (B, V)
    fp32, cache).
    """
    B, P = tokens.shape
    last = torch.zeros((B, mod_cfg.vocab_size), dtype=torch.float32,
                       device=tokens.device)
    for t in range(P):
        pos = torch.full((B,), t, dtype=torch.long, device=tokens.device)
        live = t < lengths
        logits, cache = composed_decode_step(
            base, base_cfg, mod, mod_cfg, cache, tokens[:, t:t + 1], pos,
            live)
        last = torch.where(live[:, None], logits[:, -1], last)
    return last, cache
