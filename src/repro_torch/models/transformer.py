"""LM assembly: layer program -> {base, modular} params; the
full-sequence forward and losses that training runs (``base_forward``,
``modular_forward``, ``lm_loss``); the composed decode step and the
ragged cached prefill that the serving lanes run; the fixed-batch decode
API (``init_decode_cache``, ``lm_decode_step``, ``composed_prefill``,
``lm_prefill``) that ``launch/serve.py``'s ``generate`` runs.

The parameter tree is the JAX package's, key for key:

    base    = embed (+ image projector + encoder) + prefix layers
              + base groups + fusion in-projection
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

The layer program's mixers are GQA attention ('attn', RoPE, M-RoPE or
NoPE, sliding windows, qk-norm), MLA (``cfg.use_mla``), mLSTM and sLSTM
(``xlstm.py``) and Mamba (``ssm.py``), with a dense, MoE (``moe.py``) or
no FFN and rmsnorm / layernorm / nonparam_ln, an optional cross-attention
over an encoder's output (``spec.cross_attn``, below the fusion cut
only), deepseek-v3's multi-token prediction head (``cfg.use_mtp``) and a
logit softcap (``tanh(logits / c) * c``).

Two stub frontends, as in the reference: qwen2-vl's image rows
(``batch["image_embeds"]`` (B, n_img, d) through ``img_proj``, spliced
over the first n_img token rows, under M-RoPE's 2-D grid, and no LM loss
on them) and seamless-m4t's frames (``batch["frame_embeds"]`` (B, S_enc,
d) through the bidirectional encoder, whose output every cross-attention
layer reads; decoding reads per-layer K/V caches from
``build_cross_caches``).

The forward functions return the reference's tuples: the MoE layers'
auxiliary load-balance loss is summed through the layers and groups
(``base_forward -> (z, aux)``, ``modular_forward -> (logits, aux)`` or
``(logits, aux, mtp_logits)``), and ``lm_loss`` adds it, with 0.3 times
the MTP head's offset-2 cross-entropy.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.config import LayerSpec, ModelConfig
from repro_torch.models import modules as nn
from repro_torch.models.attention import (
    attn_decode,
    attn_forward,
    cross_attn_cache,
    cross_attn_decode,
    cross_attn_forward,
    enc_self_attn_forward,
    init_attn,
    init_attn_cache,
    init_cross_attn,
)
from repro_torch.models.mlp import init_mlp, mlp_forward
from repro_torch.models.moe import init_moe, moe_decode, moe_forward
from repro_torch.models.rope import default_mrope_positions
from repro_torch.models.ssm import (
    init_mamba,
    init_mamba_cache,
    mamba_decode,
    mamba_forward,
)
from repro_torch.models.xlstm import (
    init_mlstm,
    init_mlstm_cache,
    init_slstm,
    init_slstm_cache,
    mlstm_decode,
    mlstm_forward,
    slstm_decode,
    slstm_forward,
)

Params = Dict[str, Any]


class _Mixer(NamedTuple):
    init: Callable
    forward: Callable
    decode: Callable
    init_cache: Callable


# The recurrent mixers by their name in the layer program, which is also
# their key in a layer's params.
_RECURRENT = {
    "mamba": _Mixer(init_mamba, mamba_forward, mamba_decode,
                    init_mamba_cache),
    "mlstm": _Mixer(init_mlstm, mlstm_forward, mlstm_decode,
                    init_mlstm_cache),
    "slstm": _Mixer(init_slstm, slstm_forward, slstm_decode,
                    init_slstm_cache),
}


def check_supported(cfg: ModelConfig) -> ModelConfig:
    """Raise ValueError for a mixer the layer program does not know."""
    for s in cfg.layer_specs():
        if s.mixer != "attn" and s.mixer not in _RECURRENT:
            raise ValueError(f"{cfg.name}: unknown mixer {s.mixer!r}")
    return cfg


# =========================================================================
# Single layer
# =========================================================================


def _norm(cfg: ModelConfig, lead, device, dtype) -> Params:
    """A d_model norm of the config's kind, stacked along ``lead``."""
    return nn.tree_map(
        lambda a: a.expand(*lead, *a.shape).clone(),
        nn.init_norm(cfg.d_model, cfg.norm, device=device, dtype=dtype))


def init_layer(generator, cfg: ModelConfig, spec: LayerSpec, *, device=None,
               lead=(), dtype=torch.float32) -> Params:
    """One layer's params, each leaf drawn in ``dtype`` (the recurrent
    mixers' leaves are drawn in fp32 and cast, a mixer at a time)."""
    def norm():
        return _norm(cfg, lead, device, dtype)

    kw = dict(device=device, lead=lead)
    p: Params = {"norm1": norm()}
    if spec.mixer == "attn":
        p["attn"] = init_attn(generator, cfg, spec, dtype=dtype, **kw)
    else:
        p[spec.mixer] = nn.tree_map(
            lambda a: a.to(dtype),
            _RECURRENT[spec.mixer].init(generator, cfg, **kw))
    if spec.cross_attn:
        p["norm_x"] = norm()
        p["cross"] = init_cross_attn(generator, cfg, dtype=dtype, **kw)
    if spec.ffn == "dense":
        p["norm2"] = norm()
        p["ffn"] = init_mlp(generator, cfg.d_model, cfg.d_ff, dtype=dtype,
                            **kw)
    elif spec.ffn == "moe":
        p["norm2"] = norm()
        p["moe"] = init_moe(generator, cfg, dtype=dtype, **kw)
    return p


def apply_layer(p, cfg: ModelConfig, spec: LayerSpec, x, positions,
                enc_out=None):
    """One layer over a full sequence. x: (B, S, d); positions: (B, S),
    or (3, B, S) under M-RoPE; enc_out: (B, S_enc, d), read by a
    cross-attention layer. Returns (x, aux): aux is the MoE FFN's
    load-balance loss (fp32 scalar), 0 for every other layer."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = nn.apply_norm(p["norm1"], x, cfg.norm)
    if spec.mixer == "attn":
        y = attn_forward(p["attn"], cfg, spec, h, positions)
    else:  # sLSTM's block holds its own gated FFN
        y = _RECURRENT[spec.mixer].forward(p[spec.mixer], cfg, h)
    x = x + y
    if spec.cross_attn:
        x = x + cross_attn_forward(p["cross"], cfg,
                                   nn.apply_norm(p["norm_x"], x, cfg.norm),
                                   enc_out)
    if spec.ffn == "dense":
        x = x + mlp_forward(p["ffn"], nn.apply_norm(p["norm2"], x, cfg.norm),
                            cfg.act)
    elif spec.ffn == "moe":
        y, a = moe_forward(p["moe"], cfg,
                           nn.apply_norm(p["norm2"], x, cfg.norm))
        x = x + y
        aux = aux + a
    return x, aux


def decode_layer(p, cfg: ModelConfig, spec: LayerSpec, x, lcache, pos,
                 live=None, positions=None, cross_kv=None):
    """One token per row through one layer; the layer's cache is updated
    in place, and rows where ``live`` is False keep theirs. ``positions``
    are M-RoPE's (3, B, 1) ids (None: ``pos``); ``cross_kv`` the layer's
    cross cache."""
    h = nn.apply_norm(p["norm1"], x, cfg.norm)
    if spec.mixer == "attn":
        y = attn_decode(p["attn"], cfg, spec, h, lcache["mix"], pos, live,
                        positions)
    else:
        y = _RECURRENT[spec.mixer].decode(p[spec.mixer], cfg, h,
                                          lcache["mix"], live)
    x = x + y
    if spec.cross_attn:
        x = x + cross_attn_decode(p["cross"], cfg,
                                  nn.apply_norm(p["norm_x"], x, cfg.norm),
                                  cross_kv)
    if spec.ffn == "dense":
        x = x + mlp_forward(p["ffn"], nn.apply_norm(p["norm2"], x, cfg.norm),
                            cfg.act)
    elif spec.ffn == "moe":  # each row routed alone, as one B=1 slot
        x = x + moe_decode(p["moe"], cfg,
                           nn.apply_norm(p["norm2"], x, cfg.norm))
    return x


def init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     cache_len: int, dtype, *, device=None, lead=()) -> Params:
    kw = dict(device=device, lead=lead)
    if spec.mixer == "attn":
        mix = init_attn_cache(cfg, spec, batch, cache_len, dtype, **kw)
    else:
        mix = _RECURRENT[spec.mixer].init_cache(cfg, batch, dtype, **kw)
    return {"mix": mix}


def apply_group(p, cfg: ModelConfig, pattern, x, positions, enc_out=None):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, spec in enumerate(pattern):
        x, a = apply_layer(p[f"l{i}"], cfg, spec, x, positions, enc_out)
        aux = aux + a
    return x, aux


def _remat(fn, *args):
    """``fn(*args)``, recomputed in the backward when autograd records
    (the reference's ``jax.checkpoint``)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def scan_groups(groups_p, cfg: ModelConfig, pattern, n_groups: int, x,
                positions, enc_out=None):
    """The stacked groups over a full sequence, one after another
    (``lax.scan`` in JAX). remat='group' checkpoints each group's body,
    remat='layer' each layer, remat='none' nothing. Returns (x, aux), aux
    summed over the groups' layers."""
    # One unbind per stacked leaf: its backward stacks the groups'
    # gradients once, where indexing each group would scatter every
    # group's gradient into a zeroed copy of the whole stack.
    per_group = nn.tree_map(lambda a: a.unbind(0), groups_p)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(n_groups):
        gp = nn.tree_map(lambda t: t[g], per_group)
        if cfg.remat == "group":
            x, a = _remat(lambda p_, x_, e_: apply_group(
                p_, cfg, pattern, x_, positions, e_), gp, x, enc_out)
            aux = aux + a
        elif cfg.remat == "layer":
            for i, spec in enumerate(pattern):
                x, a = _remat(lambda p_, x_, e_, spec=spec: apply_layer(
                    p_, cfg, spec, x_, positions, e_), gp[f"l{i}"], x,
                    enc_out)
                aux = aux + a
        else:
            x, a = apply_group(gp, cfg, pattern, x, positions, enc_out)
            aux = aux + a
    return x, aux


def _decode_groups(groups, caches, cfg: ModelConfig, pattern, n_groups: int,
                   x, pos, live, positions=None, cross_kvs=None):
    """The stacked groups, one after another (``lax.scan`` in JAX);
    ``cross_kvs`` stacked group-major as ``build_cross_caches`` makes
    them."""
    for g in range(n_groups):
        gp, gc = nn.tree_index(groups, g), nn.tree_index(caches, g)
        ckv = None if cross_kvs is None else nn.tree_index(cross_kvs, g)
        for i, spec in enumerate(pattern):
            x = decode_layer(gp[f"l{i}"], cfg, spec, x, gc[f"l{i}"], pos,
                             live, positions,
                             None if ckv is None else ckv.get(f"l{i}"))
    return x


# =========================================================================
# Encoder (enc-dec archs; consumes the stub frontend's frame embeddings)
# =========================================================================


def init_encoder(generator, cfg: ModelConfig, *, device=None,
                 dtype=torch.float32) -> Params:
    """``enc_layers`` bidirectional layers stacked along a leading dim
    (norm1, self-attention with H heads for k and v, norm2, dense FFN),
    then a final norm: the reference's tree."""
    lead = (cfg.enc_layers,)
    kw = dict(device=device, dtype=dtype)
    layer = {"norm1": _norm(cfg, lead, device, dtype),
             "attn": init_cross_attn(generator, cfg, lead=lead, **kw),
             "norm2": _norm(cfg, lead, device, dtype),
             "ffn": init_mlp(generator, cfg.d_model, cfg.d_ff, lead=lead,
                             **kw)}
    return {"groups": layer,
            "final_norm": nn.init_norm(cfg.d_model, cfg.norm, **kw)}


def encoder_forward(p, cfg: ModelConfig, frames):
    """frames: (B, S_enc, d_model), the stub frontend's output -> the
    encoder's normed output in the compute dtype. Its self-attention is
    the ``flash_attention`` kernels' non-causal mode on the card."""
    x = frames.to(nn.dtype_of(cfg.compute_dtype))
    per_layer = nn.tree_map(lambda a: a.unbind(0), p["groups"])
    for i in range(cfg.enc_layers):
        lp = nn.tree_map(lambda t: t[i], per_layer)
        h = nn.apply_norm(lp["norm1"], x, cfg.norm)
        x = x + enc_self_attn_forward(lp["attn"], cfg, h)
        h = nn.apply_norm(lp["norm2"], x, cfg.norm)
        x = x + mlp_forward(lp["ffn"], h, cfg.act)
    return nn.apply_norm(p["final_norm"], x, cfg.norm)


# =========================================================================
# Full LM
# =========================================================================


def init_lm(cfg: ModelConfig, *, generator: torch.Generator, device,
            dtype: torch.dtype = torch.float32) -> Params:
    """Random params with the JAX package's shapes, keys and scales:
    N(0, 1/d_in) linears with zero biases, N(0, 0.02) embeddings, unit
    norm scales. The draws themselves differ from JAX's threefry; parity
    tests carry JAX's params across with ``params_from_numpy`` instead.

    Each leaf is drawn in ``dtype`` (``modules.normal``): pass the
    config's ``param_dtype`` to build a bf16 model without an fp32 copy
    of it (deepseek-v3 cut to 2 layers + MTP is 58 GB in fp32)."""
    check_supported(cfg.validate())
    pre, bp, bg, mp, mg = cfg._resolved_program()
    kw = dict(device=device, dtype=dtype)
    base: Params = {"embed": nn.init_embedding(generator, cfg.vocab_size,
                                               cfg.d_model, **kw)}
    if cfg.num_image_tokens:
        base["img_proj"] = nn.init_linear(generator, cfg.d_model,
                                          cfg.d_model, **kw)
    if cfg.is_encdec:
        base["encoder"] = init_encoder(generator, cfg, **kw)
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
    if cfg.use_mtp:
        modular["mtp"] = {
            "layer": init_layer(generator, cfg, LayerSpec(), **kw),
            "norm": nn.init_norm(cfg.d_model, cfg.norm, **kw),
        }
    return {"base": base, "modular": modular}


# =========================================================================
# Full-sequence forward and losses (training)
# =========================================================================


def _positions(cfg: ModelConfig, batch_size: int, seq: int, device,
               batch=None):
    """(B, S) positions, or M-RoPE's (3, B, S): ``batch["mrope_positions"]``
    where the batch has them, else the default image grid."""
    if cfg.rope_type == "mrope":
        if batch is not None and "mrope_positions" in batch:
            return batch["mrope_positions"]
        return default_mrope_positions(batch_size, seq, cfg.num_image_tokens,
                                       device=device)
    return torch.arange(seq, device=device)[None].expand(batch_size, seq)


def base_forward(base: Params, cfg: ModelConfig,
                 batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (z (B, S, d_fusion) in the compute dtype, aux fp32): z is the
    fusion-layer output that IFL shares, the only activation crossing
    the client boundary; aux the base layers' MoE load-balance loss.
    batch: {"tokens": (B, S) int}, with ``image_embeds`` (B, n_img, d)
    for an image config (optionally ``mrope_positions`` (3, B, S)) and
    ``frame_embeds`` (B, S_enc, d) for an encoder-decoder."""
    pre, bp, bg, _, _ = cfg._resolved_program()
    tokens = batch["tokens"]
    B, S = tokens.shape
    cdt = nn.dtype_of(cfg.compute_dtype)
    x = nn.embedding(base["embed"], tokens, compute_dtype=cdt)
    if cfg.num_image_tokens:  # image rows replace the first n_img tokens
        img = nn.linear(base["img_proj"], batch["image_embeds"].to(cdt))
        x = torch.cat([img, x[:, cfg.num_image_tokens:]], dim=1)
    positions = _positions(cfg, B, S, tokens.device, batch)
    enc_out = None
    if cfg.is_encdec:
        enc_out = encoder_forward(base["encoder"], cfg, batch["frame_embeds"])
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for i, spec in enumerate(pre):
        x, a = apply_layer(base["prefix"][f"l{i}"], cfg, spec, x, positions,
                           enc_out)
        aux = aux + a
    if bg:
        x, a = scan_groups(base["groups"], cfg, bp, bg, x, positions, enc_out)
        aux = aux + a
    return nn.linear(base["fusion_in"], x).to(cdt), aux


def modular_trunk(mod: Params, cfg: ModelConfig, z):
    """z -> (the final normed hidden state, aux, positions): everything
    above the fusion interface except the LM head."""
    _, _, _, mp, mg = cfg._resolved_program()
    B, S, _ = z.shape
    x = nn.linear(mod["fusion_out"], z.to(nn.dtype_of(cfg.compute_dtype)))
    positions = _positions(cfg, B, S, z.device)
    aux = torch.zeros((), dtype=torch.float32, device=z.device)
    if mg:
        x, aux = scan_groups(mod["groups"], cfg, mp, mg, x, positions)
    return nn.apply_norm(mod["final_norm"], x, cfg.norm), aux, positions


def _head_logits(mod: Params, cfg: ModelConfig, x) -> torch.Tensor:
    """fp32 logits of the LM head, soft-capped where the config says."""
    logits = nn.linear(mod["lm_head"], x).float()
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits


def mtp_hidden(mod: Params, cfg: ModelConfig, x, positions):
    """The MTP head's hidden state from the trunk's: one more dense
    layer and its norm; the shared LM head reads it to predict the token
    two ahead."""
    h2, _ = apply_layer(mod["mtp"]["layer"], cfg, LayerSpec(), x, positions)
    return nn.apply_norm(mod["mtp"]["norm"], h2, cfg.norm)


def modular_forward(mod: Params, cfg: ModelConfig, z):
    """z: (B, S, d_fusion) -> (logits (B, S, V) fp32, aux), or (logits,
    aux, mtp_logits) when the config has the MTP head."""
    x, aux, positions = modular_trunk(mod, cfg, z)
    logits = _head_logits(mod, cfg, x)
    if cfg.use_mtp:
        return logits, aux, _head_logits(mod, cfg,
                                         mtp_hidden(mod, cfg, x, positions))
    return logits, aux


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


def lm_apply(params: Params, cfg: ModelConfig, batch):
    """-> (logits, aux, mtp_logits or None)."""
    z, aux_b = base_forward(params["base"], cfg, batch)
    out = modular_forward(params["modular"], cfg, z)
    mtp_logits = out[2] if cfg.use_mtp else None
    return out[0], aux_b + out[1], mtp_logits


def lm_logits(params: Params, cfg: ModelConfig, batch) -> torch.Tensor:
    """The LM head's fp32 logits (B, S, V), ``lm_apply``'s first output,
    without the MTP head, whose logits a prefill does not return (the
    reference's compiled prefill drops that work too)."""
    z, _ = base_forward(params["base"], cfg, batch)
    h, _, _ = modular_trunk(params["modular"], cfg, z)
    return _head_logits(params["modular"], cfg, h)


def _next_token_ce(logits, tokens, offset: int, start: int) -> torch.Tensor:
    """Mean CE of predicting tokens[t + offset] from position t."""
    lp = F.log_softmax(logits[:, start:logits.shape[1] - offset], dim=-1)
    tgt = tokens[:, start + offset:]
    return -torch.gather(lp, -1, tgt[..., None].long()).mean()


def lm_loss(params: Params, cfg: ModelConfig, batch) -> torch.Tensor:
    """Next-token CE (+ 0.3 x the MTP head's offset-2 CE) + the MoE
    load-balance loss; no CE on the image positions."""
    tokens = batch["tokens"]
    start = cfg.num_image_tokens
    if cfg.ce_chunk:
        z, aux_b = base_forward(params["base"], cfg, batch)
        mod = params["modular"]
        h, aux_m, positions = modular_trunk(mod, cfg, z)
        loss = chunked_ce(mod, cfg, h, tokens, offset=1, start=start)
        if cfg.use_mtp:
            h2 = mtp_hidden(mod, cfg, h, positions)
            loss = loss + 0.3 * chunked_ce(mod, cfg, h2, tokens, offset=2,
                                           start=start)
        return loss + aux_b + aux_m
    logits, aux, mtp_logits = lm_apply(params, cfg, batch)
    loss = _next_token_ce(logits, tokens, 1, start)
    if mtp_logits is not None:
        loss = loss + 0.3 * _next_token_ce(mtp_logits, tokens, 2, start)
    return loss + aux


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


def init_decode_cache(cfg: ModelConfig, batch: int, cache_len: int,
                      dtype=None, *, device=None) -> Params:
    """The decode cache of one LM (both halves under ``cfg``)."""
    return init_composed_cache(cfg, cfg, batch, cache_len, dtype,
                               device=device)


# =========================================================================
# Decode steps
# =========================================================================


def build_cross_caches(params: Params, cfg: ModelConfig, enc_out) -> Params:
    """Every cross-attention layer's K/V of the encoder output, computed
    once for decoding: {"prefix": {"l<i>": ...}} for the prefix layers
    and {"base": {"l<i>": ...}} stacked group-major for the base groups'
    (the reference's tree). enc_out: (B, S_enc, d)."""
    pre, bp, bg, _, _ = cfg._resolved_program()
    base = params["base"]
    out: Params = {}
    if pre:
        out["prefix"] = {
            f"l{i}": cross_attn_cache(base["prefix"][f"l{i}"]["cross"], cfg,
                                      enc_out)
            for i, s in enumerate(pre) if s.cross_attn}
    if bg and any(s.cross_attn for s in bp):
        out["base"] = {}
        for i, s in enumerate(bp):
            if s.cross_attn:
                per_group = [cross_attn_cache(
                    nn.tree_index(base["groups"][f"l{i}"]["cross"], g), cfg,
                    enc_out) for g in range(bg)]
                out["base"][f"l{i}"] = {
                    k: torch.stack([c[k] for c in per_group])
                    for k in ("k", "v")}
    return out


def _decode_positions(cfg: ModelConfig, pos: torch.Tensor):
    """M-RoPE's (3, B, 1) ids of a decode step, or None (``pos`` itself).
    A text token continues every axis from ``max(pos - n_img, 0) +
    grid``, grid = max(1, int(sqrt(n_img))) (the reference's decode rule,
    which differs from ``default_mrope_positions``'s start for a
    non-square image count)."""
    if cfg.rope_type != "mrope":
        return None
    n_img = cfg.num_image_tokens
    grid = max(1, int(n_img ** 0.5)) if n_img else 0
    tid = torch.clamp(pos - n_img, min=0) + grid
    return tid[None, :, None].expand(3, pos.shape[0], 1)


def base_decode_step(base: Params, cfg: ModelConfig, cache: Params,
                     token: torch.Tensor, pos: torch.Tensor,
                     live: Optional[torch.Tensor] = None,
                     cross_kvs: Optional[Params] = None):
    """The base half of one decode step: embed -> prefix -> base groups
    -> fusion in-projection. token: (B, 1) int; pos: (B,) int;
    ``cross_kvs`` from ``build_cross_caches`` for an encoder-decoder.

    Returns (z (B, 1, d_fusion), cache); the cache is updated in place.
    ``z`` is the only activation crossing the client boundary.
    """
    pre, bp, bg, _, _ = cfg._resolved_program()
    cdt = nn.dtype_of(cfg.compute_dtype)
    x = nn.embedding(base["embed"], token, compute_dtype=cdt)
    positions = _decode_positions(cfg, pos)
    cross_kvs = cross_kvs or {}
    for i, spec in enumerate(pre):
        x = decode_layer(base["prefix"][f"l{i}"], cfg, spec, x,
                         cache["prefix"][f"l{i}"], pos, live, positions,
                         cross_kvs.get("prefix", {}).get(f"l{i}"))
    if bg:
        x = _decode_groups(base["groups"], cache["base"], cfg, bp, bg, x,
                           pos, live, positions, cross_kvs.get("base"))
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
                           live, _decode_positions(cfg, pos))
    x = nn.apply_norm(mod["final_norm"], x, cfg.norm)
    return _head_logits(mod, cfg, x), cache


def composed_decode_step(base: Params, base_cfg: ModelConfig, mod: Params,
                         mod_cfg: ModelConfig, cache: Params,
                         token: torch.Tensor, pos: torch.Tensor,
                         live: Optional[torch.Tensor] = None,
                         cross_kvs: Optional[Params] = None):
    """One decode step of the composition f_m(f_b(.)): the base half
    under ``base_cfg``, the modular half under ``mod_cfg``, over the
    merged cache of ``init_composed_cache``.

    token: (B, 1) int; pos: (B,) int, each row's own position; ``live``
    (B,) bool leaves the cache of rows where it is False untouched;
    ``cross_kvs`` (``build_cross_caches``) feeds an encoder-decoder's
    cross-attention layers. ``base`` may hold per-row weights (leading B dim, see
    ``modules.linear``), ``mod`` is shared by all rows.

    The B rows are the reference's vmapped B=1 slots: no row depends on
    another. An MoE layer routes each row alone (T = 1, so its capacity
    C = max(floor(K * cf / E), 4) never drops a choice); one joint
    capacity over the B rows would drop choices once more than C rows
    pick an expert and break the lanes' bitwise contract.
    Returns (logits (B, 1, V) fp32, cache).
    """
    z, cache = base_decode_step(base, base_cfg, cache, token, pos, live,
                                cross_kvs)
    return modular_decode_step(mod, mod_cfg, cache, z, pos, live)


def _row_positions(pos, batch: int, device) -> torch.Tensor:
    """A scalar position (an int or a 0-d tensor) as the (B,) positions
    the decode step takes; a (B,) tensor as it is."""
    pos = torch.as_tensor(pos, device=device)
    return pos.expand(batch).contiguous() if pos.dim() == 0 else pos


def lm_decode_step(params: Params, cfg: ModelConfig, cache: Params,
                   token: torch.Tensor, pos,
                   cross_kvs: Optional[Params] = None):
    """One decode step of one LM: token (B, 1) int at position ``pos``
    (a scalar, the reference's form, or (B,) per row). Returns (logits
    (B, 1, V) fp32, cache); the cache is updated in place."""
    return composed_decode_step(
        params["base"], cfg, params["modular"], cfg, cache, token,
        _row_positions(pos, token.shape[0], token.device),
        cross_kvs=cross_kvs)


def composed_prefill(base: Params, base_cfg: ModelConfig, mod: Params,
                     mod_cfg: ModelConfig, cache: Params,
                     tokens: torch.Tensor,
                     cross_kvs: Optional[Params] = None, start: int = 0):
    """Batched cached prefill: the composed decode step at positions
    ``start .. start+P-1`` of tokens (B, P), so the cache it leaves is
    the one P sequential decode steps write (the reference runs the
    same steps as one ``lax.scan``). Returns (the last position's
    logits (B, 1, V) fp32, cache)."""
    B, P = tokens.shape
    logits = torch.zeros((B, 1, mod_cfg.vocab_size), dtype=torch.float32,
                         device=tokens.device)
    for t in range(P):
        pos = torch.full((B,), start + t, dtype=torch.long,
                         device=tokens.device)
        logits, cache = composed_decode_step(
            base, base_cfg, mod, mod_cfg, cache, tokens[:, t:t + 1], pos,
            cross_kvs=cross_kvs)
    return logits, cache


def lm_prefill(params: Params, cfg: ModelConfig, cache: Params,
               tokens: torch.Tensor, cross_kvs: Optional[Params] = None,
               start: int = 0):
    """``composed_prefill`` of one LM."""
    return composed_prefill(params["base"], cfg, params["modular"], cfg,
                            cache, tokens, cross_kvs, start)


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
    discards it with a whole-tree ``where``; masking the attention
    cache's write gives the same result and is cheaper eagerly. A
    recurrent state, conv windows included, is replaced by
    ``where(live, new, old)`` leaf by leaf, the reference's own rule.)
    A row with length 0 is not touched at all.

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
