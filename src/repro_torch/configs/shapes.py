"""Meta-tensor stand-ins for every (arch x shape x step kind): the port's
``repro/configs/shapes.py``.

Nothing here allocates: params and decode caches come from the real
constructors on the ``meta`` device, so a dry-run runs the exact
structures a real step would, at full width, with no memory behind
them. Where the reference stacks N clients' params along a leading
axis, the port keeps a list of N trees (``core.ifl_spmd``), so
``param_specs(cfg, n_clients=N)`` is that list.
"""

from __future__ import annotations

from typing import Any, Dict, List, Union

import torch

from repro_torch.config import INPUT_SHAPES, ModelConfig, ShapeConfig
from repro_torch.models import modules as nn
from repro_torch.models.transformer import (
    build_cross_caches,
    init_decode_cache,
    init_lm,
)

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def enc_frames_for(cfg: ModelConfig, seq: int) -> int:
    """Stub audio frontend: ~4 tokens of speech per text token budget,
    capped so encoder self-attention stays lowerable (the reference's
    rule)."""
    return min(max(cfg.enc_seq_len, 1), max(seq // 4, 64))


def _modal_extras(cfg: ModelConfig, lead, seq, compute_dtype) -> Dict:
    ex: Dict[str, Any] = {}
    if cfg.num_image_tokens:
        ex["image_embeds"] = _meta(
            (*lead, cfg.num_image_tokens, cfg.d_model), compute_dtype)
    if cfg.is_encdec:
        ex["frame_embeds"] = _meta(
            (*lead, enc_frames_for(cfg, seq), cfg.d_model), compute_dtype)
    return ex


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                      n_clients: int = 0, tau: int = 2) -> Dict[str, Any]:
    """IFL round batch (n_clients > 0): leaves (N, tau+1, B/N, ...).
    Plain DP batch (n_clients == 0): leaves (B, ...)."""
    cdt = nn.dtype_of(cfg.compute_dtype)
    B, S = shape.global_batch, shape.seq_len
    if n_clients:
        if B % n_clients:
            raise ValueError(f"global batch {B} does not split over "
                             f"{n_clients} clients")
        lead = (n_clients, tau + 1, B // n_clients)
    else:
        lead = (B,)
    batch = {"tokens": _meta((*lead, S), torch.int32)}
    batch.update(_modal_extras(cfg, lead, S, cdt))
    return batch


def prefill_batch_specs(cfg: ModelConfig,
                        shape: ShapeConfig) -> Dict[str, Any]:
    cdt = nn.dtype_of(cfg.compute_dtype)
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": _meta((B, S), torch.int32)}
    batch.update(_modal_extras(cfg, (B,), S, cdt))
    return batch


def decode_specs(cfg: ModelConfig, shape: ShapeConfig,
                 params=None) -> Dict[str, Any]:
    """serve_step inputs: one new token and a cache of length seq_len
    (``init_decode_cache``), plus the encoder's cross-attention K/V for
    enc-dec archs (``build_cross_caches`` over ``params``, by default
    ``param_specs(cfg)``). ``pos`` is int64, as the port's caches record
    positions (``slot_pos``), where the reference's is int32."""
    B, S = shape.global_batch, shape.seq_len
    out = {
        "cache": init_decode_cache(cfg, B, S, device=META),
        "token": _meta((B, 1), torch.int32),
        "pos": _meta((), torch.int64),
        "cross_kvs": None,
    }
    if cfg.is_encdec:
        params = param_specs(cfg) if params is None else params
        enc_out = _meta((B, enc_frames_for(cfg, S), cfg.d_model),
                        nn.dtype_of(cfg.compute_dtype))
        with torch.no_grad():
            out["cross_kvs"] = build_cross_caches(params, cfg, enc_out)
    return out


def param_specs(cfg: ModelConfig, *,
                n_clients: int = 0) -> Union[Dict, List[Dict]]:
    """The real initializer's tree on the meta device, in
    ``cfg.param_dtype``; with ``n_clients`` the N trees of
    ``init_ifl_state``, a list."""
    if n_clients:
        from repro_torch.core.ifl_spmd import init_ifl_state

        return init_ifl_state(cfg, n_clients=n_clients, generator=None,
                              device=META)[0]
    return init_lm(cfg, generator=None, device=META,
                   dtype=nn.dtype_of(cfg.param_dtype))


def shape_by_name(name: str) -> ShapeConfig:
    return INPUT_SHAPES[name]
