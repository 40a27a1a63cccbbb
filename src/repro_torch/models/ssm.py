"""Mamba selective-SSM mixer (as used by Jamba [arXiv:2403.19887]), the
port of the JAX package's ``models/ssm.py``.

Prefill and training run a *chunked* parallel scan: a loop over chunks
of ``CHUNK`` tokens carrying the SSM state, a parallel prefix scan
inside each chunk, contracted against C inside the chunk so the
(B, L, d_inner, d_state) states never leave it. The reference's
in-chunk scan is ``lax.associative_scan``; here it is a Hillis-Steele
scan (log2 L doubling steps of the same combine), which multiplies in
another order, so the two agree to rounding, not bit for bit. Decode is
the O(1) recurrent step (the state plus a ring of the last d_conv - 1
inputs).

The JAX package has no Pallas kernel for Mamba (it is plain ``jnp``),
so on the card it runs as plain PyTorch operations: that is its port,
not a fallback.

Both decode states, ``ssm_h`` and ``ssm_conv``, are kept in the compute
dtype, as the reference keeps them. Decode updates the cache in place;
rows where ``live`` is False keep their state. In a serving lane every
leaf may carry a leading slot dim W (a different tenant's base block a
row): ``conv_w`` (W, K, di), ``conv_b`` and ``d_skip`` (W, di), ``a_log``
(W, di, ds), and the linears' weights.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import modules as nn

CHUNK = 256


def init_mamba(generator, cfg: ModelConfig, *, device=None, lead=()):
    d, di = cfg.d_model, cfg.ssm_d_inner
    ds, dtr = cfg.ssm_d_state, cfg.resolved_dt_rank
    kw = dict(device=device, lead=lead)
    # S4D-real initialization of A.
    a_init = torch.arange(1, ds + 1, dtype=torch.float32, device=device)
    return {
        "in_proj": nn.init_linear(generator, d, 2 * di, **kw),
        "conv_w": nn.randn((*lead, cfg.ssm_d_conv, di), generator,
                           device) * 0.2,
        "conv_b": torch.zeros((*lead, di), device=device),
        "x_proj": nn.init_linear(generator, di, dtr + 2 * ds, **kw),
        "dt_proj": nn.init_linear(generator, dtr, di, bias=True, **kw),
        "a_log": torch.log(a_init).expand(*lead, di, ds).clone(),
        "d_skip": torch.ones((*lead, di), device=device),
        "out_proj": nn.init_linear(generator, di, d, **kw),
    }


def _ssm_params(p, cfg: ModelConfig, xc):
    """xc: (B, S, di) post-conv activations -> (dt, Bmat, Cmat)."""
    ds, dtr = cfg.ssm_d_state, cfg.resolved_dt_rank
    proj = nn.linear(p["x_proj"], xc)
    dt = F.softplus(nn.linear(p["dt_proj"], proj[..., :dtr]))  # (B, S, di)
    return dt, proj[..., dtr:dtr + ds], proj[..., dtr + ds:]


def _scan_chunk(h0, a, bx, Cm):
    """The linear recurrence h_t = a_t * h_{t-1} + bx_t within one
    chunk, contracted against C inside the chunk.

    a, bx: (B, L, di, ds); h0: (B, di, ds); Cm: (B, L, ds).
    Returns (h_last, y) with y: (B, L, di).
    """
    L = a.shape[1]
    o = 1
    while o < L:  # prefix (A, B) of each t from the pair o steps back
        bx = torch.cat([bx[:, :o], a[:, o:] * bx[:, :-o] + bx[:, o:]], 1)
        a = torch.cat([a[:, :o], a[:, :-o] * a[:, o:]], 1)
        o *= 2
    all_h = a * h0[:, None] + bx
    y = torch.einsum("bldn,bln->bld", all_h, Cm)
    return all_h[:, -1], y


def mamba_forward(p, cfg: ModelConfig, x):
    """x: (B, S, d) -> (B, S, d). Full sequence (training, prefill)."""
    B, S, _ = x.shape
    di, ds = cfg.ssm_d_inner, cfg.ssm_d_state
    xz = nn.linear(p["in_proj"], x)
    xm, z = xz[..., :di], xz[..., di:]
    xc = F.silu(nn.causal_conv(xm, p["conv_w"], p["conv_b"]))
    dt, Bm, Cm = _ssm_params(p, cfg, xc)
    a = torch.exp(-dt[..., None] * torch.exp(p["a_log"]).to(dt.dtype))
    bx = (dt * xc)[..., None] * Bm[:, :, None, :]  # (B, S, di, ds)

    L = min(CHUNK, S)
    if S % L:
        raise ValueError(f"seq {S} % chunk {L} != 0")
    h = torch.zeros((B, di, ds), dtype=x.dtype, device=x.device)
    ys = []
    for c0 in range(0, S, L):
        sl = slice(c0, c0 + L)
        h, y = _scan_chunk(h, a[:, sl], bx[:, sl], Cm[:, sl])
        ys.append(y)
    y = torch.cat(ys, dim=1)
    y = y + xc * nn.row(p["d_skip"].to(y.dtype), 2)
    y = y * F.silu(z)
    return nn.linear(p["out_proj"], y)


# ----------------------------------------------------------------- decode


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype, *, device=None,
                     lead=()):
    di = cfg.ssm_d_inner
    kw = dict(dtype=dtype, device=device)
    return {
        "ssm_h": torch.zeros((*lead, batch, di, cfg.ssm_d_state), **kw),
        "ssm_conv": torch.zeros((*lead, batch, cfg.ssm_d_conv - 1, di), **kw),
    }


def mamba_decode(p, cfg: ModelConfig, x, cache,
                 live: Optional[torch.Tensor] = None):
    """x: (B, 1, d). The O(1) recurrent step; updates ``cache`` in place
    (rows where ``live`` is False keep theirs). Returns y (B, 1, d)."""
    di = cfg.ssm_d_inner
    xz = nn.linear(p["in_proj"], x)
    xm, z = xz[..., :di], xz[..., di:]  # (B, 1, di)
    window = torch.cat([cache["ssm_conv"], xm], dim=1)  # (B, K, di)
    xc = nn.conv_taps(window, p["conv_w"])
    xc = F.silu(xc + nn.row(p["conv_b"].to(x.dtype), 2))
    dt, Bm, Cm = _ssm_params(p, cfg, xc)

    # exp(a_log) is (di, ds) shared or (B, di, ds) per row; both
    # broadcast against dt's (B, di, 1).
    a = torch.exp(-dt[:, 0, :, None] * torch.exp(p["a_log"]).to(dt.dtype))
    bx = (dt[:, 0] * xc[:, 0])[..., None] * Bm[:, 0, None, :]
    h = a * cache["ssm_h"] + bx  # (B, di, ds)
    y = torch.einsum("bdn,bn->bd", h, Cm[:, 0])[:, None]
    y = y + xc * nn.row(p["d_skip"].to(y.dtype), 2)
    y = y * F.silu(z)
    nn.update_state(cache, {"ssm_h": h, "ssm_conv": window[:, 1:]}, live)
    return nn.linear(p["out_proj"], y)
