"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory)
[arXiv:2405.04517], the port of the JAX package's ``models/xlstm.py``.

mLSTM trains in the chunkwise-parallel form: quadratic attention-like
weights *within* a chunk of ``cfg.mlstm_chunk`` tokens, the recurrent
(C, n, m) state carried *across* chunks, with the paper's log-space
stabilizer m, so neither the (S, S) decay matrix nor a per-step (dk, dv)
state is ever built for the whole sequence. Its decode is the O(1)
recurrent update. sLSTM has no parallel form (its recurrent weights break
associativity): its forward is a strict loop over time, as in the paper.

The JAX package has no Pallas kernel for either block (both are plain
``jnp``), so on the card they run as plain PyTorch operations: that is
their port, not a fallback. The per-chunk layout here is (B, H, L, ...)
where the reference scans (L, B, H, ...) slices; the arithmetic is the
reference's, operation for operation.

The stabilizer m starts at -inf (an empty memory). Every use of it goes
through ``exp(... + m - m_new)`` with a finite m_new, which is exp(-inf)
= 0 with a zero gradient, so the first chunk or step makes no NaN.

Decode caches are updated in place (the attention cache is too). A
``live`` (B,) bool mask keeps the old state in rows where it is False,
as the reference's ragged prefill does with a whole-tree ``where``.

Per-row parameters: in a serving lane each row is a different tenant's
base block, so every leaf may carry a leading slot dim W (``linear``
already takes it). The mixers' other leaves take it too: ``conv_w``
(W, K, di), ``conv_b`` and ``skip`` (W, di), sLSTM's ``wx`` (W, 4, d, d),
``wr`` (W, 4, nh, hd, hd) and ``b`` (W, 4, d). The JAX lane ``vmap``s a
B=1 step instead.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import modules as nn


# =========================================================================
# mLSTM
# =========================================================================


def init_mlstm(generator, cfg: ModelConfig, *, device=None, lead=()):
    d = cfg.d_model
    di = cfg.ssm_expand * d  # projection factor 2 (the paper's block)
    dqk = di // 2
    nh = cfg.num_heads
    kw = dict(device=device, lead=lead)
    return {
        "up": nn.init_linear(generator, d, 2 * di, **kw),
        "conv_w": nn.randn((*lead, 4, di), generator, device) * 0.2,
        "conv_b": torch.zeros((*lead, di), device=device),
        "wq": nn.init_linear(generator, di, dqk, **kw),
        "wk": nn.init_linear(generator, di, dqk, **kw),
        "wv": nn.init_linear(generator, di, di, **kw),
        "w_if": nn.init_linear(generator, di, 2 * nh, bias=True, **kw),
        "skip": torch.ones((*lead, di), device=device),
        "out_norm": {"scale": torch.ones((*lead, di), device=device)},
        "down": nn.init_linear(generator, di, d, **kw),
    }


def _dims(cfg: ModelConfig):
    di = cfg.ssm_expand * cfg.d_model
    nh = cfg.num_heads
    return di, nh, (di // 2) // nh, di // nh


def _mlstm_qkvif(p, cfg: ModelConfig, x):
    """x: (B, S, d) -> per-head q, k, v (B, S, nh, *), the gate
    pre-activations li, lf (B, S, nh) fp32, z and the conv output xc."""
    B, S, _ = x.shape
    di, nh, dqk_h, dv_h = _dims(cfg)
    u = nn.linear(p["up"], x)
    xm, z = u[..., :di], u[..., di:]
    xc = F.silu(nn.causal_conv(xm, p["conv_w"], p["conv_b"]))
    q = nn.linear(p["wq"], xc).reshape(B, S, nh, dqk_h)
    k = nn.linear(p["wk"], xc).reshape(B, S, nh, dqk_h) / math.sqrt(dqk_h)
    v = nn.linear(p["wv"], xm).reshape(B, S, nh, dv_h)
    gates = nn.linear(p["w_if"], xm).float()
    return q, k, v, gates[..., :nh], F.logsigmoid(gates[..., nh:]), z, xc


def _mlstm_chunk(C, n_state, m, q, k, v, li, lf):
    """One chunk of the chunkwise-parallel mLSTM.

    C (B, H, dk, dv), n_state (B, H, dk), m (B, H): the carried state;
    q, k (B, H, L, dk), v (B, H, L, dv), li, lf (B, H, L), all fp32.
    Returns ((C, n, m) at the chunk's end, h (B, H, L, dv)).
    """
    L = q.shape[2]
    b = torch.cumsum(lf, dim=-1)  # inclusive log-decay within the chunk
    btot = b[..., -1]
    # Intra-chunk decay D[j, l] = b_j - b_l + li_l (l <= j).
    D = b[..., :, None] - b[..., None, :] + li[..., None, :]
    tri = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    D = torch.where(tri, D, -math.inf)
    m_intra = torch.amax(D, dim=-1)
    m_inter = b + m[..., None]  # the decayed previous stabilizer
    m_j = torch.maximum(m_inter, m_intra)

    S_w = torch.exp(D - m_j[..., None])  # stabilized decay weights
    A = (q @ k.transpose(-1, -2)) * S_w  # masked by S_w's exp(-inf) = 0
    num = A @ v
    den = torch.sum(A, dim=-1)
    inter_scale = torch.exp(m_inter - m_j)
    num = num + inter_scale[..., None] * (q @ C)
    den = den + inter_scale * (q @ n_state[..., None])[..., 0]
    h = num / torch.maximum(torch.abs(den), torch.exp(-m_j))[..., None]

    # The state at the chunk's end.
    w_l = btot[..., None] - b + li  # log-weight of each token in the state
    m_next = torch.maximum(btot + m, torch.amax(w_l, dim=-1))
    kw = torch.exp(w_l - m_next[..., None])[..., None] * k
    decay = torch.exp(btot + m - m_next)
    C_next = decay[..., None, None] * C + kw.transpose(-1, -2) @ v
    n_next = decay[..., None] * n_state + torch.sum(kw, dim=-2)
    return (C_next, n_next, m_next), h


def mlstm_forward(p, cfg: ModelConfig, x):
    """x: (B, S, d) -> (B, S, d)."""
    B, S, _ = x.shape
    di, nh, dqk_h, dv_h = _dims(cfg)
    q, k, v, li, lf, z, xc = _mlstm_qkvif(p, cfg, x)
    L = min(cfg.mlstm_chunk, S)
    if S % L:
        raise ValueError(f"seq {S} % mlstm_chunk {L} != 0")

    def heads(a):  # (B, S, H, *) -> (B, H, S, *) fp32
        return a.float().transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    li, lf = li.transpose(1, 2), lf.transpose(1, 2)
    dev = x.device
    C = torch.zeros((B, nh, dqk_h, dv_h), device=dev)
    n_state = torch.zeros((B, nh, dqk_h), device=dev)
    m = torch.full((B, nh), -math.inf, device=dev)
    hs = []
    for c0 in range(0, S, L):
        sl = slice(c0, c0 + L)
        (C, n_state, m), h = _mlstm_chunk(C, n_state, m, q[:, :, sl],
                                          k[:, :, sl], v[:, :, sl],
                                          li[..., sl], lf[..., sl])
        hs.append(h)
    h = torch.cat(hs, dim=2).transpose(1, 2).reshape(B, S, di).to(x.dtype)
    h = nn.apply_norm(p["out_norm"], h, "rmsnorm")
    # The learnable skip of the conv path.
    h = h + xc * nn.row(p["skip"].to(x.dtype), 2)
    h = h * F.silu(z)
    return nn.linear(p["down"], h)


def init_mlstm_cache(cfg: ModelConfig, batch: int, dtype, *, device=None,
                     lead=()):
    del dtype  # the state is kept in fp32 for gate stability
    di, nh, dqk_h, dv_h = _dims(cfg)
    z = dict(dtype=torch.float32, device=device)
    return {
        "mlstm_C": torch.zeros((*lead, batch, nh, dqk_h, dv_h), **z),
        "mlstm_n": torch.zeros((*lead, batch, nh, dqk_h), **z),
        "mlstm_m": torch.full((*lead, batch, nh), -math.inf, **z),
        "mlstm_conv": torch.zeros((*lead, batch, 3, di), **z),
    }


def mlstm_decode(p, cfg: ModelConfig, x, cache,
                 live: Optional[torch.Tensor] = None):
    """x: (B, 1, d). The O(1) recurrent step; updates ``cache`` in place
    (rows where ``live`` is False keep theirs). Returns y (B, 1, d)."""
    B = x.shape[0]
    di, nh, dqk_h, dv_h = _dims(cfg)
    u = nn.linear(p["up"], x)
    xm, z = u[..., :di], u[..., di:]
    window = torch.cat([cache["mlstm_conv"].to(x.dtype), xm], dim=1)
    xc = nn.conv_taps(window, p["conv_w"])
    xc = F.silu(xc + nn.row(p["conv_b"].to(x.dtype), 2))
    q = nn.linear(p["wq"], xc).reshape(B, nh, dqk_h).float()
    k = nn.linear(p["wk"], xc).reshape(B, nh, dqk_h).float()
    k = k / math.sqrt(dqk_h)
    v = nn.linear(p["wv"], xm).reshape(B, nh, dv_h).float()
    gates = nn.linear(p["w_if"], xm)[:, 0].float()
    li, lf = gates[..., :nh], F.logsigmoid(gates[..., nh:])

    m_old = cache["mlstm_m"]
    m_new = torch.maximum(lf + m_old, li)
    dec = torch.exp(lf + m_old - m_new)
    inp = torch.exp(li - m_new)
    C = (dec[..., None, None] * cache["mlstm_C"]
         + inp[..., None, None] * (k[..., :, None] * v[..., None, :]))
    n_state = dec[..., None] * cache["mlstm_n"] + inp[..., None] * k
    num = torch.einsum("bhd,bhdv->bhv", q, C)
    den = torch.einsum("bhd,bhd->bh", q, n_state)
    h = num / torch.maximum(torch.abs(den), torch.exp(-m_new))[..., None]
    h = nn.apply_norm(p["out_norm"], h.reshape(B, 1, di).to(x.dtype),
                      "rmsnorm")
    h = h + xc * nn.row(p["skip"].to(x.dtype), 2)
    h = h * F.silu(z)
    y = nn.linear(p["down"], h)
    nn.update_state(cache, {"mlstm_C": C, "mlstm_n": n_state,
                            "mlstm_m": m_new,
                            "mlstm_conv": window[:, 1:].float()}, live)
    return y


# =========================================================================
# sLSTM
# =========================================================================


def init_slstm(generator, cfg: ModelConfig, *, device=None, lead=()):
    d, nh = cfg.d_model, cfg.num_heads
    hd = d // nh
    dff = (8 * d // 3 + 63) // 64 * 64  # gated FFN, pf ~4/3 * 2
    kw = dict(device=device, lead=lead)
    return {
        "wx": nn.randn((*lead, 4, d, d), generator, device) / math.sqrt(d),
        "wr": nn.randn((*lead, 4, nh, hd, hd), generator,
                       device) / math.sqrt(hd),
        "b": torch.zeros((*lead, 4, d), device=device),
        "gn": {"scale": torch.ones((*lead, d), device=device)},
        "ffn": {
            "w_gate": nn.init_linear(generator, d, dff, **kw),
            "w_up": nn.init_linear(generator, d, dff, **kw),
            "w_down": nn.init_linear(generator, dff, d, **kw),
        },
    }


def _x_proj(p, x):
    """The input half of the gate pre-activations, (4, B, ..., d):
    einsum('b...d,gdk->gb...k'), with per-row ``wx`` (B, 4, d, d) taken
    row by row."""
    wx = p["wx"].to(x.dtype)
    if wx.dim() == 4:
        return torch.einsum("b...d,bgdk->gb...k", x, wx)
    return torch.einsum("b...d,gdk->gb...k", x, wx)


def _gate_bias(p, dtype):
    """The gate bias as one step adds it: (4, 1, d), or (4, B, d) from a
    per-row ``b`` (B, 4, d)."""
    b = p["b"].to(dtype)
    return b.transpose(0, 1) if b.dim() == 3 else b[:, None]


def _slstm_step(p, cfg: ModelConfig, carry, xw, bias):
    """carry: (c, n, m, h) each (B, d); xw: this step's input projection
    (4, B, d) and ``bias`` the gate bias (``_gate_bias``), both in the
    compute dtype, summed with the recurrent half in the reference's
    order."""
    nh = cfg.num_heads
    c, n_s, m, h = carry
    B, d = h.shape
    hx = h.reshape(B, nh, d // nh)
    wr = p["wr"].to(h.dtype)
    if wr.dim() == 5:
        rec = torch.einsum("bnh,bgnhk->gbnk", hx, wr)
    else:
        rec = torch.einsum("bnh,gnhk->gbnk", hx, wr)
    pre = (xw + rec.reshape(4, B, d) + bias).float()
    zt = torch.tanh(pre[0])
    li = pre[1]
    lfm = F.logsigmoid(pre[2]) + m  # the log forget gate plus the old m
    ot = torch.sigmoid(pre[3])
    m_new = torch.maximum(lfm, li)
    f = torch.exp(lfm - m_new)
    i = torch.exp(li - m_new)
    c_new = f * c + i * zt
    n_new = f * n_s + i
    h_new = (ot * c_new / torch.clamp(n_new, min=1e-6)).to(h.dtype)
    return c_new, n_new, m_new, h_new


def _slstm_out(p, h):
    h = nn.apply_norm(p["gn"], h, "rmsnorm")
    f = p["ffn"]
    gelu = nn.activation("gelu")  # jax.nn.gelu: the tanh approximation
    return nn.linear(f["w_down"], gelu(nn.linear(f["w_gate"], h))
                     * nn.linear(f["w_up"], h))


def slstm_forward(p, cfg: ModelConfig, x):
    """x: (B, S, d). A strictly sequential loop over time; the input
    projection of every step is one product up front."""
    B, S, d = x.shape
    dev = x.device
    xw = _x_proj(p, x)  # (4, B, S, d)
    bias = _gate_bias(p, x.dtype)
    carry = (torch.zeros((B, d), device=dev),
             torch.zeros((B, d), device=dev),
             torch.full((B, d), -math.inf, device=dev),
             torch.zeros((B, d), dtype=x.dtype, device=dev))
    hs = []
    for t in range(S):
        carry = _slstm_step(p, cfg, carry, xw[:, :, t], bias)
        hs.append(carry[3])
    return _slstm_out(p, torch.stack(hs, dim=1))


def init_slstm_cache(cfg: ModelConfig, batch: int, dtype, *, device=None,
                     lead=()):
    shape = (*lead, batch, cfg.d_model)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "slstm_c": torch.zeros(shape, **f32),
        "slstm_n": torch.zeros(shape, **f32),
        "slstm_m": torch.full(shape, -math.inf, **f32),
        "slstm_h": torch.zeros(shape, dtype=dtype, device=device),
    }


def slstm_decode(p, cfg: ModelConfig, x, cache,
                 live: Optional[torch.Tensor] = None):
    """x: (B, 1, d). One recurrent step; updates ``cache`` in place
    (rows where ``live`` is False keep theirs). Returns y (B, 1, d)."""
    xt = x[:, 0]
    carry = (cache["slstm_c"], cache["slstm_n"], cache["slstm_m"],
             cache["slstm_h"].to(x.dtype))
    c, n_s, m, h = _slstm_step(p, cfg, carry, _x_proj(p, xt),
                               _gate_bias(p, x.dtype))
    y = _slstm_out(p, h[:, None])
    nn.update_state(cache, {"slstm_c": c, "slstm_n": n_s, "slstm_m": m,
                            "slstm_h": h}, live)
    return y
