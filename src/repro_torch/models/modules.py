"""Basic parameterized layers as (init, apply) function pairs on plain
dicts of tensors, with the JAX package's keys and layouts.

A weight may carry a leading batch dim: a linear ``w`` of shape
``(B, d_in, d_out)`` (or a norm ``scale`` of shape ``(B, d)``) applies
row ``b`` of the weight to row ``b`` of the activations. That is how a
serving lane runs W slots with W different tenants' base blocks in one
call (``torch.bmm``), where the JAX package ``vmap``s a B=1 step.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


# Elements drawn in fp32 at once when a leaf is drawn in another dtype.
_DRAW_CHUNK = 1 << 28


def _is_meta(device) -> bool:
    return device is not None and torch.device(device).type == "meta"


def randn(shape, generator, device) -> torch.Tensor:
    """N(0, 1) in fp32 from ``generator`` on ``device``. On the meta
    device an empty tensor of that shape: there is no meta generator,
    and a meta tensor has a shape and a dtype but no values."""
    if _is_meta(device):
        return torch.empty(shape, dtype=torch.float32, device=device)
    return torch.randn(shape, generator=generator, device=device,
                       dtype=torch.float32)


def normal(shape, std: float, generator, device,
           dtype=torch.float32) -> torch.Tensor:
    """N(0, std^2) in ``dtype``. In fp32 one draw of the whole leaf. In
    another dtype the leaf is drawn in fp32 a slab of leading rows at a
    time and cast as it is drawn, so a bf16 model never holds more than
    ``_DRAW_CHUNK`` fp32 elements at once (one routed-expert leaf of
    deepseek-v3, 256 x 7168 x 2048, would be 15 GB in fp32). On the
    meta device nothing is drawn (``randn``)."""
    def draw(s):
        return randn(s, generator, device) * std

    if _is_meta(device):
        return torch.empty(shape, dtype=dtype, device=device)
    if dtype == torch.float32:
        return draw(shape)
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.view(-1, shape[-1]) if len(shape) > 1 else out.view(1, -1)
    rows = max(1, _DRAW_CHUNK // max(1, flat.shape[1]))
    for r0 in range(0, flat.shape[0], rows):
        blk = flat[r0:r0 + rows]
        blk.copy_(draw(blk.shape))
    return out


# ----------------------------------------------------------------- linear


def init_linear(generator, d_in: int, d_out: int, *, bias: bool = False,
                device=None, lead=(), dtype=torch.float32):
    """N(0, 1/d_in) weights, zero bias, as the JAX package draws them.
    ``lead`` prepends stacked dims (e.g. the group dim)."""
    scale = 1.0 / math.sqrt(d_in)
    p = {"w": normal((*lead, d_in, d_out), scale, generator, device, dtype)}
    if bias:
        p["b"] = torch.zeros((*lead, d_out), device=device, dtype=dtype)
    return p


def row(t: torch.Tensor, per_row_ndim: int, x_ndim: int = 3) -> torch.Tensor:
    """A per-row parameter (leading B dim, ``per_row_ndim`` dims) with
    singleton dims inserted after B, so it broadcasts against
    activations of ``x_ndim`` dims, (B, S, ...): a (B, d) norm scale
    becomes (B, 1, d) for (B, S, d) and (B, 1, 1, d) for per-head
    (B, S, H, d). A shared parameter is returned as it is."""
    if t.dim() != per_row_ndim:
        return t
    return t.reshape(t.shape[0], *([1] * (x_ndim - per_row_ndim)),
                     *t.shape[1:])


def linear(p, x: torch.Tensor) -> torch.Tensor:
    """y = x @ w (+ b), in the activation's dtype. x: (B, S, d_in).

    The JAX package casts fp32 master weights to the activation dtype on
    every call; the port casts them once, when a serving lane is built
    (``cast_for_compute``), so the ``.to`` below is then a no-op and the
    values are bitwise the same.
    """
    w = p["w"].to(x.dtype)
    y = torch.bmm(x, w) if w.dim() == 3 else x @ w
    if "b" in p:
        y = y + row(p["b"].to(y.dtype), 2)
    return y


# ----------------------------------------------------------------- embedding


def init_embedding(generator, vocab: int, d_model: int, *, device=None,
                   dtype=torch.float32):
    return {"table": normal((vocab, d_model), 0.02, generator, device, dtype)}


def embedding(p, ids: torch.Tensor, *, compute_dtype=None) -> torch.Tensor:
    """ids: (B, S) -> (B, S, d). A per-row table (B, V, d) is indexed
    row by row."""
    t = p["table"]
    if compute_dtype is not None:
        t = t.to(compute_dtype)
    if t.dim() == 3:
        rows = torch.arange(ids.shape[0], device=ids.device)[:, None]
        return t[rows, ids]
    return t[ids]


# ----------------------------------------------------------------- norms


def init_norm(d: int, kind: str, *, device=None, dtype=torch.float32):
    if kind == "rmsnorm":
        return {"scale": torch.ones((d,), device=device, dtype=dtype)}
    if kind == "layernorm":
        return {"scale": torch.ones((d,), device=device, dtype=dtype),
                "bias": torch.zeros((d,), device=device, dtype=dtype)}
    if kind == "nonparam_ln":  # OLMo: LN without learnable affine
        return {}
    raise ValueError(kind)


def apply_norm(p, x: torch.Tensor, kind: str, *, eps: float = 1e-6):
    """fp32 upcast, normalize, scale in fp32, cast back to ``x.dtype``.
    A per-row scale (B, d) applies row b's to x[b], whatever x's rank
    (qk-norm normalizes per head, x (B, S, H, hd))."""
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        y = y * row(p["scale"].float(), 2, x.dim())
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
        if kind == "layernorm":
            y = (y * row(p["scale"].float(), 2, x.dim())
                 + row(p["bias"].float(), 2, x.dim()))
    return y.to(x.dtype)


# ----------------------------------------------------------------- acts


def activation(name: str):
    # jax.nn.gelu defaults to the tanh approximation.
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
    }[name]


# ------------------------------------------------------ recurrent mixers


def update_state(cache: dict, new: dict, live: Optional[torch.Tensor]):
    """Write ``new`` into ``cache`` in place, leaf by leaf; rows where
    ``live`` (B,) is False keep their old value."""
    for name, t in new.items():
        old = cache[name]
        if live is not None:
            t = torch.where(live.view(-1, *([1] * (old.dim() - 1))), t, old)
        old.copy_(t)


def conv_taps(window: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The decode step's causal conv: sum_k window[:, k] * w[k]. window:
    (B, K, di); w: (K, di) shared or (B, K, di) per row."""
    w = w.to(window.dtype)
    return torch.sum(window * (w if w.dim() == 3 else w[None]), dim=1,
                     keepdim=True)


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Depthwise causal conv over a full sequence. x: (B, S, di); w:
    (K, di); b: (di,)."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    w = w.to(x.dtype)
    out = 0
    for k in range(K):
        out = out + xp[:, k:k + S, :] * w[k]
    return out + b.to(x.dtype)


# ----------------------------------------------------------------- trees


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_index(tree, i: int):
    """Leaf-wise ``a[i]`` along the stacked leading dim (a view)."""
    return tree_map(lambda a: a[i], tree)


# Leaves that the layers cast to the activation dtype at use, and only
# there: linear weights and biases, embedding tables, and the recurrent
# mixers' conv taps and biases, skip gains and sLSTM weights (``wx``,
# ``wr``; sLSTM's gate bias is also called ``b``, and the reference casts
# it at use too, so casting it once gives the same values). ``a_log``
# is not among them: Mamba exponentiates it in fp32 before the cast.
CAST_AT_USE = frozenset(("w", "b", "table", "wx", "wr", "conv_w", "conv_b",
                         "skip", "d_skip"))


def cast_for_compute(tree, dtype: torch.dtype):
    """Cast the leaves in ``CAST_AT_USE`` to the compute dtype, once.
    Norm scales stay as stored: ``apply_norm`` upcasts them to fp32, and
    a bf16 round trip would change their values."""
    def walk(t):
        return {k: walk(v) if isinstance(v, dict)
                else (v.to(dtype) if k in CAST_AT_USE else v)
                for k, v in t.items()}

    return walk(tree)

