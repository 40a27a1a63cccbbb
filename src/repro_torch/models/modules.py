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
import torch
import torch.nn.functional as F


def dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


def _randn(shape, generator, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device,
                       dtype=torch.float32)


# ----------------------------------------------------------------- linear


def init_linear(generator, d_in: int, d_out: int, *, bias: bool = False,
                device=None, lead=()):
    """N(0, 1/d_in) weights, zero bias, as the JAX package draws them.
    ``lead`` prepends stacked dims (e.g. the group dim)."""
    scale = 1.0 / math.sqrt(d_in)
    p = {"w": _randn((*lead, d_in, d_out), generator, device) * scale}
    if bias:
        p["b"] = torch.zeros((*lead, d_out), device=device)
    return p


def _row(t: torch.Tensor, per_row_ndim: int) -> torch.Tensor:
    """Insert the sequence dim into a per-row parameter so it broadcasts
    against activations of shape (B, S, ...)."""
    return t.unsqueeze(1) if t.dim() == per_row_ndim else t


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
        y = y + _row(p["b"].to(y.dtype), 2)
    return y


# ----------------------------------------------------------------- embedding


def init_embedding(generator, vocab: int, d_model: int, *, device=None):
    return {"table": _randn((vocab, d_model), generator, device) * 0.02}


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


def init_norm(d: int, kind: str, *, device=None):
    if kind == "rmsnorm":
        return {"scale": torch.ones((d,), device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones((d,), device=device),
                "bias": torch.zeros((d,), device=device)}
    if kind == "nonparam_ln":  # OLMo: LN without learnable affine
        return {}
    raise ValueError(kind)


def apply_norm(p, x: torch.Tensor, kind: str, *, eps: float = 1e-6):
    """fp32 upcast, normalize, scale in fp32, cast back to ``x.dtype``."""
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        y = y * _row(p["scale"].float(), 2)
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
        if kind == "layernorm":
            y = y * _row(p["scale"].float(), 2) + _row(p["bias"].float(), 2)
    return y.to(x.dtype)


# ----------------------------------------------------------------- acts


def activation(name: str):
    # jax.nn.gelu defaults to the tanh approximation.
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
    }[name]


# ----------------------------------------------------------------- trees


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_index(tree, i: int):
    """Leaf-wise ``a[i]`` along the stacked leading dim (a view)."""
    return tree_map(lambda a: a[i], tree)


def cast_for_compute(tree, dtype: torch.dtype):
    """Cast the leaves that ``linear`` and ``embedding`` cast at use
    (``w``, ``b``, ``table``) to the compute dtype, once. Norm scales
    stay as stored: ``apply_norm`` upcasts them to fp32, and a bf16
    round trip would change their values."""
    def walk(t):
        return {k: walk(v) if isinstance(v, dict)
                else (v.to(dtype) if k in ("w", "b", "table") else v)
                for k, v in t.items()}

    return walk(tree)

