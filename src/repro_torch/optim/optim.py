"""Optimizers over tensor trees (nested dicts of tensors), the port's
copy of ``repro.optim.optim``: SGD (the paper's, optionally with
momentum and weight decay) and AdamW.

The reference is functional (``update`` returns new trees); the port
updates the params and the state **in place**, under ``torch.no_grad``,
and returns the same trees, so a full-width client's params are never
held twice. The arithmetic is the reference's, step for step.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.core.comm import tree_leaves


def _zeros_like(tree, dtype=None):
    if isinstance(tree, dict):
        return {k: _zeros_like(v, dtype) for k, v in tree.items()}
    return torch.zeros_like(tree, dtype=dtype)


# ----------------------------------------------------------------- SGD


def sgd_init(params, momentum: float = 0.0):
    if momentum == 0.0:
        return {}
    return {"mu": _zeros_like(params)}


@torch.no_grad()
def sgd_update(params, grads, state, *, lr, momentum: float = 0.0,
               weight_decay: float = 0.0):
    """p -= lr * g (with ``mu = momentum * mu + g`` in place of g when
    momentum is on; ``g + weight_decay * p`` in place of g when weight
    decay is on). ``grads`` has the structure and key order of
    ``params``."""
    ps, gs = tree_leaves(params), tree_leaves(grads)
    if weight_decay:
        gs = [g + weight_decay * p for g, p in zip(gs, ps)]
    if momentum != 0.0:
        mus = tree_leaves(state["mu"])
        for m, g in zip(mus, gs):
            m.mul_(momentum).add_(g)
        gs = mus
    for p, g in zip(ps, gs):
        p.sub_(lr * g.to(p.dtype))
    return params, state


# ----------------------------------------------------------------- AdamW


def adamw_init(params):
    return {"m": _zeros_like(params, torch.float32),
            "v": _zeros_like(params, torch.float32),
            "step": torch.zeros((), dtype=torch.int32,
                                device=tree_leaves(params)[0].device)}


@torch.no_grad()
def adamw_update(params, grads, state, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.0):
    state["step"].add_(1)
    step = state["step"].float()
    bc1 = 1 - b1 ** step
    bc2 = 1 - b2 ** step
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        gf = g.float()
        m.mul_(b1).add_((1 - b1) * gf)
        v.mul_(b2).add_((1 - b2) * torch.square(gf))
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay:
            u = u + weight_decay * p.float()
        p.copy_((p.float() - lr * u).to(p.dtype))
    return params, state


# ----------------------------------------------------------------- factory


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Tuple[Any, Any]]  # (params, grads, state, lr)


def make_optimizer(name: str, **kw) -> Optimizer:
    if name == "sgd":
        mom = kw.get("momentum", 0.0)
        return Optimizer(
            init=lambda p: sgd_init(p, mom),
            update=lambda p, g, s, lr: sgd_update(
                p, g, s, lr=lr, momentum=mom,
                weight_decay=kw.get("weight_decay", 0.0)),
        )
    if name == "adamw":
        return Optimizer(
            init=adamw_init,
            update=lambda p, g, s, lr: adamw_update(
                p, g, s, lr=lr, b1=kw.get("b1", 0.9), b2=kw.get("b2", 0.95),
                weight_decay=kw.get("weight_decay", 0.0)),
        )
    raise ValueError(name)
