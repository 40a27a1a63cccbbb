"""IFL on a language model as one round step over N clients, on one card:
the port of ``repro.core.ifl_spmd``.

The reference runs a round as one jitted SPMD program with every
parameter leaf stacked along a leading (N,) client dim. The port keeps
the N clients' parameter trees in a Python list and loops over them; the
phases and their order are the reference's (Algorithm 1, lines 5-31):

  1. tau local base-block steps (eq. 7): at each step every client takes
     one SGD step of the full LM loss with respect to its base block,
     against its own, still unchanged modular block (``lax.scan`` over
     tau with the clients inside);
  2. the fusion forward z_k = f_b(x_k) on each client's fusion
     minibatch, without autograd, then the wire
     (``SPMDFusionExchange.wire``: encode, EF, "all-gather", decode);
  3. the modular phase: for each gathered chunk (z_i, y_i) in client
     order, every client takes one modular step on it.

Each client's step builds and frees its own graph, so no more than one
client's activations are alive at a time. Params and optimizer state are
updated in place (``repro_torch.optim``). Losses are the reference's
means: ``base_loss`` over tau steps and N clients, ``mod_loss`` over N
chunks and N clients; they are read from the card once per round.

``make_dp_train_step`` is the FL-equivalent dense baseline.
Partial participation (the reference's ``partial_participation=True``,
its payload cache and ``max_staleness``) raises NotImplementedError.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.core.comm import tree_leaves
from repro_torch.core.exchange import SPMDFusionExchange, init_ef_state  # noqa: F401
from repro_torch.models import modules as nn
from repro_torch.models.transformer import (
    base_forward,
    chunked_ce,
    init_lm,
    lm_loss,
    modular_forward,
    modular_trunk,
)
from repro_torch.optim import make_optimizer


# ------------------------------------------------------------------ losses


def _modular_loss(mod, cfg: ModelConfig, z, tokens):
    if cfg.ce_chunk:
        h = modular_trunk(mod, cfg, z)
        return chunked_ce(mod, cfg, h, tokens, offset=1, start=0)
    logits = modular_forward(mod, cfg, z)
    lp = F.log_softmax(logits[:, :-1], dim=-1)
    tgt = tokens[:, 1:]
    return -torch.gather(lp, -1, tgt[..., None].long()).mean()


def _full_loss_wrt_base(base, mod, cfg: ModelConfig, batch):
    z = base_forward(base, cfg, batch)
    return _modular_loss(mod, cfg, z, batch["tokens"])


def _unflatten_like(tree, it):
    if isinstance(tree, dict):
        return {k: _unflatten_like(v, it) for k, v in tree.items()}
    return next(it)


def value_and_grad(fn, tree, *args):
    """``jax.value_and_grad(fn)(tree, *args)`` over a tensor tree: the
    gradient is taken with respect to detached aliases of the leaves, so
    the params themselves never require grad and their in-place update
    is not recorded. -> (loss detached, grads with ``tree``'s keys)."""
    live = nn.tree_map(lambda a: a.detach().requires_grad_(), tree)
    loss = fn(live, *args)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    return loss.detach(), _unflatten_like(tree, iter(grads))


# ------------------------------------------------------------------ round


def make_ifl_round_step(
    cfg: ModelConfig,
    *,
    n_clients: int,
    tau: int,
    lr_base: float = 1e-3,
    lr_modular: float = 1e-3,
    optimizer: str = "sgd",
    codec: Optional[str] = None,
    debug_return_zhat: bool = False,
    partial_participation: bool = False,
    max_staleness: Optional[int] = None,
) -> Callable:
    """Build the one-round IFL step over N per-client trees.

    params: a list of N trees ``{"base", "modular"}``; opt_state: a list
    of N ``{"base", "modular"}`` optimizer states; batch: ``{"tokens":
    (N, tau + 1, Bc, S)}``, tau base minibatches and one fusion
    minibatch per client.

    Stateless codecs:  step(params, opt_state, batch)
                         -> (params, opt_state, metrics)
    Stateful  codecs:  step(params, opt_state, batch, ef_state)
                         -> (params, opt_state, metrics, ef_state')
    with ``ef_state`` from ``init_ef_state`` (N, Bc, S, d_fusion).
    Params and state are updated in place and returned.
    ``debug_return_zhat`` adds the pre-encode ``z`` and the decoded
    ``z_hat`` (stacked) to metrics.
    """
    if partial_participation:
        raise NotImplementedError(
            "partial participation on the SPMD path (ROADMAP.md queue 1, "
            "item 4b)")
    opt = make_optimizer(optimizer)
    exchange = SPMDFusionExchange(codec, n_clients=n_clients,
                                  max_staleness=max_staleness)
    stateful = exchange.codec.has_state

    def round_step(params: List, opt_state: List, batch, ef_state=()):
        tokens = batch["tokens"]
        # Phase 1: tau local base-block updates (eq. 7).
        base_losses = []
        for t in range(tau):
            for k in range(n_clients):
                mb = {"tokens": tokens[k, t]}
                loss, g = value_and_grad(_full_loss_wrt_base,
                                         params[k]["base"],
                                         params[k]["modular"], cfg, mb)
                opt.update(params[k]["base"], g, opt_state[k]["base"],
                           lr_base)
                base_losses.append(loss)
                del g
        # Phase 2: fusion forward and the wire (lines 13-21).
        fusion_tokens = tokens[:, tau]
        with torch.no_grad():
            z = torch.stack([
                base_forward(params[k]["base"], cfg,
                             {"tokens": fusion_tokens[k]})
                for k in range(n_clients)])
        zg, yg, _, _, ef_state = exchange.wire(z, fusion_tokens, None, None,
                                               ef_state)
        # Phase 3: modular updates, chunk by chunk (lines 22-31).
        mod_losses = []
        for i in range(n_clients):
            for k in range(n_clients):
                loss, g = value_and_grad(_modular_loss, params[k]["modular"],
                                         cfg, zg[i], yg[i])
                opt.update(params[k]["modular"], g, opt_state[k]["modular"],
                           lr_modular)
                mod_losses.append(loss)
                del g
        metrics = {"base_loss": torch.stack(base_losses).mean(),
                   "mod_loss": torch.stack(mod_losses).mean()}
        if debug_return_zhat:
            metrics["z"] = z
            metrics["z_hat"] = zg
        if stateful:
            return params, opt_state, metrics, ef_state
        return params, opt_state, metrics

    return round_step


def init_ifl_state(cfg: ModelConfig, *, n_clients: int,
                   generator: torch.Generator, device,
                   optimizer: str = "sgd"):
    """N clients' params (``init_lm``, drawn one client after another
    from ``generator``, cast to ``cfg.param_dtype``) and their optimizer
    states. -> (list of N param trees, list of N {"base", "modular"}
    states). The reference's stacked init, carried across as numpy,
    becomes the same lists through ``checkpoint.unstack_clients``."""
    opt = make_optimizer(optimizer)
    pdt = nn.dtype_of(cfg.param_dtype)
    params, states = [], []
    for _ in range(n_clients):
        p = nn.tree_map(lambda a: a.to(pdt),
                        init_lm(cfg, generator=generator, device=device))
        params.append(p)
        states.append({"base": opt.init(p["base"]),
                       "modular": opt.init(p["modular"])})
    return params, states


# ------------------------------------------------------------------ dense


def make_dp_train_step(cfg: ModelConfig, *, lr: float = 1e-3,
                       optimizer: str = "sgd") -> Callable:
    """FL-equivalent plain data-parallel step (grad sync ∝ |params|):
    step(params, opt_state, batch) -> (params, opt_state, {"loss"}),
    params updated in place."""
    opt = make_optimizer(optimizer)

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(lm_loss, params, cfg, batch)
        opt.update(params, grads, opt_state, lr)
        return params, opt_state, {"loss": loss}

    return train_step
