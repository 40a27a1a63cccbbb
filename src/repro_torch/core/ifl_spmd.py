"""IFL on a language model as one round step over N clients: the port of
``repro.core.ifl_spmd``, in one process or on a ('client', 'data',
'model') mesh of ``torch.distributed`` ranks.

The reference runs a round as one jitted SPMD program with every
parameter leaf stacked along a leading (N,) client dim. The port keeps
the clients' parameter trees in a Python list and loops over them; the
phases and their order are the reference's (Algorithm 1, lines 5-31):

  1. tau local base-block steps (eq. 7): at each step every client takes
     one SGD step of the full LM loss with respect to its base block,
     against its own, still unchanged modular block (``lax.scan`` over
     tau with the clients inside);
  2. the fusion forward z_k = f_b(x_k) on each client's fusion
     minibatch, without autograd, then the wire
     (``SPMDFusionExchange.wire``: encode, EF, all-gather, decode);
  3. the modular phase: for each gathered chunk (z_i, y_i) in client
     order, every client takes one modular step on it.

Without a mesh one process holds all N clients, and the all-gather is
the stacking of their payloads. With ``mesh=`` each rank holds the
contiguous block of N / C clients that P('client', ...) gives it (C the
client axis's size) and rows [d * Bc / D, (d + 1) * Bc / D) of their
minibatches (D the data axis's size): phases 1 and 3 run on its own
clients and rows, and every gradient is averaged over the client's data
group, so it equals the full minibatch's mean; phase 2 gathers the
encoded payloads over the client group, a real collective. The 'model'
axis stays at 1 (``launch.mesh.ClientLayout``).

Each client's step builds and frees its own graph, so no more than one
client's activations are alive at a time. Params and optimizer state are
updated in place (``repro_torch.optim``). Losses are the reference's
means: ``base_loss`` over tau steps and the participating clients,
``mod_loss`` over the valid chunks and the participating clients; on a
mesh each rank's losses are averaged over its data group and gathered
over the client group, and the mean is taken in the one-process order,
so every rank reports the same numbers. They are read once per round.

Partial participation (``partial_participation=True``) threads an (N,)
bool mask and the carried payload cache (``init_payload_cache``)
through the step, with the reference's semantics; where the reference
computes absent clients' steps and discards them, the port skips them
(and the chunks that are not valid), which gives the same results.
``init_ifl_slot_state`` is one population slot's init, a function of
(seed, slot) alone. ``make_dp_train_step`` is the FL-equivalent dense
baseline; ``make_prefill_step`` / ``make_serve_step`` cover the
inference shapes.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.core.codec import get_codec
from repro_torch.core.comm import tree_leaves
from repro_torch.core.exchange import (  # noqa: F401  (re-exported)
    SPMDFusionExchange,
    init_ef_state,
    init_payload_cache,
)
from repro_torch.models import modules as nn
from repro_torch.models.transformer import (
    base_forward,
    chunked_ce,
    composed_decode_step,
    init_lm,
    lm_logits,
    lm_loss,
    modular_forward,
    modular_trunk,
    mtp_hidden,
)
from repro_torch.optim import make_optimizer


# ------------------------------------------------------------------ losses


def _next_ce(logits, tokens, offset: int, start: int):
    lp = F.log_softmax(logits[:, start:-offset], dim=-1)
    return -torch.gather(lp, -1,
                         tokens[:, start + offset:, None].long()).mean()


def _modular_loss(mod, cfg: ModelConfig, z, tokens):
    """The modular block's loss on z: next-token CE, + 0.3 x the MTP
    head's offset-2 CE, + the modular layers' MoE load-balance loss; no
    CE on the image positions."""
    start = cfg.num_image_tokens
    if cfg.ce_chunk:
        h, aux, positions = modular_trunk(mod, cfg, z)
        loss = chunked_ce(mod, cfg, h, tokens, offset=1, start=start)
        if cfg.use_mtp:
            h2 = mtp_hidden(mod, cfg, h, positions)
            loss = loss + 0.3 * chunked_ce(mod, cfg, h2, tokens, offset=2,
                                           start=start)
        return loss + aux
    out = modular_forward(mod, cfg, z)
    loss = _next_ce(out[0], tokens, 1, start)
    if cfg.use_mtp:
        loss = loss + 0.3 * _next_ce(out[2], tokens, 2, start)
    return loss + out[1]


def _full_loss_wrt_base(base, mod, cfg: ModelConfig, batch):
    z, aux_b = base_forward(base, cfg, batch)
    return _modular_loss(mod, cfg, z, batch["tokens"]) + aux_b


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
    mesh=None,
    n_clients: int,
    tau: int,
    lr_base: float = 1e-3,
    lr_modular: float = 1e-3,
    optimizer: str = "sgd",
    codec: Optional[str] = None,
    debug_return_zhat: bool = False,
    partial_participation: bool = False,
    max_staleness: Optional[int] = None,
    exchange: Optional[SPMDFusionExchange] = None,
) -> Callable:
    """Build the one-round IFL step over N per-client trees.

    params: a list of N trees ``{"base", "modular"}``; opt_state: a list
    of N ``{"base", "modular"}`` optimizer states; batch: ``{"tokens":
    (N, tau + 1, Bc, S)}``, tau base minibatches and one fusion
    minibatch per client, with ``image_embeds`` (N, tau + 1, Bc, n_img,
    d) or ``frame_embeds`` (N, tau + 1, Bc, S_enc, d) where the config
    has those frontends (every leaf sliced per client and step).

    Stateless codecs:  step(params, opt_state, batch)
                         -> (params, opt_state, metrics)
    Stateful  codecs:  step(params, opt_state, batch, ef_state)
                         -> (params, opt_state, metrics, ef_state')
    with ``ef_state`` from ``init_ef_state`` (N, Bc, S, d_fusion).

    ``partial_participation=True`` inserts an (N,) bool ``mask`` and a
    ``cache`` (from ``init_payload_cache``) after ``batch``:

    Stateless: step(params, opt_state, batch, mask, cache)
                 -> (params, opt_state, metrics, cache')
    Stateful : step(params, opt_state, batch, mask, cache, ef_state)
                 -> (params, opt_state, metrics, cache', ef_state')

    Absent clients (mask False) do no work: no base step, no fusion
    forward, no modular step, so their params, optimizer state and EF
    residual stay bitwise as they were, and their batch rows are never
    read. A chunk whose cache slot is not valid (older than
    ``max_staleness`` or never filled) is skipped, a true no-op for the
    params and the optimizer state alike. Losses are means over the
    participants (and the valid chunks); a round with no participant or
    no valid chunk reports NaN; metrics carry ``participating`` and
    ``cache_valid``.

    The wire is the exchange plane's: pass an ``exchange`` (as
    ``repro_torch.api.spmd`` does, so its ``account_round`` shares the
    codec and staleness with this step) or let one be built from
    ``codec`` / ``max_staleness``; a ``codec`` or ``max_staleness`` that
    conflicts with the given plane raises ``ValueError``.

    Params and state are updated in place and returned.
    ``debug_return_zhat`` adds the pre-encode ``z`` (zeros in absent
    clients' rows) and the decoded ``z_hat`` (stacked) to metrics.

    ``mesh``: a ('client', 'data', 'model') ``DeviceMesh`` (module
    docstring). Then params and opt_state are the lists of this rank's
    clients only (``init_ifl_state(..., mesh=)``), ``ef_state`` and the
    cache this rank's block (its clients, its rows: shapes (N / C, Bc /
    D, ...), ``SPMDFusionExchange.carried_pspecs``), while ``batch`` and
    ``mask`` keep their whole shapes, the same on every rank (the rows of
    other ranks' clients are never read, and may be zeros); z and z_hat
    in the metrics are this rank's rows. A given ``exchange`` must be
    on the same mesh. Raises where the mesh has a 'model' axis above 1,
    a client axis that does not divide N, or no process group.
    """
    from repro_torch.sharding.rules import (
        all_gather_cat,
        batch_pspec,
        local_block,
        tree_shardings,
    )

    opt = make_optimizer(optimizer)
    if exchange is None:
        exchange = SPMDFusionExchange(codec, n_clients=n_clients,
                                      max_staleness=max_staleness, mesh=mesh)
    elif exchange.mesh is not mesh:
        raise ValueError("make_ifl_round_step: the exchange plane is on "
                         "another mesh than the step; build both on one")
    else:
        if codec is not None and get_codec(codec).name != exchange.codec.name:
            raise ValueError(
                f"make_ifl_round_step: codec={codec!r} conflicts with the "
                f"exchange plane's {exchange.codec.name!r}; configure the "
                "codec on the plane")
        if (max_staleness is not None
                and max_staleness != exchange.max_staleness):
            raise ValueError(
                f"make_ifl_round_step: max_staleness={max_staleness!r} "
                f"conflicts with the exchange plane's "
                f"{exchange.max_staleness!r}; configure it on the plane")
    stateful = exchange.codec.has_state

    lay = exchange.layout
    mine = list(range(n_clients)) if lay is None else lay.clients

    def _local(batch):
        """This rank's block of the batch: its clients, its rows."""
        if lay is None:
            return batch
        specs = tree_shardings(lay.mesh, batch_pspec(batch,
                                                     client_axis=True))
        return {name: local_block(a, lay.mesh, specs[name])
                for name, a in batch.items()}

    def _mean(losses, n_rows, active):
        """The reference's mean of the (row, client) losses over every
        row and the participating clients, in the one-process order (row
        major). On a mesh each rank's losses are first averaged over its
        data group and gathered over the client group."""
        if lay is None:
            return torch.stack([losses[r, k] for r in range(n_rows)
                                for k in active]) if active else None
        local = torch.zeros((n_rows, len(mine)), dtype=torch.float32,
                            device=lay.device())
        for (r, k), loss in losses.items():
            local[r, k] = loss
        lay.mean_over_data([local])
        everyone = all_gather_cat(local, lay.client_group, 1)
        return everyone[:, active].reshape(-1) if active else None

    def _round_impl(params: List, opt_state: List, batch, ef_state, mask,
                    cache):
        batch = _local(batch)
        tokens = batch["tokens"]
        if mask is None:
            active = list(range(n_clients))
        else:
            active = [int(k) for k in torch.nonzero(mask.cpu()).flatten()]
        live = set(active)
        mine_active = [i for i, k in enumerate(mine) if k in live]

        def step(tree, fn, args, lr, state):
            loss, g = value_and_grad(fn, tree, *args)
            if lay is not None:
                lay.mean_over_data(tree_leaves(g))
            opt.update(tree, g, state, lr)
            return loss

        # Phase 1: tau local base-block updates (eq. 7).
        base_losses = {}
        for t in range(tau):
            for i in mine_active:
                mb = {name: a[i, t] for name, a in batch.items()}
                base_losses[t, i] = step(
                    params[i]["base"], _full_loss_wrt_base,
                    (params[i]["modular"], cfg, mb), lr_base,
                    opt_state[i]["base"])
        # Phase 2: fusion forward and the wire (lines 13-21).
        fusion_tokens = tokens[:, tau]
        with torch.no_grad():
            zs = {i: base_forward(params[i]["base"], cfg,
                                  {name: a[i, tau]
                                   for name, a in batch.items()})[0]
                  for i in mine_active}
            shape = (fusion_tokens.shape[1], fusion_tokens.shape[2],
                     cfg.d_fusion)
            z0 = torch.zeros(shape, dtype=nn.dtype_of(cfg.compute_dtype),
                             device=tokens.device)
            z = torch.stack([zs.get(i, z0) for i in range(len(mine))])
        zg, yg, valid, new_cache, ef_state = exchange.wire(
            z, fusion_tokens, mask, cache, ef_state)
        # Phase 3: modular updates, chunk by chunk (lines 22-31), on the
        # valid chunks only.
        chunks = (range(n_clients) if valid is None else
                  [int(i) for i in torch.nonzero(valid.cpu()).flatten()])
        mod_losses = {}
        for c, ch in enumerate(chunks):
            for i in mine_active:
                mod_losses[c, i] = step(
                    params[i]["modular"], _modular_loss,
                    (cfg, zg[ch], yg[ch]), lr_modular,
                    opt_state[i]["modular"])
        nan = torch.tensor(float("nan"), device=tokens.device)
        base = _mean(base_losses, tau, active)
        mod = _mean(mod_losses, len(chunks), active) if chunks else None
        metrics = {
            "base_loss": nan if base is None else base.mean(),
            "mod_loss": nan if mod is None else mod.mean(),
        }
        if mask is not None:
            metrics["participating"] = mask.float().sum()
            metrics["cache_valid"] = valid.sum()
        if debug_return_zhat:
            metrics["z"] = z
            metrics["z_hat"] = zg
        return params, opt_state, metrics, new_cache, ef_state

    if partial_participation and stateful:
        def round_step(params, opt_state, batch, mask, cache, ef_state):
            return _round_impl(params, opt_state, batch, ef_state, mask,
                               cache)
    elif partial_participation:
        def round_step(params, opt_state, batch, mask, cache):
            return _round_impl(params, opt_state, batch, (), mask,
                               cache)[:4]
    elif stateful:
        def round_step(params, opt_state, batch, ef_state):
            p, o, m, _, e = _round_impl(params, opt_state, batch, ef_state,
                                        None, None)
            return p, o, m, e
    else:
        def round_step(params, opt_state, batch):
            return _round_impl(params, opt_state, batch, (), None,
                               None)[:3]

    return round_step


def init_ifl_state(cfg: ModelConfig, *, n_clients: int,
                   generator: torch.Generator, device,
                   optimizer: str = "sgd", mesh=None):
    """N clients' params (``init_lm``, drawn one client after another
    from ``generator``, cast to ``cfg.param_dtype``) and their optimizer
    states. -> (list of N param trees, list of N {"base", "modular"}
    states). The reference's stacked init, carried across as numpy,
    becomes the same lists through ``checkpoint.unstack_clients``.

    With ``mesh`` the lists hold this rank's clients only, each exactly
    the tree the one-process init gives it: the rank draws every client
    in turn from ``generator`` (so it reaches its clients' draws by the
    same sequence) and keeps its own."""
    from repro_torch.launch.mesh import ClientLayout

    opt = make_optimizer(optimizer)
    pdt = nn.dtype_of(cfg.param_dtype)
    keep = (range(n_clients) if mesh is None
            else ClientLayout.of(mesh, n_clients).clients)
    params, states = [], []
    for k in range(n_clients):
        p = init_lm(cfg, generator=generator, device=device, dtype=pdt)
        if k not in keep:
            continue
        params.append(p)
        states.append({"base": opt.init(p["base"]),
                       "modular": opt.init(p["modular"])})
    return params, states


def init_ifl_slot_state(cfg: ModelConfig, *, seed: int, slot: int,
                        optimizer: str = "sgd", device=None):
    """ONE population slot's params (``init_lm`` in ``cfg.param_dtype``)
    and optimizer state, the trees a ``PopulationStore`` pages cohorts
    from. The draw comes from a CPU ``torch.Generator`` seeded from
    (seed, slot) alone and is then moved to ``device``, so it does not
    depend on the fleet size, on any other slot or on the device. (The
    reference folds the slot into a JAX key, a stream torch cannot
    reproduce; parity tests carry its slots across as numpy.)"""
    # The CPU generator keeps 32 bits of its seed: hash (seed, slot) into
    # them rather than pack the pair.
    mixed = np.random.SeedSequence([int(seed), int(slot)]).generate_state(1)
    gen = torch.Generator().manual_seed(int(mixed[0]))
    params, states = init_ifl_state(cfg, n_clients=1, generator=gen,
                                    device="cpu", optimizer=optimizer)
    return (nn.tree_map(lambda a: a.to(device), params[0]),
            nn.tree_map(lambda a: a.to(device), states[0]))


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


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """prefill_step(params, batch) -> logits (B, S, V) fp32: the LM
    head's alone (``lm_logits``; an MTP head's are not computed)."""

    def prefill_step(params, batch):
        return lm_logits(params, cfg, batch)

    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """serve_step(params, cache, token, pos, cross_kvs=None) -> (logits
    (B, 1, V), cache): one decode step of the model over a cache from
    ``transformer.init_composed_cache(cfg, cfg, ...)``; ``pos`` is this
    token's index, a scalar or one per row; ``cross_kvs`` an enc-dec
    arch's ``build_cross_caches``. The cache is updated in place."""

    def serve_step(params, cache, token, pos, cross_kvs=None):
        pos = torch.as_tensor(pos, device=token.device).expand(
            token.shape[0])
        return composed_decode_step(params["base"], cfg, params["modular"],
                                    cfg, cache, token, pos,
                                    cross_kvs=cross_kvs)

    return serve_step
