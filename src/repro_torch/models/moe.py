"""Mixture-of-Experts channel mixer with sort-based dispatch, the port of
the JAX package's ``models/moe.py``.

Experts are stacked along a leading ``(E,)`` dim. Dispatch never builds
the GShard ``(tokens, E, capacity)`` one-hot: each (token, choice) is
ranked within its expert by a stable sort of the expert ids, token-major,
entries ranked at or past the capacity C are dropped (gate weight 0, but
they still count in the load-balance statistic), and activations move by
gather and scatter into an ``(E, C, d)`` buffer that the experts run as
one batched product.

The router is a softmax with top-K choices, renormalized, and a Switch
auxiliary loss ``E * sum_e f_e * p_e * router_aux_coef`` (deepseek-v3's
sigmoid-and-bias router is approximated this way in the reference too).
``jax.lax.top_k`` puts the lower expert index first among equal
probabilities, which ``torch.topk`` does not promise; the choice here is
a stable descending sort, which does.

``moe_decode`` is the one-token form the serving paths run: the JAX
package vmaps a B=1 step over a lane's slots, so each row routes alone,
with T = 1 and C = max(floor(K * cf / E), 4) >= 1, and no row's choice is
ever dropped or depends on another row. It computes exactly that, each
row's K experts' weights gathered and applied as one batched product.
Expert and router weights may carry a leading row dim (a serving lane's
per-slot base block).

The JAX package has no Pallas kernel for MoE (it is plain ``jnp``), so
on the card it runs as plain PyTorch operations: that is its port.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import modules as nn
from repro_torch.models.mlp import init_mlp, mlp_forward


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    cap = int(tokens * cfg.num_experts_per_tok * cfg.capacity_factor
              / cfg.num_experts)
    return max(cap, 4)


def init_moe(generator, cfg: ModelConfig, *, device=None, lead=(),
             dtype=torch.float32):
    d, dff = cfg.d_model, (cfg.moe_d_ff or cfg.d_ff)
    kw = dict(device=device, lead=lead, dtype=dtype)
    p = {
        "router": nn.init_linear(generator, d, cfg.num_experts, **kw),
        "experts": init_mlp(generator, d, dff, device=device,
                            lead=(*lead, cfg.num_experts), dtype=dtype),
    }
    if cfg.num_shared_experts > 0:
        p["shared"] = init_mlp(generator, d, dff * cfg.num_shared_experts,
                               **kw)
    return p


def route(p, cfg: ModelConfig, x) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """x: (B, S, d) -> (probs (B*S, E) fp32, gates (B*S, K) fp32
    renormalized, idx (B*S, K) long), the reference's choices: among
    equal probabilities the lower expert index first."""
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    logits = nn.linear(p["router"], x).float().reshape(-1, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, idx = gate_vals[:, :K], idx[:, :K]
    gate_vals = gate_vals / (gate_vals.sum(dim=-1, keepdim=True) + 1e-9)
    return probs, gate_vals, idx


def _expert_ffn(experts, x, act: str):
    """x: (E, C, d) -> (E, C, d), batched over the expert dim. Each
    stack is cast to x's dtype where it is used, so a cast copy (15 GB
    for one of deepseek-v3's bf16 stacks in fp32) lives one at a time."""
    a = nn.activation(act)

    def w(k):
        return experts[k]["w"].to(x.dtype)

    h = a(torch.bmm(x, w("w_gate"))) * torch.bmm(x, w("w_up"))
    return torch.bmm(h, w("w_down"))


def rank_in_expert(e_flat: torch.Tensor, E: int) -> torch.Tensor:
    """Position of each (token, choice) within its expert's arrival
    order: e_flat (n,) expert ids, token-major -> (n,) ranks, from a
    stable sort (no (n, E) one-hot)."""
    n = e_flat.shape[0]
    e_sorted, order = torch.sort(e_flat, stable=True)
    hist = torch.bincount(e_flat, minlength=E)
    starts = torch.cumsum(hist, 0) - hist  # exclusive prefix sum
    pos_sorted = torch.arange(n, device=e_flat.device) - starts[e_sorted]
    return torch.empty_like(e_flat).scatter_(0, order, pos_sorted)


def moe_forward(p, cfg: ModelConfig, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) with shared weights. Returns (y (B, S, d), aux fp32
    scalar); all B * S tokens share one capacity, as in the reference."""
    B, S, d = x.shape
    T = B * S
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    C = _capacity(T, cfg)
    xt = x.reshape(T, d)
    probs, gate_vals, idx = route(p, cfg, x)

    e_flat = idx.reshape(T * K)
    pos_flat = rank_in_expert(e_flat, E)
    keep = pos_flat < C

    # Load-balance auxiliary loss (Switch): E * sum(f_e * p_e).
    frac_tokens = torch.bincount(e_flat, minlength=E).float() / (T * K)
    frac_probs = probs.mean(dim=0)
    aux = E * torch.sum(frac_tokens * frac_probs) * cfg.router_aux_coef

    # Dispatch: each kept entry's token row into its (expert, rank) slot.
    token_of = torch.arange(T, device=x.device).repeat_interleave(K)
    slot = e_flat * C + pos_flat  # unique among kept entries
    kept_slot = slot[keep]
    slot_to_token = torch.zeros(E * C, dtype=torch.long, device=x.device)
    slot_to_token[kept_slot] = token_of[keep]
    slot_used = torch.zeros(E * C, dtype=torch.bool, device=x.device)
    slot_used[kept_slot] = True
    xe = torch.where(slot_used[:, None], xt[slot_to_token], 0)
    ye = _expert_ffn(p["experts"], xe.reshape(E, C, d),
                     cfg.act).reshape(E * C, d)

    # Combine: each (token, choice)'s expert output, weighted, summed.
    gath = ye[torch.clamp(slot, max=E * C - 1)]
    w = (gate_vals.reshape(T * K) * keep.float()).to(x.dtype)
    yt = (gath * w[:, None]).reshape(T, K, d).sum(dim=1)
    y = yt.reshape(B, S, d)
    if "shared" in p:
        y = y + mlp_forward(p["shared"], x, cfg.act)
    return y, aux.float()


def moe_decode(p, cfg: ModelConfig, x) -> torch.Tensor:
    """x: (B, 1, d), each row routed alone (the reference's vmapped B=1
    step: T = 1, so no choice is dropped). Router and expert weights may
    be shared or carry a leading B dim. Returns y (B, 1, d)."""
    B, _, d = x.shape
    K = cfg.num_experts_per_tok
    _, gate_vals, idx = route(p, cfg, x)  # (B, K)
    ex = p["experts"]
    if ex["w_gate"]["w"].dim() == 4:  # per-row experts (B, E, d, f)
        rows = torch.arange(B, device=x.device)[:, None]
        wg, wu, wd = (ex[k]["w"][rows, idx].to(x.dtype)
                      for k in ("w_gate", "w_up", "w_down"))
    else:
        wg, wu, wd = (ex[k]["w"][idx].to(x.dtype)
                      for k in ("w_gate", "w_up", "w_down"))
    # (B*K, 1, d) against (B*K, d, f): one product a (row, choice).
    xk = x.expand(B, K, d).reshape(B * K, 1, d)
    a = nn.activation(cfg.act)
    h = a(torch.bmm(xk, wg.flatten(0, 1))) * torch.bmm(xk, wu.flatten(0, 1))
    yk = torch.bmm(h, wd.flatten(0, 1)).reshape(B, K, d)
    y = (yk * gate_vals.to(x.dtype)[..., None]).sum(dim=1, keepdim=True)
    if "shared" in p:
        y = y + mlp_forward(p["shared"], x, cfg.act)
    return y
