"""Training loops for LM-scale IFL and the dense DP baseline, the port of
``repro.train.loop``: the same ``SyntheticLM`` draws, the same analytic
ledger lines and the same history records as the reference, on one
device (the card unless the caller passes ``device="cpu"``) or, for IFL,
on a ('client', 'data', 'model') mesh of ``torch.distributed`` ranks
(``mesh=``: every rank runs the loop, draws its own clients' tokens and
returns its own clients' params, with the same history and ledger).

The returned dict also carries ``walls``: the host-clock seconds of each
round (or step), taken after the loss read that ends it, which waits for
the card.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core.comm import CommLedger
from repro_torch.core.ifl_spmd import (
    init_ifl_state,
    make_dp_train_step,
    make_ifl_round_step,
)
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import ClientLayout
from repro_torch.models import modules as nn
from repro_torch.models.transformer import check_supported, init_lm
from repro_torch.optim import make_optimizer


def _ifl_batch(stream: SyntheticLM, cfg: ModelConfig, n_clients: int,
               tau: int, batch: int, seq: int, step: int, *,
               device, clients=None) -> Dict:
    """Round ``step``'s tokens (N, tau + 1, B, S): client k's minibatch t
    is ``stream.sample(..., step=step * (tau + 1) + t, client=k)`` for
    k in ``clients`` (None: all), zeros for the others. An
    image config adds ``image_embeds`` (N, tau + 1, B, n_img, d), normal
    draws of numpy's ``default_rng(step)``, and an encoder-decoder
    ``frame_embeds`` (N, tau + 1, B, S_enc, d) of ``default_rng(step +
    1)``, fp32, as the reference draws them."""
    toks = np.zeros((n_clients, tau + 1, batch, seq), np.int32)
    for k in (range(n_clients) if clients is None else clients):
        toks[k] = np.stack([
            stream.sample(batch, seq, step=step * (tau + 1) + t, client=k)
            for t in range(tau + 1)
        ])
    out = {"tokens": torch.from_numpy(toks).to(device)}
    lead = (n_clients, tau + 1, batch)
    if cfg.num_image_tokens:
        out["image_embeds"] = _normal(
            step, (*lead, cfg.num_image_tokens, cfg.d_model), device)
    if cfg.is_encdec:
        out["frame_embeds"] = _normal(
            step + 1, (*lead, cfg.enc_seq_len, cfg.d_model), device)
    return out


def _dp_batch(stream: SyntheticLM, cfg: ModelConfig, batch: int, seq: int,
              step: int, *, device) -> Dict:
    """DP step ``step``'s batch: tokens (B, S), with zero ``image_embeds``
    for an image config and ``frame_embeds`` of numpy's
    ``default_rng(step)`` for an encoder-decoder, as the reference's DP
    loop draws them."""
    b = {"tokens": torch.from_numpy(
        stream.sample(batch, seq, step=step)).to(device)}
    if cfg.num_image_tokens:
        b["image_embeds"] = torch.zeros(
            (batch, cfg.num_image_tokens, cfg.d_model), device=device)
    if cfg.is_encdec:
        b["frame_embeds"] = _normal(step, (batch, cfg.enc_seq_len,
                                           cfg.d_model), device)
    return b


def _normal(seed: int, shape, device) -> torch.Tensor:
    """fp32 standard normals of numpy's ``default_rng(seed)``."""
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32)).to(device)


def train_ifl_lm(
    cfg: ModelConfig,
    *,
    rounds: int = 20,
    n_clients: int = 4,
    tau: int = 4,
    batch: int = 8,
    seq: int = 128,
    lr_base: float = 3e-3,
    lr_modular: float = 3e-3,
    seed: int = 0,
    log_every: int = 5,
    device: DeviceLike = None,
    mesh=None,
) -> Dict:
    """IFL rounds on an LM; returns history + comm ledger (+ walls). On
    ``mesh`` the device is the mesh's and ``params`` this rank's
    clients'."""
    clients = None
    if mesh is None:
        dev = resolve_device(device)
    else:
        lay = ClientLayout.of(mesh, n_clients)
        dev, clients = lay.device(), lay.clients
        if device is not None and torch.device(device).type != dev.type:
            raise ValueError(f"train_ifl_lm: device {device!r} is not the "
                             f"mesh's {dev.type!r}")
    check_supported(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params, opt_state = init_ifl_state(cfg, n_clients=n_clients,
                                       generator=gen, device=dev, mesh=mesh)
    step_fn = make_ifl_round_step(cfg, mesh=mesh, n_clients=n_clients,
                                  tau=tau, lr_base=lr_base,
                                  lr_modular=lr_modular)
    stream = SyntheticLM(cfg.vocab_size, seed=seed)
    ledger = CommLedger()
    z_bytes = batch * seq * cfg.d_fusion * 2  # bf16 fusion activations
    hist: List[Dict] = []
    walls: List[float] = []
    t0 = time.time()
    for r in range(rounds):
        t_round = time.perf_counter()
        b = _ifl_batch(stream, cfg, n_clients, tau, batch, seq, r,
                       device=dev, clients=clients)
        params, opt_state, m = step_fn(params, opt_state, b)
        # ledger: what crossed the client boundary this round.
        up = n_clients * (z_bytes + batch * seq * 4)
        ledger.uplink += up
        ledger.downlink += n_clients * up
        ledger.per_round.append({"up": up, "down": n_clients * up})
        rec = {
            "round": r,
            "base_loss": float(m["base_loss"]),
            "mod_loss": float(m["mod_loss"]),
            "uplink_mb": ledger.uplink_mb,
        }
        walls.append(time.perf_counter() - t_round)
        hist.append(rec)
        if r % log_every == 0:
            print(f"  round {r:4d}  base {rec['base_loss']:.4f}  "
                  f"mod {rec['mod_loss']:.4f}  "
                  f"uplink {rec['uplink_mb']:.2f} MB  "
                  f"({time.time()-t0:.0f}s)")
    return {"history": hist, "params": params, "ledger": ledger,
            "walls": walls}


def train_dp_lm(cfg: ModelConfig, *, steps: int = 50, batch: int = 8,
                seq: int = 128, lr: float = 3e-3, seed: int = 0,
                log_every: int = 10, device: DeviceLike = None) -> Dict:
    """Dense data-parallel baseline (FL-equivalent comm = |params|/step)."""
    dev = resolve_device(device)
    check_supported(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_lm(cfg, generator=gen, device=dev,
                     dtype=nn.dtype_of(cfg.param_dtype))
    opt = make_optimizer("sgd")
    opt_state = opt.init(params)
    step_fn = make_dp_train_step(cfg, lr=lr)
    stream = SyntheticLM(cfg.vocab_size, seed=seed)
    hist = []
    walls: List[float] = []
    for s in range(steps):
        t_step = time.perf_counter()
        b = _dp_batch(stream, cfg, batch, seq, s, device=dev)
        params, opt_state, m = step_fn(params, opt_state, b)
        hist.append({"step": s, "loss": float(m["loss"])})
        walls.append(time.perf_counter() - t_step)
        if s % log_every == 0:
            print(f"  step {s:4d}  loss {hist[-1]['loss']:.4f}")
    return {"history": hist, "params": params, "walls": walls}
