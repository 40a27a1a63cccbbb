"""Interoperable Federated Learning — Algorithm 1, the eager trainer.

The port's copy of ``repro.core.ifl``. Each client owns a different
architecture (paper Table II), private parameters and a private non-IID
shard. Per communication round t, for the participating clients:

  1. Base-block update — τ local SGD steps on θ_b only (eq. 7), the
     modular block frozen, on client-local minibatches.
  2. Fusion exchange — a fresh minibatch gives z_k = f_b,k(x_k); the
     exchange plane encodes it with the configured wire codec (the EF
     residual threaded through), ledgers exactly the encoded payload and
     the labels, and decodes once into the server's FusionCache
     (lines 13-21).
  3. Modular update — sequential SGD steps on θ_m, one per cached
     (z_hat_i, y_i) pair, in cache (slot) order (lines 24-28).

Gradients come from ``torch.autograd``; the SGD update is p - lr * g, as
the reference's. Randomness is the engine's one numpy stream, drawn in
the reference's order (schedule mask, then each participant's τ
minibatches, then each participant's fusion minibatch), so participants,
minibatches and ledger bytes match the reference exactly.

Not ported yet (ROADMAP.md queue 1): async rounds, population fleets,
delta broadcast, and ``snapshot``/``restore``; each raises
``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Sequence

import numpy as np
import torch

from repro_torch.config import RunConfig
from repro_torch.core.comm import tree_leaves
from repro_torch.core.exchange import FusionExchange
from repro_torch.core.report import RoundReport
from repro_torch.core.rounds import RoundEngine
from repro_torch.device import resolve_device


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    lp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(lp, -1, labels.long()[:, None]))


def tree_map(fn, *trees):
    """Map ``fn`` over the leaves of trees of dicts and lists."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(u[k] for u in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _sgd(params, loss_of, lr: float):
    """One SGD step p - lr * grad(loss_of)(params) -> (params', loss)."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = loss_of(live)
    grads = iter(torch.autograd.grad(loss, tree_leaves(live)))
    with torch.no_grad():
        new = tree_map(lambda p: p.detach() - lr * next(grads), live)
    return new, loss.detach()


@dataclass
class Client:
    """One vendor: private architecture + params + data shard."""

    cid: int
    params: Dict[str, Any]  # {'base': ..., 'modular': ...}
    base_apply: Callable[[Any, torch.Tensor], torch.Tensor]
    modular_apply: Callable[[Any, torch.Tensor], torch.Tensor]
    data_x: np.ndarray
    data_y: np.ndarray
    loss_fn: Callable = softmax_xent

    @property
    def num_samples(self) -> int:
        return len(self.data_y)


class IFLTrainer:
    """The eager IFL trainer. ``device`` is where the clients' params
    live and training runs: the card unless ``device='cpu'``."""

    def __init__(self, clients: Sequence[Client], cfg: RunConfig,
                 seed: int = 0, *, device=None):
        if getattr(cfg, "mode", "sync") != "sync":
            raise NotImplementedError(
                "mode='async' is not ported yet (ROADMAP.md queue 1, item 3b)")
        if getattr(cfg, "cohort", 0) or getattr(cfg, "n_population", 0):
            raise NotImplementedError(
                "population fleets are not ported yet (ROADMAP.md queue 1, "
                "item 3b)")
        self.device = resolve_device(device)
        self.clients = list(clients)
        self.cfg = cfg
        self.exchange = FusionExchange(
            cfg.codec, len(self.clients), (cfg.batch_size, cfg.d_fusion),
            max_staleness=cfg.max_staleness, broadcast=cfg.broadcast,
            device=self.device)
        self.engine = RoundEngine(len(self.clients), cfg.participation,
                                  seed=seed, exchange=self.exchange)
        self.ledger = self.engine.ledger
        self.codec = self.exchange.codec

    # ------------------------------------------------------------ steps

    @staticmethod
    def _base_step(c: Client, x, y, lr: float):
        mod = c.params["modular"]

        def loss_of(base):
            return c.loss_fn(c.modular_apply(mod, c.base_apply(base, x)), y)

        base, loss = _sgd(c.params["base"], loss_of, lr)
        return {"base": base, "modular": mod}, loss

    @staticmethod
    def _mod_step(c: Client, mod, z, y, lr: float):
        return _sgd(mod, lambda m: c.loss_fn(c.modular_apply(m, z), y), lr)

    def _sample(self, c: Client):
        return self.engine.sample(c, self.cfg.batch_size, self.device)

    # ------------------------------------------------------------ round

    def run_round(self) -> RoundReport:
        cfg = self.cfg
        eng = self.engine
        participants = eng.participants()  # sorted client slots, this round
        losses = []
        # Step 1: τ local base-block updates per participant (eq. 7); the
        # mean loss over the τ steps (NaN for τ = 0).
        for k in participants:
            c = self.clients[k]
            step_losses = []
            for _ in range(cfg.tau):
                x, y = self._sample(c)
                c.params, loss = self._base_step(c, x, y, cfg.lr_base)
                step_losses.append(loss)
            losses.append(torch.stack(step_losses).mean().item()
                          if step_losses else float("nan"))

        # Steps 2-3: fusion outputs on a fresh minibatch through the
        # exchange plane (EF-threaded encode, uplink ledger, decode once
        # into the server cache).
        for k in participants:
            c = self.clients[k]
            x, y = self._sample(c)
            with torch.no_grad():
                z = c.base_apply(c.params["base"], x)
            if z.shape[-1] != cfg.d_fusion:
                raise ValueError(f"client {c.cid} fusion dim {z.shape[-1]} "
                                 f"!= {cfg.d_fusion}")
            self.exchange.upload(int(k), z, y, eng.round_idx)

        # Steps 4-5: the valid cache to every participant.
        Z, Y, entries = self.exchange.broadcast_round(participants,
                                                      eng.round_idx)

        # Step 6: modular updates on every cached pair, in cache order.
        mod_losses = []
        for k in participants:
            c = self.clients[k]
            mod, ml = c.params["modular"], None
            for z_i, y_i in zip(Z, Y):
                mod, ml = self._mod_step(c, mod, z_i, y_i, cfg.lr_modular)
            if ml is not None:
                c.params = {"base": c.params["base"], "modular": mod}
                mod_losses.append(ml.item())

        staleness = eng.cache.staleness(eng.round_idx)
        metrics = {
            "base_loss": float(np.mean(losses)) if losses else float("nan"),
            "mod_loss": (float(np.mean(mod_losses)) if mod_losses
                         else float("nan")),
            "participants": [int(k) for k in participants],
            "cache_size": len(entries),
            "max_staleness_seen": max(staleness.values(), default=0),
        }
        return eng.end_round(metrics)

    def snapshot(self):
        raise NotImplementedError(
            "IFLTrainer.snapshot/restore and save_trainer/load_trainer are "
            "not ported yet (ROADMAP.md queue 1, item 2f)")

    restore = snapshot

    # ------------------------------------------------------------ eval

    def evaluate(self, test_x, test_y, batch: int = 512) -> List[float]:
        """Local end-to-end accuracy per client (eq. 10)."""
        return [composition_accuracy(c, c, test_x, test_y, batch)
                for c in self.clients]

    def accuracy_matrix(self, test_x, test_y, batch: int = 512) -> np.ndarray:
        """Fig. 4: entry [k, i] = acc of base_k composed with modular_i."""
        n = len(self.clients)
        out = np.zeros((n, n))
        for a in range(n):
            for b in range(n):
                out[a, b] = composition_accuracy(
                    self.clients[a], self.clients[b], test_x, test_y, batch)
        return out


def composition_accuracy(base_client: Client, mod_client: Client,
                         test_x, test_y, batch: int = 512) -> float:
    """Accuracy of f_m,i(f_b,k(x)) — eq. (11) cross-vendor inference, on
    the device of the base client's parameters."""
    dev = tree_leaves(base_client.params["base"])[0].device
    correct, total = 0, 0
    with torch.no_grad():
        for s in range(0, len(test_y), batch):
            x = torch.from_numpy(np.ascontiguousarray(test_x[s: s + batch]))
            z = base_client.base_apply(base_client.params["base"], x.to(dev))
            logits = mod_client.modular_apply(mod_client.params["modular"], z)
            y = np.asarray(test_y[s: s + batch])
            correct += int((logits.argmax(-1).cpu().numpy() == y).sum())
            total += len(y)
    return correct / max(total, 1)
