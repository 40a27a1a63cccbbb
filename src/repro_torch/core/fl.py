"""FedAvg baseline (the paper's FL-1 / FL-2 variants).

The port's copy of ``repro.core.fl``. Every client shares one
architecture (the FL limitation the paper highlights): FL-1 deploys
client 1's smallest model everywhere, FL-2 client 2's larger one. Per
round, for each participant: full-model download, τ local SGD steps on
the full model, full-model upload; then a FedAvg (eq. 4) over the
participants, weighted by their sample counts.

Partial participation (``cfg.participation``, via the shared round
engine) is classic sampled FedAvg: only the K participants download,
train and upload, and the weights are normalised over them. The engine's
one numpy stream draws the schedule mask, then each participant's τ
minibatches, in the reference's order.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import RunConfig
from repro_torch.core.ifl import Client, _sgd, tree_map
from repro_torch.core.report import RoundReport
from repro_torch.core.rounds import RoundEngine
from repro_torch.device import resolve_device


class FLTrainer:
    """FedAvg over homogeneous clients; the global model starts as a copy
    of client 0's params. ``device`` is where the models live and train:
    the card unless ``device='cpu'``."""

    def __init__(self, clients: Sequence[Client], cfg: RunConfig,
                 seed: int = 0, *, device=None):
        self.device = resolve_device(device)
        self.clients = list(clients)
        self.cfg = cfg
        self.engine = RoundEngine(len(self.clients), cfg.participation,
                                  seed=seed)
        # The base plane: whole model trees up and down, no codec, every
        # boundary byte through the one ledger.
        self.exchange = self.engine.exchange
        self.ledger = self.engine.ledger
        # A copy: the global model never aliases client 0's tensors.
        self.global_params = tree_map(torch.clone, self.clients[0].params)

    def _step(self, params, x, y, lr: float):
        c0 = self.clients[0]

        def loss_of(p):
            return c0.loss_fn(
                c0.modular_apply(p["modular"], c0.base_apply(p["base"], x)),
                y)

        return _sgd(params, loss_of, lr)

    def run_round(self) -> RoundReport:
        cfg = self.cfg
        eng = self.engine
        participants = eng.participants()
        chosen = [self.clients[k] for k in participants]
        d_total = sum(c.num_samples for c in chosen)
        locals_, losses = [], []
        for c in chosen:
            self.exchange.down(self.global_params)  # global model down
            p = self.global_params
            step_losses = []
            for _ in range(cfg.tau):
                x, y = eng.sample(c, cfg.batch_size, self.device)
                p, loss = self._step(p, x, y, cfg.lr_base)
                step_losses.append(loss)
            locals_.append((c.num_samples / d_total, p))
            # τ = 0: no local step, loss NaN by convention.
            losses.append(torch.stack(step_losses).mean().item()
                          if step_losses else float("nan"))
            self.exchange.up(p)  # full model up
        # FedAvg (eq. 4) over the participants, summed in participant
        # order. Nothing trained (no participant, or τ = 0): the global
        # model stays exactly as it was, not re-averaged.
        if locals_ and cfg.tau > 0:
            self.global_params = tree_map(
                lambda *xs: sum(w * x for (w, _), x in zip(locals_, xs)),
                *[p for _, p in locals_])
        return eng.end_round({
            "loss": float(np.mean(losses)) if losses else float("nan"),
            "participants": [int(k) for k in participants],
        })

    def snapshot(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """(tensor tree, JSON-able aux), the reference's layout: the global
        model under ``'global'``, and the engine's aux."""
        return {"global": self.global_params}, self.engine.aux_state()

    def restore(self, tree, aux) -> None:
        self.global_params = tree["global"]
        self.engine.restore_aux(aux)

    def evaluate(self, test_x, test_y, batch: int = 512) -> float:
        """Accuracy of the global model."""
        c0 = self.clients[0]
        p = self.global_params
        correct, total = 0, 0
        with torch.no_grad():
            for s in range(0, len(test_y), batch):
                x = torch.from_numpy(
                    np.ascontiguousarray(test_x[s:s + batch])).to(self.device)
                logits = c0.modular_apply(p["modular"],
                                          c0.base_apply(p["base"], x))
                y = np.asarray(test_y[s:s + batch])
                correct += int((logits.argmax(-1).cpu().numpy() == y).sum())
                total += len(y)
        return correct / max(total, 1)
