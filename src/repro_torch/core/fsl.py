"""Federated split learning baseline (after [9] / SplitFed).

The port's copy of ``repro.core.fsl``. Clients keep a personalised
client-side block up to the cut layer (the same 432-dim cut as IFL, for
a like-for-like comparison); the server owns the one shared server-side
model. Each participant makes ONE update a round (the FSL limitation the
paper contrasts with IFL's τ local steps):

  client k: minibatch -> h_k = f_c(x_k)      (upload h_k + labels)
  server  : ŷ = f_s(h_k), loss, backward     (against the round-start θ_s)
  server  : sends ∂loss/∂h_k back            (download)
  client k: backprops it into its client-side block.

The server's grads are averaged over the participants and applied once
at the end of the round (an empty round updates nothing). Inference
needs the server: there is no local end-to-end path (Table I, row 2).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import RunConfig
from repro_torch.core.comm import tree_leaves
from repro_torch.core.ifl import Client, softmax_xent, tree_map
from repro_torch.core.report import RoundReport
from repro_torch.core.rounds import RoundEngine
from repro_torch.device import resolve_device


def _live(tree):
    """Leaves detached from any graph and requiring grad."""
    return tree_map(lambda p: p.detach().requires_grad_(), tree)


class FSLTrainer:
    """Split learning over ``clients`` with the shared server block
    ``server_params`` / ``server_apply``. ``device`` is where the blocks
    live and train: the card unless ``device='cpu'``."""

    def __init__(self, clients: Sequence[Client], cfg: RunConfig,
                 server_params: Any, server_apply: Callable, seed: int = 0,
                 *, device=None):
        self.device = resolve_device(device)
        self.clients = list(clients)
        self.cfg = cfg
        self.engine = RoundEngine(len(self.clients), cfg.participation,
                                  seed=seed)
        # The base plane: cut activations and labels up, activation
        # gradients down, every boundary byte through the one ledger.
        self.exchange = self.engine.exchange
        self.ledger = self.engine.ledger
        self.server_params = server_params
        self.server_apply = server_apply

    # ---------------------------------------------------------- pieces

    def _server_step(self, server_params, h, y):
        """(server grads, dL/dh, loss) of the mean cross-entropy."""
        sp, hh = _live(server_params), h.detach().requires_grad_()
        loss = softmax_xent(self.server_apply(sp, hh), y)
        *gs, gh = torch.autograd.grad(loss, tree_leaves(sp) + [hh])
        it = iter(gs)
        return tree_map(lambda _: next(it), sp), gh, loss.detach()

    @staticmethod
    def _client_bwd(c: Client, x, gh, lr: float):
        """The client block stepped by the VJP of ``base_apply`` with the
        server-sent activation gradient."""
        bp = _live(c.params["base"])
        g = iter(torch.autograd.grad(c.base_apply(bp, x), tree_leaves(bp),
                                     grad_outputs=gh))
        with torch.no_grad():
            return tree_map(lambda p: p.detach() - lr * next(g), bp)

    # ---------------------------------------------------------- round

    def run_round(self) -> RoundReport:
        cfg = self.cfg
        eng = self.engine
        participants = eng.participants()
        losses, server_grads = [], []
        for k in participants:
            c = self.clients[k]
            x, y = eng.sample(c, cfg.batch_size, self.device)
            with torch.no_grad():
                h = c.base_apply(c.params["base"], x)
            self.exchange.up((h, y))  # cut activations + int32 labels up
            gs, gh, loss = self._server_step(self.server_params, h, y)
            self.exchange.down(gh)  # activation gradients down
            c.params = {"base": self._client_bwd(c, x, gh, cfg.lr_base),
                        "modular": c.params["modular"]}
            server_grads.append(gs)
            losses.append(loss.item())
        # One server update with the grads averaged over the participants.
        if server_grads:
            n = len(server_grads)
            avg = tree_map(lambda *g: sum(g) / n, *server_grads)
            self.server_params = tree_map(
                lambda p, g: p - cfg.lr_modular * g, self.server_params, avg)
        return eng.end_round({
            "loss": float(np.mean(losses)) if losses else float("nan"),
            "participants": [int(k) for k in participants],
        })

    # ------------------------------------------------- snapshot/restore

    def snapshot(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """(tensor tree, JSON-able aux), the reference's layout: every
        client's params under ``'clients'``, the server block under
        ``'server'``, and the engine's aux."""
        tree = {"clients": [c.params for c in self.clients],
                "server": self.server_params}
        return tree, self.engine.aux_state()

    def restore(self, tree, aux) -> None:
        for c, p in zip(self.clients, tree["clients"]):
            c.params = p
        self.server_params = tree["server"]
        self.engine.restore_aux(aux)

    # ---------------------------------------------------------- eval

    def evaluate(self, test_x, test_y, batch: int = 512) -> List[float]:
        """Per-client accuracy of f_s(f_c,k(x)): inference needs the
        server."""
        accs = []
        with torch.no_grad():
            for c in self.clients:
                correct, total = 0, 0
                for s in range(0, len(test_y), batch):
                    x = torch.from_numpy(np.ascontiguousarray(
                        test_x[s:s + batch])).to(self.device)
                    logits = self.server_apply(
                        self.server_params, c.base_apply(c.params["base"], x))
                    y = np.asarray(test_y[s:s + batch])
                    correct += int(
                        (logits.argmax(-1).cpu().numpy() == y).sum())
                    total += len(y)
                accs.append(correct / max(total, 1))
        return accs
