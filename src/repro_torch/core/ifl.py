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

The wire side (encode, EF residuals, cache, ledger, broadcast policy)
lives on the exchange plane (``repro_torch.core.exchange``);
``cfg.broadcast='delta'`` switches the downlink to mirror-sync delta
shipping (the same decoded training signal, each entry shipped once).
``snapshot``/``restore`` give the fixed fleet's state as an array tree
plus JSON aux, in the reference's layout, so a checkpoint written by
either package resumes in the other (``repro_torch.api.save_trainer``).

Clocking and fleets: ``cfg.mode='async'`` swaps in the
``AsyncRoundEngine`` (participants come from an arrival trace coalesced
per server tick; ``run_round`` is clock-agnostic). A population fleet
(``cfg.cohort`` > 0, usually a ``LazyFleet`` of ``cfg.n_population``
clients built on first touch) admits a cohort of at most C a round; the
exchange plane serves the cohort's fresh uploads only and ages EF
residuals and mirrors by ``max_staleness``, and the snapshot is sparse:
touched clients, live residuals and cache entries, keyed by slot, so
neither memory nor a checkpoint grows with N. A population trainer
evaluates at most 16 touched clients and skips the N x N matrix.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import RunConfig
from repro_torch.core.comm import tree_leaves
from repro_torch.core.exchange import CacheEntry, FusionExchange
from repro_torch.core.population import LazyFleet
from repro_torch.core.report import RoundReport
from repro_torch.core.rounds import AsyncRoundEngine, RoundEngine
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
        self.device = resolve_device(device)
        # A LazyFleet stays lazy: a population never pays N inits.
        self.clients = (clients if isinstance(clients, LazyFleet)
                        else list(clients))
        self.cfg = cfg
        cohort = cfg.cohort or None
        self._population = cohort is not None
        self.exchange = FusionExchange(
            cfg.codec, len(self.clients), (cfg.batch_size, cfg.d_fusion),
            max_staleness=cfg.max_staleness, broadcast=cfg.broadcast,
            population=self._population, device=self.device)
        if cfg.mode == "async":
            self.engine = AsyncRoundEngine(
                len(self.clients), cfg.trace, tick=cfg.tick, seed=seed,
                exchange=self.exchange, cohort=cohort)
        else:
            self.engine = RoundEngine(
                len(self.clients), cfg.participation, seed=seed,
                exchange=self.exchange, cohort=cohort)
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

        # Steps 4-5: the valid cache to the participants under the
        # broadcast policy (the same decoded pairs under both).
        Z, Y, entries, shipped = self.exchange.broadcast_round(
            participants, eng.round_idx)

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
        if self.exchange.broadcast == "delta":
            # E of ifl_round_bytes(broadcast='delta', delta_entries=E).
            metrics["shipped_entries"] = len(shipped)
        return eng.end_round(metrics)

    # ---------------------------------------------------- snapshot/restore

    def snapshot(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """(tensor tree, JSON-able aux), the Trainer protocol's state: every
        client's params, the EF residuals in slot order and the fusion
        cache stacked over all slots (``FusionExchange.cache_tree``);
        the aux is the engine's (round, rng, ledger totals, cache entry
        rounds, delta mirrors, and an async engine's cursor). The
        reference's tree, key for key. A population trainer's snapshot
        is sparse (``_snapshot_population``)."""
        if self._population:
            return self._snapshot_population()
        tree = {
            "clients": [c.params for c in self.clients],
            "ef": [self.exchange.ef_state[k]
                   for k in range(len(self.clients))],
            "cache": self.exchange.cache_tree(),
        }
        return tree, self.engine.aux_state()

    def _touched(self) -> List[int]:
        return (self.clients.materialized
                if isinstance(self.clients, LazyFleet)
                else list(range(len(self.clients))))

    def _snapshot_population(self):
        """The working set only, keyed by slot (as strings): touched
        clients' params, live EF residuals and the cache's entries; the
        slot lists, entry rounds and last uploads ride in
        ``aux['population']``."""
        touched = self._touched()
        ex = self.exchange
        ef_slots = sorted(int(k) for k in ex.ef_state)
        entries = ex.cache._entries
        tree = {
            "clients": {str(k): self.clients[k].params for k in touched},
            "ef": {str(k): ex.ef_state[k] for k in ef_slots},
            "cache": {str(s): {"payload": e.payload, "z_hat": e.z_hat,
                               "y": e.y}
                      for s, e in sorted(entries.items())},
        }
        aux = self.engine.aux_state()
        aux["population"] = {
            "clients": [int(k) for k in touched],
            "ef": ef_slots,
            "cache_rounds": {str(s): int(e.round_idx)
                             for s, e in entries.items()},
            "last_upload": {str(s): int(r)
                            for s, r in ex._last_upload.items()},
        }
        return tree, aux

    def snapshot_template(self, extra):
        """The tree a saved checkpoint is read into (``load_trainer``'s
        hook): a fresh population trainer has touched nothing, so build
        exactly the saved slot lists (lazy init is deterministic, so the
        shapes are the saved run's). Cache labels are int32, as this
        package's cache holds them."""
        if not self._population:
            return self.snapshot()[0]
        pop = extra.get("population", {})
        ex = self.exchange
        z0 = torch.zeros(ex.z_shape, dtype=torch.float32, device=self.device)
        empty = self.codec.encode(z0)
        y0 = torch.zeros((ex.z_shape[0],), dtype=torch.int32,
                         device=self.device)
        return {
            "clients": {str(int(k)): self.clients[int(k)].params
                        for k in pop.get("clients", [])},
            "ef": {str(int(k)): ex.ef_state[int(k)]
                   for k in pop.get("ef", [])},
            "cache": {str(int(s)): {"payload": empty, "z_hat": z0, "y": y0}
                      for s in pop.get("cache_rounds", {})},
        }

    def restore(self, tree, aux) -> None:
        if self._population:
            self._restore_population(tree, aux)
            return
        for k, (c, p, e) in enumerate(
                zip(self.clients, tree["clients"], tree["ef"])):
            c.params = p
            self.exchange.ef_state[k] = e
        self.engine.restore_aux(aux)  # clears the cache in place ...
        # ... and the snapshot refills it.
        self.exchange.restore_cache(tree["cache"],
                                    aux["exchange"]["cache_rounds"])

    def _restore_population(self, tree, aux) -> None:
        ex = self.exchange
        for k, p in tree["clients"].items():
            self.clients[int(k)].params = p
        ex.ef_state.clear()
        for k, e in tree.get("ef", {}).items():
            ex.ef_state[int(k)] = e
        self.engine.restore_aux(aux)  # clears the cache in place ...
        pop = aux["population"]
        rounds = pop.get("cache_rounds", {})
        ex.cache._entries.update({
            int(s): CacheEntry(payload=sub["payload"], z_hat=sub["z_hat"],
                               y=sub["y"], round_idx=int(rounds[s]))
            for s, sub in tree.get("cache", {}).items()})
        ex._last_upload = {int(s): int(r)
                           for s, r in pop.get("last_upload", {}).items()}

    # ------------------------------------------------------------ eval

    def _eval_slots(self, cap: int = 16) -> List[int]:
        """The clients to evaluate: all of a concrete fleet; of a
        population, at most ``cap`` touched ones (evaluating 10^4 lazy
        clients would build them all)."""
        if not self._population:
            return list(range(len(self.clients)))
        return self._touched()[:cap] or list(range(min(cap,
                                                       len(self.clients))))

    @property
    def eval_matrix(self) -> bool:
        """Whether the N x N composition matrix is affordable: the runner
        skips it for a population."""
        return not self._population

    def evaluate(self, test_x, test_y, batch: int = 512) -> List[float]:
        """Local end-to-end accuracy per client (eq. 10), over
        ``_eval_slots``."""
        return [composition_accuracy(self.clients[k], self.clients[k],
                                     test_x, test_y, batch)
                for k in self._eval_slots()]

    def accuracy_matrix(self, test_x, test_y, batch: int = 512) -> np.ndarray:
        """Fig. 4: entry [a, b] = acc of base of slot a composed with the
        modular block of slot b, over ``_eval_slots``."""
        slots = self._eval_slots()
        out = np.zeros((len(slots), len(slots)))
        for a, ka in enumerate(slots):
            for b, kb in enumerate(slots):
                out[a, b] = composition_accuracy(
                    self.clients[ka], self.clients[kb], test_x, test_y, batch)
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
