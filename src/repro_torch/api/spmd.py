"""`SPMDIFLTrainer`: the LM round step behind the Trainer protocol.

The port of ``repro.api.spmd``. It adapts
``repro_torch.core.ifl_spmd.make_ifl_round_step`` (one round of
Algorithm 1 over N per-client LM trees, in one process or on a
('client', 'data', 'model') mesh of ``torch.distributed`` ranks) to the
front door, so ``run_experiment(spec.replace(scheme="ifl_spmd"))``
drives the LM path with the eager engine's scheduling, staleness and
byte accounting:

  - participation masks come from the same ``RoundEngine`` (or the
    ``AsyncRoundEngine`` under ``mode="async"``: one tick is one round,
    its coalesced arrivals the mask), one numpy stream seeded by the
    spec;
  - bytes are the exchange plane's (``SPMDFusionExchange.account_round``):
    the codec's analytic ``encoded_nbytes`` per fresh upload plus int32
    token labels, and the downlink under the spec's broadcast policy;
  - ``snapshot`` / ``restore`` use the reference's layout (params,
    optimizer state, EF residual and payload cache stacked along a
    leading (N,) axis; a population's sparse ``slots`` tree), so
    ``save_trainer`` / ``load_trainer`` resume across the two packages in
    both directions, and a resume in one package is bitwise on the CPU.

Two regimes. Legacy (``fleet.cohort == 0``): the N client trees, the EF
residual and the carried payload cache live on the device. Population
(``fleet.cohort = C``): the device holds a C-wide cohort; slots are
drawn by the engine, padded to C by repeating the first slot under a
False mask, and paged in and out of host ``PopulationStore``s (params and
optimizer state; EF residuals, which age out by ``max_staleness``); the
payload cache is rebuilt fresh every round, since cohort positions are
bound to other slots each round.

On a mesh (``mesh=``, legacy regime) every rank builds the trainer
from the same spec: it holds its block of clients (their params,
optimizer states, EF rows and cache slots, its rows of their
minibatches), draws its own clients' tokens only, and keeps the same
engine, masks and ledger as every other rank; ``snapshot`` gathers the
blocks into the one-process layout on every rank, ``restore`` keeps
each rank's block, so a run saved on one mesh resumes on another or in
one process. The population regime runs on a client axis of 1 only.

Data: minibatch t of round r for client k is ``SyntheticLM.sample(...,
step=r * (tau + 1) + t, client=k)`` (the ``synth_tokens`` dataset), a
function of (seed, step, client), so nothing of the data is
checkpointed. Absent clients' tokens are not drawn: the round step never
reads them.

Weights: slot k's init is ``init_params(k)`` (a numpy tree
``{"base", "modular"}``, e.g. a slot of the reference's
``init_ifl_state`` or ``init_ifl_slot_state``) when given, else
``init_ifl_slot_state(cfg, seed=spec.seed, slot=k)``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.api.spec import ExperimentSpec
from repro_torch.checkpoint import params_from_numpy
from repro_torch.config import ModelConfig
from repro_torch.core.exchange import (
    _NEVER,
    SPMDFusionExchange,
    init_payload_cache,
)
from repro_torch.core.ifl_spmd import (
    init_ifl_slot_state,
    make_ifl_round_step,
)
from repro_torch.core.population import PopulationStore
from repro_torch.core.report import RoundReport
from repro_torch.core.rounds import (
    AsyncRoundEngine,
    FullParticipation,
    RoundEngine,
)
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import ClientLayout
from repro_torch.models import modules as nn
from repro_torch.models.transformer import base_forward, modular_forward
from repro_torch.optim import make_optimizer
from repro_torch.sharding.rules import (
    all_gather_cat,
    gather_block,
    local_block,
    param_pspecs,
    placements_of,
)

__all__ = ["SPMDIFLTrainer", "smoke_model_config"]

_EVAL_STEP = 999_983  # SyntheticLM step reserved for held-out eval data


def smoke_model_config() -> ModelConfig:
    """CPU-scale LM config the scheme defaults to (``spec.model == ''``)."""
    return ModelConfig(
        name="spmd-smoke", num_layers=4, d_model=48, num_heads=2,
        num_kv_heads=2, d_ff=96, vocab_size=128, d_fusion=32, q_block=16,
        compute_dtype="float32", remat="none",
    ).validate()


def _stack(trees: Sequence[Any]):
    """N per-client trees of tensors -> one tree, leaves (N, ...)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(list(trees))


def _unstack(tree, n: int) -> List[Any]:
    """Inverse of ``_stack``: each client's own copy of its slice."""
    return [nn.tree_map(lambda a: a[k].clone(), tree) for k in range(n)]


class SPMDIFLTrainer:
    """IFL on an LM, one spec -> one resumable run, on ``device`` (the
    card unless ``'cpu'``).

    ``spec.batch_size`` is the per-client minibatch Bc and ``seq`` the
    LM context; the model is ``get_config(spec.model).reduced()``, or
    the smoke config when ``spec.model`` is empty, with
    ``d_fusion=spec.d_fusion``. ``init_params(slot)`` returns slot's
    initial params as numpy (module docstring).
    """

    def __init__(self, spec: ExperimentSpec, *, seq: int = 32, device=None,
                 init_params: Optional[Callable[[int], Any]] = None,
                 mesh=None):
        self.mesh = mesh
        self.layout = None
        if mesh is not None:
            if spec.fleet.cohort and int(mesh.mesh.shape[0]) > 1:
                raise NotImplementedError(
                    "SPMDIFLTrainer: the population regime (fleet.cohort) "
                    "on a client axis above 1 is not in the port yet "
                    "(ROADMAP item 1 (ii)); use a client axis of 1")
            width = (spec.fleet.cohort if spec.fleet.cohort
                     else spec.fleet.n_clients)
            self.layout = ClientLayout.of(mesh, width)
            self.device = self.layout.device()
            if device is not None and torch.device(device).type != \
                    self.device.type:
                raise ValueError(f"SPMDIFLTrainer: device {device!r} is not "
                                 f"the mesh's {self.device.type!r}")
        else:
            self.device = resolve_device(device)
        if spec.model:
            from repro_torch.configs import get_config

            cfg = get_config(spec.model).reduced()
        else:
            cfg = smoke_model_config()
        # The front door draws tokens only, as the reference's does.
        for key, on in (("image_embeds", cfg.num_image_tokens > 0),
                        ("frame_embeds", cfg.is_encdec)):
            if on:
                raise ValueError(
                    f"SPMDIFLTrainer: {cfg.name} needs {key!r} in every "
                    "batch, and the synth_tokens data of this front door "
                    "draws tokens only; train it with "
                    "repro_torch.train.loop.train_ifl_lm")
        # The spec is the one source of the fusion interface.
        self.model_cfg = cfg.replace(d_fusion=spec.d_fusion).validate()
        self.spec = spec
        self.seq = seq
        self._population = bool(spec.fleet.cohort)
        self.n_clients = spec.fleet.population
        self.width = (spec.fleet.cohort if self._population
                      else spec.fleet.n_clients)
        # Sized at N: accounting tracks population slots, only the step
        # is cohort-shaped.
        self.exchange = SPMDFusionExchange(
            spec.codec, n_clients=self.n_clients,
            max_staleness=spec.max_staleness, broadcast=spec.broadcast,
            population=self._population)
        # The step's own plane on a mesh: the cohort's wire is C wide;
        # the accounting plane above stays N wide on every rank.
        self._wire = (self.exchange if mesh is None else SPMDFusionExchange(
            spec.codec, n_clients=self.width,
            max_staleness=spec.max_staleness, mesh=mesh))
        cohort = spec.fleet.cohort_size
        if spec.mode == "async":
            self.engine = AsyncRoundEngine(
                self.n_clients, spec.trace, tick=spec.tick, seed=spec.seed,
                exchange=self.exchange, cohort=cohort)
        else:
            self.engine = RoundEngine(
                self.n_clients, spec.participation, seed=spec.seed,
                exchange=self.exchange, cohort=cohort)
        self.ledger = self.engine.ledger
        self.codec = self.exchange.codec
        self.partial = (self._population or spec.mode == "async" or
                        not isinstance(self.engine.schedule,
                                       FullParticipation))

        self._z_shape = (self.width, spec.batch_size, seq,
                         self.model_cfg.d_fusion)
        self._tok_shape = (self.width, spec.batch_size, seq)
        # This rank's block of the carried state: its clients, its rows.
        self._mine = list(range(self.width))
        rows = spec.batch_size
        if self.layout is not None:
            self._mine = self.layout.clients
            rows = len(range(spec.batch_size)[self.layout.rows(
                spec.batch_size)])
        self._local_tok = (len(self._mine), rows, seq)
        self._local_z = self._local_tok + (self.model_cfg.d_fusion,)
        pdt = nn.dtype_of(self.model_cfg.param_dtype)
        opt = make_optimizer("sgd")
        model_cfg, seed = self.model_cfg, spec.seed

        def init_slot(slot: int) -> Dict[str, Any]:
            """Slot's {"params", "opt"} on the CPU."""
            if init_params is None:
                params, state = init_ifl_slot_state(model_cfg, seed=seed,
                                                    slot=slot, device="cpu")
            else:
                params = params_from_numpy(init_params(slot), device="cpu",
                                           dtype=pdt)
                state = {"base": opt.init(params["base"]),
                         "modular": opt.init(params["modular"])}
            return {"params": params, "opt": state}

        if self._population:
            slot_z = self._z_shape[1:]
            self.store = PopulationStore(self.n_clients, init_slot)
            # EF residuals, client state the protocol carries, age out by
            # max_staleness and come back as zeros, like a fresh slot.
            self.ef_store = (
                PopulationStore(self.n_clients,
                                lambda slot: self.codec.init_state(slot_z),
                                max_staleness=spec.max_staleness)
                if self.codec.has_state else None)
            self.params = self.opt_state = self.ef_state = None
            self._last_cohort: List[int] = []
        else:
            self.store = self.ef_store = None
            slots = [init_slot(k) for k in self._mine]
            self.params = [nn.tree_map(lambda a: a.to(self.device),
                                       s["params"]) for s in slots]
            self.opt_state = [nn.tree_map(lambda a: a.to(self.device),
                                          s["opt"]) for s in slots]
            self.ef_state = (self.codec.init_state(self._local_z,
                                                   device=self.device)
                             if self.codec.has_state else None)
        self._step = make_ifl_round_step(
            self.model_cfg, mesh=mesh, n_clients=self.width, tau=spec.tau,
            lr_base=spec.lr, lr_modular=spec.lr,
            partial_participation=self.partial, exchange=self._wire)
        self.cache = self._fresh_cache() if self.partial else None
        self._stream = SyntheticLM(self.model_cfg.vocab_size, seed=spec.seed)
        # One client's fusion payload (+ int32 labels), analytically.
        self._entry_bytes = (self.codec.encoded_nbytes(self._z_shape[1:])
                             + spec.batch_size * seq * 4)

    def _fresh_cache(self):
        return init_payload_cache(self.codec, self._local_z, self._local_tok,
                                  device=self.device)

    # ------------------------------------------------- the mesh's blocks

    def _blocks(self, tree, specs, gather: bool):
        """``tree`` (dicts of tensors) cut to this rank's block (gather
        False: the whole tree in) or put back together from every rank's
        block (gather True: a collective), leaf by leaf, by ``specs``."""
        mesh = self.mesh

        def go(t, sp):
            if isinstance(t, dict):
                return {k: go(t[k], sp[k]) for k in t}
            pl = placements_of(mesh, sp)
            return (gather_block(t, mesh, pl) if gather
                    else local_block(t, mesh, pl).clone())

        return go(tree, specs)

    def _client_blocks(self, stacked, gather: bool):
        """Params or optimizer states stacked over the clients, by the
        rules (``param_pspecs(client_axis=True)``)."""
        return self._blocks(stacked, param_pspecs(stacked, client_axis=True),
                            gather)

    def _carried_blocks(self, tree, gather: bool):
        """The EF residual or the payload cache, by the plane's layout."""
        return self._blocks(tree, self._wire.carried_pspecs(tree), gather)

    # ------------------------------------------------------------- data

    def _round_batch(self, round_idx: int, ids: Sequence[int],
                     live: Sequence[bool]) -> Dict[str, torch.Tensor]:
        """(width, tau + 1, Bc, S) tokens: position i draws client
        ``ids[i]``'s stream where ``live[i]``, and is zeros elsewhere
        (the step never reads an absent client's rows)."""
        spec = self.spec
        toks = np.zeros((len(ids), spec.tau + 1, spec.batch_size, self.seq),
                        np.int32)
        for i, (k, on) in enumerate(zip(ids, live)):
            if on:
                toks[i] = np.stack([
                    self._stream.sample(spec.batch_size, self.seq,
                                        step=round_idx * (spec.tau + 1) + t,
                                        client=int(k))
                    for t in range(spec.tau + 1)])
        return {"tokens": torch.from_numpy(toks).to(self.device)}

    # ------------------------------------------------------------ round

    def _report(self, slots: List[int], base_loss: float, mod_loss: float
                ) -> RoundReport:
        eng = self.engine
        # The plane's host accounting: K fresh uploads, the downlink
        # under the broadcast policy; its valid-entry replay equals the
        # step's cache_valid.
        entries, shipped = self.exchange.account_round(
            slots, eng.round_idx, self._entry_bytes)
        metrics = {"base_loss": base_loss, "mod_loss": mod_loss,
                   "participants": slots, "cache_size": entries}
        if self.exchange.broadcast == "delta":
            metrics["shipped_entries"] = shipped
        return eng.end_round(metrics)

    def run_round(self) -> RoundReport:
        if self._population:
            return self._run_round_population()
        eng = self.engine
        participants = [int(k) for k in eng.participants()]
        live = np.zeros(self.n_clients, bool)
        live[participants] = True
        mine = np.zeros(self.n_clients, bool)
        mine[self._mine] = True
        batch = self._round_batch(eng.round_idx, range(self.n_clients),
                                  live & mine)
        args = [self.params, self.opt_state, batch]
        if self.partial:
            args += [torch.from_numpy(live).to(self.device), self.cache]
        if self.codec.has_state:
            args.append(self.ef_state)
        out = self._step(*args)
        m = out[2]
        if self.partial:
            self.cache = out[3]
        if self.codec.has_state:
            self.ef_state = out[-1]
        return self._report(participants, float(m["base_loss"]),
                            float(m["mod_loss"]))

    def _run_round_population(self) -> RoundReport:
        """One cohort-shaped round: draw <= C slots, page their state into
        the C-wide device cohort, run the masked step, page the trained
        positions back out. No device tensor is N-shaped."""
        eng = self.engine
        slots = [int(s) for s in eng.participants()]
        base_loss = mod_loss = float("nan")
        if slots:
            # Padding repeats a real slot under a False mask: the step
            # never touches it and it is never paged out.
            pad = self.width - len(slots)
            cohort = slots + [slots[0]] * pad
            live = np.arange(self.width) < len(slots)
            state = self.store.page_in(cohort, device=self.device)
            params = _unstack(state["params"], self.width)
            opt = _unstack(state["opt"], self.width)
            batch = self._round_batch(eng.round_idx, cohort, live)
            args = [params, opt, batch, torch.from_numpy(live).to(
                self.device), self._fresh_cache()]
            if self.codec.has_state:
                ef = self.ef_store.page_in(cohort, device=self.device)
                args.append(ef if self.mesh is None
                            else self._carried_blocks(ef, gather=False))
            out = self._step(*args)
            self.store.page_out(slots, {"params": _stack(params),
                                        "opt": _stack(opt)}, eng.round_idx)
            if self.codec.has_state:
                ef = out[-1]
                if self.mesh is not None:
                    ef = self._carried_blocks(ef, gather=True)
                self.ef_store.page_out(slots, ef, eng.round_idx)
                self.ef_store.prune(eng.round_idx)
            base_loss = float(out[2]["base_loss"])
            mod_loss = float(out[2]["mod_loss"])
            self._last_cohort = slots
        return self._report(slots, base_loss, mod_loss)

    # ------------------------------------------------------------- eval

    def evaluate(self, test_x=None, test_y=None) -> List[float]:
        """Per-client next-token accuracy. ``test_x`` may be a (B, S) int
        token array; None, or a non-token array, uses the held-out
        SyntheticLM batch (step ``_EVAL_STEP``, never drawn in training)
        of ``min(spec.data.n_test, 64)`` rows. ``test_y`` is ignored. A
        population evaluates its last cohort (the first ``min(width,
        N)`` slots before any round)."""
        if test_x is not None:
            arr = np.asarray(test_x)
            if arr.ndim != 2 or not np.issubdtype(arr.dtype, np.integer):
                test_x = None
        if test_x is None:
            n = max(1, min(self.spec.data.n_test, 64))
            test_x = self._stream.sample(n, self.seq, step=_EVAL_STEP,
                                         client=0)
        toks = torch.from_numpy(np.asarray(test_x, np.int32)).to(self.device)
        if self._population:
            slots = (self._last_cohort
                     or list(range(min(self.width, self.n_clients))))
            params = [nn.tree_map(lambda a: a.to(self.device),
                                  self.store.get(s)["params"])
                      for s in slots]
        else:
            params = self.params
        cfg = self.model_cfg
        accs = []
        with torch.no_grad():
            for p in params:
                z, _ = base_forward(p["base"], cfg, {"tokens": toks})
                pred = modular_forward(p["modular"], cfg,
                                       z)[0][:, :-1].argmax(-1)
                accs.append((pred == toks[:, 1:]).float().mean())
        accs = torch.stack(accs)
        if self.mesh is not None and not self._population:
            accs = all_gather_cat(accs, self.layout.client_group, 0)
        return [float(a) for a in accs.tolist()]

    # ------------------------------------------------- snapshot/restore

    def snapshot(self):
        """(tensor tree, JSON-able aux), the Trainer protocol's state, in
        the reference's layout. Legacy: ``params``, ``opt``, ``ef`` and
        ``cache`` stacked over the N clients; the cache is fixed-shape,
        so a resume is bitwise even mid-staleness. Population: a sparse
        tree of the materialized slots (``slots``, and ``ef_slots`` for
        an EF codec) keyed by slot id, with the slot lists and last-seen
        rounds in ``aux['population']``; untouched slots come back
        through the store's deterministic init."""
        if self._population:
            state, last_seen = self.store.snapshot_state()
            tree = {"slots": {str(s): t for s, t in state.items()}}
            pop = {"slots": sorted(state),
                   "last_seen": {str(s): r for s, r in last_seen.items()},
                   "last_cohort": list(self._last_cohort)}
            if self.ef_store is not None:
                ef_state, ef_seen = self.ef_store.snapshot_state()
                tree["ef_slots"] = {str(s): t for s, t in ef_state.items()}
                pop["ef_slots"] = sorted(ef_state)
                pop["ef_last_seen"] = {str(s): r
                                       for s, r in ef_seen.items()}
            aux = self.engine.aux_state()
            aux["population"] = pop
            return tree, aux
        tree = {"params": _stack(self.params), "opt": _stack(self.opt_state)}
        if self.ef_state is not None:
            tree["ef"] = self.ef_state.clone()
        if self.cache is not None:
            tree["cache"] = nn.tree_map(torch.clone, self.cache)
        if self.mesh is not None:
            tree = {k: (self._client_blocks(v, gather=True)
                        if k in ("params", "opt")
                        else self._carried_blocks(v, gather=True))
                    for k, v in tree.items()}
        return tree, self.engine.aux_state()

    def snapshot_template(self, extra):
        """The tree a saved checkpoint is read into (``load_trainer``'s
        hook): a population's sparse snapshot depends on the slots the
        saved run touched, so build exactly those through the stores'
        deterministic init."""
        if not self._population:
            return self.snapshot()[0]
        pop = extra.get("population", {})
        tree = {"slots": {str(int(s)): self.store.init_fn(int(s))
                          for s in pop.get("slots", [])}}
        if self.ef_store is not None:
            tree["ef_slots"] = {str(int(s)): self.ef_store.init_fn(int(s))
                                for s in pop.get("ef_slots", [])}
        return tree

    def restore(self, tree, aux) -> None:
        if self._population:
            pop = aux["population"]
            self.store.restore_state(tree["slots"], pop["last_seen"])
            if self.ef_store is not None:
                self.ef_store.restore_state(tree.get("ef_slots", {}),
                                            pop.get("ef_last_seen", {}))
            self._last_cohort = [int(s) for s in pop.get("last_cohort", [])]
            self.engine.restore_aux(aux)
            return
        whole = tree
        if self.mesh is not None:
            tree = {k: (self._client_blocks(v, gather=False)
                        if k in ("params", "opt")
                        else self._carried_blocks(v, gather=False))
                    for k, v in tree.items()}
        n = len(self._mine)
        self.params = _unstack(tree["params"], n)
        if tree["opt"]["base"] or tree["opt"]["modular"]:
            self.opt_state = _unstack(tree["opt"], n)
        if self.ef_state is not None:
            self.ef_state = tree["ef"].clone()
        if self.cache is not None:
            self.cache = nn.tree_map(torch.clone, tree["cache"])
        self.engine.restore_aux(aux)
        if "exchange" not in aux and self.cache is not None:
            # A checkpoint from before the exchange plane kept host state:
            # the cache comes back warm, so rebuild the host age replica
            # from the restored ages (a slot of age a last uploaded at
            # round (round_idx - 1) - a) instead of ledgering cold.
            last = self.engine.round_idx - 1
            self.exchange._last_upload = [
                None if int(a) >= _NEVER else last - int(a)
                for a in whole["cache"]["age"].tolist()]
