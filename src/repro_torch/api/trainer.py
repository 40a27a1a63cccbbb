"""The unified `Trainer` protocol and checkpoint plumbing for resume.

The port's copy of ``repro.api.trainer``. Every scheme the registry
builds satisfies one structural interface:

  run_round()  -> RoundReport     one communication round
  evaluate(test_x, test_y)        per-client accuracies (or a scalar)
  snapshot()   -> (tree, aux)     tensor tree + JSON-able aux state
  restore(tree, aux)              inverse of snapshot
  ledger       : CommLedger       bytes that crossed the client boundary

``save_trainer`` / ``load_trainer`` write and read the tree through
``repro_torch.checkpoint`` (the .npz of the JAX package's format, aux in
the manifest's ``extra``), so a trainer resumes bit for bit mid-run, and
a checkpoint the JAX package's ``save_trainer`` wrote resumes here. An
async trainer's event clock (the trace cursor and upload counters) rides
in the aux under ``'async'``, so it resumes on the same arrivals.
"""

from __future__ import annotations

from typing import Any, Dict, Protocol, Tuple, runtime_checkable

from repro_torch.checkpoint import load_checkpoint, load_extra, save_checkpoint
from repro_torch.core.comm import CommLedger
from repro_torch.core.report import RoundReport

__all__ = ["Trainer", "save_trainer", "load_trainer"]


@runtime_checkable
class Trainer(Protocol):
    """Structural interface every registered scheme's trainer satisfies."""

    ledger: CommLedger

    def run_round(self) -> RoundReport: ...

    def evaluate(self, test_x, test_y): ...

    def snapshot(self) -> Tuple[Any, Dict[str, Any]]: ...

    def restore(self, tree, aux) -> None: ...


def save_trainer(path: str, trainer: Trainer) -> None:
    """Checkpoint a mid-run trainer (.npz + manifest). A trainer on a
    mesh (``trainer.mesh``) gathers its ranks' blocks into the
    one-process layout (every rank calls this), rank 0 writes the file,
    and every rank waits for the write."""
    tree, aux = trainer.snapshot()
    mesh = getattr(trainer, "mesh", None)
    if mesh is None:
        save_checkpoint(path, tree, step=int(aux.get("round_idx", 0)),
                        extra=aux)
        return
    import torch.distributed as dist

    if dist.get_rank() == 0:
        save_checkpoint(path, tree, step=int(aux.get("round_idx", 0)),
                        extra=aux)
    dist.barrier()


def load_trainer(path: str, trainer: Trainer) -> Trainer:
    """Restore ``trainer`` (built from the same spec) in place and return
    it. The trainer's own ``snapshot()`` tree is the template the
    checkpoint is checked against, shape by shape, so restoring across
    another fleet or codec fails instead of mixing states. A trainer
    whose snapshot's structure depends on its history (a population's
    sparse one) gives ``snapshot_template(extra)``, read from the
    manifest's aux first. A trainer on a mesh reads the whole file on
    every rank and keeps its own block, whatever mesh (or one process)
    saved it."""
    extra = load_extra(path)
    if hasattr(trainer, "snapshot_template"):
        template = trainer.snapshot_template(extra)
    else:
        template, _ = trainer.snapshot()
    trainer.restore(load_checkpoint(path, template), extra)
    return trainer
