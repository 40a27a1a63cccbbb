"""`run_experiment(spec)` — the one way to run a scheme.

The port's copy of ``repro.api.runner``: resolve the scheme from the
registry, load the data, build the trainer, run ``spec.rounds`` rounds
collecting :class:`RoundReport`s, evaluate on the spec's cadence, and
return (and optionally cache) a :class:`RunResult`.

Caching is content-addressed: the file is
``<scheme>_<spec_hash>_<device type>.json`` (the spec hash equals the JAX
package's for the same spec) with the spec, the package and the device
inside, so a run on the card is never served a CPU run's result, and an
entry another package or device wrote is a miss. ``PAPER_RESULTS`` is
the port's own directory, ``results/torch/``: a port run is never served
the JAX package's fixtures under ``results/paper/`` as its own result.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.api import schemes
from repro_torch.api.registry import get_scheme
from repro_torch.api.result import PACKAGE, RunResult
from repro_torch.api.spec import ExperimentSpec
from repro_torch.api.trainer import Trainer
from repro_torch.core.report import RoundReport
from repro_torch.device import resolve_device

__all__ = ["run_experiment", "build_trainer", "PAPER_RESULTS"]

PAPER_RESULTS = os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "results", "torch"
)


def build_trainer(spec: ExperimentSpec, *, device=None,
                  params: Optional[Sequence] = None) -> Trainer:
    """Registry lookup + data load + scheme build (no rounds run), on
    ``device`` (the card unless ``'cpu'``), from ``params`` (per-slot
    numpy trees) when given."""
    return get_scheme(spec.scheme).build(spec, schemes.load_data(spec),
                                         device=device, params=params)


def _eval_record(trainer, data, report: RoundReport) -> Dict[str, Any]:
    """One eval-cadence record, in the reference's shape."""
    rec: Dict[str, Any] = {
        "round": report.round,
        "uplink_mb": trainer.ledger.uplink_mb,
        "total_mb": trainer.ledger.total_mb,
    }
    for key in ("sim_time", "uploads_per_sec"):
        if key in report.metrics:
            rec[key] = report.metrics[key]
    accs = trainer.evaluate(data.test_x, data.test_y)
    if isinstance(accs, (list, tuple)):
        rec["acc_mean"] = float(np.mean(accs))
        rec["accs"] = list(accs)
    else:
        rec["acc_mean"] = float(accs)
    if hasattr(trainer, "accuracy_matrix") and getattr(
            trainer, "eval_matrix", True):
        mat = trainer.accuracy_matrix(data.test_x[:2000], data.test_y[:2000])
        rec["matrix"] = mat.tolist()
        # Fig. 3: per-base-block SD across modular compositions.
        rec["sd_per_base"] = np.std(mat * 100, axis=1).tolist()
    return rec


def _cache_path(spec: ExperimentSpec, cache_dir: str, dev) -> str:
    return os.path.join(cache_dir,
                        f"{spec.scheme}_{spec.spec_hash()}_{dev.type}.json")


def _cached(spec: ExperimentSpec, cache_dir: str,
            dev) -> Optional[RunResult]:
    """The entry this package wrote for ``spec`` on ``dev``'s type, or
    None."""
    path = _cache_path(spec, cache_dir, dev)
    if not os.path.exists(path):
        return None
    hit = RunResult.from_json(path)
    if hit.package != PACKAGE or hit.device != dev.type:
        return None
    return hit


def run_experiment(
    spec: ExperimentSpec,
    *,
    cache_dir: Optional[str] = None,
    force: bool = False,
    keep_trainer: bool = False,
    on_record: Optional[Callable[[Dict[str, Any], RoundReport], None]] = None,
    device=None,
    params: Optional[Sequence] = None,
) -> RunResult:
    """Run (or serve from cache) the experiment ``spec`` describes.

    ``cache_dir`` enables spec-hash result caching; ``force`` re-runs and
    overwrites. With ``keep_trainer`` the live trainer rides on
    ``result.trainer``, so a cache hit is bypassed (a live trainer only
    exists for a live run). ``on_record(record, report)`` fires at every
    eval point; on a cache hit it replays over the cached records.
    ``device`` (the card unless ``'cpu'``; resolved before the cache is
    read, so the default raises without CUDA) and ``params`` go to the
    scheme's builder; ``params`` with ``cache_dir`` raises, because the
    spec hash does not name a carried init.
    """
    if params is not None and cache_dir:
        raise ValueError("run_experiment: params= with cache_dir= would key "
                         "a run from a carried init by a spec hash that "
                         "does not name it")
    dev = resolve_device(device)
    if cache_dir and not force and not keep_trainer:
        cached = _cached(spec, cache_dir, dev)
        if cached is not None:
            if on_record:
                by_round = {rep.get("round"): rep for rep in cached.reports}
                for rec in cached.records:
                    on_record(rec, RoundReport.from_dict(
                        by_round.get(rec.get("round"), rec)))
            return cached

    data = schemes.load_data(spec)
    trainer = get_scheme(spec.scheme).build(spec, data, device=device,
                                            params=params)

    records: List[Dict[str, Any]] = []
    reports: List[Dict[str, Any]] = []
    for r in range(spec.rounds):
        report = trainer.run_round()
        reports.append(report.to_dict())
        if (spec.eval_every > 0 and r % spec.eval_every == 0) \
                or r == spec.rounds - 1:
            rec = _eval_record(trainer, data, report)
            records.append(rec)
            if on_record:
                on_record(rec, report)

    result = RunResult(
        spec=spec,
        records=records,
        reports=reports,
        uplink_mb=trainer.ledger.uplink_mb,
        downlink_mb=trainer.ledger.downlink_mb,
        device=dev.type,
    )
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        out_path = _cache_path(spec, cache_dir, dev)
        # Only ``force`` may clobber an existing cache entry.
        if force or not os.path.exists(out_path):
            result.to_json(out_path)
    if keep_trainer:
        result.trainer = trainer
    return result
