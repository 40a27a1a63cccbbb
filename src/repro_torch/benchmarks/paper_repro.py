"""Delegates over the port's front door, the twin of
``benchmarks/paper_repro.py``: ``make_clients`` and ``run_scheme`` keep
the reference's signatures, plus ``device=`` (the card unless ``'cpu'``)
and ``cache_dir=``. New code builds an ``ExperimentSpec`` directly, as
``fig2_comm_efficiency`` does."""

from __future__ import annotations

from typing import Dict, List

from repro_torch.api import (
    DataBundle,
    DataSpec,
    ExperimentSpec,
    FleetSpec,
    build_fleet,
    run_experiment,
)
from repro_torch.api import PAPER_RESULTS as RESULTS
from repro_torch.core import Client


def make_clients(tx, ty, *, heterogeneous: bool = True, arch: int = 1,
                 alpha: float = 0.5, seed: int = 0,
                 device=None) -> List[Client]:
    """``build_fleet`` over a 4-client fleet of the given shards."""
    spec = ExperimentSpec(
        seed=seed,
        fleet=FleetSpec(n_clients=4, heterogeneous=heterogeneous,
                        arch=arch, alpha=alpha),
    )
    return build_fleet(spec, DataBundle(tx, ty, None, None), device=device)


def run_scheme(scheme: str, rounds: int, *, eval_every: int = 5,
               n_train: int = 20000, n_test: int = 4000,
               tau: int = 10, seed: int = 0, lr: float = 0.05,
               codec: str = "fp32", participation: str = "full",
               max_staleness=None, force: bool = False, device=None,
               cache_dir: str = RESULTS) -> Dict:
    """``run_experiment`` of the spec these arguments name, cached under
    ``cache_dir`` by its spec hash; lr 0.05 is the reference's
    calibrated default for the synthetic stand-in."""
    spec = ExperimentSpec(
        scheme=scheme, rounds=rounds, tau=tau, lr=lr, codec=codec,
        participation=participation, max_staleness=max_staleness,
        eval_every=eval_every, seed=seed,
        data=DataSpec(n_train=n_train, n_test=n_test),
    )
    return run_experiment(spec, cache_dir=cache_dir, force=force,
                          device=device).to_dict()
