"""Registered schemes: data loading, fleet construction, trainer builders.

The port's copy of ``repro.api.schemes``: the same
make-data -> Dirichlet-partition -> Client-list -> trainer sequence
(shard seed ``spec.seed``, heterogeneous fleets cycling the four Table-II
architectures, trainer seed ``spec.seed``), so a spec replays the
reference's participants, minibatches and ledger bytes.

Parameters: the reference draws client k's init from
``jax.random.PRNGKey(100 + k)``, which torch cannot reproduce. ``params``
takes those trees (as numpy, carried by ``checkpoint.params_from_numpy``)
to start from the reference's own init; without it, client k draws the
same distributions from ``torch.Generator().manual_seed(100 + k)`` on the
CPU, so a run on the card and a run on the CPU start from equal weights.

The registry holds the reference's five names. Not ported yet: the
``fsl``/``fl1``/``fl2`` baselines (ROADMAP.md queue 1, item 3a),
``ifl_spmd`` (item 4b), the token dataset (item 4b) and population fleets
(item 3b); their builders raise ``NotImplementedError``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.api.registry import register_scheme
from repro_torch.api.spec import ExperimentSpec
from repro_torch.checkpoint import params_from_numpy
from repro_torch.core.ifl import Client, IFLTrainer
from repro_torch.data.dirichlet import dirichlet_partition
from repro_torch.data.images import make_synth_kmnist
from repro_torch.device import resolve_device
from repro_torch.models.small import (
    client_base_apply,
    client_modular_apply,
    init_client_model,
)

__all__ = ["DataBundle", "load_data", "apply_fns", "build_fleet",
           "build_ifl"]


class DataBundle(NamedTuple):
    """Loaded train/test arrays."""

    train_x: Optional[np.ndarray]
    train_y: Optional[np.ndarray]
    test_x: Optional[np.ndarray]
    test_y: Optional[np.ndarray]


def load_data(spec: ExperimentSpec) -> DataBundle:
    if spec.data.dataset == "synth_kmnist":
        return DataBundle(*make_synth_kmnist(spec.data.n_train,
                                             spec.data.n_test))
    if spec.data.dataset == "synth_tokens":
        raise NotImplementedError(
            "dataset 'synth_tokens' serves the SPMD scheme, not ported yet "
            "(ROADMAP.md queue 1, item 4b)")
    raise ValueError(f"unknown dataset {spec.data.dataset!r}; available: "
                     "synth_kmnist")


def apply_fns(cid: int):
    """(base_apply, modular_apply) closures for Table-II arch ``cid``."""
    return (
        functools.partial(
            lambda p, x, c: client_base_apply({"base": p}, c, x), c=cid),
        functools.partial(
            lambda p, z, c: client_modular_apply({"modular": p}, c, z), c=cid),
    )


def build_fleet(spec: ExperimentSpec, data: DataBundle, *,
                params: Optional[Sequence] = None, device=None):
    """Dirichlet-shard the data and build the Client list on ``device``
    (the card unless ``'cpu'``). ``params[k]`` (numpy trees, optional) is
    slot k's initial parameters; see the module docstring."""
    fleet = spec.fleet
    if fleet.n_population:
        raise NotImplementedError(
            "population fleets are not ported yet (ROADMAP.md queue 1, "
            "item 3b)")
    dev = resolve_device(device)
    n = fleet.population
    shards = dirichlet_partition(data.train_y, n, alpha=fleet.alpha,
                                 seed=spec.seed)
    clients = []
    for k in range(n):
        cid = (k % 4 + 1) if fleet.heterogeneous else fleet.arch
        if params is not None:
            p = params_from_numpy(params[k], device=dev)
        else:
            gen = torch.Generator().manual_seed(100 + k)
            p = init_client_model(cid, generator=gen, device=dev)
        base_fn, mod_fn = apply_fns(cid)
        clients.append(Client(
            cid=cid, params=p, base_apply=base_fn, modular_apply=mod_fn,
            data_x=data.train_x[shards[k]], data_y=data.train_y[shards[k]]))
    return clients


@register_scheme("ifl", summary="Interoperable FL (the paper, Algorithm 1): "
                                "heterogeneous fleet, fusion-output exchange")
def build_ifl(spec: ExperimentSpec, data: DataBundle, *,
              params: Optional[Sequence] = None, device=None) -> IFLTrainer:
    """The paper's Algorithm 1: a heterogeneous fleet exchanging fusion
    outputs."""
    dev = resolve_device(device)
    return IFLTrainer(build_fleet(spec, data, params=params, device=dev),
                      spec.run_config(), seed=spec.seed, device=dev)


def _not_ported(name: str, item: str, summary: str) -> None:
    """Register ``name`` with a builder that raises, naming its item."""

    @register_scheme(name, summary=summary)
    def build(spec, data, **kw):
        raise NotImplementedError(f"scheme {name!r} is not ported yet "
                                  f"(ROADMAP.md queue 1, item {item})")


_not_ported("fsl", "3a", "federated split learning baseline "
                         "(SplitFed-style shared server block)")
_not_ported("fl1", "3a", "FedAvg, client 1's smallest arch cloned "
                         "fleet-wide (paper FL-1)")
_not_ported("fl2", "3a", "FedAvg, client 2's larger arch cloned "
                         "fleet-wide (paper FL-2)")
_not_ported("ifl_spmd", "4b", "IFL as one SPMD round step (LM-scale, "
                              "stacked-client mesh)")
