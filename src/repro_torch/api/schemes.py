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

A population spec (``fleet.n_population`` set) gets a
:class:`repro_torch.core.population.LazyFleet` of N clients, client k
built on first touch from ``params[k]`` or its ``manual_seed(100 + k)``
draw, both deterministic in k, so lazy == eager bitwise.

The registry holds the reference's five names: ``ifl``, the baselines
``fsl``, ``fl1`` and ``fl2`` (with the reference's refusals of async
modes and population fleets, as ``ValueError``), and ``ifl_spmd``, the
LM trainer of ``repro_torch.api.spmd`` on the ``synth_tokens`` dataset
(which loads to an empty bundle: the trainer streams ``SyntheticLM``
itself). ``build_ifl_spmd``'s ``params[k]`` is slot k's LM init.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.api.registry import register_scheme
from repro_torch.api.spec import ExperimentSpec
from repro_torch.api.spmd import SPMDIFLTrainer
from repro_torch.checkpoint import params_from_numpy
from repro_torch.core.fl import FLTrainer
from repro_torch.core.fsl import FSLTrainer
from repro_torch.core.ifl import Client, IFLTrainer
from repro_torch.core.population import LazyFleet
from repro_torch.data.dirichlet import dirichlet_partition
from repro_torch.data.images import make_synth_kmnist
from repro_torch.device import resolve_device
from repro_torch.models.small import (
    client_base_apply,
    client_modular_apply,
    init_client_model,
)

__all__ = ["DataBundle", "load_data", "apply_fns", "build_fleet",
           "build_ifl", "build_fsl", "build_fl1", "build_fl2",
           "build_ifl_spmd"]


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
        # The SPMD trainer streams its tokens from SyntheticLM itself.
        return DataBundle(None, None, None, None)
    raise ValueError(f"unknown dataset {spec.data.dataset!r}; available: "
                     "synth_kmnist, synth_tokens")


def apply_fns(cid: int):
    """(base_apply, modular_apply) closures for Table-II arch ``cid``."""
    return (
        functools.partial(
            lambda p, x, c: client_base_apply({"base": p}, c, x), c=cid),
        functools.partial(
            lambda p, z, c: client_modular_apply({"modular": p}, c, z), c=cid),
    )


def build_fleet(spec: ExperimentSpec, data: DataBundle, *,
                heterogeneous: Optional[bool] = None,
                arch: Optional[int] = None,
                params: Optional[Sequence] = None, device=None):
    """Dirichlet-shard the data and build the Client list on ``device``
    (the card unless ``'cpu'``). Heterogeneous fleets cycle the four
    Table-II architectures; homogeneous ones (the FL regime) clone
    ``arch`` everywhere; both default to the spec's fleet. ``params[k]``
    (numpy trees, optional) is slot k's initial parameters; see the
    module docstring. A population spec gets a ``LazyFleet``."""
    fleet = spec.fleet
    if heterogeneous is None:
        heterogeneous = fleet.heterogeneous
    arch = fleet.arch if arch is None else arch
    dev = resolve_device(device)
    n = fleet.population
    shards = dirichlet_partition(data.train_y, n, alpha=fleet.alpha,
                                 seed=spec.seed)

    def build_client(k: int) -> Client:
        cid = (k % 4 + 1) if heterogeneous else arch
        if params is not None:
            p = params_from_numpy(params[k], device=dev)
        else:
            gen = torch.Generator().manual_seed(100 + k)
            p = init_client_model(cid, generator=gen, device=dev)
        base_fn, mod_fn = apply_fns(cid)
        return Client(
            cid=cid, params=p, base_apply=base_fn, modular_apply=mod_fn,
            data_x=data.train_x[shards[k]], data_y=data.train_y[shards[k]])

    if fleet.n_population:
        return LazyFleet(n, build_client)
    return [build_client(k) for k in range(n)]


@register_scheme("ifl", summary="Interoperable FL (the paper, Algorithm 1): "
                                "heterogeneous fleet, fusion-output exchange")
def build_ifl(spec: ExperimentSpec, data: DataBundle, *,
              params: Optional[Sequence] = None, device=None) -> IFLTrainer:
    """The paper's Algorithm 1: a heterogeneous fleet exchanging fusion
    outputs."""
    dev = resolve_device(device)
    return IFLTrainer(build_fleet(spec, data, params=params, device=dev),
                      spec.run_config(), seed=spec.seed, device=dev)


def _require_sync(spec: ExperimentSpec, scheme: str) -> None:
    # FedAvg and split learning aggregate a *shared* block, which is only
    # well-defined at a round barrier: refuse at build time.
    if spec.mode != "sync":
        raise ValueError(
            f"scheme {scheme!r} only supports mode='sync' — async "
            "arrival-driven rounds need the IFL fusion cache "
            "(use scheme='ifl' or 'ifl_spmd')"
        )


def _require_no_population(spec: ExperimentSpec, scheme: str) -> None:
    # Only the IFL fusion planes page per-slot state through a population
    # store; FedAvg/FSL have no cohort-shaped path.
    if spec.fleet.n_population or spec.fleet.cohort:
        raise ValueError(
            f"scheme {scheme!r} has no cohort-shaped path yet — "
            "population fleets (n_population/cohort) need the IFL "
            "fusion cache (use scheme='ifl' or 'ifl_spmd')"
        )


@register_scheme("fsl", summary="federated split learning baseline "
                                "(SplitFed-style shared server block)")
def build_fsl(spec: ExperimentSpec, data: DataBundle, *,
              params: Optional[Sequence] = None, device=None) -> FSLTrainer:
    """Split learning over the heterogeneous fleet; the server block is
    client 1's modular block, drawn from ``manual_seed(999)`` on the CPU
    (the reference draws it from ``PRNGKey(999)``: to carry that init,
    ``load_trainer`` a reference checkpoint or construct the
    :class:`FSLTrainer` with ``params_from_numpy`` of its tree)."""
    _require_sync(spec, "fsl")
    _require_no_population(spec, "fsl")
    dev = resolve_device(device)
    clients = build_fleet(spec, data, params=params, device=dev)
    gen = torch.Generator().manual_seed(999)
    server = init_client_model(1, generator=gen, device=dev)["modular"]
    _, server_apply = apply_fns(1)
    return FSLTrainer(clients, spec.run_config(), server, server_apply,
                      seed=spec.seed, device=dev)


def _build_fl(spec: ExperimentSpec, data: DataBundle, arch: int, *,
              params: Optional[Sequence], device) -> FLTrainer:
    _require_sync(spec, f"fl{arch}")
    _require_no_population(spec, f"fl{arch}")
    dev = resolve_device(device)
    clients = build_fleet(spec, data, heterogeneous=False, arch=arch,
                          params=params, device=dev)
    return FLTrainer(clients, spec.run_config(), seed=spec.seed, device=dev)


@register_scheme("fl1", summary="FedAvg, client 1's smallest arch cloned "
                                "fleet-wide (paper FL-1)")
def build_fl1(spec: ExperimentSpec, data: DataBundle, *,
              params: Optional[Sequence] = None, device=None) -> FLTrainer:
    return _build_fl(spec, data, 1, params=params, device=device)


@register_scheme("fl2", summary="FedAvg, client 2's larger arch cloned "
                                "fleet-wide (paper FL-2)")
def build_fl2(spec: ExperimentSpec, data: DataBundle, *,
              params: Optional[Sequence] = None, device=None) -> FLTrainer:
    return _build_fl(spec, data, 2, params=params, device=device)


@register_scheme("ifl_spmd", summary="IFL as one SPMD round step (LM-scale, "
                                     "stacked-client mesh)")
def build_ifl_spmd(spec: ExperimentSpec, data: DataBundle, *,
                   params: Optional[Sequence] = None, device=None,
                   **kw) -> SPMDIFLTrainer:
    """IFL on an LM over stacked clients (``repro_torch.api.spmd``); the
    data bundle is unused (the trainer streams ``SyntheticLM`` tokens).
    ``params[k]`` (numpy trees, optional) is slot k's initial
    ``{"base", "modular"}``; ``kw`` goes to the trainer (``seq``,
    ``init_params``)."""
    if params is not None:
        kw["init_params"] = params.__getitem__
    return SPMDIFLTrainer(spec, device=device, **kw)
