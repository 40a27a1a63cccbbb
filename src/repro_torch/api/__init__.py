"""The port's front door, as far as slice 2 goes: ``ExperimentSpec``
(identical canonical dict and ``spec_hash()``), data loading, fleet
construction and the ``ifl`` builder.

The reference's scheme registry, ``run_experiment`` with its result
cache, ``ExperimentResult`` and ``save_trainer``/``load_trainer`` are not
ported yet (ROADMAP.md queue 1, item 2f); they raise
``NotImplementedError``.
"""

from repro_torch.api.schemes import (  # noqa: F401
    DataBundle,
    apply_fns,
    build_fleet,
    build_ifl,
    build_scheme,
    load_data,
)
from repro_torch.api.spec import DataSpec, ExperimentSpec, FleetSpec  # noqa: F401

_FRONT_DOOR = ("not ported yet (ROADMAP.md queue 1, item 2f: "
               "registry, runner, result, save/load)")


def run_experiment(*args, **kwargs):
    raise NotImplementedError(f"run_experiment is {_FRONT_DOOR}")


def save_trainer(*args, **kwargs):
    raise NotImplementedError(f"save_trainer is {_FRONT_DOOR}")


def load_trainer(*args, **kwargs):
    raise NotImplementedError(f"load_trainer is {_FRONT_DOOR}")
