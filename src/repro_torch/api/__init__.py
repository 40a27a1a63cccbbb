"""repro_torch.api — the port's front door, the twin of ``repro.api``.

    from repro_torch.api import ExperimentSpec, run_experiment

    result = run_experiment(ExperimentSpec(
        scheme="ifl", rounds=20, codec="ef(int4)", participation="k2",
    ))                                  # on the card; device="cpu" there
    print(result.final["acc_mean"], result.uplink_mb)

Pieces (each its own module, all re-exported here):

  ExperimentSpec / DataSpec / FleetSpec   what to run (frozen; the same
                                          ``spec_hash()`` as the JAX
                                          package's)
  register_scheme / get_scheme /          scheme registry: the reference's
  available_schemes                       five names, all ported (``ifl``,
                                          ``fsl``, ``fl1``, ``fl2``,
                                          ``ifl_spmd``)
  SPMDIFLTrainer / smoke_model_config     the LM trainer behind
                                          ``ifl_spmd``
  Trainer / RoundReport / RunResult       the protocol and its outputs
  run_experiment / build_trainer          the runner (spec-hash caching,
                                          ``device=``, ``params=``)
  save_trainer / load_trainer             mid-run checkpoint + resume
                                          (the JAX package's format)
"""

from repro_torch.api.spec import DataSpec, ExperimentSpec, FleetSpec  # noqa: F401
from repro_torch.api.registry import (  # noqa: F401
    SchemeEntry,
    available_schemes,
    get_scheme,
    register_scheme,
)
from repro_torch.core.report import RoundReport  # noqa: F401
from repro_torch.api.result import RunResult  # noqa: F401
from repro_torch.api.trainer import Trainer, load_trainer, save_trainer  # noqa: F401
from repro_torch.api import schemes  # noqa: F401  (registers the schemes)
from repro_torch.api.schemes import (  # noqa: F401
    DataBundle,
    apply_fns,
    build_fl1,
    build_fl2,
    build_fleet,
    build_fsl,
    build_ifl,
    build_ifl_spmd,
    load_data,
)
from repro_torch.api.spmd import SPMDIFLTrainer, smoke_model_config  # noqa: F401
from repro_torch.api.runner import (  # noqa: F401
    PAPER_RESULTS,
    build_trainer,
    run_experiment,
)
