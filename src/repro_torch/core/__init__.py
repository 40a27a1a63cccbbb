"""The paper's contribution, ported: the eager IFL trainer (Algorithm 1)
and its exchange plane.

Submodules (each the twin of the JAX package's module of that name):
  comm      — communication ledger + analytic per-round byte formulas
  report    — RoundReport, the structured run_round() return type
  codec     — fusion-payload wire codecs + EF21 wrapping (ef(<codec>))
  exchange  — the eager fusion exchange plane (codec, EF residuals,
              FusionCache, ledger, full broadcast)
  rounds    — participation schedules and the sync RoundEngine
  ifl       — the two-stage IFL algorithm (eager, heterogeneous clients)
"""

from repro_torch.core.codec import (  # noqa: F401
    Codec,
    EFCodec,
    available_codecs,
    get_codec,
)
from repro_torch.core.comm import (  # noqa: F401
    CommLedger,
    fl_round_bytes,
    fsl_round_bytes,
    ifl_round_bytes,
    nbytes,
)
from repro_torch.core.exchange import ExchangePlane, FusionExchange  # noqa: F401
from repro_torch.core.ifl import (  # noqa: F401
    Client,
    IFLTrainer,
    composition_accuracy,
)
from repro_torch.core.report import RoundReport  # noqa: F401
from repro_torch.core.rounds import (  # noqa: F401
    BernoulliSchedule,
    FullParticipation,
    ParticipationSchedule,
    RoundEngine,
    StragglerSchedule,
    UniformK,
    parse_participation,
)
