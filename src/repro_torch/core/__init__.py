"""The paper's contribution, ported: the eager IFL trainer (Algorithm 1)
and its exchange plane.

Submodules (each the twin of the JAX package's module of that name):
  comm      — communication ledger + analytic per-round byte formulas
  report    — RoundReport, the structured run_round() return type
  codec     — fusion-payload wire codecs + EF21 wrapping (ef(<codec>))
  exchange  — the fusion exchange planes: the eager one (codec, EF
              residuals, FusionCache, ledger, full and delta broadcast,
              the population regime) and the SPMD one of the LM round
              step (masked wire, payload cache, account_round), with
              init_payload_cache and expected_delta_entries
  rounds    — participation schedules, arrival traces, the sync and
              async round engines, cohorts
  population — PopulationStore and LazyFleet
  ifl       — the two-stage IFL algorithm (eager, heterogeneous clients)
  ifl_spmd  — IFL on a language model, one round step over N clients
  fl        — the FedAvg baseline (FL-1 / FL-2)
  fsl       — the federated split learning baseline
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
from repro_torch.core.exchange import (  # noqa: F401
    ExchangePlane,
    FusionCache,
    FusionExchange,
    SPMDFusionExchange,
    expected_delta_entries,
    init_ef_state,
    init_payload_cache,
    parse_broadcast,
)
from repro_torch.core.fl import FLTrainer  # noqa: F401
from repro_torch.core.fsl import FSLTrainer  # noqa: F401
from repro_torch.core.ifl import (  # noqa: F401
    Client,
    IFLTrainer,
    composition_accuracy,
)
from repro_torch.core.population import (  # noqa: F401
    LazyFleet,
    PopulationStore,
)
from repro_torch.core.report import RoundReport  # noqa: F401
from repro_torch.core.rounds import (  # noqa: F401
    ArrivalTrace,
    AsyncRoundEngine,
    BernoulliSchedule,
    DiurnalSchedule,
    FullParticipation,
    ParetoTrace,
    ParticipationSchedule,
    PeriodicTrace,
    PoissonTrace,
    ReplayTrace,
    RoundEngine,
    StragglerSchedule,
    UniformK,
    ZipfSchedule,
    expected_async_participants,
    expected_cohort_participants,
    parse_participation,
    parse_trace,
    simulate_sync_wall_clock,
)
