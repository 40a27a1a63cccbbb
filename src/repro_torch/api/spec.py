"""`ExperimentSpec` — the single declarative description of one run.

The paper's argument is comparative (IFL vs FSL vs FL at matched
budgets), so the unit of work is "scheme X under codec Y and schedule Z
on data D with fleet F, seeded": that tuple IS the spec.  It is frozen,
dict-round-trippable, and content-addressed — ``spec_hash()`` is a
stable digest of the canonical dict, used by ``run_experiment`` to key
its result cache (replacing the old filename tags that embedded raw
codec strings like ``..._cef(int4).json``: shell-hostile parentheses,
float-formatting collisions on lr, and silently non-unique once a field
didn't make it into the tag).

``ExperimentSpec.run_config()`` lowers the spec onto the trainers'
:class:`RunConfig`; the scheme builders in ``api.schemes`` consume the
rest (data + fleet).

The port's copy of ``repro.api.spec``: the same fields, defaults, checks,
canonical dict and ``spec_hash()``, so a spec names the same experiment
in both packages.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from repro_torch.config import RunConfig

__all__ = ["DataSpec", "FleetSpec", "ExperimentSpec"]


@dataclass(frozen=True)
class DataSpec:
    """What the fleet trains on.

    ``dataset`` names a loader in ``repro.api.schemes`` ('synth_kmnist'
    for the paper's Table-II image setup, 'synth_tokens' for the
    LM-scale SPMD scheme).  Sizes are in samples (images) or eval
    sequences (tokens); token schemes stream training data from a
    seeded generator, so ``n_train`` only applies to materialized
    datasets.
    """

    dataset: str = "synth_kmnist"
    n_train: int = 20000
    n_test: int = 4000


@dataclass(frozen=True)
class FleetSpec:
    """Who trains: the client fleet.

    ``heterogeneous=True`` assigns the paper's Table-II architectures
    round-robin (client k gets arch ``k % 4 + 1``); ``False`` clones
    ``arch`` everywhere (the FL-1/FL-2 regime — FedAvg cannot serve a
    heterogeneous fleet, which is the limitation the paper targets).
    ``alpha`` is the Dirichlet non-IID concentration of the shards.

    Population regime (the FedAvg/HeteroFL deployment shape): setting
    ``n_population=N`` with ``cohort=C`` sizes the fleet at N clients of
    which at most C are admitted per round — device state stays
    C-shaped, per-slot carried state lives in the host-side population
    store, and the downlink serves the cohort's fresh uploads only.
    Both default to 0 (off: the fleet is ``n_clients`` and every
    pre-population spec hash is unchanged — the fields are elided from
    the canonical dict at their defaults).
    """

    n_clients: int = 4
    heterogeneous: bool = True
    arch: int = 1
    alpha: float = 0.5
    n_population: int = 0
    cohort: int = 0

    def __post_init__(self):
        if self.n_population < 0 or self.cohort < 0:
            raise ValueError(
                f"n_population/cohort must be >= 0, got "
                f"{self.n_population}/{self.cohort}"
            )
        if self.n_population and not self.cohort:
            raise ValueError(
                f"n_population={self.n_population} needs a cohort size "
                "(cohort=C, the per-round admission cap)"
            )
        pop = self.n_population or self.n_clients
        if self.cohort > pop:
            raise ValueError(
                f"cohort ({self.cohort}) cannot exceed the population "
                f"({pop} clients)"
            )

    @property
    def population(self) -> int:
        """The actual fleet size: ``n_population`` when set, else
        ``n_clients``."""
        return self.n_population or self.n_clients

    @property
    def cohort_size(self) -> Optional[int]:
        """The per-round admission cap (None when uncapped)."""
        return self.cohort or None


@dataclass(frozen=True)
class ExperimentSpec:
    """One experiment, fully pinned: same spec + same seed = same run.

    ``lr`` applies to both blocks (the paper uses one η; the calibrated
    synthetic-stand-in default is 0.05 — see benchmarks/paper_repro.py).
    ``model`` names an LM config (repro.configs) for the SPMD scheme,
    reduced to smoke scale; empty = that scheme's builtin tiny config.
    """

    scheme: str = "ifl"
    rounds: int = 20
    tau: int = 10
    lr: float = 0.05
    batch_size: int = 32
    d_fusion: int = 432
    codec: str = "fp32"
    participation: str = "full"
    max_staleness: Optional[int] = None
    # Downlink policy for the fusion broadcast: 'full' | 'delta'
    # (repro.core.exchange). Ignored by schemes without a fusion
    # downlink (FL/FSL).
    broadcast: str = "full"
    # Round clocking: 'sync' is the paper's barriered loop; 'async'
    # drives the engine from an ArrivalTrace (``trace``, e.g.
    # 'pareto(1.2,0.5)' or 'replay:<path>') with a server fuse every
    # ``tick`` simulated seconds (repro.core.rounds.AsyncRoundEngine).
    # Only the IFL schemes support async — FedAvg/FSL need the barrier.
    mode: str = "sync"
    trace: str = ""
    tick: float = 1.0
    eval_every: int = 5  # <=0: evaluate on the final round only
    seed: int = 0
    model: str = ""
    data: DataSpec = field(default_factory=DataSpec)
    fleet: FleetSpec = field(default_factory=FleetSpec)

    # Axes added after the canonical form was pinned, elided from
    # ``to_dict`` at their compat default: every pre-existing spec hash
    # (including the tracked results/paper fixtures) stays addressable,
    # and only a non-default value hashes as a new experiment.
    _ELIDE_AT_DEFAULT = (
        ("broadcast", "full"),
        ("mode", "sync"),
        ("trace", ""),
        ("tick", 1.0),
    )
    # Same compat contract for axes nested under the fleet dict.
    _ELIDE_FLEET_AT_DEFAULT = (
        ("n_population", 0),
        ("cohort", 0),
    )

    def __post_init__(self):
        if self.mode not in ("sync", "async"):
            raise ValueError(
                f"mode={self.mode!r}: expected 'sync' or 'async'"
            )
        if self.mode == "async":
            if not self.trace:
                raise ValueError(
                    "mode='async' needs an arrival trace — e.g. "
                    "trace='poisson(0.5)', 'pareto(1.2,0.5)', or "
                    "'replay:<path>' (see repro.core.rounds.parse_trace)"
                )
            if self.participation != "full":
                raise ValueError(
                    "mode='async' draws participants from the arrival "
                    "trace; participation schedules only apply to sync "
                    f"mode (got participation={self.participation!r})"
                )
            if self.tick <= 0:
                raise ValueError(f"tick={self.tick}: must be > 0")
        elif self.trace:
            raise ValueError(
                f"trace={self.trace!r} set but mode='sync' — arrival "
                "traces only drive async mode (use participation= for "
                "sync schedules)"
            )

    # ------------------------------------------------------- conversions

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        for name, default in self._ELIDE_AT_DEFAULT:
            if d[name] == default:
                del d[name]
        for name, default in self._ELIDE_FLEET_AT_DEFAULT:
            if d["fleet"][name] == default:
                del d["fleet"][name]
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExperimentSpec":
        d = dict(d)
        data = d.pop("data", {}) or {}
        fleet = d.pop("fleet", {}) or {}
        known = {f.name for f in dataclasses.fields(cls)} - {"data", "fleet"}
        unknown = set(d) - known
        if unknown:
            # Strict on purpose: a typo'd field ('round' for 'rounds')
            # silently falling back to defaults would run — and cache —
            # a different experiment than the caller believes.
            raise ValueError(
                f"unknown ExperimentSpec field(s) {sorted(unknown)}; "
                f"known: {sorted(known | {'data', 'fleet'})}"
            )
        return cls(data=DataSpec(**data), fleet=FleetSpec(**fleet), **d)

    def replace(self, **kw) -> "ExperimentSpec":
        return dataclasses.replace(self, **kw)

    def run_config(self) -> RunConfig:
        """Lower onto the trainers' RunConfig (lr drives both blocks)."""
        return RunConfig(
            n_clients=self.fleet.population,
            n_population=self.fleet.n_population,
            cohort=self.fleet.cohort,
            tau=self.tau,
            rounds=self.rounds,
            batch_size=self.batch_size,
            lr_base=self.lr,
            lr_modular=self.lr,
            d_fusion=self.d_fusion,
            dirichlet_alpha=self.fleet.alpha,
            codec=self.codec,
            participation=self.participation,
            max_staleness=self.max_staleness,
            broadcast=self.broadcast,
            mode=self.mode,
            trace=self.trace,
            tick=self.tick,
        )

    # ------------------------------------------------------------ hashing

    def canonical_json(self) -> str:
        """Key-sorted, whitespace-free JSON of ``to_dict()`` — the bytes
        ``spec_hash`` digests.  json round-trips every field type used
        here (str/int/float/bool/None) exactly, so the hash is stable
        across processes and platforms."""
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))

    def spec_hash(self) -> str:
        """12-hex content address of the spec (sha256 prefix).

        Filesystem- and shell-safe by construction — this replaces the
        free-form filename tags as the results-cache key."""
        digest = hashlib.sha256(self.canonical_json().encode("utf-8"))
        return digest.hexdigest()[:12]
