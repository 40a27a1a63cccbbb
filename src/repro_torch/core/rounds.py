"""Participation-aware round engine: who shows up in round t, and the one
rng stream that pins a run.

The port's copy of the synchronous half of ``repro.core.rounds``:

  ParticipationSchedule   who participates in round t
    - FullParticipation         everyone, every round (Algorithm 1)
    - UniformK(k)               uniform K-of-N without replacement
    - BernoulliSchedule(p)      independent per-client availability
    - StragglerSchedule(f, m)   deterministic straggler trace
  RoundEngine             rng + schedule + round counter + history,
                          driving an exchange plane
                          (``repro_torch.core.exchange``)

Schedules parse from strings: ``full`` | ``k2`` | ``bern0.5`` |
``straggle(0.2,3)``. The engine makes the same ``np.random.default_rng
(seed)`` draws in the same order as the reference — the schedule mask,
then each participant's minibatch indices — so participants and
minibatches match it bitwise. Not ported yet (ROADMAP.md queue 1, item 3b):
``zipf(<a>)`` and ``diurnal(...)`` schedules, cohorts, arrival traces and
the async engine; asking for them raises ``NotImplementedError``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.core.exchange import ExchangePlane, FusionCache
from repro_torch.core.report import RoundReport

__all__ = [
    "ParticipationSchedule",
    "FullParticipation",
    "UniformK",
    "BernoulliSchedule",
    "StragglerSchedule",
    "parse_participation",
    "RoundEngine",
]

_SLICE_3B = "not ported yet (ROADMAP.md queue 1, item 3b)"


class ParticipationSchedule:
    """Who participates in round t. ``mask`` returns a bool (n,) array.

    Schedules that need randomness draw from the engine's generator;
    deterministic schedules must not touch it."""

    name: str = "abstract"

    def mask(self, round_idx: int, n: int,
             rng: np.random.Generator) -> np.ndarray:
        raise NotImplementedError


    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.name!r})"


@dataclass(frozen=True, repr=False)
class FullParticipation(ParticipationSchedule):
    """Every client, every round — Algorithm 1 as written."""

    name: str = "full"

    def mask(self, round_idx, n, rng):
        return np.ones(n, bool)



@dataclass(frozen=True, repr=False)
class UniformK(ParticipationSchedule):
    """Uniform K-of-N sampling without replacement, fresh each round."""

    k: int = 1
    name: str = ""

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if not self.name:
            object.__setattr__(self, "name", f"k{self.k}")

    def mask(self, round_idx, n, rng):
        m = np.zeros(n, bool)
        m[rng.choice(n, size=min(self.k, n), replace=False)] = True
        return m



@dataclass(frozen=True, repr=False)
class BernoulliSchedule(ParticipationSchedule):
    """Independent per-client availability: P(client up) = p. Rounds with
    no participant are legal."""

    p: float = 0.5
    name: str = ""

    def __post_init__(self):
        if not 0.0 < self.p <= 1.0:
            raise ValueError(f"p must be in (0, 1], got {self.p}")
        if not self.name:
            object.__setattr__(self, "name", f"bern{self.p:g}")

    def mask(self, round_idx, n, rng):
        return rng.random(n) < self.p



@dataclass(frozen=True, repr=False)
class StragglerSchedule(ParticipationSchedule):
    """Deterministic straggler trace (no rng draws): the last
    ``ceil(frac * n)`` slots are stragglers, and straggler slot i only
    participates in rounds with ``t % period == i % period``."""

    frac: float = 0.2
    period: int = 3
    name: str = ""

    def __post_init__(self):
        if not 0.0 <= self.frac <= 1.0:
            raise ValueError(f"frac must be in [0, 1], got {self.frac}")
        if self.period < 1:
            raise ValueError(f"period must be >= 1, got {self.period}")
        if not self.name:
            object.__setattr__(
                self, "name", f"straggle({self.frac:g},{self.period})")

    def mask(self, round_idx, n, rng):
        m = np.ones(n, bool)
        n_strag = int(np.ceil(self.frac * n))
        for i in range(n - n_strag, n):
            m[i] = (round_idx % self.period) == (i % self.period)
        return m



_K_RE = re.compile(r"^k(\d+)$")
_BERN_RE = re.compile(r"^bern(\d+(?:\.\d*)?(?:[eE][-+]?\d+)?)$")
_STRAGGLE_RE = re.compile(r"^straggle\(\s*([^,\s]+)\s*,\s*(\d+)\s*\)$")


def parse_participation(
    spec: Union[str, ParticipationSchedule, None],
) -> ParticipationSchedule:
    """Resolve a schedule spec: ``full`` | ``k<K>`` | ``bern<p>`` |
    ``straggle(<frac>,<period>)`` — or pass a schedule through. The same
    strict patterns as the reference; ``zipf``/``diurnal`` raise
    ``NotImplementedError``."""
    if spec is None:
        return FullParticipation()
    if isinstance(spec, ParticipationSchedule):
        return spec
    spec = spec.strip()
    if spec == "full":
        return FullParticipation()
    m = _K_RE.match(spec)
    if m:
        return UniformK(int(m.group(1)))
    if spec.startswith("k"):
        try:
            int(spec[1:])
        except ValueError:
            pass
        else:
            raise ValueError(
                f"participation spec {spec!r}: K must be a plain positive "
                "integer with no sign or padding (e.g. 'k2')")
    m = _BERN_RE.match(spec)
    if m:
        return BernoulliSchedule(float(m.group(1)))
    if spec.startswith("bern"):
        try:
            float(spec[len("bern"):])
        except ValueError:
            pass
        else:
            raise ValueError(
                f"participation spec {spec!r}: p must be a plain decimal "
                "with no sign or padding (e.g. 'bern0.5')")
    m = _STRAGGLE_RE.match(spec)
    if m:
        return StragglerSchedule(float(m.group(1)), int(m.group(2)))
    if spec.startswith(("zipf(", "diurnal(")):
        raise NotImplementedError(f"participation {spec!r}: {_SLICE_3B}")
    raise ValueError(
        f"unknown participation spec {spec!r}; expected 'full', 'k<K>' "
        "(e.g. k2), 'bern<p>' (e.g. bern0.5), or "
        "'straggle(<frac>,<period>)' (e.g. straggle(0.2,3))")


class RoundEngine:
    """The scheduling core: one rng stream for schedule draws AND
    minibatch sampling (so a seed pins the run), the participation
    schedule, the round counter and the metrics history, scheduled
    against an exchange plane that owns the wire side."""

    def __init__(self, n_clients: int,
                 participation: Union[str, ParticipationSchedule, None] = None,
                 *, seed: int = 0, exchange: Optional[ExchangePlane] = None):
        self.n_clients = n_clients
        self.schedule = parse_participation(participation)
        self.rng = np.random.default_rng(seed)
        self.exchange = ExchangePlane() if exchange is None else exchange
        self.ledger = self.exchange.ledger
        # The fusion cache lives on the plane when the plane carries one.
        self.cache = getattr(self.exchange, "cache", None)
        if self.cache is None:
            self.cache = FusionCache()
        self.round_idx = 0
        self.history: List[RoundReport] = []

    def participants(self) -> np.ndarray:
        """Sorted slot indices participating in the current round."""
        mask = self.schedule.mask(self.round_idx, self.n_clients, self.rng)
        return np.flatnonzero(mask)

    def sample(self, client, batch_size: int, device=None):
        """One private minibatch from ``client`` (.data_x/.data_y numpy,
        .num_samples), drawn as the reference draws it, as tensors on
        ``device`` (x fp32, y int32)."""
        idx = self.rng.integers(0, client.num_samples, size=batch_size)
        return (torch.from_numpy(client.data_x[idx]).to(device),
                torch.from_numpy(client.data_y[idx]).to(device))

    def end_round(self, metrics: Dict[str, Any]) -> RoundReport:
        """Close the ledger round, log metrics, advance the counter."""
        self.ledger.end_round()
        self.cache.prune(self.round_idx)
        metrics = dict(metrics)
        metrics.pop("uplink_mb", None)
        report = RoundReport(
            round=int(metrics.pop("round", self.round_idx)),
            uplink_mb=self.ledger.uplink_mb,
            downlink_mb=self.ledger.downlink_mb,
            participants=[int(k) for k in metrics.pop("participants", [])],
            metrics=metrics,
        )
        self.history.append(report)
        self.round_idx += 1
        return report
