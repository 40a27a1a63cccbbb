"""Participation-aware round engines: who shows up in round t (or in a
server tick), and the one rng stream that pins a run.

The port's copy of ``repro.core.rounds``:

  ParticipationSchedule   who participates in round t
    - FullParticipation         everyone, every round (Algorithm 1)
    - UniformK(k)               uniform K-of-N without replacement
    - BernoulliSchedule(p)      independent per-client availability
    - StragglerSchedule(f, m)   deterministic straggler trace
    - ZipfSchedule(a)           popularity-skewed availability
    - DiurnalSchedule(T, z)     deterministic time-zone waves
  RoundEngine             rng + schedule + round counter + history,
                          driving an exchange plane
                          (``repro_torch.core.exchange``); ``cohort=C``
                          admits a uniform C-of-available draw
  ArrivalTrace            each client's upload clock on a simulated
                          timeline: ``periodic(<p>)`` |
                          ``poisson(<rate>)`` | ``pareto(<alpha>,<scale>)``
                          | ``replay:<path>`` (a recorded log), via
                          :func:`parse_trace`
  AsyncRoundEngine        one round == one server tick of ``tick``
                          simulated seconds; the participants are the
                          clients with >= 1 arrival in the tick window,
                          coalesced to one upload each (``cohort=C``
                          admits the C earliest), so a tick prices like a
                          sync round of K participants; reports gain
                          ``sim_time``, ``arrivals`` and
                          ``uploads_per_sec``
  simulate_sync_wall_clock  what the same trace costs a barrier run
  expected_cohort_participants / expected_async_participants
                          E[participants] by replaying the draws

Schedules parse from strings: ``full`` | ``k2`` | ``bern0.5`` |
``straggle(0.2,3)`` | ``zipf(1.1)`` | ``diurnal(24,4)``. Everything here
is numpy on the host, and the engines make the same
``np.random.default_rng(seed)`` draws in the same order as the
reference: the schedule mask (then the cohort draw), or the trace
cursor's gaps (the first arrivals at construction, later ones as
``participants()`` pops a tick, slot by slot), then each participant's
minibatch indices. So events, participants, minibatches and simulated
times match it bitwise. ``cohort=None`` draws nothing extra.
"""

from __future__ import annotations

import json
import math
import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

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
    "ZipfSchedule",
    "DiurnalSchedule",
    "parse_participation",
    "expected_cohort_participants",
    "TraceCursor",
    "ArrivalTrace",
    "PeriodicTrace",
    "PoissonTrace",
    "ParetoTrace",
    "ReplayTrace",
    "parse_trace",
    "RoundEngine",
    "AsyncRoundEngine",
    "simulate_sync_wall_clock",
    "expected_async_participants",
]


class ParticipationSchedule:
    """Who participates in round t. ``mask`` returns a bool (n,) array.

    Schedules that need randomness draw from the engine's generator;
    deterministic schedules must not touch it."""

    name: str = "abstract"

    def mask(self, round_idx: int, n: int,
             rng: np.random.Generator) -> np.ndarray:
        raise NotImplementedError

    def expected_participants(self, n: int) -> float:
        """E[K] per round for an n-client fleet."""
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.name!r})"


@dataclass(frozen=True, repr=False)
class FullParticipation(ParticipationSchedule):
    """Every client, every round — Algorithm 1 as written."""

    name: str = "full"

    def mask(self, round_idx, n, rng):
        return np.ones(n, bool)

    def expected_participants(self, n):
        return float(n)


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

    def expected_participants(self, n):
        return float(min(self.k, n))


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

    def expected_participants(self, n):
        return self.p * n


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

    def expected_participants(self, n):
        n_strag = int(np.ceil(self.frac * n))
        return (n - n_strag) + n_strag / self.period


@dataclass(frozen=True, repr=False)
class ZipfSchedule(ParticipationSchedule):
    """Popularity-skewed availability: slot k is up independently with
    probability ``(k+1)^-a``, one ``rng.random(n)`` draw a round. ``a=0``
    is full participation; larger ``a`` thins the tail faster. Rounds
    with no participant are legal."""

    a: float = 1.0
    name: str = ""

    def __post_init__(self):
        if not self.a >= 0.0:
            raise ValueError(f"a must be >= 0, got {self.a}")
        if not self.name:
            object.__setattr__(self, "name", f"zipf({self.a:g})")

    def mask(self, round_idx, n, rng):
        p = (np.arange(n) + 1.0) ** (-self.a)
        return rng.random(n) < p

    def expected_participants(self, n):
        return float(((np.arange(n) + 1.0) ** (-self.a)).sum())


@dataclass(frozen=True, repr=False)
class DiurnalSchedule(ParticipationSchedule):
    """Deterministic time-zone waves (no rng draws): the fleet splits into
    ``zones`` equal contiguous slices; zone z is awake for the first
    ``ceil(period/2)`` rounds of every ``period``-round day, shifted by
    ``z * period / zones`` rounds."""

    period: int = 24
    zones: int = 4
    name: str = ""

    def __post_init__(self):
        if self.period < 2:
            raise ValueError(f"period must be >= 2, got {self.period}")
        if self.zones < 1:
            raise ValueError(f"zones must be >= 1, got {self.zones}")
        if not self.name:
            object.__setattr__(
                self, "name", f"diurnal({self.period},{self.zones})")

    def mask(self, round_idx, n, rng):
        zone = (np.arange(n) * self.zones) // max(n, 1)
        phase = (round_idx - zone * self.period // self.zones) % self.period
        return phase < (self.period + 1) // 2

    def expected_participants(self, n):
        return n * ((self.period + 1) // 2) / self.period


_K_RE = re.compile(r"^k(\d+)$")
_BERN_RE = re.compile(r"^bern(\d+(?:\.\d*)?(?:[eE][-+]?\d+)?)$")
_STRAGGLE_RE = re.compile(r"^straggle\(\s*([^,\s]+)\s*,\s*(\d+)\s*\)$")
_ZIPF_RE = re.compile(r"^zipf\(\s*([^,\s)]+)\s*\)$")
_DIURNAL_RE = re.compile(r"^diurnal\(\s*(\d+)\s*(?:,\s*(\d+)\s*)?\)$")


def parse_participation(
    spec: Union[str, ParticipationSchedule, None],
) -> ParticipationSchedule:
    """Resolve a schedule spec: ``full`` | ``k<K>`` | ``bern<p>`` |
    ``straggle(<frac>,<period>)`` | ``zipf(<a>)`` |
    ``diurnal(<period>[,<zones>])`` — or pass a schedule through. The
    same strict patterns as the reference."""
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
    m = _ZIPF_RE.match(spec)
    if m:
        return ZipfSchedule(float(m.group(1)))
    m = _DIURNAL_RE.match(spec)
    if m:
        return DiurnalSchedule(int(m.group(1)),
                               int(m.group(2)) if m.group(2) else 4)
    raise ValueError(
        f"unknown participation spec {spec!r}; expected 'full', 'k<K>' "
        "(e.g. k2), 'bern<p>' (e.g. bern0.5), "
        "'straggle(<frac>,<period>)' (e.g. straggle(0.2,3)), "
        "'zipf(<a>)' (e.g. zipf(1.1)), or "
        "'diurnal(<period>[,<zones>])' (e.g. diurnal(24,4))")


def expected_cohort_participants(
    schedule: Union[str, ParticipationSchedule, None], n_clients: int,
    cohort: Optional[int] = None, *, rounds: int = 256, seed: int = 0,
) -> float:
    """E[participants a round] under a cohort cap, by replaying the
    schedule's own mask draws (``min(K_avail, C)`` has no closed form
    for the random schedules)."""
    schedule = parse_participation(schedule)
    rng = np.random.default_rng(seed)
    total = 0
    for t in range(max(rounds, 1)):
        k = int(schedule.mask(t, n_clients, rng).sum())
        total += min(k, cohort) if cohort is not None else k
    return total / max(rounds, 1)


# ---------------------------------------------------------- arrival traces


class TraceCursor:
    """Consumable view of one fleet's arrival stream: the async engine
    pops every event up to its next tick boundary (``pop_until``); the
    sync-barrier simulation asks for one client's next arrival after a
    round starts (``next_after``). ``state`` / ``restore`` make it
    checkpointable: with the engine's rng state, an async run resumes
    bitwise."""

    def pop_until(self, t_end: float,
                  rng: np.random.Generator) -> List[Tuple[float, int]]:
        """Consume and return every (time, slot) event with ``time <=
        t_end``, sorted by (time, slot)."""
        raise NotImplementedError

    def next_after(self, slot: int, t: float,
                   rng: np.random.Generator) -> float:
        """Consume ``slot``'s arrivals through its first one strictly
        after ``t`` and return that time (``inf`` once a replayed log
        has no more of them)."""
        raise NotImplementedError

    def state(self) -> Dict[str, Any]:
        raise NotImplementedError

    def restore(self, state: Dict[str, Any]) -> None:
        raise NotImplementedError


class _SamplerCursor(TraceCursor):
    """Cursor over per-client renewal processes: each slot's next pending
    arrival, with gaps drawn lazily from the generator it is handed (the
    engine's one stream), in slot order."""

    def __init__(self, trace: "ArrivalTrace", n: int,
                 rng: np.random.Generator):
        self.trace = trace
        self.next = [trace.first(k, n, rng) for k in range(n)]

    def pop_until(self, t_end, rng):
        events: List[Tuple[float, int]] = []
        for k in range(len(self.next)):
            while self.next[k] <= t_end:
                events.append((self.next[k], k))
                self.next[k] += self.trace.gap(k, rng)
        return sorted(events)

    def next_after(self, slot, t, rng):
        while self.next[slot] <= t:
            self.next[slot] += self.trace.gap(slot, rng)
        arrival = self.next[slot]
        self.next[slot] += self.trace.gap(slot, rng)
        return arrival

    def state(self):
        return {"next": [float(t) for t in self.next]}

    def restore(self, state):
        self.next = [float(t) for t in state["next"]]


class _ReplayCursor(TraceCursor):
    """Cursor over a recorded event list (a position per slot)."""

    def __init__(self, times_by_slot: List[List[float]]):
        self.times = times_by_slot
        self.pos = [0] * len(times_by_slot)

    def pop_until(self, t_end, rng):
        events: List[Tuple[float, int]] = []
        for k, ts in enumerate(self.times):
            p = self.pos[k]
            while p < len(ts) and ts[p] <= t_end:
                events.append((ts[p], k))
                p += 1
            self.pos[k] = p
        return sorted(events)

    def next_after(self, slot, t, rng):
        ts, p = self.times[slot], self.pos[slot]
        while p < len(ts) and ts[p] <= t:
            p += 1
        if p >= len(ts):
            self.pos[slot] = p
            return math.inf
        self.pos[slot] = p + 1
        return ts[p]

    def state(self):
        return {"pos": [int(p) for p in self.pos]}

    def restore(self, state):
        self.pos = [int(p) for p in state["pos"]]


class ArrivalTrace:
    """Each client's upload clock on the simulated timeline.

    Sampler traces are per-client renewal processes: ``gap`` is the time
    to the next upload, ``first`` the time of the first (one gap from
    t = 0 by default). A replayed log overrides ``cursor``. ``name``
    round-trips through :func:`parse_trace`."""

    name: str = "abstract"

    def first(self, slot: int, n: int, rng: np.random.Generator) -> float:
        return self.gap(slot, rng)

    def gap(self, slot: int, rng: np.random.Generator) -> float:
        raise NotImplementedError

    def cursor(self, n: int, rng: np.random.Generator) -> TraceCursor:
        return _SamplerCursor(self, n, rng)

    def mean_gap(self) -> float:
        """E[inter-arrival] (``inf`` where the mean diverges)."""
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.name!r})"


@dataclass(frozen=True, repr=False)
class PeriodicTrace(ArrivalTrace):
    """Deterministic clocks, no rng: client k uploads every ``period``
    seconds, its first upload at ``(k+1)/n * period``."""

    period: float = 1.0
    name: str = ""

    def __post_init__(self):
        if not self.period > 0:
            raise ValueError(f"period must be > 0, got {self.period}")
        if not self.name:
            object.__setattr__(self, "name", f"periodic({self.period:g})")

    def first(self, slot, n, rng):
        return self.period * (slot + 1) / max(n, 1)

    def gap(self, slot, rng):
        return self.period

    def mean_gap(self):
        return self.period


@dataclass(frozen=True, repr=False)
class PoissonTrace(ArrivalTrace):
    """Memoryless clocks: exponential gaps at ``rate`` uploads/s a client."""

    rate: float = 1.0
    name: str = ""

    def __post_init__(self):
        if not self.rate > 0:
            raise ValueError(f"rate must be > 0, got {self.rate}")
        if not self.name:
            object.__setattr__(self, "name", f"poisson({self.rate:g})")

    def gap(self, slot, rng):
        return float(rng.exponential(1.0 / self.rate))

    def mean_gap(self):
        return 1.0 / self.rate


@dataclass(frozen=True, repr=False)
class ParetoTrace(ArrivalTrace):
    """Heavy-tailed clocks: gap = ``scale * U^(-1/alpha)`` (Pareto with
    minimum ``scale``, tail index ``alpha``; ``alpha <= 1`` has no mean),
    so a barrier's round time, the max over clients, is pinned by the
    tail."""

    alpha: float = 1.5
    scale: float = 0.5
    name: str = ""

    def __post_init__(self):
        if not self.alpha > 0:
            raise ValueError(f"alpha must be > 0, got {self.alpha}")
        if not self.scale > 0:
            raise ValueError(f"scale must be > 0, got {self.scale}")
        if not self.name:
            object.__setattr__(
                self, "name", f"pareto({self.alpha:g},{self.scale:g})")

    def gap(self, slot, rng):
        u = 1.0 - rng.random()  # (0, 1]: bounds the draw away from inf
        return float(self.scale * u ** (-1.0 / self.alpha))

    def mean_gap(self):
        if self.alpha <= 1.0:
            return math.inf
        return self.alpha * self.scale / (self.alpha - 1.0)


class ReplayTrace(ArrivalTrace):
    """A replayed upload log: explicit (time, slot) events, ordered by
    (time, slot) (duplicate timestamps are legal and kept; an empty log
    is legal). ``from_file`` reads JSON lines (``{"t": 3.2, "client":
    1}``) or CSV (``time,slot``), skipping ``#`` comments and blank
    lines."""

    def __init__(self, events: Sequence[Tuple[float, int]],
                 n_clients: Optional[int] = None, *, path: str = ""):
        evs = []
        for i, (t, s) in enumerate(events):
            t, s = float(t), int(s)
            if not math.isfinite(t) or t < 0:
                raise ValueError(f"replay trace event {i}: time must be "
                                 f"finite and >= 0, got {t}")
            if s < 0:
                raise ValueError(f"replay trace event {i}: client slot must "
                                 f"be >= 0, got {s}")
            evs.append((t, s))
        self.events = sorted(evs)
        self.n_slots = max((s for _, s in self.events), default=-1) + 1
        if n_clients is not None and self.n_slots > n_clients:
            raise ValueError(
                f"replay trace names client slot {self.n_slots - 1} but "
                f"the fleet has only {n_clients} clients")
        self.name = f"replay:{path}" if path else "replay"

    @classmethod
    def from_file(cls, path: str,
                  n_clients: Optional[int] = None) -> "ReplayTrace":
        events = []
        with open(path) as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                try:
                    if line.startswith("{"):
                        rec = json.loads(line)
                        events.append((rec["t"], rec["client"]))
                    else:
                        t_s, s_s = line.split(",")
                        events.append((float(t_s), int(s_s)))
                except (ValueError, KeyError, TypeError) as e:
                    raise ValueError(
                        f"{path}:{lineno}: malformed arrival-log line "
                        f"{line!r} (expected JSON {{'t':..,'client':..}} "
                        f"or CSV 'time,slot'): {e}") from None
        return cls(events, n_clients, path=path)

    def cursor(self, n, rng):
        # A trace built without n_clients skipped the constructor's check.
        if self.n_slots > n:
            raise ValueError(
                f"replay trace names client slot {self.n_slots - 1} but "
                f"the fleet has only {n} clients")
        times: List[List[float]] = [[] for _ in range(n)]
        for t, s in self.events:
            times[s].append(t)
        return _ReplayCursor(times)

    def mean_gap(self):
        """Empirical mean inter-arrival over the log's clients."""
        gaps = []
        by_slot: Dict[int, List[float]] = {}
        for t, s in self.events:
            by_slot.setdefault(s, []).append(t)
        for ts in by_slot.values():
            gaps.extend(b - a for a, b in zip(ts, ts[1:]))
        return float(np.mean(gaps)) if gaps else math.inf

    def __repr__(self) -> str:
        return f"ReplayTrace({len(self.events)} events, {self.name!r})"


_TRACE_RES = {
    re.compile(r"^periodic\(([^,)]+)\)$"):
        lambda m: PeriodicTrace(float(m.group(1))),
    re.compile(r"^poisson\(([^,)]+)\)$"):
        lambda m: PoissonTrace(float(m.group(1))),
    re.compile(r"^pareto\(([^,)]+),([^,)]+)\)$"):
        lambda m: ParetoTrace(float(m.group(1)), float(m.group(2))),
}


def parse_trace(spec: Union[str, ArrivalTrace],
                n_clients: Optional[int] = None) -> ArrivalTrace:
    """Resolve an arrival-trace spec: ``periodic(<period>)`` |
    ``poisson(<rate>)`` | ``pareto(<alpha>,<scale>)`` | ``replay:<path>``
    (or pass a trace through). The spec strings are the traces' names."""
    if isinstance(spec, ArrivalTrace):
        return spec
    if not spec:
        raise ValueError(
            "async mode needs an arrival trace: 'periodic(<period>)', "
            "'poisson(<rate>)', 'pareto(<alpha>,<scale>)', or "
            "'replay:<path>'")
    if spec.startswith("replay:"):
        return ReplayTrace.from_file(spec[len("replay:"):], n_clients)
    for pat, build in _TRACE_RES.items():
        m = pat.match(spec)
        if m:
            try:
                return build(m)  # range errors (rate <= 0, ...) propagate
            except ValueError as e:
                if "could not convert" not in str(e):
                    raise
                break
    raise ValueError(
        f"unknown arrival-trace spec {spec!r}; expected "
        "'periodic(<period>)' (e.g. periodic(1)), 'poisson(<rate>)' "
        "(e.g. poisson(0.5)), 'pareto(<alpha>,<scale>)' (e.g. "
        "pareto(1.5,0.5)), or 'replay:<path>'")


# ------------------------------------------------------------ round engines


class RoundEngine:
    """The scheduling core: one rng stream for schedule draws AND
    minibatch sampling (so a seed pins the run), the participation
    schedule, the round counter and the metrics history, scheduled
    against an exchange plane that owns the wire side. ``cohort=C``
    caps admission: the schedule decides who is available and the
    engine admits a uniform C-of-available draw. A plane without a
    cache of its own (the baselines' plain plane) gets an unbounded
    one here."""

    def __init__(self, n_clients: int,
                 participation: Union[str, ParticipationSchedule, None] = None,
                 *, seed: int = 0,
                 exchange: Optional[ExchangePlane] = None,
                 cohort: Optional[int] = None):
        self.n_clients = n_clients
        self.schedule = parse_participation(participation)
        self.rng = np.random.default_rng(seed)
        if cohort is not None:
            cohort = int(cohort)
            if cohort < 1:
                raise ValueError(f"cohort must be >= 1, got {cohort}")
            if cohort > n_clients:
                raise ValueError(f"cohort ({cohort}) cannot exceed the "
                                 f"population ({n_clients} clients)")
        self.cohort = cohort
        self.exchange = ExchangePlane() if exchange is None else exchange
        self.ledger = self.exchange.ledger
        # The fusion cache lives on the plane when the plane carries one.
        self.cache = getattr(self.exchange, "cache", None)
        if self.cache is None:
            self.cache = FusionCache()
        self.round_idx = 0
        self.history: List[RoundReport] = []

    def participants(self) -> np.ndarray:
        """Sorted slot indices participating in the current round; under
        a cohort, a uniform C-of-available draw (``cohort=None`` draws
        nothing extra)."""
        mask = self.schedule.mask(self.round_idx, self.n_clients, self.rng)
        avail = np.flatnonzero(mask)
        if self.cohort is not None and len(avail) > self.cohort:
            avail = np.sort(self.rng.choice(avail, size=self.cohort,
                                            replace=False))
        return avail

    def sample(self, client, batch_size: int, device=None):
        """One private minibatch from ``client`` (.data_x/.data_y numpy,
        .num_samples), drawn as the reference draws it, as tensors on
        ``device`` (x fp32, y int32)."""
        idx = self.rng.integers(0, client.num_samples, size=batch_size)
        return (torch.from_numpy(client.data_x[idx]).to(device),
                torch.from_numpy(client.data_y[idx]).to(device))

    def aux_state(self) -> Dict[str, Any]:
        """JSON-able engine state for checkpoint resume: round counter,
        the numpy bit-generator state and the ledger totals, plus the
        exchange plane's host state under ``'exchange'`` (cache entry
        rounds and delta-mirror versions of the fusion plane). The
        cache's arrays ride in the trainer's snapshot tree."""
        aux = {
            "round_idx": self.round_idx,
            "rng": self.rng.bit_generator.state,
            "ledger": {"uplink": self.ledger.uplink,
                       "downlink": self.ledger.downlink},
        }
        ex = self.exchange.aux_state()
        if ex:
            aux["exchange"] = ex
        return aux

    def restore_aux(self, aux: Dict[str, Any]) -> None:
        self.round_idx = int(aux["round_idx"])
        self.rng.bit_generator.state = aux["rng"]
        self.ledger.uplink = int(aux["ledger"]["uplink"])
        self.ledger.downlink = int(aux["ledger"]["downlink"])
        if "exchange" in aux:
            self.exchange.restore_aux(aux["exchange"])
        # Clear the cache in place (the plane and the trainer hold it): an
        # in-place rewind may hold payloads uploaded after the snapshot
        # round, which the rewound counter would never expire. The
        # trainer refills it from its snapshot tree. History and per-round
        # ledger trails past the restored round go.
        self.cache._entries.clear()
        del self.history[self.round_idx:]
        del self.ledger.per_round[self.round_idx:]

    def end_round(self, metrics: Dict[str, Any]) -> RoundReport:
        """Close the ledger round, age expired cache entries (and, on a
        population plane, EF residuals and delta mirrors) out of memory,
        log metrics, advance the counter."""
        self.ledger.end_round()
        self.cache.prune(self.round_idx)
        self.exchange.prune(self.round_idx)
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


class AsyncRoundEngine(RoundEngine):
    """Event-driven scheduling: arrivals on client clocks, server ticks.

    One round == one server tick of ``tick`` simulated seconds. The
    participants are the clients with >= 1 arrival in ``(round_idx *
    tick, (round_idx + 1) * tick]``; several arrivals of one client
    coalesce into one upload (the raw count rides in the report's
    ``arrivals``), so a tick prices exactly like a sync round with K
    participants. Under ``cohort=C`` the C earliest distinct arrivals
    win the tick. Empty ticks are legal. The trace owns availability, so
    the schedule is pinned to ``full``."""

    def __init__(self, n_clients: int, trace: Union[str, ArrivalTrace],
                 *, tick: float = 1.0, seed: int = 0,
                 exchange: Optional[ExchangePlane] = None,
                 cohort: Optional[int] = None):
        super().__init__(n_clients, "full", seed=seed, exchange=exchange,
                         cohort=cohort)
        if not tick > 0:
            raise ValueError(f"tick must be > 0, got {tick}")
        self.trace = parse_trace(trace, n_clients)
        self.tick = float(tick)
        # The cursor draws its gaps from the engine's one stream,
        # interleaved with the minibatch draws.
        self.cursor = self.trace.cursor(n_clients, self.rng)
        self.total_uploads = 0
        self.total_arrivals = 0
        self._pending: Optional[Tuple[np.ndarray, int]] = None

    @property
    def sim_time(self) -> float:
        """Simulated seconds elapsed through the last closed tick."""
        return self.round_idx * self.tick

    def participants(self) -> np.ndarray:
        """Clients with >= 1 arrival in the current tick window,
        coalesced (idempotent until ``end_round`` advances the tick)."""
        if self._pending is None:
            t_end = (self.round_idx + 1) * self.tick
            events = self.cursor.pop_until(t_end, self.rng)
            if self.cohort is None:
                slots = sorted({s for _, s in events})
            else:
                # The C earliest distinct arrivals win; events come
                # (time, slot)-sorted, so first seen is first arrived.
                admitted: List[int] = []
                seen = set()
                for _, s in events:
                    if s not in seen:
                        seen.add(s)
                        admitted.append(s)
                slots = sorted(admitted[:self.cohort])
            self._pending = (np.asarray(slots, dtype=np.int64), len(events))
        return self._pending[0]

    def end_round(self, metrics: Dict[str, Any]) -> RoundReport:
        parts, arrivals = (self._pending if self._pending is not None
                           else (np.zeros(0, np.int64), 0))
        self._pending = None
        self.total_uploads += len(parts)
        self.total_arrivals += arrivals
        t_end = (self.round_idx + 1) * self.tick
        metrics = dict(metrics)
        metrics["sim_time"] = t_end
        metrics["arrivals"] = int(arrivals)
        metrics["uploads_per_sec"] = self.total_uploads / t_end
        return super().end_round(metrics)

    # The rng state rides in the base aux; the cursor and the throughput
    # counters ride here, so a resumed run replays the same arrivals.

    def aux_state(self) -> Dict[str, Any]:
        aux = super().aux_state()
        aux["async"] = {
            "cursor": self.cursor.state(),
            "uploads": int(self.total_uploads),
            "arrivals": int(self.total_arrivals),
        }
        return aux

    def restore_aux(self, aux: Dict[str, Any]) -> None:
        super().restore_aux(aux)
        a = aux["async"]
        self.cursor.restore(a["cursor"])
        self.total_uploads = int(a["uploads"])
        self.total_arrivals = int(a["arrivals"])
        self._pending = None


# ------------------------------------------------------ wall-clock models


def simulate_sync_wall_clock(
    trace: Union[str, ArrivalTrace], n_clients: int, rounds: int, *,
    participation: Union[str, ParticipationSchedule, None] = None,
    seed: int = 0,
) -> List[float]:
    """Per-round barrier durations of a synchronous run under ``trace``:
    round r starts when round r-1's slowest participant landed and
    closes at the max over this round's scheduled participants of each
    one's next arrival. Its own rng stream (seeded), so it never moves a
    training run's draws; once a barrier never closes (a replayed log
    that ends) every later round is ``inf``; a round with no participant
    costs 0."""
    trace = parse_trace(trace, n_clients)
    schedule = parse_participation(participation)
    rng = np.random.default_rng(seed)
    cursor = trace.cursor(n_clients, rng)
    t = 0.0
    durations: List[float] = []
    for r in range(rounds):
        parts = np.flatnonzero(schedule.mask(r, n_clients, rng))
        if len(parts) == 0:
            durations.append(0.0)
            continue
        landing = max(cursor.next_after(int(p), t, rng) for p in parts)
        if not math.isfinite(landing):
            # Every later round is stuck behind the unclosed barrier.
            durations.extend([math.inf] * (rounds - r))
            break
        durations.append(landing - t)
        t = landing
    return durations


def expected_async_participants(
    trace: Union[str, ArrivalTrace], n_clients: int, tick: float, *,
    ticks: int = 256, seed: int = 0,
) -> Tuple[float, float]:
    """(mean coalesced uploads, mean raw arrivals) a tick, by replaying
    the trace through the engine's tick coalescing."""
    rng = np.random.default_rng(seed)
    cursor = parse_trace(trace, n_clients).cursor(n_clients, rng)
    uploads = arrivals = 0
    for t in range(ticks):
        events = cursor.pop_until((t + 1) * tick, rng)
        uploads += len({s for _, s in events})
        arrivals += len(events)
    return uploads / max(ticks, 1), arrivals / max(ticks, 1)
