"""Structured per-round reports — the Trainer protocol's return type.

Every trainer's ``run_round`` returns a :class:`RoundReport` instead of
an ad-hoc dict: the cross-scheme fields every consumer needs (round
index, cumulative ledger bytes on both legs, who participated) are
typed attributes, while scheme-specific metrics (``base_loss`` /
``mod_loss`` for IFL, ``loss`` for FL/FSL, cache occupancy, ...) ride in
``metrics``.

``RoundReport`` is also a read-only :class:`~collections.abc.Mapping`
over the union of both, so every pre-existing consumer of the old dicts
(``report["base_loss"]``, ``report["participants"]``) keeps working
unchanged — the mapping view is exactly what ``to_dict()`` serializes.

The port's copy of ``repro.core.report``, unchanged in behaviour.
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List


@dataclass
class RoundReport(Mapping):
    """One communication round, as every scheme reports it.

    ``uplink_mb`` / ``downlink_mb`` are the *cumulative* ledger totals
    after this round (the paper's Fig.-2 x-axis is cumulative MB), so a
    round's own cost is the delta between consecutive reports — or
    ``CommLedger.per_round`` for the exact byte split.
    """

    round: int
    uplink_mb: float
    downlink_mb: float
    participants: List[int] = field(default_factory=list)
    metrics: Dict[str, Any] = field(default_factory=dict)

    _FIELDS = ("round", "uplink_mb", "downlink_mb", "participants")

    # -- Mapping view over fields + metrics (back-compat with the dicts
    # -- the trainers used to return) ----------------------------------

    def __getitem__(self, key: str) -> Any:
        if key in self._FIELDS:
            return getattr(self, key)
        return self.metrics[key]

    def __iter__(self) -> Iterator[str]:
        yield from self._FIELDS
        for k in self.metrics:
            if k not in self._FIELDS:
                yield k

    def __len__(self) -> int:
        return len(list(iter(self)))

    # -- serialization -------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        """Plain JSON-able dict (the Mapping view, materialized)."""
        return {k: self[k] for k in self}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RoundReport":
        d = dict(d)
        return cls(
            round=int(d.pop("round", -1)),
            uplink_mb=float(d.pop("uplink_mb", 0.0)),
            downlink_mb=float(d.pop("downlink_mb", 0.0)),
            participants=[int(k) for k in d.pop("participants", [])],
            metrics=d,
        )
