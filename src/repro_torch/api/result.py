"""`RunResult` — the structured outcome of `run_experiment`.

The port's copy of ``repro.api.result``: the spec that produced it, the
eval-cadence ``records`` (round, cumulative uplink/total MB, accuracies,
the composition matrix for IFL), the per-round ``reports`` (serialized
:class:`~repro_torch.core.report.RoundReport`) and the final ledger
totals, and the device type the run took. JSON round-trips losslessly;
``to_dict`` is also the cache file format, self-describing through the
embedded spec, package and device.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.api.spec import ExperimentSpec

__all__ = ["RunResult", "PACKAGE"]

PACKAGE = "repro_torch"  # names this package's results in the cache


@dataclass
class RunResult:
    spec: ExperimentSpec
    records: List[Dict[str, Any]] = field(default_factory=list)
    reports: List[Dict[str, Any]] = field(default_factory=list)
    uplink_mb: float = 0.0
    downlink_mb: float = 0.0
    device: Optional[str] = None  # "cuda" / "cpu": where the run took place
    package: Optional[str] = PACKAGE  # which package wrote the result
    # Set by run_experiment(keep_trainer=True); never serialized.
    trainer: Optional[Any] = None

    def to_dict(self) -> Dict[str, Any]:
        """JSON-able dict, with the reference's legacy top-level keys
        (scheme, rounds, tau, codec, participation) and the port's
        ``package`` and ``device``."""
        return {
            "scheme": self.spec.scheme,
            "rounds": self.spec.rounds,
            "tau": self.spec.tau,
            "codec": self.spec.codec,
            "participation": self.spec.participation,
            "spec": self.spec.to_dict(),
            "spec_hash": self.spec.spec_hash(),
            "records": self.records,
            "reports": self.reports,
            "uplink_mb": self.uplink_mb,
            "downlink_mb": self.downlink_mb,
            "package": self.package,
            "device": self.device,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RunResult":
        """Rebuild from ``to_dict()`` output (a dict with no ``package``
        was not written by this package)."""
        return cls(
            spec=ExperimentSpec.from_dict(d["spec"]),
            records=list(d.get("records", [])),
            reports=list(d.get("reports", [])),
            uplink_mb=float(d.get("uplink_mb", 0.0)),
            downlink_mb=float(d.get("downlink_mb", 0.0)),
            device=d.get("device"),
            package=d.get("package"),
        )

    def to_json(self, path: Optional[str] = None, *, indent: int = 1) -> str:
        s = json.dumps(self.to_dict(), indent=indent)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s

    @classmethod
    def from_json(cls, src: str) -> "RunResult":
        """``src`` is a path or a JSON string (which embeds its spec)."""
        if src.lstrip().startswith("{"):
            return cls.from_dict(json.loads(src))
        with open(src) as f:
            return cls.from_dict(json.load(f))

    @property
    def final(self) -> Dict[str, Any]:
        """Last eval record (the end-of-training numbers)."""
        return self.records[-1] if self.records else {}
