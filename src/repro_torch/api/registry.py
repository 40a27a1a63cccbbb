"""Scheme registry — collaborative-learning schemes as pluggable entries.

The port's copy of ``repro.api.registry``: FL-1/FL-2, FSL, IFL and the
SPMD IFL adapter are looked up by name, so a new scheme is one
``@register_scheme("name")`` away from ``run_experiment`` and the
quickstart.

A *builder* is a callable ``(spec, data, **kw) -> Trainer``: it receives
the :class:`~repro_torch.api.spec.ExperimentSpec`, the loaded
:class:`~repro_torch.api.schemes.DataBundle` and the port's keywords,
``device=`` (where the trainer runs: the card unless ``'cpu'``) and
``params=`` (per-slot initial parameters as numpy trees, e.g. the JAX
package's init), and returns an object satisfying the
:class:`~repro_torch.api.trainer.Trainer` protocol.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

__all__ = [
    "SchemeEntry",
    "register_scheme",
    "get_scheme",
    "available_schemes",
    "SCHEMES",
]


@dataclass(frozen=True)
class SchemeEntry:
    """One registered scheme: its name, builder, and one-line summary."""

    name: str
    builder: Callable  # (ExperimentSpec, DataBundle, **kw) -> Trainer
    summary: str = ""

    def build(self, spec, data, **kw):
        return self.builder(spec, data, **kw)


SCHEMES: Dict[str, SchemeEntry] = {}


def register_scheme(name: str, *, summary: str = ""):
    """Decorator: ``@register_scheme("ifl")`` over a builder callable."""

    def deco(builder):
        SCHEMES[name] = SchemeEntry(name, builder, summary)
        return builder

    return deco


def available_schemes() -> Tuple[str, ...]:
    return tuple(sorted(SCHEMES))


def get_scheme(name: str) -> SchemeEntry:
    """Resolve a scheme name; an unknown name lists what is registered."""
    try:
        return SCHEMES[name]
    except KeyError:
        raise ValueError(
            f"unknown scheme {name!r}; available: "
            f"{', '.join(available_schemes()) or '(none registered)'}"
        ) from None
