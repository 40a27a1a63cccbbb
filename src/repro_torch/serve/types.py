"""Request/response types of the serving plane (the port's copy of the
JAX package's, field for field).

A request names a *tenant* — the unit of personalization: the engine
routes it to that tenant's trained base block composed with the shared
modular block of the tenant's (base_arch, modular_arch) pair, and
continuously batches it with other in-flight requests of the same pair.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence

__all__ = ["Request", "Completion"]


@dataclass(frozen=True)
class Request:
    """One generation request against a tenant's composed model.

    ``arrival`` is the engine tick (the step-count clock) at which the
    request becomes admissible — the simulation analogue of a wall-clock
    arrival time, so staggered traffic is deterministic and testable.
    ``eos_id`` < 0 disables EOS eviction (run to ``max_new_tokens``).

    Sampling: ``temperature == 0`` (the default) is greedy argmax;
    ``temperature > 0`` samples from the logits over the ``top_k``
    largest (0 = the full vocab) divided by the temperature, on a PRNG
    key chain derived from (``seed``, ``rid``), the JAX package's own.
    """

    rid: int
    tenant: str
    prompt: Sequence[int]
    max_new_tokens: int = 16
    arrival: int = 0
    eos_id: int = -1
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0

    def __post_init__(self):
        if len(self.prompt) < 1:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"request {self.rid}: max_new_tokens must be >= 1"
            )
        if self.temperature < 0:
            raise ValueError(
                f"request {self.rid}: temperature must be >= 0"
            )
        if self.top_k < 0:
            raise ValueError(f"request {self.rid}: top_k must be >= 0")


@dataclass
class Completion:
    """A finished request: the generated continuation + timing marks.

    ``tokens`` are the NEW tokens only (no prompt echo).  All *_tick
    fields are engine step-clock stamps; the benchmark harness converts
    them to wall time by timing each tick.
    """

    rid: int
    tenant: str
    tokens: List[int] = field(default_factory=list)
    finish_reason: str = "length"  # 'length' | 'eos'
    prompt_len: int = 0
    arrival: int = 0
    admitted_tick: int = -1
    finished_tick: int = -1
    # Tick stamp of every emitted token (first one = prefill tick).
    token_ticks: List[int] = field(default_factory=list)
