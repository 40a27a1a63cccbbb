"""Host-side population store: paged per-slot state behind fixed-shape
cohorts, and the lazy client fleet.

The port's copy of ``repro.core.population``. At population scale the
device must never see N: the eager trainer must not build N clients up
front, and a cohort-shaped trainer keeps its per-slot state on the host.

  PopulationStore   slot -> tree of CPU tensors with lazy deterministic
                    init; ``page_in`` stacks C slots into one
                    cohort-shaped tree on an explicit device,
                    ``page_out`` copies the cohort back into exactly the
                    slots named (the others are bitwise untouched), and
                    ``max_staleness`` ages slots out, so memory follows
                    the working set, not N.
  LazyFleet         a Sequence of clients, each built on first touch
                    (the eager trainer's population fleet).

``init_fn(slot)`` / ``build_fn(slot)`` must be pure functions of the slot,
so a slot that ages out and comes back is indistinguishable from a fresh
one. The eager trainer uses ``LazyFleet``; ``PopulationStore`` serves a
cohort-shaped trainer (ROADMAP.md queue 1, item 4b, the SPMD trainer).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.comm import tree_leaves

__all__ = ["PopulationStore", "LazyFleet"]


def _map(fn, *trees):
    """Map ``fn`` over the leaves of trees of dicts, lists and tuples."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _map(fn, *(u[k] for u in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _host(leaf) -> torch.Tensor:
    """A CPU tensor copy of a leaf (tensor on any device, or array)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return torch.from_numpy(np.array(leaf))


class PopulationStore:
    """Slot-indexed host store of per-slot trees with paged cohorts.

    ``init_fn(slot)`` materializes a slot's state on first access and
    after aging; it must be deterministic in ``slot``. Leaves are kept as
    CPU tensors, each a copy: paging a cohort out never pins the
    cohort-shaped device buffer."""

    def __init__(self, n_population: int, init_fn: Callable[[int], Any], *,
                 max_staleness: Optional[int] = None):
        if n_population < 1:
            raise ValueError(f"n_population must be >= 1, got {n_population}")
        if max_staleness is not None and max_staleness < 0:
            raise ValueError(f"max_staleness must be >= 0, got "
                             f"{max_staleness}")
        self.n_population = int(n_population)
        self.init_fn = init_fn
        self.max_staleness = max_staleness
        self._state: Dict[int, Any] = {}
        self._last_seen: Dict[int, int] = {}

    def __len__(self) -> int:
        return len(self._state)

    def __contains__(self, slot: int) -> bool:
        return int(slot) in self._state

    def slots(self) -> List[int]:
        """Sorted slot indices currently materialized."""
        return sorted(self._state)

    def get(self, slot: int) -> Any:
        """This slot's state, materialized on first access."""
        slot = self._check(slot)
        if slot not in self._state:
            self._state[slot] = _map(_host, self.init_fn(slot))
        return self._state[slot]

    def put(self, slot: int, state: Any,
            round_idx: Optional[int] = None) -> None:
        slot = self._check(slot)
        self._state[slot] = _map(_host, state)
        if round_idx is not None:
            self._last_seen[slot] = int(round_idx)

    def _check(self, slot: int) -> int:
        slot = int(slot)
        if not 0 <= slot < self.n_population:
            raise IndexError(f"slot {slot} out of range for a population "
                             f"of {self.n_population}")
        return slot

    # -- gather / scatter ------------------------------------------------

    def page_in(self, slots: Sequence[int], *, device=None) -> Any:
        """Gather: the slots' trees stacked into one tree with leading
        axis ``len(slots)`` (position i <- slots[i]) on ``device`` (the
        CPU by default). Repeated slots are legal (cohort padding)."""
        trees = [self.get(s) for s in slots]
        if not trees:
            raise ValueError("page_in needs at least one slot")
        return _map(lambda *xs: torch.stack(xs).to(device), *trees)

    def page_out(self, slots: Sequence[int], cohort_tree: Any,
                 round_idx: Optional[int] = None) -> None:
        """Scatter: cohort position i -> slots[i], for exactly
        ``len(slots)`` leading positions; trailing padding is dropped and
        slots not named are untouched. Each slot gets a copy."""
        for i, s in enumerate(slots):
            self.put(s, _map(lambda a, i=i: a[i], cohort_tree), round_idx)

    # -- aging -----------------------------------------------------------

    def touch(self, slot: int, round_idx: int) -> None:
        self._last_seen[self._check(slot)] = int(round_idx)

    def prune(self, round_idx: int) -> List[int]:
        """Evict slots not seen within ``max_staleness`` rounds and return
        them, sorted; they re-materialize through ``init_fn``. Slots never
        stamped with a round are kept."""
        if self.max_staleness is None:
            return []
        stale = [s for s, r in self._last_seen.items()
                 if round_idx - r > self.max_staleness]
        for s in stale:
            del self._last_seen[s]
            self._state.pop(s, None)
        return sorted(stale)

    # -- snapshot / restore ---------------------------------------------

    def snapshot_state(self):
        """Sparse host view for a checkpoint: ``({slot: tree}, {slot:
        last_seen_round})`` over exactly the materialized slots (the
        store's own tensors: serialize before mutating further)."""
        return ({s: self._state[s] for s in sorted(self._state)},
                dict(self._last_seen))

    def restore_state(self, state, last_seen) -> None:
        """Inverse of ``snapshot_state`` (slot keys may be strings, as
        JSON gives them back)."""
        self._state = {self._check(int(s)): _map(_host, t)
                       for s, t in state.items()}
        self._last_seen = {self._check(int(s)): int(r)
                           for s, r in last_seen.items()}

    def memory_bytes(self) -> int:
        """Bytes of every materialized leaf."""
        return sum(x.numel() * x.element_size()
                   for tree in self._state.values()
                   for x in tree_leaves(tree))


class LazyFleet(Sequence):
    """A client list built on first touch: ``len()`` is the whole
    population N, so every engine and plane sized off the fleet sees N,
    while only the slots a cohort draws ever pay model init.
    ``build_fn(slot)`` must be deterministic in the slot."""

    def __init__(self, n: int, build_fn: Callable[[int], Any]):
        if n < 1:
            raise ValueError(f"fleet size must be >= 1, got {n}")
        self._n = int(n)
        self._build = build_fn
        self._cache: Dict[int, Any] = {}

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, k):
        if isinstance(k, slice):
            return [self[i] for i in range(*k.indices(self._n))]
        k = int(k)
        if k < 0:
            k += self._n
        if not 0 <= k < self._n:
            raise IndexError(f"client {k} out of range for a fleet of "
                             f"{self._n}")
        if k not in self._cache:
            self._cache[k] = self._build(k)
        return self._cache[k]

    @property
    def materialized(self) -> List[int]:
        """Sorted slot indices built so far (the touched working set)."""
        return sorted(self._cache)
