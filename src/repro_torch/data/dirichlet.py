"""Dirichlet non-IID label-skew partitioner (paper §IV, α = 0.5).

The port's own copy of ``repro.data.dirichlet``: numpy only, and it
makes the same draws from the same seeds.
"""

from __future__ import annotations

from typing import List

import numpy as np


def dirichlet_partition(
    labels: np.ndarray,
    n_clients: int,
    alpha: float = 0.5,
    seed: int = 0,
    min_per_client: int = 16,
) -> List[np.ndarray]:
    """Split sample indices across clients with per-class Dirichlet(α)
    proportions. Small α => highly skewed shards. Returns index arrays."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    shards: List[List[int]] = [[] for _ in range(n_clients)]
    for c in range(n_classes):
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet(np.full(n_clients, alpha))
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for k, part in enumerate(np.split(idx, cuts)):
            shards[k].extend(part.tolist())
    out = []
    for k in range(n_clients):
        if len(shards[k]) < min_per_client:  # top up from the global pool
            extra = rng.integers(0, len(labels), min_per_client)
            shards[k].extend(extra.tolist())
        arr = np.array(shards[k])
        rng.shuffle(arr)
        out.append(arr)
    return out
