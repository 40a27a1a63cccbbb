"""Synthetic LM token stream (numpy), the port's copy of the JAX
package's ``SyntheticLM``: the same seed gives the same tokens in both
packages, which is how the serving demo makes its prompts.

Deterministic Zipfian n-gram stream with latent per-client "dialects":
a latent Markov chain with per-state Zipf-like emissions. Streams are
reproducible from (seed, client, step).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SyntheticLM:
    vocab_size: int
    seed: int = 0
    n_latent: int = 64  # latent markov states

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        V, L = self.vocab_size, self.n_latent
        # latent chain + per-state zipf-ish emissions
        self.trans = rng.dirichlet(np.full(L, 0.3), size=L).astype(np.float32)
        ranks = np.arange(1, V + 1)
        zipf = (1.0 / ranks**1.1).astype(np.float32)
        emis = []
        for s in range(L):
            perm = np.random.default_rng(self.seed + 7 * s).permutation(V)
            emis.append(zipf[np.argsort(perm)])
        self.emis = np.stack(emis)
        self.emis /= self.emis.sum(-1, keepdims=True)

    def sample(self, batch: int, seq: int, *, step: int,
               client: int = 0) -> np.ndarray:
        """(batch, seq) int32, deterministic in (seed, client, step)."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + client * 9176 + step) % (2**63)
        )
        L = self.trans.shape[0]
        # client dialect: biased initial latent distribution
        init = np.zeros(L, np.float32)
        init[(client * 13) % L] = 0.7
        init += 0.3 / L
        init /= init.sum()
        out = np.empty((batch, seq), np.int64)
        state = rng.choice(L, size=batch, p=init)
        for t in range(seq):
            # vectorized: sample emission then next latent
            u = rng.random(batch)
            cdf = np.cumsum(self.emis[state], axis=1)
            out[:, t] = (u[:, None] < cdf).argmax(1)
            un = rng.random(batch)
            cdfn = np.cumsum(self.trans[state], axis=1)
            state = (un[:, None] < cdfn).argmax(1)
        return out.astype(np.int32)
