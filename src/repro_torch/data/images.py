"""Synthetic KMNIST stand-in (the container is offline).

Deterministic class-conditional generator with the same cardinality as
Kuzushiji-MNIST (28x28 grayscale, 10 classes, 50k train / 10k test).
Each class is a mixture of 3 prototype "strokes" (random low-frequency
fields, fixed per class) plus per-sample elastic jitter and noise, so:
  - classes are separable but NOT linearly trivial (a linear probe gets
    ~70-80%, CNN/MLPs in Table II reach the 90%+ regime like the paper),
  - per-class distributions are unimodal enough for Dirichlet non-IID
    splits to actually skew difficulty, as in the paper's setup.

The port's own copy of ``repro.data.images``: numpy only, and it
makes the same draws from the same seeds.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _prototypes(rng: np.random.Generator, n_classes: int, n_proto: int = 3):
    """Low-frequency class prototypes, (C, P, 28, 28)."""
    freqs = rng.normal(size=(n_classes, n_proto, 4, 4))
    protos = np.zeros((n_classes, n_proto, 28, 28), np.float32)
    xs = np.linspace(0, 1, 28)
    gx, gy = np.meshgrid(xs, xs, indexing="ij")
    for c in range(n_classes):
        for p in range(n_proto):
            field = np.zeros((28, 28))
            for i in range(4):
                for j in range(4):
                    field += freqs[c, p, i, j] * np.sin(
                        np.pi * (i + 1) * gx + 1.3 * c
                    ) * np.cos(np.pi * (j + 1) * gy + 0.7 * p)
            field = (field - field.min()) / (np.ptp(field) + 1e-6)
            protos[c, p] = field
    return protos


def make_synth_kmnist(
    n_train: int = 50_000,
    n_test: int = 10_000,
    n_classes: int = 10,
    seed: int = 1871,  # Kuzushiji-era
    noise: float = 0.25,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (train_x, train_y, test_x, test_y); x: (N, 28, 28, 1) fp32."""
    rng = np.random.default_rng(seed)
    protos = _prototypes(rng, n_classes)

    def gen(n, rng):
        y = rng.integers(0, n_classes, size=n)
        mix = rng.dirichlet(np.ones(protos.shape[1]) * 0.7, size=n)
        base = np.einsum("np,nphw->nhw", mix, protos[y]).astype(np.float32)
        # per-sample global shift jitter (cheap elastic proxy)
        sx = rng.integers(-2, 3, size=n)
        sy = rng.integers(-2, 3, size=n)
        out = np.empty_like(base)
        for i in range(n):
            out[i] = np.roll(np.roll(base[i], sx[i], 0), sy[i], 1)
        out += rng.normal(scale=noise, size=out.shape).astype(np.float32)
        out = np.clip(out, 0.0, 1.5)
        return out[..., None], y.astype(np.int32)

    train_x, train_y = gen(n_train, rng)
    test_x, test_y = gen(n_test, rng)
    return train_x, train_y, test_x, test_y
