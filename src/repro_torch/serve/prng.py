"""The JAX package's PRNG key chain as torch integer ops: threefry2x32,
``split``, ``random_bits``, ``uniform``, ``gumbel`` and ``categorical``,
bit for bit those of ``jax.random`` under its default threefry2x32
implementation with ``jax_threefry_partitionable`` on:

* ``split(key, n)`` is threefry2x32 of the key over the counters
  0..n-1, each counter a 64-bit index split into (hi, lo) words; new
  key i is (x0[i], x1[i]).
* ``random_bits(key, shape)`` is ``x0 ^ x1`` of the same hash over the
  flat index of each element of ``shape``.
* ``uniform`` keeps the top 23 bits as a float in [1, 2) (``bits >> 9 |
  0x3F800000``, reinterpreted), subtracts 1, scales to [minval, maxval)
  with one rounding (XLA fuses the multiply and add) and clamps below at
  minval, in fp32.
* ``gumbel`` is ``-log(-log(u))`` of ``uniform`` on [tiny, 1) (JAX's
  mode "low"), and ``categorical`` the first index of the largest
  ``gumbel + logits``.

The integer steps are exact on any device. ``log`` is the one inexact
step: XLA's and torch's may differ in the last bit, so a token drawn
here differs from JAX's only where two candidates' ``gumbel + logits``
lie within an ulp.

Keys are ``(..., 2)`` int64 tensors holding uint32 words: uint32
arithmetic runs on int64 under ``& 0xFFFFFFFF``, since torch's uint32
lacks shifts and adds on CUDA. A key with leading dims is a batch of
keys, each drawing its own ``shape`` (``random_bits(keys (W, 2), (V,))
-> (W, V)``): one set of elementwise launches for a whole lane.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

__all__ = ["categorical", "gumbel", "prng_key", "random_bits", "split",
           "threefry2x32", "uniform"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# The smallest normal fp32 (jnp.finfo(float32).tiny), gumbel's minval.
_TINY = torch.finfo(torch.float32).tiny


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a seed in int32's range, as JAX
    makes it without 64-bit mode: the words (0, seed & 0xFFFFFFFF)."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.long,
                        device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(key: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) of the counter words (x0, x1), both of
    one shape, under every key of ``key`` (..., 2): int64 tensors
    holding uint32 values. -> (y0, y1), each (..., *x0.shape)."""
    lead = key.shape[:-1] + (1,) * x0.dim()
    k0, k1 = key[..., 0].reshape(lead), key[..., 1].reshape(lead)
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def _counters(key: torch.Tensor, shape: Sequence[int]):
    """The (hi, lo) words of the flat index over ``shape``."""
    n = 1
    for s in shape:
        n *= int(s)
    idx = torch.arange(n, dtype=torch.long, device=key.device)
    return ((idx >> 32).reshape(tuple(shape)),
            (idx & _MASK).reshape(tuple(shape)))


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split``: (..., 2) -> (..., n, 2)."""
    hi, lo = _counters(key, (n,))
    y0, y1 = threefry2x32(key, hi, lo)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32 words as int64):
    (..., 2) -> (..., *shape)."""
    hi, lo = _counters(key, shape)
    y0, y1 = threefry2x32(key, hi, lo)
    return y0 ^ y1


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in fp32: (..., 2) -> (..., *shape)."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32)
    span = (torch.tensor(maxval, dtype=torch.float32) - lo).item()
    # floats * span + lo rounded once, as XLA's fused multiply-add does:
    # the product of two fp32 values is exact in fp64.
    out = (floats.double() * span + lo.item()).float()
    return torch.clamp_min(out, lo.item())


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low") in fp32."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last dim, fp32
    logits. A (2,) key draws one gumbel array of the logits' shape; a
    batch of keys (K..., 2) draws row by row, each key over the trailing
    dims of ``logits`` (K..., *rest). -> the first index of the largest
    ``gumbel + logits``."""
    g = gumbel(key, logits.shape[key.dim() - 1:])
    return torch.argmax(g + logits, dim=-1)
