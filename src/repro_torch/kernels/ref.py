"""Plain PyTorch versions of the port's kernels (the ground truth the
kernels are held against, and what the wrappers run on CPU tensors)."""

from __future__ import annotations

import math
from typing import Optional

import torch

# The mask value of the TPU kernel (kernels/flash_attention.py:25).
NEG = -1e30


def cached_attn_decode_ref(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, valid: torch.Tensor,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Single-token attention against a KV cache, the plain version of
    the ``flash_decode`` kernel.

    q: (B, 1, KVH, G, hd) grouped query (G = H / KVH); k, v: (B, L, KVH,
    hd) cache in the model's layout; valid: (B, L) bool, which cache rows
    are live for each batch row (causality and the ring-buffer window
    already folded in). Returns (B, 1, KVH, G, hd) in ``q.dtype``.

    Scores, probabilities and the weighted sum are fp32, and the sum is
    divided by the softmax denominator at the end, as the kernel does. A
    fully masked row gives **zeros**, as the TPU kernel
    ``flash_decode_pallas`` flushes them; the JAX package's jnp oracle
    returns the mean of v there instead. On the serving path such rows
    occur only in unoccupied or not-yet-admitted slots (every
    ``slot_pos`` still -1), whose outputs are discarded; an occupied
    slot always has its just-written row valid.
    """
    hd = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float()) * scale
    mask = valid[:, None, None, None, :]
    s = torch.where(mask, s, NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * mask
    denom = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgqs,bskh->bkgqh", p, v.float())
    out = acc / denom.clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


def wire_encode_ref(z: torch.Tensor, codec) -> dict:
    """The plain version of the ``wire_encode`` kernel: the codec's own
    encode ops (``repro_torch.core.codec``), whose order of operations,
    top-k tie order and sketch sum order the kernel reproduces."""
    return codec.encode(z)


def wire_encode_ef_ref(z: torch.Tensor, e: torch.Tensor, ef_codec):
    """The plain version of the ``wire_encode_ef`` kernel: the EF codec's
    ``encode_with_state`` -> (payload, e')."""
    return ef_codec.encode_with_state(z, e)
