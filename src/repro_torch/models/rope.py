"""Rotary position embeddings: standard RoPE (HF 'neox' half-split
layout) and Qwen2-VL's multimodal M-RoPE with its default position grid
over the leading image tokens."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), fp32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotate pairs laid out as [x1 | x2] halves."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (B, S, H, hd); positions: (B, S) int, one position per row.

    cos/sin are computed in fp32 and cast to ``x.dtype`` *before* the
    rotation, as the JAX package does.
    """
    inv = rope_freqs(x.shape[-1], theta, device=x.device)  # (hd/2,)
    ang = positions[..., None].float() * inv  # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    return _rotate(x, cos, sin)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, ...]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE [arXiv:2409.12191]. x: (B, S, H, hd);
    positions: (3, B, S) int, the (temporal, height, width) ids.
    ``sections`` splits the hd/2 frequency bands among the three axes in
    order; text tokens carry one id on all three axes, where M-RoPE is
    1-D RoPE. cos/sin in fp32, cast to ``x.dtype`` before the rotation,
    as ``apply_rope``."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to "
                         f"head_dim / 2 = {half}")
    inv = rope_freqs(x.shape[-1], theta, device=x.device)  # (half,)
    ang_all = positions[..., None].float() * inv  # (3, B, S, half)
    owner = torch.repeat_interleave(
        torch.arange(len(sections), device=x.device),
        torch.tensor(sections, device=x.device),
        output_size=half)  # (half,) axis a band reads
    ang = torch.gather(ang_all, 0,
                       owner.expand(1, *ang_all.shape[1:]))[0]  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    return _rotate(x, cos, sin)


def default_mrope_positions(batch: int, seq: int, num_image_tokens: int,
                            image_hw: Optional[Tuple[int, int]] = None,
                            device=None) -> torch.Tensor:
    """(3, B, S) int64 position ids: a 2-D (h, w) grid over the leading
    image tokens (temporal id 0), then text ids on all three axes
    starting at max(h, w). Without ``image_hw`` the grid is h x (n / h)
    for the largest h <= sqrt(n) that divides n, as the reference
    chooses it."""
    if num_image_tokens == 0:
        p = torch.arange(seq, device=device)[None].expand(batch, seq)
        return torch.stack([p, p, p])
    if image_hw is None:
        h = max(1, int(num_image_tokens ** 0.5))
        while num_image_tokens % h:
            h -= 1
        image_hw = (h, num_image_tokens // h)
    h, w = image_hw
    grid_h = torch.arange(h, device=device).repeat_interleave(w)
    grid_w = torch.arange(w, device=device).repeat(h)
    t_img = torch.zeros(num_image_tokens, dtype=torch.long, device=device)
    text = max(h, w) + torch.arange(seq - num_image_tokens, device=device)
    pos = torch.stack([torch.cat([t_img, text]), torch.cat([grid_h, text]),
                       torch.cat([grid_w, text])])
    return pos[:, None, :].expand(3, batch, seq)
