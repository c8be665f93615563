"""Rotary position embeddings (split-half convention), port of
``repro/core/rope.py``.

ForkKV stores the base Key cache with RoPE already applied and the residual
cache *without* RoPE; RoPE is a per-position linear map, so applying it to
the up-projected residual at reconstruction time is exact.
"""
from __future__ import annotations

import torch


def rope_sincos(positions: torch.Tensor, head_dim: int,
                theta: float = 10_000.0, dtype=torch.float32):
    """Return (sin, cos) tables of shape positions.shape + (head_dim//2,)."""
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32,
                            device=positions.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=positions.device), exponent)
    angles = positions.to(torch.float32)[..., None] * freqs
    return torch.sin(angles).to(dtype), torch.cos(angles).to(dtype)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` (..., seq, heads, head_dim) by per-position (sin, cos)
    of shape (..., seq, head_dim//2), broadcast over the heads axis."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    sin = sin[..., None, :]
    cos = cos[..., None, :]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)
