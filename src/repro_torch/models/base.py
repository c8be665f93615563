"""Model utilities shared by the port's serving model (port of
``repro/models/base.py``)."""
from __future__ import annotations

from typing import Any, Dict, Sequence

import torch

Params = Dict[str, Any]


def dense_init(gen: torch.Generator, shape: Sequence[int], dtype,
               scale: float = 0.02) -> torch.Tensor:
    """Normal(0, scale) weights drawn in f32 on the generator's device."""
    return (torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                        device=gen.device) * scale).to(dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32, scaling by ``(1 + w)`` like the reference."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + w.to(torch.float32))
            ).to(x.dtype)
