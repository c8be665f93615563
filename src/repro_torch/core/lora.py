"""LoRA runtime math: parameter containers, initialization and batched
application (port of ``repro/core/lora.py``).

The serving engine hosts many adapters on one base model (multi-LoRA).  For
a batch whose rows may target *different* adapters every adapter of the
registry lives in one stacked tensor and each row gathers its adapter id
(Punica's BGMV as a gather and an einsum).  Pure math: the model zoo folds
the same products into its layers (``models/transformer._bgmv``).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch


class LoRAWeights(NamedTuple):
    """One adapter for one linear projection: ``y = x @ A @ B * scaling``."""

    a: torch.Tensor   # (d_in, r)
    b: torch.Tensor   # (r, d_out)
    scaling: float


def init_lora(gen: torch.Generator, d_in: int, d_out: int, rank: int,
              alpha: float = 32.0, dtype=torch.bfloat16) -> LoRAWeights:
    """Kaiming-init A, zero-init B (standard LoRA init), on the
    generator's device."""
    a = torch.randn((d_in, rank), generator=gen, dtype=torch.float32,
                    device=gen.device) / math.sqrt(d_in)
    b = torch.zeros((rank, d_out), dtype=torch.float32, device=gen.device)
    return LoRAWeights(a.to(dtype), b.to(dtype), alpha / rank)


def init_lora_nonzero(gen: torch.Generator, d_in: int, d_out: int,
                      rank: int, alpha: float = 32.0, dtype=torch.bfloat16,
                      scale: float = 0.05) -> LoRAWeights:
    """Non-degenerate init used by tests/benchmarks so adapters actually
    perturb activations (zero-init B makes ForkKV trivially exact)."""
    a = torch.randn((d_in, rank), generator=gen, dtype=torch.float32,
                    device=gen.device) / math.sqrt(d_in)
    b = torch.randn((rank, d_out), generator=gen, dtype=torch.float32,
                    device=gen.device) * scale / math.sqrt(rank)
    return LoRAWeights(a.to(dtype), b.to(dtype), alpha / rank)


def lora_apply(x: torch.Tensor, w: LoRAWeights) -> torch.Tensor:
    """Full LoRA offset ``(x @ A) @ B * scaling``."""
    return (x @ w.a @ w.b) * w.scaling


def lora_down(x: torch.Tensor, w: LoRAWeights) -> torch.Tensor:
    """Down-projection only, the rCache entry ``x @ A`` (paper §5.1), with
    ``scaling`` folded in so reconstruction is a plain ``rCache @ B``."""
    return (x @ w.a) * w.scaling


def lora_up(r: torch.Tensor, w: LoRAWeights) -> torch.Tensor:
    """Up-projection of a stored residual: ``rCache @ B``."""
    return r @ w.b


class AdapterStack(NamedTuple):
    """All adapters of a registry stacked for batched multi-LoRA execution."""

    a: torch.Tensor        # (n_adapters, d_in, r)
    b: torch.Tensor        # (n_adapters, r, d_out)
    scaling: torch.Tensor  # (n_adapters,) f32


def stack_adapters(adapters: Dict[int, LoRAWeights]) -> AdapterStack:
    ids = sorted(adapters)
    if ids != list(range(len(ids))):
        raise ValueError("adapter ids must be dense 0..n-1")
    a = torch.stack([adapters[i].a for i in ids])
    b = torch.stack([adapters[i].b for i in ids])
    s = torch.tensor([adapters[i].scaling for i in ids], dtype=torch.float32,
                     device=a.device)
    return AdapterStack(a, b, s)


def bgmv_down(x: torch.Tensor, stack: AdapterStack,
              adapter_ids: torch.Tensor) -> torch.Tensor:
    """Batched multi-adapter down-projection.  x: (batch, seq, d_in);
    adapter_ids: (batch,).  Returns (batch, seq, r) residuals with per-row
    adapters (scaling folded)."""
    a = stack.a[adapter_ids]                       # (batch, d_in, r)
    s = stack.scaling[adapter_ids]                 # (batch,)
    r = torch.einsum("bsd,bdr->bsr", x, a.to(x.dtype))
    return r * s[:, None, None].to(x.dtype)


def bgmv_up(r: torch.Tensor, stack: AdapterStack,
            adapter_ids: torch.Tensor) -> torch.Tensor:
    """Batched multi-adapter up-projection.  r: (batch, seq, rank) ->
    (batch, seq, d_out)."""
    b = stack.b[adapter_ids]                       # (batch, r, d_out)
    return torch.einsum("bsr,brd->bsd", r, b.to(r.dtype))
