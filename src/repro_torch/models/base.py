"""Model utilities shared by the port's serving model (port of
``repro/models/base.py``)."""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

Params = Dict[str, Any]


class ShapesOnly:
    """The generator of a tree on the ``meta`` device, which torch has no
    generator for: a draw there has a shape and no values (the dry run's
    abstract state, :mod:`repro_torch.launch.steps`)."""

    device = torch.device("meta")


def generator(seed: int, device: torch.device):
    """A ``torch.Generator`` on ``device`` seeded with ``seed``;
    :class:`ShapesOnly` on the meta device."""
    if device.type == "meta":
        return ShapesOnly()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def randn(gen, shape: Sequence[int]) -> torch.Tensor:
    """Standard normal f32 draws of ``shape`` from ``gen`` on its device
    (:func:`generator`)."""
    return torch.randn(tuple(shape), dtype=torch.float32, device=gen.device,
                       generator=None if isinstance(gen, ShapesOnly)
                       else gen)


def dense_init(gen: torch.Generator, shape: Sequence[int], dtype,
               scale: float = 0.02) -> torch.Tensor:
    """Normal(0, scale) weights drawn in f32 on the generator's device."""
    return (randn(gen, shape) * scale).to(dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32, scaling by ``(1 + w)`` like the reference."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + w.to(torch.float32))
            ).to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm in f32 (biased variance), as the reference computes it."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.to(torch.float32) + b.to(torch.float32)).to(x.dtype)


def activation(name: str):
    """``silu`` or ``gelu`` (the tanh approximation, ``jax.nn.gelu``'s
    default)."""
    return {"silu": torch.nn.functional.silu,
            "gelu": lambda x: torch.nn.functional.gelu(
                x, approximate="tanh")}[name]


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict/list tree, in the order the reference's
    ``jax.tree_util.tree_leaves`` gives them (dict keys sorted)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in leaves(x)]
    return []


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the tensors of nested dicts/lists/tuples (a NamedTuple
    stays one), with the matching leaves of ``rest``; other leaves are
    passed to ``fn`` too (the reference's ``jax.tree_util.tree_map``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def count_params(params: Params) -> int:
    return sum(int(p.numel()) for p in leaves(params))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross entropy in f32 over the vocabulary.  logits:
    (B, S, V), labels: (B, S); with ``mask`` (B, S) the mean over the
    masked-in tokens."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    if isinstance(logits, DTensor):
        # vocab-sharded logits: each shard picks its own gold logits (a
        # sum with one nonzero term, so exact), summed across shards
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        gold = torch.where(vocab == labels[..., None], logits,
                           0.0).sum(-1)
    else:
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.to(torch.float32)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def remat(fn: Callable, *args, on: bool):
    """``fn(*args)``, under ``torch.utils.checkpoint`` (non-reentrant) when
    ``on`` and grad mode is on: where the reference wraps the same unit in
    ``jax.checkpoint``, its activations are recomputed in the backward pass
    instead of kept.  Outside training (no grad) it is a plain call."""
    if on and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)
