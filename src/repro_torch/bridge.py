"""Carry the reference's parameter pytrees across to the port.

The JAX package draws its weights with ``jax.random``, which torch cannot
reproduce.  To run both sides on the same weights, a caller converts the
reference pytree to numpy (``jax.tree_util.tree_map(np.asarray, tree)``)
and hands it here.  Keys, shapes, layout and dtype are kept exactly, bf16
included, so the round trip is bit-exact.  This module never imports JAX.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.core.device import resolve_device

Device = Optional[Union[str, torch.device]]


def tensor_from_numpy(arr: np.ndarray, device: Device = None
                      ) -> torch.Tensor:
    """One array, bit for bit.  numpy has no native bfloat16: JAX hands out
    ``ml_dtypes.bfloat16`` arrays, which are reinterpreted through their
    16-bit pattern."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(resolve_device(device))


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Inverse of :func:`tensor_from_numpy` (bf16 comes back as
    ``ml_dtypes.bfloat16``, imported only then)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _convert(tree: Any, device: Device) -> Any:
    """Dicts, lists and tuples keep their type (the hybrid family's
    ``params["layers"]`` is a list of per-layer dicts); leaves become
    tensors."""
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_convert(v, device) for v in tree)
    return tensor_from_numpy(np.asarray(tree), device)


def params_from_jax(tree: Dict[str, Any], device: Device = None
                    ) -> Dict[str, Any]:
    """Model parameters (``tfm.init_params``'s or ``hybrid.init_params``'s
    pytree as numpy arrays) -> torch tensors with the same keys, layout and
    dtype."""
    return _convert(tree, device)


def lora_from_jax(tree: Dict[str, Any], device: Device = None
                  ) -> Dict[str, Any]:
    """LoRA stacks (``tfm.init_lora_stacks``'s pytree as numpy arrays) ->
    torch tensors with the same keys, layout and dtype."""
    return _convert(tree, device)
