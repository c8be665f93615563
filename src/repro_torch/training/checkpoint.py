"""Checkpoints of trees of tensors (port of
``repro/training/checkpoint.py``).

``save`` writes ``<dir>/<name>.npz`` with one array per leaf under the
reference's key paths: dict keys and list indices joined by ``"/"`` (a
NamedTuple's field as ``.field``, as ``jax.tree_util`` names it).  bf16
leaves are stored as the reference stores them: ``np.asarray`` of a bf16
JAX array is an ``ml_dtypes`` bfloat16 array, which ``np.savez`` writes as
2-byte void (``<V2``) holding the 16-bit patterns.  The port writes and
reads those patterns through int16, without ``ml_dtypes``, so a file the
JAX package wrote restores into the port's tree and back.
"""
from __future__ import annotations

import os
from typing import Dict, Iterator, Tuple

import numpy as np
import torch


def _paths(tree, prefix: Tuple[str, ...] = ()
           ) -> Iterator[Tuple[str, torch.Tensor]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f, v in zip(tree._fields, tree):
            yield from _paths(v, prefix + (f".{f}",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _from_numpy(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bfloat16:
        if a.dtype.itemsize != 2 or a.dtype.kind not in "Vfiu":
            a = a.astype(np.float32)        # e.g. an f32 leaf into bf16
            return torch.from_numpy(a).to(like.device, torch.bfloat16)
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(like.device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(like.device,
                                                        like.dtype)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {key: _to_numpy(leaf) for key, leaf in _paths(tree)}


def save(tree, directory: str, name: str) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{name}.npz")
    tmp = path + ".tmp.npz"
    np.savez(tmp, **_flatten(tree))
    os.replace(tmp, path)
    return path


def restore(tree_like, directory: str, name: str):
    """Restore into the structure, dtypes and devices of ``tree_like``
    (shapes must match; raises ValueError naming the leaf otherwise)."""
    path = os.path.join(directory, f"{name}.npz")
    with np.load(path) as data:
        leaves = {}
        for key, leaf in _paths(tree_like):
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: checkpoint shape {arr.shape}, "
                                 f"expected {tuple(leaf.shape)}")
            leaves[key] = _from_numpy(arr, leaf)
    return _rebuild(tree_like, leaves, ())


def _rebuild(tree, leaves, prefix):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, leaves, prefix + (f".{f}",))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return leaves["/".join(prefix)]


def exists(directory: str, name: str) -> bool:
    return os.path.exists(os.path.join(directory, f"{name}.npz"))
