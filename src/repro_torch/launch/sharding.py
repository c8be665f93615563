"""Logical-to-physical sharding rules (MaxText-style) with divisibility
fallback, on torch's ``DeviceMesh`` (port of ``repro/launch/sharding.py``).

Every model exposes trees of *logical axis names* per parameter/cache dim
(``repro_torch.models.*.logical_axes``).  :func:`spec_for_axes` turns one
leaf's axes into a spec for a mesh: each dim takes the first rule
candidate whose mesh axes (a) exist in the mesh, (b) are not already used
by another dim of the same tensor, and (c) divide the dim size.
Non-divisible dims fall through, e.g. llama4's 40 q-heads are not
divisible by model=16, so the model axis lands on head_dim (or the ff dim)
instead of failing.  A spec is a tuple with one entry per leading dim
(trailing unsharded dims dropped), each None, a mesh axis name, or a tuple
of names that shard the dim jointly: the entries of the reference's
``PartitionSpec``.  :func:`tree_shardings` gives each leaf its spec and
the DTensor placements it means on the mesh (``Shard(dim)`` on every mesh
dimension that shards tensor dim ``dim``, so a dim sharded over ("pod",
"data") is ``Shard(dim)`` on both; ``Replicate()`` on the rest), and
:func:`local_shape` the shape of one device's shard.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, \
    Tuple

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.launch.mesh import mesh_axis_sizes

# Rule table: logical axis -> priority list of candidates; each candidate is
# a tuple of mesh axes that shard the dim jointly.
DEFAULT_RULES: Dict[Optional[str], Tuple[Tuple[str, ...], ...]] = {
    "batch": (("pod", "data"), ("data",)),
    "vocab": (("model",),),
    "q_out": (("model",),),
    "kv_out": (("model",),),
    "heads": (("model",),),
    "kv_heads": (("model",),),
    "kv_head_dim": (("model",),),        # fallback when kv_heads indivisible
    "ff": (("model",),),
    "expert_w": ((),),                   # tensor-parallel MoE: shard ff, not E
    "embed": (("data",),),               # FSDP
    "embed_pod": (("pod", "data"), ("data",)),   # 405B-class FSDP
    "rank": ((),),
    "inner": (("model",),),
    "inner_in": ((),),
    "inner_head": (("model",),),
    "state": ((),),
    "layers": ((),),
    None: ((),),
}


BIG_MODEL = 5e10      # params above which weights cannot replicate over data
SMALL_MODEL = 1e9     # params below which weights replicate on every chip

# Sharding strategy: "baseline" is the paper-faithful first implementation
# (FSDP over data + tensor parallel over model for train/prefill);
# "optimized" applies the reference's hillclimbing results:
#   * small-model train: pure data parallelism over ALL mesh axes (the
#     16-way TP all-reduces dominated tiny models' rooflines),
#   * sub-50B prefill: FSDP over the model axis instead of TP (one weight
#     all-gather per layer amortizes over 32k tokens; activation
#     all-reduces do not).
STRATEGIES = ("baseline", "optimized")

Spec = Tuple[Any, ...]
Rules = Dict[Optional[str], Tuple[Tuple[str, ...], ...]]


def rules_for(cfg, purpose: str = "train",
              strategy: str = "baseline") -> Rules:
    """Sharding rule table per (model size, step purpose).

    train/prefill: FSDP — weights sharded on the embed dim over data
      (+pod for 405B-class) and on heads/ff over model; batch over pod+data.
      The per-layer weight all-gather amortizes over S tokens.
    decode small:  weights replicated over data (they fit), model-parallel
      over model; batch + KV cache over data.  No per-step param collectives.
    decode big:    2D tensor parallel — weight output dims sharded over
      (pod×data×model) jointly so 405B-class weights fit; batch replicated
      for weights, KV cache still batch-sharded over data (+head_dim over
      model).  Per-step collectives are small decode activations.
    """
    rules = dict(DEFAULT_RULES)
    big = cfg is not None and cfg.num_params > BIG_MODEL
    small = cfg is not None and cfg.num_params < SMALL_MODEL
    if strategy == "optimized" and cfg is not None:
        tp_axes = ("ff", "q_out", "kv_out", "inner", "inner_head", "vocab",
                   "kv_heads", "kv_head_dim")
        if purpose == "train" and small:
            for ax in tp_axes:
                rules[ax] = ((),)
            rules["embed"] = ((),)
            rules["batch"] = (("pod", "data", "model"), ("pod", "data"),
                              ("data", "model"), ("data",))
            return rules
        if purpose == "prefill" and not big:
            for ax in ("ff", "q_out", "kv_out", "inner", "inner_head"):
                rules[ax] = ((),)
            rules["vocab"] = (("model",),)     # keep logits sharded
            rules["embed"] = (("model",), ("data",))
            return rules
    if purpose == "decode":
        rules["embed"] = ((),)                      # no per-step FSDP gather
        if big:
            two_d = (("pod", "data", "model"), ("data", "model"), ("model",))
            for ax in ("q_out", "kv_out", "ff", "vocab", "inner"):
                rules[ax] = two_d
    else:
        if cfg is not None and cfg.num_params > 2e11:
            # 405B-class: fp32 optimizer state needs pod+data FSDP
            rules["embed"] = (("pod", "data"), ("data",))
    return rules


def spec_for_axes(axes: Optional[Sequence[Optional[str]]],
                  shape: Tuple[int, ...], mesh_sizes: Dict[str, int],
                  rules: Rules) -> Spec:
    """The spec of a tensor of ``shape`` whose dims have logical ``axes``
    (None: replicated, ``()``), on a mesh of ``mesh_sizes``."""
    if axes is None:
        return ()
    assert len(axes) == len(shape), (axes, shape)
    used: set = set()
    entries = []
    for name, dim in zip(axes, shape):
        chosen = None
        for cand in rules.get(name, ((),)):
            if not cand:
                break
            if any(a not in mesh_sizes or a in used for a in cand):
                continue
            size = math.prod(mesh_sizes[a] for a in cand)
            if size > 1 and dim % size == 0:
                chosen = cand
                used.update(cand)
                break
        if chosen is None:
            entries.append(None)
        elif len(chosen) == 1:
            entries.append(chosen[0])
        else:
            entries.append(tuple(chosen))
    # strip trailing Nones for tidiness
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shape(shape: Sequence[int], spec: Spec,
                mesh_sizes: Dict[str, int]) -> Tuple[int, ...]:
    """The shape of one device's shard of a tensor of ``shape`` under
    ``spec`` (every sharded dim divides: :func:`spec_for_axes` shards no
    other)."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        n = math.prod(mesh_sizes[a] for a in _entry_axes(entry))
        out[dim] //= n
    return tuple(out)


def placements(spec: Spec, mesh_axes: Sequence[str]) -> tuple:
    """The DTensor placements of ``spec`` on a mesh whose dims are named
    ``mesh_axes``: ``Shard(dim)`` on each mesh dim that shards tensor dim
    ``dim``, ``Replicate()`` elsewhere."""
    of_axis = {a: dim for dim, entry in enumerate(spec)
               for a in _entry_axes(entry)}
    return tuple(Shard(of_axis[a]) if a in of_axis else Replicate()
                 for a in mesh_axes)


class LeafSharding(NamedTuple):
    """One leaf's sharding: its spec and the DTensor placements it means
    on the mesh."""
    spec: Spec
    placements: tuple


def map_leaves(fn: Callable, tree, axes):
    """``fn(tensor, axes)`` over the tensors of ``tree`` (nested dicts,
    lists and NamedTuples), each with the matching node of ``axes``, a
    tree of the same structure whose leaves are tuples of axis names or
    None (the reference's ``flatten_up_to``)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, axes)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, None if axes is None else axes[k])
                for k, v in tree.items()}
    sub = [None] * len(tree) if axes is None else axes
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_leaves(fn, v, a) for v, a in zip(tree, sub)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, v, a) for v, a in zip(tree, sub))
    raise TypeError(f"not a tensor tree node: {type(tree)}")


def tree_shardings(mesh, shapes_tree, axes_tree, cfg=None,
                   purpose: str = "train", strategy: str = "baseline"):
    """A :class:`LeafSharding` for every tensor of ``shapes_tree`` (meta or
    real tensors), from the matching axes of ``axes_tree`` and the rules
    for (cfg, purpose, strategy), on ``mesh`` (a ``DeviceMesh``, a
    ``MeshConfig`` or {axis: size})."""
    rules = rules_for(cfg, purpose, strategy)
    sizes = mesh_axis_sizes(mesh)

    def leaf(t, axes):
        spec = spec_for_axes(axes, tuple(t.shape), sizes, rules)
        return LeafSharding(spec, placements(spec, tuple(sizes)))

    return map_leaves(leaf, shapes_tree, axes_tree)


def vector_sharding(mesh, batch: int, cfg=None, purpose: str = "train",
                    strategy: str = "baseline") -> LeafSharding:
    """Sharding for (batch,)-shaped step vectors (tokens, kv_len, ids),
    respecting divisibility of the actual batch size."""
    sizes = mesh_axis_sizes(mesh)
    rules = rules_for(cfg, purpose, strategy)
    spec = spec_for_axes(("batch",), (batch,), sizes, rules)
    return LeafSharding(spec, placements(spec, tuple(sizes)))


def batch_sharding_for(mesh, batch: int) -> Tuple[str, ...]:
    """The mesh axes actually usable for a given global batch size."""
    sizes = mesh_axis_sizes(mesh)
    for cand in (("pod", "data"), ("data",)):
        if all(a in sizes for a in cand):
            size = math.prod(sizes[a] for a in cand)
            if batch % size == 0 and size > 1:
                return cand
    return ()


def input_shardings(mesh, specs: Dict[str, torch.Tensor], cfg=None,
                    purpose: str = "train",
                    strategy: str = "baseline") -> Dict[str, LeafSharding]:
    """Shardings for the per-step data inputs from
    ``configs.input_specs``: the batch dim by the rules, the rest
    replicated."""
    sizes = mesh_axis_sizes(mesh)
    rules = rules_for(cfg, purpose, strategy)
    out = {}
    for name, s in specs.items():
        axes = ("batch",) + (None,) * (len(s.shape) - 1)
        spec = spec_for_axes(axes, tuple(s.shape), sizes, rules)
        out[name] = LeafSharding(spec, placements(spec, tuple(sizes)))
    return out


def local_bytes(tree, shardings, mesh) -> int:
    """Bytes of one device's shards of the tensors of ``tree`` under the
    matching :class:`LeafSharding` tree (a leaf without one, None, is
    replicated)."""
    sizes = mesh_axis_sizes(mesh)
    total = 0

    def add(t, sh):
        nonlocal total
        spec = sh.spec if sh is not None else ()
        total += math.prod(local_shape(t.shape, spec, sizes)) * \
            t.element_size()
        return None

    map_leaves(add, tree, shardings)
    return total
