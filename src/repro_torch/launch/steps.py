"""Step builders for the dry run and for runs on a mesh (port of
``repro/launch/steps.py``).

For each (architecture x input shape) this constructs:
  * abstract state (params / optimizer / LoRA stacks / KV caches) as
    ``meta`` tensors, which have shapes and dtypes and hold no memory (the
    reference's ``jax.eval_shape``);
  * the shardings of every argument and output, from the model's logical
    axes and the rule table (:mod:`repro_torch.launch.sharding`);
  * the step itself, a plain function that runs on whatever device its
    arguments are on: on meta tensors it computes shapes only (the dry
    run counts its FLOPs, :mod:`repro_torch.launch.roofline`); on real
    tensors of a 1x1 mesh (``mesh.make_local_mesh``) it is the step, as
    the reference's jitted step runs on ``make_local_mesh()``.

Sharded, the step runs on DTensors, the counterpart of the reference's jit
with in and out shardings: :func:`shard_args` lays its arguments (real or
meta) out by ``shardings.args``, :func:`run_sharded` runs it and
redistributes its outputs to ``shardings.outputs``.  The tensors a model
makes itself (positions, masks, RoPE tables, fresh buffers) are taken as
replicated in one place, :func:`sharded`, with torch's
``implicit_replication``; there too what DTensor refuses, or would
gather or reduce where GSPMD keeps it sharded, is resharded first
(:class:`_Reshard`).  The caches are written and the embedding looked up
shard by shard (:mod:`repro_torch.core.shards`).  A plain-tensor call
runs as before.

train_4k   -> train_step   (loss + grads + optimizer update)
prefill_32k-> prefill_step (populate disaggregated cache, argmax logits)
decode_*   -> serve_step   (ONE token against a seq_len cache)
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Any, Callable, Iterator, NamedTuple, Optional, Sequence

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs as cfg_lib
from repro_torch.core import shards
from repro_torch.core.config import ModelConfig, ShapeConfig
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import mesh_axis_sizes
from repro_torch.models import base
from repro_torch.models.registry import get_model
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import train_loop

N_ADAPTERS = 8          # concurrent agents in the serving dry-run
# gradient-accumulation microbatches per train step: 16 keeps the local
# microbatch at 1 sequence per chip (256 global / 16 data shards / 16),
# bounding activation temps
DEFAULT_ACCUM = 16
ACCUM_STEPS = {}

META = torch.device("meta")


def accum_for(cfg, strategy: str = "baseline") -> int:
    # optimized strategy, small models: activations fit without microbatching
    # and every accumulation pass re-streams the (replicated) weights
    if strategy == "optimized" and cfg.num_params < 1e9:
        return 1
    return ACCUM_STEPS.get(cfg.name, DEFAULT_ACCUM)


class StepShardings(NamedTuple):
    """The sharding trees of a step's arguments and of its outputs (None:
    replicated), one per argument and output."""
    args: tuple
    outputs: tuple


class BuiltStep(NamedTuple):
    step_fn: Callable       # runs on meta or real tensors alike
    abstract_args: tuple    # meta trees to call it with
    shardings: StepShardings
    description: str
    abstract_outputs: tuple = ()   # meta trees of what it returns
    # a train step's pieces (train_loop.TrainParts) on the meta device
    parts: Optional[train_loop.TrainParts] = None


def _opt_axes(cfg: ModelConfig, param_axes):
    inner = opt_lib.opt_state_logical_axes(cfg.optimizer, param_axes)
    return opt_lib.OptState(step=None, inner=inner)


def _device_of(tree) -> torch.device:
    return base.leaves(tree)[0].device


def _placements(sh, mesh) -> tuple:
    return sh.placements if sh is not None else \
        (Replicate(),) * mesh.ndim


def distribute(tree, shardings, mesh):
    """The tensors of ``tree`` (real or meta, each rank holding all of it)
    as DTensors on ``mesh``, laid out by the matching
    :class:`~repro_torch.launch.sharding.LeafSharding` of ``shardings``
    (None: replicated).  Each rank keeps its own shard of a plain tensor,
    with no communication; a DTensor is redistributed."""
    def leaf(t, sh):
        pl = _placements(sh, mesh)
        if isinstance(t, DTensor):
            return t.redistribute(mesh, pl)
        return distribute_tensor(t, mesh, pl, src_data_rank=None)
    return shd.map_leaves(leaf, tree, shardings)


def _zeros(tree, shardings, mesh, device: torch.device):
    """Zeros shaped as the (meta) tensors of ``tree``, as DTensors laid out
    by ``shardings`` on ``mesh``, each rank allocating only its shard on
    ``device``."""
    sizes = mesh_axis_sizes(mesh)

    def leaf(t, sh):
        local = shd.local_shape(t.shape, sh.spec if sh is not None else (),
                                sizes)
        return DTensor.from_local(
            torch.zeros(local, dtype=t.dtype, device=device), mesh,
            _placements(sh, mesh), run_check=False, shape=t.shape,
            stride=t.stride())
    return shd.map_leaves(leaf, tree, shardings)


def _view_groups(a: Sequence[int], b: Sequence[int]) -> list:
    """The dims of shape ``a`` and of shape ``b`` (same numel) that a view
    from ``a`` to ``b`` maps onto each other, in order: ([dims of a], [dims
    of b]) with equal products."""
    groups, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        pa, pb, ia, jb = a[i], b[j], [i], [j]
        i, j = i + 1, j + 1
        while pa != pb:
            if pa < pb:
                pa *= a[i]
                ia.append(i)
                i += 1
            else:
                pb *= b[j]
                jb.append(j)
                j += 1
        groups.append((ia, jb))
    return groups


def _target_shape(t: torch.Tensor, shape) -> tuple:
    """The shape a view asks for, -1 resolved."""
    shape = [int(n) for n in shape]
    if -1 in shape:
        known = math.prod(n for n in shape if n != -1)
        shape[shape.index(-1)] = t.numel() // known if known else 0
    return tuple(shape)


class _Reshard(TorchDispatchMode):
    """Where DTensor refuses an operation that GSPMD would reshard for, or
    would gather or reduce a tensor that GSPMD keeps sharded, this mode
    reshards first, in the forward and the backward pass alike:

    * a view that splits a sharded dim into dims of which the first does
      not divide by the dim's shard count (8 KV heads of a projection
      sharded 16 ways), that moves a shard off a group's leading dim, or
      that merges an unevenly sharded dim (``einsum`` views its operands
      too): the dim is replicated over as few of its mesh dims as it must
      be (:func:`_viewable`);
    * a slice along a sharded dim (a microbatch of the train step's split
      batch) moves the shards onto the next dim (:func:`_shard_past`);
    * a product whose result outgrows both operands (attention's scores)
      gathers its contracted dim (:func:`_whole_contraction`);
    * a sum of a partial sum and a tensor that is none reduces the partial
      first, onto the other's shards (:func:`_reduced_against`);
    * torch before 2.13 also refuses a lookup whose ids are sharded over
      two mesh dims at once and a ``flip``: :func:`_one_mesh_dim_each`,
      :func:`_flip_on_shards`.

    An embedding lookup keeps its ids' sharding through
    :func:`repro_torch.core.shards.lookup`."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is _FLIP and isinstance(args[0], DTensor):
            return _flip_on_shards(*args)
        new = _resharded(func, args)
        if new is not None:
            return func(*new, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        return func(*args, **kwargs)


def _resharded(func, args) -> Optional[tuple]:
    """``args`` of ``func`` with the rules of :class:`_Reshard` applied, or
    None where no rule moves a tensor (DTensor then runs the operation as
    it would without the mode, with no second dispatch)."""
    a = args[0]
    if func is _INDEX and isinstance(a, DTensor):
        ids = [_one_mesh_dim_each(i) for i in args[1]]
        changed = any(x is not y for x, y in zip(ids, args[1]))
        return (a, ids) if changed else None
    if func in _VIEWS and isinstance(a, DTensor):
        new = (_viewable(a, _target_shape(a, args[1])),)
    elif func is _SELECT and isinstance(a, DTensor):
        new = (_shard_past(a, args[1] % a.ndim),)
    elif func in _PRODUCTS and all(isinstance(x, DTensor)
                                   for x in args[:2]):
        new = _whole_contraction(*args[:2])
    elif func in _ADDS and any(isinstance(x, DTensor) for x in args[:2]) \
            and all(isinstance(x, torch.Tensor) for x in args[:2]):
        new = (_reduced_against(a, args[1]), _reduced_against(args[1], a))
    else:
        return None
    if all(x is y for x, y in zip(new, args)):
        return None
    return tuple(new) + tuple(args[len(new):])


_VIEWS = (torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default)
_INDEX = torch.ops.aten.index.Tensor
_FLIP = torch.ops.aten.flip.default
_SELECT = torch.ops.aten.select.int
_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)
_ADDS = (torch.ops.aten.add.Tensor, torch.ops.aten.sub.Tensor)


def _laid_out(t: DTensor, pl) -> DTensor:
    """``t`` redistributed to the placements ``pl``.  Inside the mode the
    operation's gradient is the autograd graph's above it, so the
    redistribution is made off the graph (torch 2.11 cannot detach a
    DTensor in place, which a redistribution in the backward pass of a
    tensor that requires grad would)."""
    return t if list(pl) == list(t.placements) else \
        t.detach().redistribute(t.device_mesh, pl)


def _reduced_against(t, other):
    """``t`` (when a DTensor) with its partial sums reduced on every mesh
    dim on which ``other`` (a DTensor or a plain tensor, taken as
    replicated) is no partial sum, onto ``other``'s shards there: a
    product whose contraction was sharded is made whole where a residual
    or a bias is added to it, as GSPMD and Megatron's row-parallel layer
    do, where DTensor would carry the partial sum through every later
    linear operation and reduce it again at each nonlinear one (and torch
    before 2.13 cannot add a shard to a partial sum at all)."""
    if not isinstance(t, DTensor):
        return t
    opl = other.placements if isinstance(other, DTensor) else \
        (Replicate(),) * t.device_mesh.ndim

    def onto(q):             # other's shard as a dim of t (broadcast)
        d = q.dim + t.ndim - other.ndim if q.is_shard() else -1
        return Shard(d) if 0 <= d < t.ndim and \
            t.shape[d] == other.shape[q.dim] else Replicate()

    pl = [onto(q) if p.is_partial() and not q.is_partial() else p
          for p, q in zip(t.placements, opl)]
    return _laid_out(t, pl)


def _one_mesh_dim_each(t):
    """An index tensor (a table lookup's token ids) with each of its dims
    sharded by one mesh dim at most, the innermost: torch before 2.13
    cannot index with ids whose batch dim is sharded over ("pod", "data")
    at once."""
    if not isinstance(t, DTensor):
        return t
    pl, seen = list(t.placements), set()
    for m in reversed(range(len(pl))):
        if pl[m].is_shard():
            if pl[m].dim in seen:
                pl[m] = Replicate()
            seen.add(pl[m].dim if pl[m].is_shard() else None)
    return _laid_out(t, pl)


def _flip_on_shards(t: DTensor, dims) -> DTensor:
    """``t.flip(dims)`` shard by shard, the flipped dims whole (torch before
    2.13 has no sharding rule for ``flip``, which ``cumsum``'s backward
    runs)."""
    dims = [d % t.ndim for d in dims]
    pl = tuple(Replicate() if p.is_shard() and p.dim in dims else p
               for p in t.placements)
    return shards.on_shards(lambda x: x.flip(dims), list(pl), (pl,),
                            t.detach())


def _shard_counts(t: DTensor) -> dict:
    """{tensor dim: the number of shards it is cut into} of ``t``."""
    sizes = t.device_mesh.shape
    count: dict = {}
    for m, p in enumerate(t.placements):
        if p.is_shard():
            count[p.dim] = count.get(p.dim, 1) * sizes[m]
    return count


def _viewable(t: DTensor, shape: tuple) -> DTensor:
    """``t`` laid out so that DTensor can view it as ``shape``: each dim
    that the view splits or merges keeps its shards over the innermost
    mesh dims whose shard count still divides it, and loses the others."""
    sizes = t.device_mesh.shape
    pl, seen = list(t.placements), set()
    for ia, jb in _view_groups(tuple(t.shape), shape):
        seen.update(ia)
        ia = [i for i in ia if t.shape[i] != 1] or ia[:1]
        jb = [j for j in jb if shape[j] != 1] or jb[:1]
        d = ia[0]
        pl = [Replicate() if p.is_shard() and p.dim in ia[1:] else p
              for p in pl]
        meshes = [m for m, p in enumerate(pl) if p == Shard(d)]
        if len(ia) == 1 and len(jb) == 1:
            continue
        while meshes and (t.shape[d] % math.prod(sizes[m] for m in meshes)
                          or shape[jb[0]] % math.prod(sizes[m]
                                                      for m in meshes)):
            pl[meshes.pop(0)] = Replicate()
    pl = [Replicate() if p.is_shard() and p.dim not in seen else p
          for p in pl]
    return _laid_out(t, pl)


def _whole_contraction(a: DTensor, b: DTensor) -> tuple:
    """The operands of a product ``a @ b`` (``mm`` or ``bmm``), their
    contracted dims replicated where the result outgrows both operands
    (attention's scores): DTensor would contract over a sharded dim and
    leave the large result a partial sum to reduce, where GSPMD gathers
    the small operand."""
    ka, kb = a.ndim - 1, b.ndim - 2
    if a.numel() // max(a.shape[ka], 1) * b.shape[-1] <= a.numel() + \
            b.numel():
        return a, b
    return _replicated_dims(a, {ka}), _replicated_dims(b, {kb})


def _replicated_dims(t: DTensor, dims) -> DTensor:
    """``t`` with every shard of the tensor dims ``dims`` replicated."""
    pl = [Replicate() if p.is_shard() and p.dim in dims else p
          for p in t.placements]
    return _laid_out(t, pl)


def _shard_past(t: DTensor, dim: int) -> DTensor:
    """``t`` with the shards of ``dim`` moved onto the next dim where they
    divide it: a slice along a sharded dim (a microbatch of the train
    step's split batch) stays sharded, as GSPMD reshards a scanned
    operand, where DTensor would gather it whole."""
    count = _shard_counts(t)
    if dim not in count or dim + 1 >= t.ndim or dim + 1 in count or \
            t.shape[dim + 1] % count[dim]:
        return t
    return _laid_out(t, [Shard(dim + 1) if p == Shard(dim) else p
                         for p in t.placements])


def shard_args(built: "BuiltStep", mesh, args: Optional[tuple] = None
               ) -> tuple:
    """A built step's arguments (None: its abstract, meta ones) as DTensors
    laid out by ``built.shardings.args`` on ``mesh``: the reference's jit
    ``in_shardings``."""
    args = built.abstract_args if args is None else args
    return tuple(distribute(a, sh, mesh)
                 for a, sh in zip(args, built.shardings.args))


def run_sharded(built: "BuiltStep", mesh, *dargs) -> tuple:
    """``built.step_fn`` on DTensor arguments (:func:`shard_args`), its
    outputs redistributed to ``built.shardings.outputs``: the reference's
    jit ``out_shardings``.  It runs under :func:`sharded`."""
    with sharded():
        return shard_outputs(built, mesh, built.step_fn(*dargs))


def shard_outputs(built: "BuiltStep", mesh, out) -> tuple:
    """A step's outputs redistributed to ``built.shardings.outputs``."""
    return tuple(distribute(o, sh, mesh)
                 for o, sh in zip(out, built.shardings.outputs))


@contextlib.contextmanager
def sharded() -> Iterator[None]:
    """What a step needs to run on DTensors: the tensors the model makes
    itself taken as replicated (``implicit_replication``), and what
    DTensor refuses or would lay out unlike GSPMD resharded first
    (:class:`_Reshard`)."""
    with implicit_replication(), _Reshard():
        yield


def build_train_step(cfg: ModelConfig, mesh, shape: ShapeConfig,
                     strategy: str = "baseline",
                     accum: Optional[int] = None) -> BuiltStep:
    """``train_loop.make_train_step`` with ``accum_for``'s microbatches
    (``accum`` given: that many)."""
    api = get_model(cfg)
    accum = accum_for(cfg, strategy) if accum is None else accum

    @functools.lru_cache(maxsize=None)
    def on(device: torch.device):
        return train_loop.make_train_step(cfg, accum_steps=accum,
                                          device=device)

    params_sds = api.init_params(0, device=META)
    opt_sds = on(META)[0](params_sds)
    batch_sds = cfg_lib.input_specs(cfg, shape)

    p_axes = api.logical_axes()
    params_sh = shd.tree_shardings(mesh, params_sds, p_axes, cfg, "train",
                                   strategy)
    opt_sh = shd.tree_shardings(mesh, opt_sds, _opt_axes(cfg, p_axes), cfg,
                                "train", strategy)
    batch_sh = shd.input_shardings(mesh, batch_sds, cfg, "train", strategy)

    def train_step(params, opt_state, batch):
        return on(_device_of(params))[1](params, opt_state, batch)

    scalar = torch.empty((), dtype=torch.float32, device=META)
    return BuiltStep(train_step, (params_sds, opt_sds, batch_sds),
                     StepShardings((params_sh, opt_sh, batch_sh),
                                   (params_sh, opt_sh, None)),
                     f"train_step accum={accum} opt={cfg.optimizer}",
                     (params_sds, opt_sds,
                      {"loss": scalar, "grad_norm": scalar}),
                     on(META)[1].parts)


def _lora_state(cfg: ModelConfig, api, mesh, purpose: str,
                strategy: str = "baseline"):
    if api.init_lora_stacks is None:
        return None, None
    lora_sds = api.init_lora_stacks(0, N_ADAPTERS, device=META)
    lora_sh = shd.tree_shardings(mesh, lora_sds, api.lora_logical_axes(),
                                 cfg, purpose, strategy)
    return lora_sds, lora_sh


def build_prefill_step(cfg: ModelConfig, mesh, shape: ShapeConfig,
                       disagg: Optional[bool] = None,
                       strategy: str = "baseline") -> BuiltStep:
    """A fresh cache of Sq positions, the prompt prefilled into it; the
    argmax of the last position's logits and the cache."""
    api = get_model(cfg)
    disagg = api.supports_forkkv if disagg is None else disagg
    B, S = shape.global_batch, shape.seq_len

    params_sds = api.init_params(0, device=META)
    params_sh = shd.tree_shardings(mesh, params_sds, api.logical_axes(), cfg,
                                   "prefill", strategy)
    lora_sds, lora_sh = _lora_state(cfg, api, mesh, "prefill", strategy)
    batch_sds = cfg_lib.input_specs(cfg, shape)
    batch_sh = shd.input_shardings(mesh, batch_sds, cfg, "prefill", strategy)

    cache_sds = api.init_cache(B, S, disagg=disagg, device=META)
    cache_sh = shd.tree_shardings(mesh, cache_sds,
                                  api.cache_logical_axes(disagg=disagg), cfg,
                                  "prefill", strategy)
    ids_sds = torch.empty((B,), dtype=torch.int32, device=META)
    ids_sh = shd.vector_sharding(mesh, B, cfg, "prefill", strategy)

    def prefill_step(params, lora, batch, adapter_ids):
        tokens = batch["tokens"]
        if isinstance(tokens, DTensor):
            cache = _zeros(cache_sds, cache_sh, tokens.device_mesh,
                           tokens.device)
        else:
            cache = api.init_cache(B, S, disagg=disagg, device=tokens.device)
        kwargs = {}
        if "extra_embeds" in batch:
            kwargs["extra_embeds"] = batch["extra_embeds"]
        if lora is not None:
            kwargs.update(lora=lora, adapter_ids=adapter_ids, disagg=disagg)
        with torch.no_grad():
            logits, cache = api.prefill(params, batch["tokens"], cache,
                                        **kwargs)
        # dim 1, not -1: DTensor's argmax over a sharded vocab gathers
        # along the dim it is given and takes no negative one
        return torch.argmax(logits[:, -1], dim=1).to(torch.int32), cache

    return BuiltStep(prefill_step,
                     (params_sds, lora_sds, batch_sds, ids_sds),
                     StepShardings((params_sh, lora_sh, batch_sh, ids_sh),
                                   (ids_sh, cache_sh)),
                     f"prefill_step disagg={disagg}", (ids_sds, cache_sds))


def build_serve_step(cfg: ModelConfig, mesh, shape: ShapeConfig,
                     disagg: Optional[bool] = None,
                     strategy: str = "baseline") -> BuiltStep:
    """Decode: ONE new token with a KV cache of shape.seq_len."""
    api = get_model(cfg)
    disagg = api.supports_forkkv if disagg is None else disagg
    B, S = shape.global_batch, shape.seq_len

    params_sds = api.init_params(0, device=META)
    params_sh = shd.tree_shardings(mesh, params_sds, api.logical_axes(), cfg,
                                   "decode", strategy)
    lora_sds, lora_sh = _lora_state(cfg, api, mesh, "decode", strategy)

    cache_sds = api.init_cache(B, S, disagg=disagg, device=META)
    cache_sh = shd.tree_shardings(mesh, cache_sds,
                                  api.cache_logical_axes(disagg=disagg), cfg,
                                  "decode", strategy)
    tok_sds = torch.empty((B,), dtype=torch.int32, device=META)
    len_sds = torch.empty((B,), dtype=torch.int32, device=META)
    vec_sh = shd.vector_sharding(mesh, B, cfg, "decode", strategy)

    def serve_step(params, lora, cache, tokens, kv_len, adapter_ids):
        kwargs = {}
        if lora is not None:
            kwargs.update(lora=lora, adapter_ids=adapter_ids, disagg=disagg)
        with torch.no_grad():
            logits, cache = api.decode_step(params, tokens, cache, kv_len,
                                            **kwargs)
        return torch.argmax(logits, dim=1).to(torch.int32), cache

    return BuiltStep(
        serve_step,
        (params_sds, lora_sds, cache_sds, tok_sds, len_sds, tok_sds),
        StepShardings((params_sh, lora_sh, cache_sh, vec_sh, vec_sh, vec_sh),
                      (vec_sh, cache_sh)),
        f"serve_step disagg={disagg} cache_len={S}", (tok_sds, cache_sds))


def build_step(cfg: ModelConfig, mesh, shape: ShapeConfig,
               **kw: Any) -> BuiltStep:
    if shape.mode == "train":
        kw.pop("disagg", None)
        return build_train_step(cfg, mesh, shape, **kw)
    kw.pop("accum", None)
    if shape.mode == "prefill":
        return build_prefill_step(cfg, mesh, shape, **kw)
    return build_serve_step(cfg, mesh, shape, **kw)
