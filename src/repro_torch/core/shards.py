"""Running a function on the local shards of DTensors, and the in-place
cache writes of the model API on them.

A model step takes plain tensors or DTensors (``launch.steps.run_sharded``
lays a step's arguments out on a mesh).  Most of its operations DTensor
runs as they are, with the collectives they need.  An in-place write into
a cache cannot change the cache's layout, so :func:`write_rows` and
:func:`copy_into` lay the rows to be written out as the cache is and let
each shard write its own part; a plain cache is written as before.  An
embedding lookup (:func:`lookup`) keeps the ids' sharding, as GSPMD does,
where DTensor would gather the ids (and with them every later activation)
or the whole table.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import local_map


def _replicated(t, mesh):
    """A plain tensor as a replicated DTensor on ``mesh`` (what
    ``implicit_replication`` takes it for); anything else as it is."""
    if isinstance(t, torch.Tensor) and not isinstance(t, DTensor):
        return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                                  run_check=False)
    return t


def on_shards(fn: Callable, out_placements, in_placements, *args):
    """``fn`` over the local shards of ``args``, at least one of them a
    DTensor: each tensor argument is first laid out as ``in_placements``
    gives (a plain tensor counts as replicated), so ``fn`` needs nothing
    from another shard, and the tensors ``fn`` returns become DTensors with
    ``out_placements`` (one placements tuple per output, in a tuple; for a
    single output a list of placements; None when it returns None).
    torch's ``local_map``."""
    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    args = tuple(_replicated(a, mesh) for a in args)
    return local_map(fn, out_placements, in_placements, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def laid_out_as(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t`` laid out as the DTensor ``ref`` is (a gradient as its
    parameter: partial sums reduced onto the parameter's shards, as GSPMD
    lays out what is added to a sharded tensor); otherwise ``t`` as it
    is."""
    if isinstance(t, DTensor) and isinstance(ref, DTensor):
        return t.redistribute(ref.device_mesh, ref.placements)
    return t


def _rows_placements(placements) -> tuple:
    """The placements of a (B, n) row index into a cache whose placements
    are ``placements``: its batch dim sharded as the cache's, the rest
    replicated."""
    if any(p.is_partial() or p == Shard(1) for p in placements):
        raise ValueError(f"a cache laid out as {placements} cannot be "
                         f"written row by row on its shards")
    return tuple(p if p == Shard(0) else Replicate() for p in placements)


def _write_rows(dest, slot, src) -> None:
    bidx = torch.arange(dest.shape[0], device=dest.device)[:, None]
    dest[bidx, slot.long()] = src.to(dest.dtype)


def write_rows(dest: torch.Tensor, slot: torch.Tensor,
               src: torch.Tensor) -> None:
    """``dest[b, slot[b, j]] = src[b, j]`` in place, for a cache ``dest``
    (B, Smax, ...), slots ``slot`` (B, n) and rows ``src`` (B, n, ...).  On
    a DTensor cache each shard writes its own rows: the slots and rows are
    laid out as the cache is (batch over the cache's mesh dims, the
    trailing dims too), so the write moves no cache across shards."""
    if not isinstance(dest, DTensor):
        _write_rows(dest, slot, src)
        return
    pl = dest.placements
    on_shards(_write_rows, None, (pl, _rows_placements(pl), pl), dest, slot,
              src)


def _copy(dest, src) -> None:
    dest.copy_(src)


def copy_into(dest: torch.Tensor, src: torch.Tensor) -> None:
    """``dest.copy_(src)`` in place (a state cache, ``src`` of its shape);
    on a DTensor ``dest`` each shard copies its own part, ``src`` laid out
    as ``dest`` first."""
    if not isinstance(dest, DTensor):
        dest.copy_(src)
        return
    on_shards(_copy, None, (dest.placements, dest.placements), dest, src)


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``: the rows of an embedding table (V, d) for integer
    ``ids``.  On a DTensor table each shard looks up its own ids.  Where a
    mesh dim shards both, the table is gathered over it if it shards the
    table's d (FSDP's weight gather) and the ids are if it shards the rows
    (they are few); the ids keep every other shard, so the rows come out
    sharded as the ids are.  Over a mesh dim that shards only the table's
    rows (the vocab), each shard takes the rows it holds and zeros for the
    rest, and one all-reduce makes them whole; over one that shards only
    its d, the rows' last dim is sharded.  The gradient reaches the table
    summed over the ids' shards."""
    if not isinstance(table, DTensor):
        return table[ids]
    mesh = table.device_mesh
    ids = _replicated(ids, mesh)
    tpl, ipl = list(table.placements), list(ids.placements)
    for m, (p, q) in enumerate(zip(tpl, ipl)):
        if p.is_shard() and q.is_shard():
            if p.dim == 0:
                ipl[m] = Replicate()
            else:
                tpl[m] = Replicate()
    out_pl = [q if q.is_shard() else Partial() if p == Shard(0) else
              Shard(ids.ndim) if p.is_shard() else Replicate()
              for p, q in zip(tpl, ipl)]
    grad_pl = [Partial() if q.is_shard() else p for p, q in zip(tpl, ipl)]
    first = compute_local_shape_and_global_offset(table.shape, mesh,
                                                  tpl)[1][0]
    rows_sharded = any(p == Shard(0) for p in tpl)

    def rows(t, i):
        if not rows_sharded:
            return t[i]
        i = i.long() - first
        held = (i >= 0) & (i < t.shape[0])
        return t[i.clamp(0, t.shape[0] - 1)] * held[..., None].to(t.dtype)

    out = local_map(rows, out_pl, (tpl, ipl), (grad_pl, ipl),
                    device_mesh=mesh, redistribute_inputs=True)(table, ids)
    whole = [Replicate() if p.is_partial() else p for p in out_pl]
    return out if whole == out_pl else out.redistribute(mesh, whole)
