"""Roofline terms on the H100's constants, and the measured side of a
dry-run record (port of ``repro/launch/roofline.py``).

  compute    = FLOPs       / PEAK_FLOPS_BF16
  memory     = bytes       / HBM_BW
  collective = coll_bytes  / LINK_BW

per device, from per-device quantities.  The reference reads FLOPs and
bytes from XLA's ``cost_analysis()`` of the compiled step and collective
bytes from its HLO text.  Here the step runs on ``meta`` tensors: its
FLOPs come from torch's ``FlopCounterMode`` (:func:`step_flops`), which
counts every matrix product the step dispatches, every layer and loop
pass included, over the global batch; its per-device memory is the bytes
of one device's shards of its arguments and outputs
(:func:`analyze_step`).  The record's roofline takes its collective bytes
from the analytic model (:mod:`repro_torch.launch.analytic`), as the
reference's primary roofline does; beside them, :func:`collective_bytes`
counts those a sharded step issues when it runs on DTensors
(``launch.steps.run_sharded``), where the reference parses them out of
its compiled HLO.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core.config import HBM_BW, LINK_BW, PEAK_FLOPS_BF16
from repro_torch.launch import sharding as shd


COLL_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
            "collective-permute")

# torch's functional collectives (what DTensor issues) by kind
_KIND_OF = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_out": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "isend": "collective-permute",
}


def _operand_bytes(arg) -> int:
    if isinstance(arg, torch.Tensor):
        return arg.numel() * arg.element_size()
    return sum(_operand_bytes(a) for a in arg)


class _Collectives(TorchDispatchMode):
    """Sums, per kind, the bytes of the local input of every functional
    collective dispatched under it (the operands DTensor hands the process
    group), and counts them."""

    def __init__(self):
        super().__init__()
        self.out = dict.fromkeys(COLL_OPS, 0)
        self.out["count"] = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # let DTensor lower it first
        if func.namespace == "_c10d_functional":
            kind = _KIND_OF.get(func.overloadpacket.__name__)
            if kind is not None:
                self.out[kind] += _operand_bytes(args[0])
                self.out["count"] += 1
        return func(*args, **(kwargs or {}))


def collective_bytes(step_fn: Callable, *args) -> Dict[str, int]:
    """The collectives ``step_fn(*args)`` issues, with the reference's
    keys: per kind the bytes of each collective's per-device operand (its
    local input tensor), ``count`` and ``total`` (the sum of the kinds).
    The step runs on DTensors (``launch.steps.run_sharded``): on meta
    tensors over the ``"fake"`` process group this counts a production
    step without running one.  DTensor lowers a change of sharded dim to
    ``all_to_all_single`` on a CUDA mesh but, on a CPU mesh (the dry
    run's), to an all-gather and a local chunk."""
    with _Collectives() as mode:
        step_fn(*args)
    out = mode.out
    out["total"] = sum(out[k] for k in COLL_OPS)
    return out


def roofline_terms(flops: float, bytes_accessed: float, coll_bytes: float,
                   chips: int) -> Dict[str, Any]:
    """All inputs are per-device quantities; each term divides by one
    card's rate (the H100's, ``core.config``).  ``chips`` is kept for the
    reference's signature."""
    compute = flops / PEAK_FLOPS_BF16
    memory = bytes_accessed / HBM_BW
    collective = coll_bytes / LINK_BW
    terms: Dict[str, Any] = {"compute_s": compute, "memory_s": memory,
                             "collective_s": collective}
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom
    terms["bound_s"] = terms[dom]
    return terms


def step_flops(step_fn: Callable, *args) -> Tuple[float, Any]:
    """(FLOPs, outputs) of ``step_fn(*args)``: the floating-point operations
    of every matrix product, attention and convolution it dispatches, as
    ``FlopCounterMode`` counts them (2 per multiply-add; a backward pass
    counted too), over the whole (global) batch.  On meta tensors the step
    computes shapes only, so this is the count of a production step with
    no device and no memory."""
    with FlopCounterMode(display=False) as counter:
        out = step_fn(*args)
    return float(counter.get_total_flops()), out


def analyze_step(built, mesh, chips: int, flops: float,
                 model_flops: Optional[float] = None) -> Dict[str, Any]:
    """The record of a built step: its FLOPs over the global batch
    (``step_flops``), the per-device bytes of its arguments and outputs
    under its shardings on ``mesh`` (``argument_size_in_bytes``,
    ``output_size_in_bytes``: the counterparts of XLA's
    ``memory_analysis()``), and, given ``model_flops``,
    ``useful_fraction`` = model_flops / FLOPs."""
    mem = {"argument_size_in_bytes": sum(
               shd.local_bytes(a, s, mesh) for a, s in
               zip(built.abstract_args, built.shardings.args)),
           "output_size_in_bytes": sum(
               shd.local_bytes(o, s, mesh) for o, s in
               zip(built.abstract_outputs, built.shardings.outputs))}
    result: Dict[str, Any] = {"flops": flops, "flops_dev": flops / chips,
                              "memory": mem}
    if model_flops:
        result["model_flops"] = model_flops
        result["useful_fraction"] = model_flops / flops if flops else 0.0
    return result
