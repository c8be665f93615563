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
(:func:`analyze_step`).  Collective bytes come from the analytic model
(:mod:`repro_torch.launch.analytic`), as the reference's primary roofline
does: counting those of a sharded execution needs it to run, which is
later work.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core.config import HBM_BW, LINK_BW, PEAK_FLOPS_BF16
from repro_torch.launch import sharding as shd


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
