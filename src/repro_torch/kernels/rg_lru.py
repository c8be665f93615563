"""RG-LRU linear scan on the card: the wrappers over the hand-written CUDA
kernels in ``csrc/rg_lru.cu``, the scan and its backward, and
:class:`RgLruScan`, the autograd function that joins them.

It replaces the Pallas kernel ``rg_lru_scan`` of ``repro/kernels/rg_lru.py``
(the Griffin / RecurrentGemma recurrence h_t = a_t * h_{t-1} + b_t with an
f32 state).  The wrapper checks device, dtype, shape and contiguity,
raises on anything the kernel does not take, allocates the outputs,
launches on PyTorch's current stream and raises if the launch failed.  It
never falls back to the plain version; that is
:func:`repro_torch.kernels.ref.rg_lru_scan_ref`, chosen only for CPU
tensors, by :class:`RgLruScan`.

Bound on an H100: bytes (read a and b, write the states; 3.35 TB/s).  One
thread per (row, lane of W) steps through S with the next loads in flight;
a short batch fills few SMs (the source's note).  The backward
(:func:`rg_lru_scan_bwd`) walks S in reverse the same way: bytes too (read
a, the states and their gradient, write da and db).

Every caller goes through :class:`RgLruScan` (``ops.rg_lru_scan``), so a
gradient taken through the hybrid model reaches ``a``, ``b`` and ``h0``
on every device: on the card both directions launch their kernels, on the
CPU both run their plain versions.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import _build
from repro_torch.kernels import ref as ref_mod

# Launches of each kernel.  ``chip_smoke.py`` zeroes these before it drives
# the hybrid model and reads them after, to show the path went through
# them.
LAUNCHES: Dict[str, int] = {"rg_lru_scan": 0, "rg_lru_scan_bwd": 0}

SOURCE = "rg_lru"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    lib.rg_lru_scan.argtypes = [_I] + [_P] * 5 + [_I] * 3 + [_P]
    lib.rg_lru_scan.restype = ctypes.c_int
    lib.rg_lru_scan_bwd.argtypes = [_I] + [_P] * 8 + [_I] * 3 + [_P]
    lib.rg_lru_scan_bwd.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile and load the kernels now (they are built at first use
    otherwise)."""
    _lib()


def _check(a: torch.Tensor, others) -> tuple:
    """The checks both kernels make: ``a`` a contiguous (B, S, W) CUDA
    tensor of f32 or bf16, and each (name, tensor, ndim) of ``others`` of
    a's device, dtype and contiguity, (B, S, W) or (B, W).  Returns
    (B, S, W)."""
    if a.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got "
                         f"{a.device}")
    if a.dtype not in _DTYPES:
        raise TypeError(f"a must be float32 or bfloat16, got {a.dtype}")
    if a.dim() != 3:
        raise ValueError(f"a must be (B, S, W), got shape {tuple(a.shape)}")
    bsz, s, w = a.shape
    if s < 1 or w < 1 or bsz < 1:
        raise ValueError(f"empty scan: shape {tuple(a.shape)}")
    if bsz > 65535:
        raise ValueError("batch above 65535 rows")
    for name, t, ndim in (("a", a, 3),) + tuple(others):
        shape = (bsz, s, w) if ndim == 3 else (bsz, w)
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, expected {a.device}")
        if t.dtype != a.dtype:
            raise TypeError(f"{name} is {t.dtype}, expected {a.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return bsz, s, w


def rg_lru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """h_t = a_t * h_{t-1} + b_t over the sequence axis.  Replaces
    ``rg_lru_scan`` (repro/kernels/rg_lru.py:48).

    a, b: (B, S, W) and h0: (B, W), contiguous CUDA tensors of one dtype
    (float32 or bfloat16).  The state is carried in f32.  Returns (states
    (B, S, W), last state (B, W)) in that dtype; the last state equals
    ``states[:, -1]``."""
    bsz, s, w = _check(a, (("b", b, 3), ("h0", h0, 2)))
    states = torch.empty_like(a)
    h_last = torch.empty_like(h0)
    err = _lib().rg_lru_scan(
        _DTYPES[a.dtype], a.data_ptr(), b.data_ptr(), h0.data_ptr(),
        states.data_ptr(), h_last.data_ptr(), bsz, s, w,
        torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rg_lru_scan launch failed: CUDA error {err}")
    LAUNCHES["rg_lru_scan"] += 1
    return states, h_last


def rg_lru_scan_bwd(a: torch.Tensor, states: torch.Tensor, h0: torch.Tensor,
                    dstates: torch.Tensor, dh_last: torch.Tensor):
    """The scan's gradient (``rg_lru_scan_bwd_kernel``): given the forward's
    a, states and h0 and the gradients of its two outputs, returns (da, db,
    dh0) by the reverse recurrence g_t = dstates_t + a_{t+1} g_{t+1} (g_S =
    dstates_S + dh_last), db_t = g_t, da_t = g_t h_{t-1}, dh0 = a_1 g_1,
    with g carried in f32.  The plain version is
    :func:`repro_torch.kernels.ref.rg_lru_scan_bwd_ref`.

    a, states, dstates: (B, S, W); h0, dh_last: (B, W); contiguous CUDA
    tensors of one dtype (float32 or bfloat16).  Bound: bytes (3.35
    TB/s)."""
    bsz, s, w = _check(a, (("states", states, 3), ("h0", h0, 2),
                           ("dstates", dstates, 3), ("dh_last", dh_last, 2)))
    da = torch.empty_like(a)
    db = torch.empty_like(a)
    dh0 = torch.empty_like(h0)
    err = _lib().rg_lru_scan_bwd(
        _DTYPES[a.dtype], a.data_ptr(), states.data_ptr(), h0.data_ptr(),
        dstates.data_ptr(), dh_last.data_ptr(),
        da.data_ptr(), db.data_ptr(), dh0.data_ptr(), bsz, s, w,
        torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rg_lru_scan_bwd launch failed: CUDA error {err}")
    LAUNCHES["rg_lru_scan_bwd"] += 1
    return da, db, dh0


class RgLruScan(torch.autograd.Function):
    """h_t = a_t h_{t-1} + b_t with a gradient: the kernels of this module
    for CUDA tensors, their plain versions (:mod:`.ref`) for CPU tensors,
    in both directions.  ``RgLruScan.apply(a, b, h0)`` returns (states,
    last state) as :func:`rg_lru_scan` does; a, b and h0 share one dtype
    (the dispatcher ``ops.rg_lru_scan`` casts h0)."""

    @staticmethod
    def forward(ctx, a, b, h0):
        if a.device.type == "cpu":
            states, _ = ref_mod.rg_lru_scan_ref(a, b, h0)
            h_last = states[:, -1].clone()
        else:
            states, h_last = rg_lru_scan(a, b, h0)
        ctx.save_for_backward(a, states, h0)
        return states, h_last

    @staticmethod
    @once_differentiable
    def backward(ctx, dstates, dh_last):
        # autograd hands zeros for an output that did not reach the loss
        a, states, h0 = ctx.saved_tensors
        if a.device.type == "cpu":
            return ref_mod.rg_lru_scan_bwd_ref(a, states, h0, dstates,
                                               dh_last)
        return rg_lru_scan_bwd(a, states, h0, dstates.contiguous(),
                               dh_last.contiguous())
