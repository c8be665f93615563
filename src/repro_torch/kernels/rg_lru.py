"""RG-LRU linear scan on the card: the wrapper over the hand-written CUDA
kernel in ``csrc/rg_lru.cu``.

It replaces the Pallas kernel ``rg_lru_scan`` of ``repro/kernels/rg_lru.py``
(the Griffin / RecurrentGemma recurrence h_t = a_t * h_{t-1} + b_t with an
f32 state).  The wrapper checks device, dtype, shape and contiguity,
raises on anything the kernel does not take, allocates the outputs,
launches on PyTorch's current stream and raises if the launch failed.  It
never falls back to the plain version; that is
:func:`repro_torch.kernels.ref.rg_lru_scan_ref`, chosen only for CPU
tensors by :mod:`repro_torch.kernels.ops`.

Bound on an H100: bytes (read a and b, write the states; 3.35 TB/s).  One
thread per (row, lane of W) steps through S with the next loads in flight;
a short batch fills few SMs (the source's note).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from repro_torch.kernels import _build

# Launches of the kernel.  ``chip_smoke.py`` zeroes this before it drives
# the hybrid model and reads it after, to show the path went through it.
LAUNCHES: Dict[str, int] = {"rg_lru_scan": 0}

SOURCE = "rg_lru"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    lib.rg_lru_scan.argtypes = [_I] + [_P] * 5 + [_I] * 3 + [_P]
    lib.rg_lru_scan.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile and load the kernel now (it is built at first use
    otherwise)."""
    _lib()


def rg_lru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """h_t = a_t * h_{t-1} + b_t over the sequence axis.  Replaces
    ``rg_lru_scan`` (repro/kernels/rg_lru.py:48).

    a, b: (B, S, W) and h0: (B, W), contiguous CUDA tensors of one dtype
    (float32 or bfloat16).  The state is carried in f32.  Returns (states
    (B, S, W), last state (B, W)) in that dtype; the last state equals
    ``states[:, -1]``."""
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
    for name, t, shape in (("a", a, (bsz, s, w)), ("b", b, (bsz, s, w)),
                           ("h0", h0, (bsz, w))):
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, expected {a.device}")
        if t.dtype != a.dtype:
            raise TypeError(f"{name} is {t.dtype}, expected {a.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
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
