"""Paged ResidualAttention on the card: wrappers over the hand-written CUDA
kernels in ``csrc/paged_residual_attention.cu``.

These replace the Pallas kernels of ``repro/kernels/paged_residual_attention.py``
that carry the serving path's unified prefill/decode grid.  Each wrapper
checks device, dtype, contiguity and shapes, raises on anything the kernel
does not take, allocates the output, launches on PyTorch's current stream
and raises if the launch failed.  It never falls back to the plain version;
that lives in :mod:`repro_torch.kernels.ref` and is chosen only for CPU
tensors, by :mod:`repro_torch.kernels.ops`.

Bound on an H100.  A decode row reads every live page of kb/vb (Hkv·D
values per token) and kr/vr (R per token) once and does about 4·G·D
flops per token and kv head: a few flops per byte, far below the card's
~295 bf16 flops/byte ridge, so decode is bound by bytes.  The design
reads each page once for all G query heads of its kv head and rebuilds K
on chip, so the residual adds only R/(Hkv·D) of the base bytes.  A long
prefill row does ~4·tq·G·D flops per token of each page it reads and is
bound by operations; this first design runs them as f32 FMAs on the CUDA
cores (67 TFLOP/s peak) instead of bf16 tensor-core MMAs, so it stays far
from the 989 TFLOP/s bound (later work: wgmma, TMA, split-K over pages).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build

# Launches of each kernel.  ``chip_smoke.py`` zeroes these before it serves
# and reads them after, to show the serving path went through the kernels.
LAUNCHES: Dict[str, int] = {
    "paged_residual_attention_mixed": 0,
    "paged_residual_attention_decode": 0,
    "paged_attention_mixed_base": 0,
    "paged_attention_decode_base": 0,
}

SOURCE = "paged_residual_attention"
MAX_ROWS = 64          # query rows (positions x group heads) per CTA
MAX_PAGE = 32
MAX_RANK = 32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "paged_residual_attention_mixed":
        [_I] + [_P] * 13 + [_I] * 9 + [_F, _I, _F, _I, _P],
    "paged_residual_attention_decode":
        [_I] + [_P] * 11 + [_I] * 7 + [_F, _I, _F, _I, _P],
    "paged_attention_mixed_base":
        [_I] + [_P] * 8 + [_I] * 8 + [_F, _I, _P],
    "paged_attention_decode_base":
        [_I] + [_P] * 6 + [_I] * 6 + [_F, _I, _P],
}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile and load the kernels now (they are built at first use
    otherwise)."""
    _lib()


def _check(name: str, t: Optional[torch.Tensor], device: torch.device,
           dtype: torch.dtype, ndim: int) -> None:
    if t is None:
        raise ValueError(f"{name} is required")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{ndim} dims")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _geometry(q, kb_pool, vb_pool, bt_b, kv_len, kb_scale, window,
              decode: bool):
    """Shared checks; returns (bsz, sq, hq, hkv, d, page, w, g, dtype code)."""
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got "
                         f"{q.device}")
    if kb_scale is not None:
        raise NotImplementedError(
            "int8 bCache pages are not ported to the CUDA kernels yet "
            "(ROADMAP Queue 2, int8 variant of kernels 1-4)")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    dev, dt = q.device, q.dtype
    _check("q", q, dev, dt, 3 if decode else 4)
    _check("kb_pool", kb_pool, dev, dt, 4)
    _check("vb_pool", vb_pool, dev, dt, 4)
    if vb_pool.shape != kb_pool.shape:
        raise ValueError("kb_pool and vb_pool shapes differ")
    _check("bt_b", bt_b, dev, torch.int32, 2)
    _check("kv_len", kv_len, dev, torch.int32, 1)
    bsz = q.shape[0]
    sq = 1 if decode else q.shape[1]
    hq, d = q.shape[-2], q.shape[-1]
    page, hkv = kb_pool.shape[1], kb_pool.shape[2]
    if kb_pool.shape[3] != d:
        raise ValueError("pool head_dim differs from q's")
    if d not in (64, 128):
        raise ValueError(f"head_dim {d} not supported (64 or 128)")
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    g = hq // hkv
    if g > MAX_ROWS:
        raise ValueError(f"group size {g} > {MAX_ROWS}")
    if not 1 <= page <= MAX_PAGE:
        raise ValueError(f"page size {page} not in [1, {MAX_PAGE}]")
    if bt_b.shape[0] != bsz or kv_len.shape[0] != bsz:
        raise ValueError("block table / kv_len batch differs from q's")
    if window < 0:
        raise ValueError("window must be >= 0")
    if bsz > 65535:
        raise ValueError("batch above 65535 rows")
    return bsz, sq, hq, hkv, d, page, bt_b.shape[1], g, _DTYPES[dt]


def _check_residual(q, kr_pool, vr_pool, b_k, b_v, bt_r, bsz, hkv, d, page,
                    w):
    dev, dt = q.device, q.dtype
    _check("kr_pool", kr_pool, dev, dt, 3)
    _check("vr_pool", vr_pool, dev, dt, 3)
    _check("b_k", b_k, dev, dt, 3)
    _check("b_v", b_v, dev, dt, 3)
    _check("bt_r", bt_r, dev, torch.int32, 2)
    r = kr_pool.shape[2]
    if vr_pool.shape != kr_pool.shape or kr_pool.shape[1] != page:
        raise ValueError("residual pools must be (Pr, page, R), equal")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"rank {r} not in [1, {MAX_RANK}]")
    for name, t in (("b_k", b_k), ("b_v", b_v)):
        if tuple(t.shape) != (bsz, r, hkv * d):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{(bsz, r, hkv * d)}")
    if tuple(bt_r.shape) != (bsz, w):
        raise ValueError("bt_r shape differs from bt_b's")
    return r


def _check_rows(start, q_len, bsz, dev):
    _check("start", start, dev, torch.int32, 1)
    _check("q_len", q_len, dev, torch.int32, 1)
    if start.shape[0] != bsz or q_len.shape[0] != bsz:
        raise ValueError("start / q_len batch differs from q's")


def _run(name: str, *args) -> None:
    err = getattr(_lib(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def paged_residual_attention_mixed(q, kb_pool, vb_pool, kr_pool, vr_pool,
                                   b_k, b_v, bt_b, bt_r, start, q_len,
                                   kv_len, *, scale: float, window: int = 0,
                                   rope_theta: float = 10_000.0,
                                   use_rope: bool = True, kb_scale=None,
                                   vb_scale=None) -> torch.Tensor:
    """Unified mixed prefill/decode attention over paged disaggregated
    pools.  Replaces ``paged_residual_attention_mixed``
    (repro/kernels/paged_residual_attention.py:764).

    q: (B, Sq, Hq, D); kb/vb: (P, page, Hkv, D); kr/vr: (Pr, page, R);
    b_k/b_v: (B, R, Hkv·D); bt_b/bt_r: (B, W) int32; start/q_len/kv_len:
    (B,) int32 with ``kv_len = start + q_len``.  Rows at or past q_len come
    back as exact zeros.  Returns (B, Sq, Hq, D).  Bound: bytes for decode
    rows, operations for long prefill rows (module docstring)."""
    bsz, sq, hq, hkv, d, page, w, g, code = _geometry(
        q, kb_pool, vb_pool, bt_b, kv_len, kb_scale, window, decode=False)
    r = _check_residual(q, kr_pool, vr_pool, b_k, b_v, bt_r, bsz, hkv, d,
                        page, w)
    _check_rows(start, q_len, bsz, q.device)
    tq = max(1, min(sq, MAX_ROWS // g))
    out = torch.empty_like(q)
    _run("paged_residual_attention_mixed", code, _ptr(q), _ptr(kb_pool),
         _ptr(vb_pool), _ptr(kr_pool), _ptr(vr_pool), _ptr(b_k), _ptr(b_v),
         _ptr(bt_b), _ptr(bt_r), _ptr(start), _ptr(q_len), _ptr(kv_len),
         _ptr(out), bsz, sq, hq, hkv, d, r, page, w, tq, float(scale),
         int(window), float(rope_theta), int(use_rope), _stream(q))
    return out


def paged_residual_attention_decode(q, kb_pool, vb_pool, kr_pool, vr_pool,
                                    b_k, b_v, bt_b, bt_r, kv_len, *,
                                    scale: float, window: int = 0,
                                    rope_theta: float = 10_000.0,
                                    use_rope: bool = True, kb_scale=None,
                                    vb_scale=None) -> torch.Tensor:
    """Decode over paged disaggregated pools: one query row per request at
    position ``kv_len - 1``.  Replaces ``paged_residual_attention_decode``
    (repro/kernels/paged_residual_attention.py:206).  The same kernel as
    :func:`paged_residual_attention_mixed` with Sq = 1.

    q: (B, Hq, D); pools and tables as the mixed kernel; kv_len: (B,)
    int32.  Returns (B, Hq, D).  Bound: bytes (module docstring)."""
    bsz, _, hq, hkv, d, page, w, _, code = _geometry(
        q, kb_pool, vb_pool, bt_b, kv_len, kb_scale, window, decode=True)
    r = _check_residual(q, kr_pool, vr_pool, b_k, b_v, bt_r, bsz, hkv, d,
                        page, w)
    out = torch.empty_like(q)
    _run("paged_residual_attention_decode", code, _ptr(q), _ptr(kb_pool),
         _ptr(vb_pool), _ptr(kr_pool), _ptr(vr_pool), _ptr(b_k), _ptr(b_v),
         _ptr(bt_b), _ptr(bt_r), _ptr(kv_len), _ptr(out), bsz, hq, hkv, d,
         r, page, w, float(scale), int(window), float(rope_theta),
         int(use_rope), _stream(q))
    return out


def paged_attention_mixed_base(q, kb_pool, vb_pool, bt_b, start, q_len,
                               kv_len, *, scale: float, window: int = 0,
                               kb_scale=None, vb_scale=None) -> torch.Tensor:
    """Base-only unified mixed grid over unified caches (the prefix and
    full_reuse baselines).  Replaces ``paged_attention_mixed_base``
    (repro/kernels/paged_residual_attention.py:910).  Shapes as
    :func:`paged_residual_attention_mixed` minus the residual stream.
    Bound: bytes for decode rows, operations for long prefill rows."""
    bsz, sq, hq, hkv, d, page, w, g, code = _geometry(
        q, kb_pool, vb_pool, bt_b, kv_len, kb_scale, window, decode=False)
    _check_rows(start, q_len, bsz, q.device)
    tq = max(1, min(sq, MAX_ROWS // g))
    out = torch.empty_like(q)
    _run("paged_attention_mixed_base", code, _ptr(q), _ptr(kb_pool),
         _ptr(vb_pool), _ptr(bt_b), _ptr(start), _ptr(q_len), _ptr(kv_len),
         _ptr(out), bsz, sq, hq, hkv, d, page, w, tq, float(scale),
         int(window), _stream(q))
    return out


def paged_attention_decode_base(q, kb_pool, vb_pool, bt_b, kv_len, *,
                                scale: float, window: int = 0,
                                kb_scale=None, vb_scale=None
                                ) -> torch.Tensor:
    """Base-only paged decode.  Replaces ``paged_attention_decode_base``
    (repro/kernels/paged_residual_attention.py:345).  Shapes as
    :func:`paged_residual_attention_decode` minus the residual stream.
    Bound: bytes."""
    bsz, _, hq, hkv, d, page, w, _, code = _geometry(
        q, kb_pool, vb_pool, bt_b, kv_len, kb_scale, window, decode=True)
    out = torch.empty_like(q)
    _run("paged_attention_decode_base", code, _ptr(q), _ptr(kb_pool),
         _ptr(vb_pool), _ptr(bt_b), _ptr(kv_len), _ptr(out), bsz, hq, hkv,
         d, page, w, float(scale), int(window), _stream(q))
    return out
