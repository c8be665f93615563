"""Dense ResidualAttention on the card: wrappers over the hand-written CUDA
kernels in ``csrc/residual_attention.cu``.

These replace the two Pallas kernels of
``repro/kernels/residual_attention.py``: the prefill kernel (any number of
query rows at given positions) and the decode kernel (one query row per
request, at ``kv_len - 1``), both over a disaggregated KV cache laid out
contiguously per request, which is what the dense model's ``forward``
hands them.  Each wrapper checks device, dtype, contiguity and shapes,
raises on anything the kernel does not take, allocates the output,
launches on PyTorch's current stream and raises if the launch failed.  It
never falls back to the plain version; that lives in
:mod:`repro_torch.kernels.ref` and is chosen only for CPU tensors, by
:mod:`repro_torch.kernels.ops`.

Bound on an H100.  A long causal prefill does ~4·G·D flops per (query,
key) pair and kv head over keys it reads once per query tile: bound by
operations (989 TFLOP/s bf16).  A bf16 prefill runs a flash tile on the
tensor cores (mma.sync, 128 query rows per CTA, K rebuilt per key block
by an MMA with RoPE in registers; counted as
``residual_attention_prefill_mma``).  Decode does a few flops per byte of
K/V: bound by bytes (3.35 TB/s), and at the main path's one new token
(``forward`` at S 1) by latency alone.  A bf16 decode runs a split-K
kernel (``decode_split_plan``; counted as
``residual_attention_decode_splitk``): CTAs of 4 warps over up to 16
query heads as one m16 tile, each CTA a range of every row's live keys,
each warp 16-key steps of it with K rebuilt on the tensor cores; with one
range (Sk 1 always) the CTA finishes the row and applies B_v itself, with
several a second kernel combines the ranges from an f32 workspace.  Every
f32 launch runs the first, scalar design, f32 FMAs on the CUDA cores (67
TFLOP/s peak), which keeps f32 IEEE (the tensor cores have no such mode);
its decode is one CTA per (kv head, row) over the whole cache.  Head
dims 32, 64, 120, 128 and 256 are taken.  At 120 (h2o-danube-3-4b's) the
bf16 kernels run D 128's tile in the split-half layout
(``tile_columns``): RoPE pairs column c with c + 60, so the halves go to
tile columns 0..59 and 64..123 and the tile's own pairing c <-> c + 64
holds; the four columns after each half are zero on chip, add nothing to
Q·Kᵀ and are never stored, and q and the cache are read as they are, in
8-byte copies (a half starts at byte 120).  The scalar kernel takes any
even D as it is.  A CTA of the
scalar kernel holds 64 query rows at D <= 128 and 32 at D 256
(``ROWS_BY_HEAD_DIM``), or 16 at D 256 where the rank leaves no room for
32 (``scalar_rows``), so its shared memory stays inside the card's
227 KB; the tensor-core kernel holds 128 (``MMA_ROWS``), or 64 at D 256
from rank 33 to 64 (``mma_rows``).  Every kernel takes every rank of 1
and above at every head_dim.  Ranks up to ``RANK_CHUNK`` (64) run
instances of RP = 16, 32 and 64 padded rank columns (``rank_instance``),
which hold B_k and B_v and an accumulator O_r of RP columns on chip;
above it the chunked instances (``rank_chunked``, counted as
``<counter>_rchunk``, ``csrc/rank_chunk.cuh``) rebuild each key block's
K and V on chip one rank chunk of 64 at a time, so nothing on chip grows
with the rank.  The scalar kernel's chunked instance (chunks of 32) also
takes a group whose rows its layout at rank R cannot hold, as 32 heads at
D 256 and rank 64 (``scalar_chunked``).
Unlike the Pallas prefill, which pads Sq and Sk to multiples of 128 with
copies, the kernel takes any Sq and Sk and masks the ragged edge itself.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from repro_torch.core.device import SMEM_PER_CTA_RESERVED, SMEM_PER_SM, \
    sm_count
from repro_torch.kernels import _build

# Launches of each kernel.  ``chip_smoke.py`` zeroes these before it drives
# the dense model and reads them after, to show the path went through them.
# A bf16 prefill runs the tensor-core kernel, counted apart under
# ``residual_attention_prefill_mma``, a bf16 decode the split-K decode,
# ``residual_attention_decode_splitk``; f32 launches run the scalar kernel.
# The chunked instances count under the same names + ``_rchunk``.
_COUNTERS = ("residual_attention_prefill", "residual_attention_prefill_mma",
             "residual_attention_decode", "residual_attention_decode_splitk")
LAUNCHES: Dict[str, int] = {
    name + suffix: 0 for name in _COUNTERS for suffix in ("", "_rchunk")}

SOURCE = "residual_attention"
# Query rows (positions x group heads) per CTA, by head_dim: the CTA holds
# its Q tile, accumulator and a rebuilt key block in shared memory
# (``Layout`` in the source), which at D 256 and 64 rows would need ~280 KB
# of the H100's 227 KB; 32 rows need ~203 KB at R 16.
ROWS_BY_HEAD_DIM = {32: 64, 64: 64, 120: 64, 128: 64, 256: 32}
# The bf16 kernels' tile width by head_dim where it is wider than the head:
# head_dim 120 runs in D 128's tile, its halves split (``tile_columns``).
TILE_DIM = {120: 128}
# Query rows per CTA of the bf16 tensor-core prefill at every head_dim: 8
# warps of 16 rows, its softmax state in registers.
MMA_ROWS = 128
# LoRA ranks up to RANK_CHUNK run the instance of the smallest RP in
# RANK_INSTANCES at least the rank (its K_r/V_r columns from R to RP are
# zero); every rank above it the chunked instance, which takes the rank in
# chunks of RANK_CHUNK (SCALAR_RANK_CHUNK in the f32 scalar kernel)
RANK_CHUNK = 64
RANK_INSTANCES = (16, 32, 64)
SCALAR_RANK_CHUNK = 32
SMEM_PER_CTA = 227 * 1024  # dynamic shared memory one CTA may have
# The bf16 split-K decode: a CTA of SPLIT_WARPS warps takes up to
# SPLIT_HEADS query heads (one m16 tile) and one range of each row's live
# keys, a multiple of SPLIT_KEYS * SPLIT_WARPS keys; each warp 16-key steps.
SPLIT_KEYS = 16
SPLIT_WARPS = 4
SPLIT_HEADS = 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "residual_attention_prefill":
        [_I] + [_P] * 12 + [_I] * 8 + [_F, _I, _I, _P],
    "residual_attention_decode":
        [_I] + [_P] * 15 + [_I] * 7 + [_F, _I, _P],
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
           dtype: torch.dtype, shape) -> None:
    if t is None:
        raise ValueError(f"{name} is required")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def refuse_grad(kernel: str, *tensors: Optional[torch.Tensor]) -> None:
    """The attention kernels have no backward, as the Pallas kernels they
    replace have none (``jax.grad`` through those fails too).  With grad
    mode on, an input that requires grad would silently get no gradient
    through the kernel's output: raise RuntimeError naming the kernel."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel} has no backward: an input requires grad; call it "
            f"under torch.no_grad() (the serving paths do) or train through "
            f"the plain attention (disagg=False)")


def rank_instance(r: int) -> int:
    """RP, the padded rank of the kernel instance that a LoRA rank ``r``
    runs in; above ``RANK_CHUNK`` the chunked instance's chunk, RANK_CHUNK
    (``rank_chunked``).  Raises ValueError naming a rank below 1."""
    if r < 1:
        raise ValueError(f"rank {r} not in [1, ...): a LoRA rank is at "
                         f"least 1")
    return next((rp for rp in RANK_INSTANCES if r <= rp), RANK_CHUNK)


def rank_chunked(r: int) -> bool:
    """Whether rank ``r`` runs the chunked instances (``rank_chunk.cuh``):
    every rank above ``RANK_CHUNK``."""
    return rank_instance(r) < r


def chunk_block_smem(d: int, bk: int, int8: bool = False) -> int:
    """Shared-memory bytes of the chunked instances' key block of ``bk``
    keys at tile width ``d`` (``flash::ChunkBlock``): bf16 K and V tiles,
    sin and cos rows, one chunk of K_r or V_r and one of B_k or B_v rows
    (rows padded by 8), the f32 sums (bk x d), and for int8 pages the
    block's codes and scales."""
    ds, hs, rs = d + 8, d // 2 + 8, RANK_CHUNK + 8
    elems = 2 * bk * ds + 2 * bk * hs + bk * rs + RANK_CHUNK * ds
    return 2 * elems + 4 * bk * d + ((2 * bk * d + 8 * bk) if int8 else 0)


def scalar_smem(rows: int, tq: int, d: int, r: int,
                chunk: bool = False) -> int:
    """Shared-memory bytes of one CTA of the scalar kernel (``Layout`` in
    the source): rows of Q, acc, scores and softmax state, a 32-key block
    of K, V, sin, cos, K_r and V_r, acc_r, B_k and tq positions (B_v is
    loaded over the key block after the key loop).  ``chunk``: no acc_r,
    and a rank chunk (``SCALAR_RANK_CHUNK``) of K_r or V_r and of B_k or
    B_v in place of the rank's."""
    blk = 32
    rc = SCALAR_RANK_CHUNK if chunk else 0
    r = 0 if chunk else r
    words = rows * (d + 1) + rows * d + rows * (blk + 1) + 3 * rows \
        + blk * (d + 1) + blk * d + 2 * blk * (d // 2) + rows * r \
        + 2 * blk * r + r * d + blk * rc + rc * d + tq
    return 4 * words


def _scalar_fit(d: int, group: int, r: int, chunk: bool) -> Optional[int]:
    rows = ROWS_BY_HEAD_DIM[d]
    while rows >= max(group, 16):
        tq = rows // group
        if scalar_smem(tq * group, tq, d, r, chunk) <= SMEM_PER_CTA:
            return rows
        rows //= 2
    return None


def scalar_chunked(d: int, group: int, r: int) -> bool:
    """Whether the scalar kernel runs its chunked instance: above
    ``RANK_CHUNK``, or where no tile of whole groups at rank ``r`` fits its
    layout (the source's ``launch`` makes the same choice from the tile
    it is given)."""
    return rank_chunked(r) or _scalar_fit(d, group, r, False) is None


def scalar_rows(d: int, group: int, r: int) -> int:
    """Query rows per CTA of the scalar kernel: ``ROWS_BY_HEAD_DIM[d]``,
    halved (down to 16) until a tile of whole groups fits the CTA's shared
    memory at rank ``r`` in the instance it runs (``scalar_chunked``).
    Raises ValueError where none does."""
    rows = _scalar_fit(d, group, r, scalar_chunked(d, group, r))
    if rows is None:
        raise ValueError(f"group size {group} at head_dim {d} and rank {r}: "
                         f"no query tile fits the scalar kernel's shared "
                         f"memory")
    return rows


def tile_rows(d: int, group: int, r: int = 16) -> int:
    """Query rows per CTA of the scalar kernel at head_dim ``d`` for
    ``group`` query heads per kv head at rank ``r`` (``scalar_rows``);
    raises for a head_dim the kernels do not take, a group larger than the
    head_dim's row budget or a rank below 1."""
    if d not in ROWS_BY_HEAD_DIM:
        raise ValueError(f"head_dim {d} not supported "
                         f"({', '.join(map(str, ROWS_BY_HEAD_DIM))})")
    rows = ROWS_BY_HEAD_DIM[d]
    if group > rows:
        raise ValueError(f"group size {group} > {rows} query rows per CTA "
                         f"at head_dim {d}")
    rank_instance(r)
    return scalar_rows(d, group, r)


def mma_rows(d: int, r: int) -> int:
    """Query rows per CTA of the tensor-core prefill: ``MMA_ROWS``, or 64
    at D 256 from rank 33 to 64, where B_k and B_v of 64 rank rows leave no
    room for a Q tile of 128 (``MmaLayout`` in the source); the chunked
    instance holds 128 at every head_dim."""
    return MMA_ROWS // 2 if tile_dim(d) == 256 and rank_instance(r) == 64 \
        and not rank_chunked(r) else MMA_ROWS


def tile_dim(d: int) -> int:
    """Columns of the bf16 kernels' tile for head_dim ``d``."""
    return TILE_DIM.get(d, d)


def tile_columns(d: int) -> torch.Tensor:
    """The tile column of each of the ``d`` columns of a head row in the
    bf16 kernels (``flash::Cols`` in ``csrc/flash_tile.cuh``): the identity
    where the tile is ``d`` wide; the split-half layout where it is wider,
    the first half at 0.. and the second at ``tile_dim(d) / 2``.., so RoPE's
    pairs c <-> c + d/2 sit at c <-> c + tile_dim(d)/2.  sin/cos rows fill
    the first d/2 of the tile's half.  The columns left out are zero."""
    cols = torch.arange(d)
    return torch.where(cols < d // 2, cols, cols + (tile_dim(d) - d) // 2)


def _chunk_suffix(dtype: torch.dtype, r: int, d: int, group: int) -> str:
    chunked = rank_chunked(r) if dtype == torch.bfloat16 else \
        scalar_chunked(d, group, r)
    return "_rchunk" if chunked else ""


def prefill_kernel(dtype: torch.dtype, r: int = 16, d: int = 128,
                   group: int = 1) -> str:
    """The prefill kernel, by its launch counter, that q in ``dtype`` runs
    at rank ``r``, head_dim ``d`` and ``group`` query heads per kv head:
    the tensor-core kernel for bf16, the scalar one for f32 (IEEE f32; the
    tensor cores have no such mode), ``_rchunk`` for their chunked
    instances (``rank_chunked``, ``scalar_chunked``)."""
    name = "residual_attention_prefill_mma" if dtype == torch.bfloat16 \
        else "residual_attention_prefill"
    return name + _chunk_suffix(dtype, r, d, group)


def decode_kernel(dtype: torch.dtype, r: int = 16, d: int = 128,
                  group: int = 1) -> str:
    """The decode kernel, by its launch counter, that q in ``dtype`` runs:
    the split-K decode for bf16, the scalar kernel for f32, ``_rchunk``
    for their chunked instances (as ``prefill_kernel``)."""
    name = "residual_attention_decode_splitk" if dtype == torch.bfloat16 \
        else "residual_attention_decode"
    return name + _chunk_suffix(dtype, r, d, group)


def decode_split_smem(d: int, r: int) -> int:
    """Shared-memory bytes of one CTA of the split-K decode (``Layout`` of
    ``splitk`` in the source): Q (16 rows), B_k and B_v (RP rows), and per
    warp two stages (one at D 256) of 16 keys' K, V, K_r, V_r, sin and cos
    rows, all bf16, rows padded by 8 elements; at the tile's width
    (``tile_dim``).  Above ``RANK_CHUNK``: Q and one 64-key block of the
    chunked instance (``chunk_block_smem``)."""
    d = tile_dim(d)
    if rank_chunked(r):
        return 2 * SPLIT_HEADS * (d + 8) + chunk_block_smem(
            d, SPLIT_KEYS * SPLIT_WARPS)
    rp = rank_instance(r)
    ds, rs, hs, keys = d + 8, rp + 8, d // 2 + 8, SPLIT_KEYS
    stage = keys * 2 * (2 * ds + 2 * rs + 2 * hs)
    stages = 1 if d > 128 else 2
    return 2 * (SPLIT_HEADS + 2 * rp) * ds + SPLIT_WARPS * stages * stage


def decode_ctas_per_sm(d: int, r: int) -> int:
    """Resident CTAs per SM of the split-K decode, as its shared memory
    allows, at most 2 (128 threads of up to 255 registers)."""
    need = decode_split_smem(d, r) + SMEM_PER_CTA_RESERVED
    return max(1, min(2, SMEM_PER_SM // need))


def decode_split_plan(bsz: int, hq: int, hkv: int, d: int, r: int, sk: int,
                      window: int, sm_count: int) -> Dict[str, object]:
    """The bf16 split-K decode's launch: ``n_split`` ranges of each row's
    live keys (at most min(Sk, window) of them), as many as fill the
    card's resident CTA slots (``decode_ctas_per_sm``) in one pass and no
    more than those keys have ``SPLIT_KEYS * SPLIT_WARPS``-key ranges; its
    grid, and the combine's grid and f32 workspace (m, l, acc, acc_r
    partials), both absent with one range (then the CTA finishes the row
    itself: Sk 1 always)."""
    groups = hkv * -(-(hq // hkv) // SPLIT_HEADS)
    ctas = decode_ctas_per_sm(d, r)
    fit = ctas * sm_count // max(1, bsz * groups)
    live = min(sk, window) if window else sk
    most = -(-live // (SPLIT_KEYS * SPLIT_WARPS))
    n_split = max(1, min(fit, most))
    combine = n_split > 1
    return dict(n_split=n_split, ctas_per_sm=ctas,
                grid=(n_split, groups, bsz),
                combine_grid=bsz * hq if combine else 0,
                workspace_bytes=4 * bsz * hq * n_split * (d + r + 2)
                if combine else 0)


def tile_positions(d: int, group: int, sq: int, dtype: torch.dtype,
                   r: int = 16) -> int:
    """Query positions per CTA of the prefill kernel that ``dtype`` runs
    at rank ``r``: its row budget over the group, at most Sq."""
    mma = prefill_kernel(dtype).endswith("_mma")
    rows = mma_rows(d, r) if mma else tile_rows(d, group, r)
    return max(1, min(sq, rows // group))


def _geometry(q, k_base, v_base, k_res, v_res, b_k, b_v, sin, cos, kv_len,
              window, decode: bool):
    """Shared checks; returns (bsz, sq, sk, hq, hkv, d, r, dtype code)."""
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got "
                         f"{q.device}")
    for name, t in (("k_base", k_base), ("v_base", v_base), ("k_res", k_res),
                    ("v_res", v_res), ("b_k", b_k), ("b_v", b_v),
                    ("sin", sin), ("cos", cos)):
        if t is None:
            raise ValueError(f"{name} is required")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if q.dim() != (3 if decode else 4) or k_base.dim() != 4 or \
            k_res.dim() != 3:
        raise ValueError("q must be (B, Hq, D) for decode and (B, Sq, Hq, D) "
                         "for prefill; k_base (B, Sk, Hkv, D); k_res "
                         "(B, Sk, R)")
    dev, dt = q.device, q.dtype
    bsz, hq, d = q.shape[0], q.shape[-2], q.shape[-1]
    sq = 1 if decode else q.shape[1]
    sk, hkv = k_base.shape[1], k_base.shape[2]
    r = k_res.shape[2]
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    tile_rows(d, hq // hkv, r)
    if hq // hkv > mma_rows(d, r):
        raise ValueError(f"group size {hq // hkv} > {mma_rows(d, r)} query "
                         f"rows per CTA at head_dim {d} and rank {r}")
    if sk < 1:
        raise ValueError("the cache holds no key")
    if window < 0:
        raise ValueError("window must be >= 0")
    if bsz > 65535:
        raise ValueError("batch above 65535 rows")
    _check("q", q, dev, dt, q.shape)
    _check("k_base", k_base, dev, dt, (bsz, sk, hkv, d))
    _check("v_base", v_base, dev, dt, (bsz, sk, hkv, d))
    _check("k_res", k_res, dev, dt, (bsz, sk, r))
    _check("v_res", v_res, dev, dt, (bsz, sk, r))
    _check("b_k", b_k, dev, dt, (bsz, r, hkv * d))
    _check("b_v", b_v, dev, dt, (bsz, r, hkv * d))
    _check("sin", sin, dev, dt, (bsz, sk, d // 2))
    _check("cos", cos, dev, dt, (bsz, sk, d // 2))
    if kv_len is not None:
        _check("kv_len", kv_len, dev, torch.int32, (bsz,))
    return bsz, sq, sk, hq, hkv, d, r, _DTYPES[dt]


def _run(name: str, counter: str, *args) -> None:
    """Launch entry ``name``; the launch counts under ``counter``."""
    err = getattr(_lib(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[counter] += 1


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def residual_attention_prefill(q, k_base, v_base, k_res, v_res, b_k, b_v,
                               sin, cos, qpos, kv_len=None, *, scale: float,
                               causal: bool = True, window: int = 0
                               ) -> torch.Tensor:
    """Attention of query rows at given positions over a contiguous
    disaggregated cache.  Replaces ``residual_attention_prefill``
    (repro/kernels/residual_attention.py:111).

    q: (B, Sq, Hq, D) RoPE'd; k_base/v_base: (B, Sk, Hkv, D), k_base RoPE'd;
    k_res/v_res: (B, Sk, R) scaled residuals without RoPE; b_k/b_v:
    (B, R, Hkv·D); sin/cos: (B, Sk, D/2) RoPE tables of the cache
    positions; qpos: (B, Sq) int32 positions of the query rows; kv_len:
    (B,) int32 valid keys, or None for all Sk.  Keys are masked to
    kpos < kv_len, kpos <= qpos (``causal``) and kpos > qpos - window
    (``window`` > 0).  A row that sees no key comes back as zeros.
    Returns (B, Sq, Hq, D).  Bound: operations for long prefills (module
    docstring)."""
    refuse_grad("residual_attention_prefill", q, k_base, v_base, k_res,
                v_res, b_k, b_v, sin, cos)
    bsz, sq, sk, hq, hkv, d, r, code = _geometry(
        q, k_base, v_base, k_res, v_res, b_k, b_v, sin, cos, kv_len, window,
        decode=False)
    _check("qpos", qpos, q.device, torch.int32, (bsz, sq))
    tq = tile_positions(d, hq // hkv, sq, q.dtype, r)
    out = torch.empty_like(q)
    _run("residual_attention_prefill",
         prefill_kernel(q.dtype, r, d, hq // hkv), code,
         _ptr(q), _ptr(k_base),
         _ptr(v_base), _ptr(k_res), _ptr(v_res), _ptr(b_k), _ptr(b_v),
         _ptr(sin), _ptr(cos), _ptr(qpos), _ptr(kv_len), _ptr(out), bsz, sq,
         sk, hq, hkv, d, r, tq, float(scale), int(causal), int(window),
         _stream(q))
    return out


def residual_attention_decode(q, k_base, v_base, k_res, v_res, b_k, b_v,
                              sin, cos, kv_len=None, *, scale: float,
                              window: int = 0) -> torch.Tensor:
    """One query row per request at position ``kv_len - 1`` (``Sk - 1``
    with ``kv_len=None``) over a contiguous disaggregated cache.  Replaces
    ``residual_attention_decode`` (repro/kernels/residual_attention.py:267).
    bf16 runs the split-K decode (``decode_split_plan``; with several
    ranges a workspace of its ``workspace_bytes`` and a combine), f32 the
    scalar kernel with Sq = 1.

    q: (B, Hq, D); the cache as :func:`residual_attention_prefill`.
    Returns (B, Hq, D).  Bound: bytes (module docstring)."""
    refuse_grad("residual_attention_decode", q, k_base, v_base, k_res,
                v_res, b_k, b_v, sin, cos)
    bsz, _, sk, hq, hkv, d, r, code = _geometry(
        q, k_base, v_base, k_res, v_res, b_k, b_v, sin, cos, kv_len, window,
        decode=True)
    n_split = 1
    if q.dtype == torch.bfloat16:
        n_split = decode_split_plan(bsz, hq, hkv, d, r, sk, window,
                                    sm_count(q.device.index))["n_split"]
    # f32 partials of several ranges: m and l (B, Hq, n_split), acc (...,
    # D), acc_r (..., R); none with one range
    n = bsz * hq * n_split
    ws = torch.empty(n * (d + r + 2), dtype=torch.float32,
                     device=q.device) if n_split > 1 else None
    parts = [None] * 4 if ws is None else \
        [ws[:n], ws[n:2 * n], ws[2 * n:(2 + d) * n], ws[(2 + d) * n:]]
    out = torch.empty_like(q)
    _run("residual_attention_decode", decode_kernel(q.dtype, r, d, hq // hkv),
         code,
         _ptr(q), _ptr(k_base), _ptr(v_base), _ptr(k_res), _ptr(v_res),
         _ptr(b_k), _ptr(b_v), _ptr(sin), _ptr(cos), _ptr(kv_len),
         *map(_ptr, parts), _ptr(out), bsz, sk, hq, hkv, d, r, n_split,
         float(scale), int(window), _stream(q))
    return out
