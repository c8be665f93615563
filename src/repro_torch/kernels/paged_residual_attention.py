"""Paged ResidualAttention on the card: wrappers over the hand-written CUDA
kernels in ``csrc/paged_residual_attention.cu`` and, for the
disaggregated chunked prefill, mixed grid and decode (#5, #1, #2),
``csrc/paged_residual_disagg.cu``; the two build in parallel.

These replace the six Pallas kernels of
``repro/kernels/paged_residual_attention.py``: the unified prefill/decode
grid (mixed and decode) and the phase-separated chunked prefill, each
disaggregated and base-only, and each with its int8 variant: given
``kb_scale``/``vb_scale`` (f32 (P, page, Hkv)), the bCache pools are int8
and every page is dequantized on chip (the Pallas entries' ``quant =
kb_scale is not None`` branch).  Each wrapper checks device, dtype,
contiguity and shapes, raises on anything the kernel does not take,
allocates the output, launches on PyTorch's current stream and raises if
the launch failed.  It never falls back to the plain version; that lives
in :mod:`repro_torch.kernels.ref` and is chosen only for CPU tensors, by
:mod:`repro_torch.kernels.ops`.

Bound on an H100.  A decode row reads every live page of kb/vb (Hkv·D
values per token) and kr/vr (R per token) once and does about 4·G·D
flops per token and kv head: a few flops per byte, far below the card's
~295 bf16 flops/byte ridge, so decode is bound by bytes.  The design
reads each page once for all G query heads of its kv head and rebuilds K
on chip, so the residual adds only R/(Hkv·D) of the base bytes.  A long
prefill row does ~4·tq·G·D flops per token of each page it reads and is
bound by operations; the template runs them as f32 FMAs on the CUDA
cores (67 TFLOP/s peak), far from the 989 TFLOP/s bound.  Redesigns
replace the template where it lost most, in the entries that run them:

* a bf16 launch of a chunked prefill or of a mixed grid
  (``MMA_ENTRIES``: #6 and #3, the disaggregated #5 and #1; bf16 or int8
  pages) runs a flash tile on the tensor cores (mma.sync, 128 query rows
  per CTA, 64-key blocks gathered through the block tables; counted as
  ``<entry>[_int8]_mma``); the mixed grids give each row's q_len, the
  chunked prefills derive it; #5's tile, which #1 shares, rebuilds K =
  K_b + RoPE(K_r . B_k) per key block on the tensor cores, with RoPE from
  ``rope_table``, and applies B_v once after the key loop;
* every launch of a decode (``SPLIT_ENTRIES``, any type) runs a split-K
  kernel: each row's live keys are cut into shares, one CTA (#4, up to 8
  query heads, 64-key shares, ``split_plan``) or one warp (#2, up to 16
  heads as an m16 tile, 16-key shares, ``res_split_plan``; in bf16 it
  rebuilds K on the tensor cores and keeps a second accumulator of R
  columns, in f32 it is the template share by share), and a second kernel
  combines the shares' f32 partials from a workspace, #2's applying B_v
  (counted as ``<entry>[_int8]_splitk``).  A CUDA tensor never reaches the
  template through these entries.

LoRA ranks up to ``residual_attention.RANK_CHUNK`` (64) run instances of
RP 16, 32 and 64 padded rank columns; every rank above it the chunked
instances of #5/#1, #2 and the template (``csrc/rank_chunk.cuh``; counted
as ``<counter>_rchunk``), which rebuild a key block's K and V on chip one
rank chunk at a time, so no buffer or accumulator grows with the rank;
#2's then walks its CTA's shares in 64-key blocks with all four warps,
and its combine applies no B_v (V carries it).

Head dims 32, 64, 120 and 128 are taken.  At 120 (h2o-danube-3-4b's) the
bf16 tiles (#6, #3, #5, #1) and #2's group tile run D 128's columns in the
split-half layout of the dense kernels (``residual_attention.tile_columns``,
``flash::Cols``): RoPE pairs c with c + 60, so the halves go to tile
columns 0.. and 64.. and the gap columns are zero on chip; q, the pages and
the RoPE table (rows of 60) are read as they are, with 8-byte copies, and
int8 codes are dequantized in groups of 4 (``flash::dequantize_cols``),
since the second half of a row of 120 codes starts at byte 60.  #4 gives
each lane 8 columns in order, 16 lanes to a key as at D 128, the last of
them idle.
The f32 template takes any even head_dim as it is.  Pages of more than
``MAX_PAGE`` tokens run as sub-pages (``sub_pages``): the pools are viewed
as pages of the largest divisor of the page up to ``MAX_PAGE`` and the
block tables expanded, with no page copied.

f32 launches of the tensor-core entries stay on the template; wgmma and
TMA are later work.  The chunked prefill is bound like the mixed grid:
operations for long chunks, bytes for short ones.  Unlike the Pallas
prefill, which holds all G·chunk query
rows of a (row, kv head) in VMEM (16 MB of accumulator at chunk 8192, G
4), it tiles query positions like the mixed grid and skips the tiles at
or past a row's valid count, so a padded chunk costs only its valid rows.
int8 pages halve the base bytes of a bf16 page (plus 4 bytes of scale per
token and head), which is what a bytes-bound decode gains; the template
reads them one byte per load.
"""
from __future__ import annotations

import ctypes
import functools
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import torch

from repro_torch.core import rope as rope_lib
from repro_torch.core.device import SMEM_PER_CTA_RESERVED, SMEM_PER_SM, \
    sm_count
from repro_torch.kernels import _build
from repro_torch.kernels import residual_attention as ra

ENTRIES = ("paged_residual_attention_mixed",
           "paged_residual_attention_decode",
           "paged_residual_attention_prefill",
           "paged_attention_mixed_base",
           "paged_attention_decode_base",
           "paged_attention_prefill_base")
# Entries whose bf16 launches run a tensor-core kernel (bf16 or int8
# pages); their f32 launches run the template.
MMA_ENTRIES = ("paged_attention_prefill_base", "paged_attention_mixed_base",
               "paged_residual_attention_prefill",
               "paged_residual_attention_mixed")
# Entries whose every launch runs a split-K decode.
SPLIT_ENTRIES = ("paged_attention_decode_base",
                 "paged_residual_attention_decode")
# Entries with the residual stream, and so a LoRA rank.
RES_ENTRIES = ENTRIES[:3]


def kernel_name(entry: str, dtype: torch.dtype, int8: bool,
                r: Optional[int] = None) -> str:
    """The kernel, by its launch counter, that entry ``entry`` runs with q
    in ``dtype`` over int8 (``int8``) or full-precision pages at LoRA rank
    ``r``: a split-K decode for ``SPLIT_ENTRIES`` in every type, a
    tensor-core kernel for bf16 launches of ``MMA_ENTRIES``, else the
    template (f32 stays IEEE f32; the tensor cores have no such mode);
    ``_rchunk`` after the name of a ``RES_ENTRIES`` entry's chunked
    instance (a rank above ``RANK_CHUNK``).  The base entries have no
    rank: ``r`` is ignored there, and None means no rank."""
    name = f"{entry}_int8" if int8 else entry
    if entry in SPLIT_ENTRIES:
        name = f"{name}_splitk"
    elif entry in MMA_ENTRIES and dtype == torch.bfloat16:
        name = f"{name}_mma"
    if entry in RES_ENTRIES and r is not None and ra.rank_chunked(r):
        name = f"{name}_rchunk"
    return name


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Launches of each kernel, the int8 variants apart under "<entry>_int8",
# the tensor-core kernel under "<entry>[_int8]_mma" and the split-K decode
# under "<entry>[_int8]_splitk".  ``chip_smoke.py`` zeroes these before it
# serves and reads them after, to show the serving path went through the
# kernels.
LAUNCHES: Dict[str, int] = {
    kernel_name(e, dt, i8, r): 0 for r in (None, ra.RANK_CHUNK + 1)
    for i8 in (False, True) for e in ENTRIES for dt in _DTYPES}

SOURCE = "paged_residual_attention"
# the sources under csrc/, and the entries that live in the second
SOURCES = (SOURCE, "paged_residual_disagg")
_ENTRY_SOURCE = {"paged_residual_attention_prefill": SOURCES[1],
                 "paged_residual_attention_mixed": SOURCES[1],
                 "paged_residual_attention_decode": SOURCES[1]}
# the head_dims each kernel has an instance of (120 in D 128's tile,
# ``residual_attention.tile_dim``)
HEAD_DIMS = (32, 64, 120, 128)
MAX_ROWS = 64          # query rows (positions x group heads) per CTA
MMA_ROWS = 128         # the same for the tensor-core kernel (8 warps)
MAX_PAGE = 32          # tokens per page a kernel takes; larger: sub-pages
SPLIT_KEYS = 64        # a decode split's share of keys: multiples of this
SPLIT_HEADS = 8        # query heads per split-K CTA, at most
# resident split-K CTAs per SM, by query heads per CTA: the kernel's
# __launch_bounds__ minimum (min_blocks in the .cu)
SPLIT_CTAS_PER_SM = {1: 4, 2: 4, 4: 4, 8: 2}
# The split-K decode with the residual stream (#2): a share is a multiple
# of RES_SPLIT_KEYS keys (the bf16 kernel's warp step), a CTA of
# RES_SPLIT_WARPS warps takes that many shares, and up to RES_SPLIT_HEADS
# query heads (one m16 tile); its shared memory (``res_split_smem``)
# decides how many CTAs an SM holds.
RES_SPLIT_KEYS = 16
RES_SPLIT_WARPS = 4
RES_SPLIT_HEADS = 16

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "paged_residual_attention_mixed":
        [_I] + [_P] * 17 + [_I] * 9 + [_F, _I, _F, _I, _P],
    "paged_residual_attention_decode":
        [_I] + [_P] * 19 + [_I] * 8 + [_F, _I, _F, _I, _P],
    "paged_residual_attention_prefill":
        [_I] + [_P] * 16 + [_I] * 9 + [_F, _I, _F, _I, _P],
    "paged_attention_mixed_base":
        [_I] + [_P] * 10 + [_I] * 8 + [_F, _I, _P],
    "paged_attention_decode_base":
        [_I] + [_P] * 11 + [_I] * 7 + [_F, _I, _P],
    "paged_attention_prefill_base":
        [_I] + [_P] * 9 + [_I] * 8 + [_F, _I, _P],
}


@functools.lru_cache(maxsize=None)
def _lib(source: str) -> ctypes.CDLL:
    lib = _build.load(source)
    for name, argtypes in _SIGNATURES.items():
        if _ENTRY_SOURCE.get(name, SOURCE) == source:
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile and load the kernels now, one nvcc per source, together
    (they are built at first use otherwise)."""
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(_lib, SOURCES))


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


def check_heads(hq: int, hkv: int, d: int, page: int) -> int:
    """The head and page geometry every wrapper takes: head_dim in
    ``HEAD_DIMS``, Hq a multiple of Hkv with at most ``MAX_ROWS`` query heads
    per kv head, pages of at least one token (above ``MAX_PAGE``, as
    ``sub_pages``).  Returns the group size; raises ValueError for anything
    else."""
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported "
                         f"({', '.join(map(str, HEAD_DIMS))})")
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    g = hq // hkv
    if g > MAX_ROWS:
        raise ValueError(f"group size {g} > {MAX_ROWS}")
    if page < 1:
        raise ValueError(f"page size {page} < 1")
    return g


def sub_page(page: int) -> int:
    """Tokens per page that the kernels run a page of ``page`` at: the
    page itself up to ``MAX_PAGE``, else its largest divisor up to it."""
    if page <= MAX_PAGE:
        return page
    return max(s for s in range(1, MAX_PAGE + 1) if page % s == 0)


def sub_pages(kb_pool, vb_pool, kb_scale, vb_scale, kr_pool, vr_pool, bt_b,
              bt_r):
    """Pages of p > ``MAX_PAGE`` tokens as p/s pages of s = ``sub_page(p)``
    tokens, without copying a page: the pools (and the int8 scale pools)
    viewed as (P·p/s, s, ...), and each block table entry e expanded on
    the pools' device to e·(p/s) + j, j = 0..p/s-1.  Anything else comes
    back as it is (absent tensors as None; a pool that is not contiguous
    as it is, for the wrapper's checks to refuse)."""
    p = kb_pool.shape[1]
    s = sub_page(p)
    if s == p or not all(t is None or t.is_contiguous() for t in (
            kb_pool, vb_pool, kb_scale, vb_scale, kr_pool, vr_pool)):
        return kb_pool, vb_pool, kb_scale, vb_scale, kr_pool, vr_pool, \
            bt_b, bt_r
    n = p // s

    def view(t):
        return None if t is None else t.view(
            (t.shape[0] * n, s) + tuple(t.shape[2:]))

    def expand(bt):
        if bt is None:
            return None
        j = torch.arange(n, device=bt.device, dtype=bt.dtype)
        return (bt[:, :, None] * n + j).reshape(bt.shape[0], -1)

    return (view(kb_pool), view(vb_pool), view(kb_scale), view(vb_scale),
            view(kr_pool), view(vr_pool), expand(bt_b), expand(bt_r))


def _geometry(q, kb_pool, vb_pool, bt_b, kv_len, kb_scale, vb_scale,
              window, decode: bool):
    """Shared checks; returns (bsz, sq, hq, hkv, d, page, w, g, dtype code).
    The pools are in q's dtype, or int8 with both f32 scale pools
    (P, page, Hkv)."""
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got "
                         f"{q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if (kb_scale is None) != (vb_scale is None):
        raise ValueError("kb_scale and vb_scale go together")
    dev, dt = q.device, q.dtype
    pool_dt = dt if kb_scale is None else torch.int8
    if kb_scale is None and kb_pool is not None and \
            kb_pool.dtype == torch.int8:
        raise ValueError("int8 bCache pools need kb_scale and vb_scale")
    _check("q", q, dev, dt, 3 if decode else 4)
    _check("kb_pool", kb_pool, dev, pool_dt, 4)
    _check("vb_pool", vb_pool, dev, pool_dt, 4)
    if vb_pool.shape != kb_pool.shape:
        raise ValueError("kb_pool and vb_pool shapes differ")
    if kb_scale is not None:
        for name, t in (("kb_scale", kb_scale), ("vb_scale", vb_scale)):
            _check(name, t, dev, torch.float32, 3)
            if t.shape != kb_pool.shape[:3]:
                raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                                 f"expected {tuple(kb_pool.shape[:3])}")
    _check("bt_b", bt_b, dev, torch.int32, 2)
    _check("kv_len", kv_len, dev, torch.int32, 1)
    bsz = q.shape[0]
    sq = 1 if decode else q.shape[1]
    hq, d = q.shape[-2], q.shape[-1]
    page, hkv = kb_pool.shape[1], kb_pool.shape[2]
    if kb_pool.shape[3] != d:
        raise ValueError("pool head_dim differs from q's")
    g = check_heads(hq, hkv, d, page)
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
    ra.rank_instance(r)         # refuses a rank below 1, by name
    for name, t in (("b_k", b_k), ("b_v", b_v)):
        if tuple(t.shape) != (bsz, r, hkv * d):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{(bsz, r, hkv * d)}")
    if tuple(bt_r.shape) != (bsz, w):
        raise ValueError("bt_r shape differs from bt_b's")
    return r


def _check_rows(start, q_len, bsz, dev):
    """``q_len=None``: the chunked prefill, whose q-lengths the kernel
    derives from ``kv_len - start``."""
    _check("start", start, dev, torch.int32, 1)
    if start.shape[0] != bsz:
        raise ValueError("start batch differs from q's")
    if q_len is not None:
        _check("q_len", q_len, dev, torch.int32, 1)
        if q_len.shape[0] != bsz:
            raise ValueError("q_len batch differs from q's")


def tile_positions(entry: str, dtype: torch.dtype, group: int,
                   sq: int) -> int:
    """Query positions per CTA of the kernel that ``entry`` runs in
    ``dtype``: its row budget (``MMA_ROWS`` for a tensor-core kernel, else
    ``MAX_ROWS``) over the group, at most Sq."""
    mma = kernel_name(entry, dtype, False).endswith("_mma")
    return max(1, min(sq, (MMA_ROWS if mma else MAX_ROWS) // group))


def split_heads(group: int) -> int:
    """Query heads per split-K CTA: the group rounded up to a power of
    two, at most ``SPLIT_HEADS`` (a larger group takes several CTAs)."""
    gt = 1
    while gt < min(group, SPLIT_HEADS):
        gt *= 2
    return gt


def decode_splits(bsz: int, groups: int, w: int, page: int,
                  sm_count: int, heads: int) -> int:
    """Splits of each row's keys for a decode launch of ``bsz`` rows x
    ``groups`` CTAs per row (Hkv x the head tiles of a group, ``heads``
    query heads each) over tables ``w`` pages wide: as many as fill the
    card's resident CTA slots (``SPLIT_CTAS_PER_SM[heads]`` per SM) in one
    pass, so no CTA waits for a second wave; at least one, and no more
    than a full table has ``SPLIT_KEYS``-key shares."""
    fit = SPLIT_CTAS_PER_SM[heads] * sm_count // max(1, bsz * groups)
    most = -(-w * page // SPLIT_KEYS)
    return max(1, min(fit, most))


def split_plan(bsz: int, hq: int, hkv: int, d: int, w: int, page: int,
               sm_count: int) -> Dict[str, object]:
    """The split-K decode's launch: its split count, the two kernels'
    grids and the f32 workspace bytes (m, l and acc partials)."""
    g = hq // hkv
    heads = split_heads(g)
    groups = hkv * -(-g // heads)
    n_split = decode_splits(bsz, groups, w, page, sm_count, heads)
    return dict(n_split=n_split, heads=heads,
                grid=(n_split, groups, bsz),
                combine_grid=-(-bsz * hq * d // 128),
                workspace_bytes=4 * bsz * hq * n_split * (d + 2))


def res_split_smem(d: int, r: int, int8: bool) -> int:
    """Shared-memory bytes of one CTA of the split-K decode with the
    residual stream, block-table slices aside (``Layout`` of
    ``splitk_res`` in the source): B_k (RP rows), and per warp two stages
    of 16 keys' K, V, K_r, V_r and RoPE rows (+ a bf16 V tile for int8
    pages).  Rows are padded by 8 elements; at the tile's width
    (``residual_attention.tile_dim``).  Above ``RANK_CHUNK``: Q's 16 rows
    and one 64-key block of the chunked instance
    (``residual_attention.chunk_block_smem``)."""
    d = ra.tile_dim(d)
    if ra.rank_chunked(r):
        return 2 * RES_SPLIT_HEADS * (d + 8) + ra.chunk_block_smem(
            d, RES_SPLIT_KEYS * RES_SPLIT_WARPS, int8)
    rp = ra.rank_instance(r)
    ds, rs, hs, keys = d + 8, rp + 8, d // 2 + 8, RES_SPLIT_KEYS
    row = d if int8 else 2 * ds
    stage = keys * (2 * row + (8 if int8 else 0) + 4 * rs + 4 * hs)
    warp = 2 * stage + (2 * keys * ds if int8 else 0)
    return 2 * rp * ds + RES_SPLIT_WARPS * warp


def res_ctas_per_sm(d: int, r: int, int8: bool) -> int:
    """Resident CTAs per SM of the split-K decode with the residual
    stream, as its shared memory allows (2 KB left for the block-table
    slices), at most 3."""
    need = res_split_smem(d, r, int8) + SMEM_PER_CTA_RESERVED + 2048
    return max(1, min(3, SMEM_PER_SM // need))


def res_split_plan(bsz: int, hq: int, hkv: int, d: int, r: int, w: int,
                   page: int, int8: bool, sm_count: int) -> Dict[str, object]:
    """The launch of the split-K decode with the residual stream (#2):
    ``n_split`` shares of each row's live keys, RES_SPLIT_WARPS per CTA,
    with as many CTAs per (row, head tile) as fill the card's resident
    slots (``res_ctas_per_sm``) in one pass, and no more than a full table
    has 64-key CTA ranges; the bf16 kernel's and the combine's grids; the
    f32 workspace bytes (m, l, acc and acc_r partials).  f32 launches run
    the template one CTA per share, over the same shares."""
    g = hq // hkv
    groups = hkv * -(-g // RES_SPLIT_HEADS)
    ctas = res_ctas_per_sm(d, r, int8)
    fit = ctas * sm_count // max(1, bsz * groups)
    most = -(-w * page // (RES_SPLIT_KEYS * RES_SPLIT_WARPS))
    cta_splits = max(1, min(fit, most))
    n_split = cta_splits * RES_SPLIT_WARPS
    return dict(n_split=n_split, ctas_per_sm=ctas,
                grid=(cta_splits, groups, bsz), combine_grid=bsz * hq,
                workspace_bytes=4 * bsz * hq * n_split * (d + r + 2))


ROPE_TABLE_ROWS = 4096      # rows of a RoPE table, at least
_ROPE_TABLES: Dict[tuple, torch.Tensor] = {}


def rope_table(device: torch.device, d: int, theta: float,
               dtype: torch.dtype, rows: int,
               use_rope: bool = True) -> torch.Tensor:
    """(2, N, D/2): sin, then cos, of positions 0..N-1 as the plain
    version computes them (``core/rope.rope_sincos``) rounded to
    ``dtype``, as it rounds them; sin 0 and cos 1 without RoPE, which the
    kernels' rotation passes through unchanged.  N is a power of two, at
    least ``ROPE_TABLE_ROWS`` and ``rows`` (the launch's W * page).  Built
    once per (device, D, theta, dtype, use_rope) and rebuilt larger when a
    launch needs more rows (1 MB at 4096 rows, D 128, bf16)."""
    key = (str(device), d, float(theta), dtype, bool(use_rope))
    table = _ROPE_TABLES.get(key)
    if table is None or table.shape[1] < rows:
        n = ROPE_TABLE_ROWS
        while n < rows:
            n *= 2
        if use_rope:
            sin, cos = rope_lib.rope_sincos(
                torch.arange(n, device=device), d, theta)
        else:
            sin = torch.zeros(n, d // 2, device=device)
            cos = torch.ones(n, d // 2, device=device)
        table = torch.stack([sin, cos]).to(dtype).contiguous()
        _ROPE_TABLES[key] = table
    return table


def _run(name: str, counter: str, *args) -> None:
    """Launch entry ``name``; the count goes to ``counter``, the kernel it
    runs (``kernel_name``)."""
    err = getattr(_lib(_ENTRY_SOURCE.get(name, SOURCE)), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[counter] += 1


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """Device address; None (a null pointer) for an absent tensor."""
    return None if t is None else t.data_ptr()


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
    (repro/kernels/paged_residual_attention.py:764), and given
    ``kb_scale``/``vb_scale`` its int8 branch (:787).

    q: (B, Sq, Hq, D); kb/vb: (P, page, Hkv, D) in q's dtype, or int8 with
    kb_scale/vb_scale (P, page, Hkv) f32; kr/vr: (Pr, page, R);
    b_k/b_v: (B, R, Hkv·D); bt_b/bt_r: (B, W) int32; start/q_len/kv_len:
    (B,) int32 with ``kv_len = start + q_len``.  Rows at or past q_len come
    back as exact zeros.  bf16 runs #5's tensor-core tile with each row's
    q_len given (K rebuilt per key block on chip, RoPE from
    ``rope_table``; a tile with no row below q_len only zeroes its rows),
    f32 the template.  Returns (B, Sq, Hq, D).  Bound: bytes for decode
    rows, operations for long prefill rows (module docstring)."""
    ra.refuse_grad("paged_residual_attention_mixed", q, kb_pool, vb_pool,
                   kr_pool, vr_pool, b_k, b_v)
    kb_pool, vb_pool, kb_scale, vb_scale, kr_pool, vr_pool, bt_b, bt_r = \
        sub_pages(kb_pool, vb_pool, kb_scale, vb_scale, kr_pool, vr_pool,
                  bt_b, bt_r)
    bsz, sq, hq, hkv, d, page, w, g, code = _geometry(
        q, kb_pool, vb_pool, bt_b, kv_len, kb_scale, vb_scale, window,
        decode=False)
    r = _check_residual(q, kr_pool, vr_pool, b_k, b_v, bt_r, bsz, hkv, d,
                        page, w)
    _check_rows(start, q_len, bsz, q.device)
    tq = tile_positions("paged_residual_attention_mixed", q.dtype, g, sq)
    table = rope_table(q.device, d, rope_theta, q.dtype, w * page,
                       use_rope) if q.dtype == torch.bfloat16 else None
    out = torch.empty_like(q)
    _run("paged_residual_attention_mixed",
         kernel_name("paged_residual_attention_mixed", q.dtype,
                     kb_scale is not None, r),
         code, _ptr(q),
         _ptr(kb_pool), _ptr(vb_pool), _ptr(kb_scale), _ptr(vb_scale),
         _ptr(kr_pool), _ptr(vr_pool), _ptr(b_k), _ptr(b_v),
         _ptr(None if table is None else table[0]),
         _ptr(None if table is None else table[1]), _ptr(bt_b), _ptr(bt_r),
         _ptr(start), _ptr(q_len), _ptr(kv_len), _ptr(out), bsz, sq, hq,
         hkv, d, r, page, w, tq, float(scale), int(window),
         float(rope_theta), int(use_rope), _stream(q))
    return out


def paged_residual_attention_decode(q, kb_pool, vb_pool, kr_pool, vr_pool,
                                    b_k, b_v, bt_b, bt_r, kv_len, *,
                                    scale: float, window: int = 0,
                                    rope_theta: float = 10_000.0,
                                    use_rope: bool = True, kb_scale=None,
                                    vb_scale=None) -> torch.Tensor:
    """Decode over paged disaggregated pools: one query row per request at
    position ``kv_len - 1``.  Replaces ``paged_residual_attention_decode``
    (repro/kernels/paged_residual_attention.py:206), and given
    ``kb_scale``/``vb_scale`` its int8 branch (:231).  Runs, in every type,
    the split-K decode with the residual stream (``res_split_plan``) and
    its combine, which applies B_v, with a workspace of
    ``res_split_plan(...)["workspace_bytes"]``; RoPE comes from
    ``rope_table`` in q's type.

    q: (B, Hq, D); pools and tables as the mixed kernel; kv_len: (B,)
    int32.  Returns (B, Hq, D).  Bound: bytes (module docstring)."""
    ra.refuse_grad("paged_residual_attention_decode", q, kb_pool, vb_pool,
                   kr_pool, vr_pool, b_k, b_v)
    kb_pool, vb_pool, kb_scale, vb_scale, kr_pool, vr_pool, bt_b, bt_r = \
        sub_pages(kb_pool, vb_pool, kb_scale, vb_scale, kr_pool, vr_pool,
                  bt_b, bt_r)
    bsz, _, hq, hkv, d, page, w, _, code = _geometry(
        q, kb_pool, vb_pool, bt_b, kv_len, kb_scale, vb_scale, window,
        decode=True)
    r = _check_residual(q, kr_pool, vr_pool, b_k, b_v, bt_r, bsz, hkv, d,
                        page, w)
    n_split = res_split_plan(bsz, hq, hkv, d, r, w, page,
                             kb_scale is not None,
                             sm_count(q.device.index))["n_split"]
    # f32 partials: m and l (B, Hq, n_split), acc (..., D), acc_r (..., R)
    n = bsz * hq * n_split
    ws = torch.empty(n * (d + r + 2), dtype=torch.float32, device=q.device)
    table = rope_table(q.device, d, rope_theta, q.dtype, w * page, use_rope)
    out = torch.empty_like(q)
    _run("paged_residual_attention_decode",
         kernel_name("paged_residual_attention_decode", q.dtype,
                     kb_scale is not None, r),
         code, _ptr(q),
         _ptr(kb_pool), _ptr(vb_pool), _ptr(kb_scale), _ptr(vb_scale),
         _ptr(kr_pool), _ptr(vr_pool), _ptr(b_k), _ptr(b_v), _ptr(table[0]),
         _ptr(table[1]), _ptr(bt_b), _ptr(bt_r), _ptr(kv_len), _ptr(ws[:n]),
         _ptr(ws[n:2 * n]),
         _ptr(ws[2 * n:(2 + d) * n]), _ptr(ws[(2 + d) * n:]), _ptr(out),
         bsz, hq, hkv, d, r, page, w, n_split, float(scale), int(window),
         float(rope_theta), int(use_rope), _stream(q))
    return out


def paged_residual_attention_prefill(q, kb_pool, vb_pool, kr_pool, vr_pool,
                                     b_k, b_v, bt_b, bt_r, start, kv_len, *,
                                     scale: float, window: int = 0,
                                     rope_theta: float = 10_000.0,
                                     use_rope: bool = True, kb_scale=None,
                                     vb_scale=None) -> torch.Tensor:
    """Phase-separated chunked prefill over paged disaggregated pools; the
    chunk's own K/V is already written into them.  Replaces
    ``paged_residual_attention_prefill``
    (repro/kernels/paged_residual_attention.py:488), and given
    ``kb_scale``/``vb_scale`` its int8 branch (:516).  Each row's
    q-length is clamp(kv_len - start, 0, chunk), computed in the kernel.
    bf16 runs the tensor-core tile (K rebuilt per key block on chip, RoPE
    from ``rope_table``), f32 the template.

    q: (B, chunk, Hq, D); pools, tables and B_k/B_v as the mixed kernel;
    start: (B,) int32 position of each row's first query; kv_len: (B,)
    int32 = start + n_valid.  Rows at or past n_valid are rows the caller
    ignores: they come back as zeros and their tiles are skipped.  Returns
    (B, chunk, Hq, D).  Bound: operations for long chunks, bytes for short
    ones (module docstring)."""
    ra.refuse_grad("paged_residual_attention_prefill", q, kb_pool, vb_pool,
                   kr_pool, vr_pool, b_k, b_v)
    kb_pool, vb_pool, kb_scale, vb_scale, kr_pool, vr_pool, bt_b, bt_r = \
        sub_pages(kb_pool, vb_pool, kb_scale, vb_scale, kr_pool, vr_pool,
                  bt_b, bt_r)
    bsz, sq, hq, hkv, d, page, w, g, code = _geometry(
        q, kb_pool, vb_pool, bt_b, kv_len, kb_scale, vb_scale, window,
        decode=False)
    r = _check_residual(q, kr_pool, vr_pool, b_k, b_v, bt_r, bsz, hkv, d,
                        page, w)
    _check_rows(start, None, bsz, q.device)
    tq = tile_positions("paged_residual_attention_prefill", q.dtype, g, sq)
    table = rope_table(q.device, d, rope_theta, q.dtype, w * page,
                       use_rope) if q.dtype == torch.bfloat16 else None
    out = torch.empty_like(q)
    _run("paged_residual_attention_prefill",
         kernel_name("paged_residual_attention_prefill", q.dtype,
                     kb_scale is not None, r),
         code, _ptr(q),
         _ptr(kb_pool), _ptr(vb_pool), _ptr(kb_scale), _ptr(vb_scale),
         _ptr(kr_pool), _ptr(vr_pool), _ptr(b_k), _ptr(b_v),
         _ptr(None if table is None else table[0]),
         _ptr(None if table is None else table[1]), _ptr(bt_b), _ptr(bt_r),
         _ptr(start), _ptr(kv_len), _ptr(out), bsz, sq, hq, hkv, d, r, page,
         w, tq, float(scale), int(window), float(rope_theta), int(use_rope),
         _stream(q))
    return out


def paged_attention_mixed_base(q, kb_pool, vb_pool, bt_b, start, q_len,
                               kv_len, *, scale: float, window: int = 0,
                               kb_scale=None, vb_scale=None) -> torch.Tensor:
    """Base-only unified mixed grid over unified caches (the prefix and
    full_reuse baselines).  Replaces ``paged_attention_mixed_base``
    (repro/kernels/paged_residual_attention.py:910), and given
    ``kb_scale``/``vb_scale`` its int8 branch (:922).  Shapes as
    :func:`paged_residual_attention_mixed` minus the residual stream.  In
    bf16 it runs #6's tensor-core tile with each row's q_len given.
    Bound: bytes for decode rows, operations for long prefill rows."""
    ra.refuse_grad("paged_attention_mixed_base", q, kb_pool, vb_pool)
    kb_pool, vb_pool, kb_scale, vb_scale, _, _, bt_b, _ = sub_pages(
        kb_pool, vb_pool, kb_scale, vb_scale, None, None, bt_b, None)
    bsz, sq, hq, hkv, d, page, w, g, code = _geometry(
        q, kb_pool, vb_pool, bt_b, kv_len, kb_scale, vb_scale, window,
        decode=False)
    _check_rows(start, q_len, bsz, q.device)
    tq = tile_positions("paged_attention_mixed_base", q.dtype, g, sq)
    out = torch.empty_like(q)
    _run("paged_attention_mixed_base",
         kernel_name("paged_attention_mixed_base", q.dtype,
                     kb_scale is not None),
         code, _ptr(q),
         _ptr(kb_pool), _ptr(vb_pool), _ptr(kb_scale), _ptr(vb_scale),
         _ptr(bt_b), _ptr(start), _ptr(q_len), _ptr(kv_len),
         _ptr(out), bsz, sq, hq, hkv, d, page, w, tq, float(scale),
         int(window), _stream(q))
    return out


def paged_attention_decode_base(q, kb_pool, vb_pool, bt_b, kv_len, *,
                                scale: float, window: int = 0,
                                kb_scale=None, vb_scale=None
                                ) -> torch.Tensor:
    """Base-only paged decode.  Replaces ``paged_attention_decode_base``
    (repro/kernels/paged_residual_attention.py:345), and given
    ``kb_scale``/``vb_scale`` its int8 branch (:363).  Shapes as
    :func:`paged_residual_attention_decode` minus the residual stream.
    Runs the split-K decode (``split_plan``) and its combine, with a
    workspace of ``split_plan(...)["workspace_bytes"]``.  Bound: bytes."""
    ra.refuse_grad("paged_attention_decode_base", q, kb_pool, vb_pool)
    kb_pool, vb_pool, kb_scale, vb_scale, _, _, bt_b, _ = sub_pages(
        kb_pool, vb_pool, kb_scale, vb_scale, None, None, bt_b, None)
    bsz, _, hq, hkv, d, page, w, _, code = _geometry(
        q, kb_pool, vb_pool, bt_b, kv_len, kb_scale, vb_scale, window,
        decode=True)
    n_split = split_plan(bsz, hq, hkv, d, w, page,
                         sm_count(q.device.index))["n_split"]
    # f32 partials: m and l (B, Hq, n_split), acc (B, Hq, n_split, D)
    n = bsz * hq * n_split
    ws = torch.empty(n * (d + 2), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    _run("paged_attention_decode_base",
         kernel_name("paged_attention_decode_base", q.dtype,
                     kb_scale is not None),
         code, _ptr(q),
         _ptr(kb_pool), _ptr(vb_pool), _ptr(kb_scale), _ptr(vb_scale),
         _ptr(bt_b), _ptr(kv_len), _ptr(ws[:n]), _ptr(ws[n:2 * n]),
         _ptr(ws[2 * n:]), _ptr(out), bsz, hq, hkv, d, page, w, n_split,
         float(scale), int(window), _stream(q))
    return out


def paged_attention_prefill_base(q, kb_pool, vb_pool, bt_b, start, kv_len,
                                 *, scale: float, window: int = 0,
                                 kb_scale=None, vb_scale=None
                                 ) -> torch.Tensor:
    """Base-only chunked prefill: the prefix and full_reuse baselines'
    phase-separated prefill and the broadcast-fork base trajectory
    (B = 1).  Replaces ``paged_attention_prefill_base``
    (repro/kernels/paged_residual_attention.py:633), and given
    ``kb_scale``/``vb_scale`` its int8 branch (:645).  Shapes as
    :func:`paged_residual_attention_prefill` minus the residual stream.
    Bound: operations for long chunks, bytes for short ones."""
    ra.refuse_grad("paged_attention_prefill_base", q, kb_pool, vb_pool)
    kb_pool, vb_pool, kb_scale, vb_scale, _, _, bt_b, _ = sub_pages(
        kb_pool, vb_pool, kb_scale, vb_scale, None, None, bt_b, None)
    bsz, sq, hq, hkv, d, page, w, g, code = _geometry(
        q, kb_pool, vb_pool, bt_b, kv_len, kb_scale, vb_scale, window,
        decode=False)
    _check_rows(start, None, bsz, q.device)
    tq = tile_positions("paged_attention_prefill_base", q.dtype, g, sq)
    out = torch.empty_like(q)
    _run("paged_attention_prefill_base",
         kernel_name("paged_attention_prefill_base", q.dtype,
                     kb_scale is not None),
         code, _ptr(q),
         _ptr(kb_pool), _ptr(vb_pool), _ptr(kb_scale), _ptr(vb_scale),
         _ptr(bt_b), _ptr(start), _ptr(kv_len), _ptr(out),
         bsz, sq, hq, hkv, d, page, w, tq, float(scale), int(window),
         _stream(q))
    return out
