"""Dispatchers for ResidualAttention (port of ``repro/kernels/ops.py``)
and the RG-LRU scan.

The dense and hybrid models and the serving executor call these with the
reference's signatures.  They dispatch by the tensors' device and by
nothing else:

* CPU tensors go to the plain PyTorch versions (:mod:`.ref`), and so do
  ``meta`` tensors (the dry run's abstract steps,
  :mod:`repro_torch.launch.steps`), on which they compute shapes only;
* CUDA tensors go to the hand-written kernels
  (:mod:`.residual_attention` over contiguous caches,
  :mod:`.paged_residual_attention` over paged pools, :mod:`.rg_lru` for
  the scan), which launch or raise;
* DTensors (a sharded step, :mod:`repro_torch.launch.steps`) reach the
  scan, which runs on each shard's rows and channels by the rules above.

Pass ``kr_pool=None`` (with ``vr_pool``/``b_k``/``b_v``/``bt_r`` also None)
for the base-only variants used by the unified-cache baselines.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core import shards
from repro_torch.kernels import paged_residual_attention as pra
from repro_torch.kernels import ref as ref_mod
from repro_torch.kernels import residual_attention as ra
from repro_torch.kernels import rg_lru


def _on_cpu(q: torch.Tensor) -> bool:
    """True for the plain versions (CPU, or meta: shapes only), False for
    the card's kernels; raises for any other device."""
    if q.device.type in ("cpu", "meta"):
        return True
    if q.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {q.device}")


def residual_attention(q, k_base, v_base, k_res, v_res, b_k, b_v, sin, cos,
                       *, qpos, kv_len=None, window: int = 0,
                       causal: bool = True,
                       scale: Optional[float] = None) -> torch.Tensor:
    """Attention over a contiguous disaggregated cache (shapes as in
    :func:`repro_torch.kernels.ref.residual_attention_ref`).  On the card,
    Sq = 1 takes the decode kernel, whose query sits at ``kv_len - 1``
    (``qpos`` and ``causal`` are not read, as in the reference), and any
    other Sq the prefill kernel.  ``kv_len=None`` means all of Sk is valid,
    the reference's own meaning on its plain path.  Returns
    (B, Sq, Hq, D)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _on_cpu(q):
        return ref_mod.residual_attention_ref(
            q, k_base, v_base, k_res, v_res, b_k, b_v, sin, cos, qpos=qpos,
            kv_len=kv_len, window=window, causal=causal, scale=scale)
    if kv_len is not None:
        kv_len = kv_len.to(torch.int32)
    if q.shape[1] == 1:
        return ra.residual_attention_decode(
            q[:, 0], k_base, v_base, k_res, v_res, b_k, b_v, sin, cos,
            kv_len, scale=scale, window=window)[:, None]
    return ra.residual_attention_prefill(
        q, k_base, v_base, k_res, v_res, b_k, b_v, sin, cos,
        qpos.to(torch.int32).contiguous(), kv_len, scale=scale,
        causal=causal, window=window)


def rg_lru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """h_t = a_t * h_{t-1} + b_t with an f32 state; a, b: (B, S, W), h0:
    (B, W).  Returns (states in a's dtype, states[:, -1]).  Always through
    :class:`~repro_torch.kernels.rg_lru.RgLruScan`, so a gradient reaches
    a, b and h0: on the card by the forward and backward kernels, on the
    CPU by their plain versions.  On DTensors each shard scans its own
    rows and channels, the sequence dim kept whole."""
    if isinstance(a, DTensor):
        pl = tuple(Replicate() if p == Shard(1) or p.is_partial() else p
                   for p in a.placements)
        h_pl = tuple(Shard(1) if p == Shard(2) else p for p in pl)
        return shards.on_shards(rg_lru_scan, (pl, h_pl), (pl, pl, h_pl), a,
                                b, h0)
    _on_cpu(a)
    return rg_lru.RgLruScan.apply(a.contiguous(), b.contiguous(),
                                  h0.to(a.dtype).contiguous())


def paged_residual_attention(q, kb_pool, vb_pool, kr_pool, vr_pool, b_k,
                             b_v, bt_b, bt_r, kv_len, *,
                             scale: Optional[float] = None,
                             window: int = 0,
                             rope_theta: float = 10_000.0,
                             use_rope: bool = True,
                             kb_scale=None, vb_scale=None) -> torch.Tensor:
    """Decode attention over paged pools + block tables.  ``kv_len`` counts
    all valid tokens incl. the one just written; the query row sits at
    position ``kv_len - 1``.  Returns (B, Hq, D)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _on_cpu(q):
        return ref_mod.paged_residual_attention_ref(
            q, kb_pool, vb_pool, kr_pool, vr_pool, b_k, b_v, bt_b, bt_r,
            kv_len, scale=scale, window=window, rope_theta=rope_theta,
            use_rope=use_rope, kb_scale=kb_scale, vb_scale=vb_scale)
    if kr_pool is None:
        return pra.paged_attention_decode_base(
            q, kb_pool, vb_pool, bt_b, kv_len, scale=scale, window=window,
            kb_scale=kb_scale, vb_scale=vb_scale)
    return pra.paged_residual_attention_decode(
        q, kb_pool, vb_pool, kr_pool, vr_pool, b_k, b_v, bt_b, bt_r,
        kv_len, scale=scale, window=window, rope_theta=rope_theta,
        use_rope=use_rope, kb_scale=kb_scale, vb_scale=vb_scale)


def paged_residual_attention_prefill(q, kb_pool, vb_pool, kr_pool, vr_pool,
                                     b_k, b_v, bt_b, bt_r, start, kv_len, *,
                                     scale: Optional[float] = None,
                                     window: int = 0,
                                     rope_theta: float = 10_000.0,
                                     use_rope: bool = True,
                                     kb_scale=None, vb_scale=None
                                     ) -> torch.Tensor:
    """Chunked-prefill attention over paged pools + block tables.  q is a
    (B, chunk, Hq, D) tile whose K/V is ALREADY written into the pools;
    ``start`` (B,) is the position of each row's first query and
    ``kv_len`` (B,) counts valid tokens including the chunk's writes.
    Rows at or past ``kv_len - start`` are padding the caller ignores (the
    plain version computes them, the kernels zero them).  Returns
    (B, chunk, Hq, D)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _on_cpu(q):
        return ref_mod.paged_residual_attention_prefill_ref(
            q, kb_pool, vb_pool, kr_pool, vr_pool, b_k, b_v, bt_b, bt_r,
            start, kv_len, scale=scale, window=window,
            rope_theta=rope_theta, use_rope=use_rope, kb_scale=kb_scale,
            vb_scale=vb_scale)
    if kr_pool is None:
        return pra.paged_attention_prefill_base(
            q, kb_pool, vb_pool, bt_b, start, kv_len, scale=scale,
            window=window, kb_scale=kb_scale, vb_scale=vb_scale)
    return pra.paged_residual_attention_prefill(
        q, kb_pool, vb_pool, kr_pool, vr_pool, b_k, b_v, bt_b, bt_r,
        start, kv_len, scale=scale, window=window, rope_theta=rope_theta,
        use_rope=use_rope, kb_scale=kb_scale, vb_scale=vb_scale)


def paged_residual_attention_mixed(q, kb_pool, vb_pool, kr_pool, vr_pool,
                                   b_k, b_v, bt_b, bt_r, start, q_len,
                                   kv_len, *, scale: Optional[float] = None,
                                   window: int = 0,
                                   rope_theta: float = 10_000.0,
                                   use_rope: bool = True,
                                   kb_scale=None, vb_scale=None
                                   ) -> torch.Tensor:
    """Unified mixed prefill/decode attention: one launch over rows of
    different q-lengths.  Rows past ``q_len`` come back as exact zeros on
    every device.  ``kv_len`` must equal ``start + q_len`` per row.
    Returns (B, chunk, Hq, D)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _on_cpu(q):
        return ref_mod.paged_residual_attention_mixed_ref(
            q, kb_pool, vb_pool, kr_pool, vr_pool, b_k, b_v, bt_b, bt_r,
            start, q_len, kv_len, scale=scale, window=window,
            rope_theta=rope_theta, use_rope=use_rope, kb_scale=kb_scale,
            vb_scale=vb_scale)
    if kr_pool is None:
        return pra.paged_attention_mixed_base(
            q, kb_pool, vb_pool, bt_b, start, q_len, kv_len, scale=scale,
            window=window, kb_scale=kb_scale, vb_scale=vb_scale)
    return pra.paged_residual_attention_mixed(
        q, kb_pool, vb_pool, kr_pool, vr_pool, b_k, b_v, bt_b, bt_r,
        start, q_len, kv_len, scale=scale, window=window,
        rope_theta=rope_theta, use_rope=use_rope, kb_scale=kb_scale,
        vb_scale=vb_scale)
