"""Dispatchers for paged ResidualAttention (port of ``repro/kernels/ops.py``).

The serving executor calls these with the reference's signatures.  They
dispatch by the tensors' device and by nothing else:

* CPU tensors go to the plain PyTorch versions (:mod:`.ref`);
* CUDA tensors go to the hand-written kernels
  (:mod:`.paged_residual_attention`), which launch or raise.

Pass ``kr_pool=None`` (with ``vr_pool``/``b_k``/``b_v``/``bt_r`` also None)
for the base-only variants used by the unified-cache baselines.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import paged_residual_attention as pra
from repro_torch.kernels import ref as ref_mod


def _on_cpu(q: torch.Tensor) -> bool:
    if q.device.type == "cpu":
        return True
    if q.device.type == "cuda":
        return False
    raise ValueError(f"no paged attention for device {q.device}")


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
