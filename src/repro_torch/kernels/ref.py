"""Plain PyTorch versions of the paged ResidualAttention kernels (port of
``repro/kernels/ref.py``).

Computes attention over a *disaggregated* KV cache:

    K = K_base + RoPE(K_res @ B_k)
    V = V_base + V_res @ B_v
    O = softmax(Q K^T / sqrt(d)) V

The CUDA kernels rebuild K/V one page at a time on chip with two
accumulators; these versions gather the block-table pages into contiguous
views and materialise everything, which makes them the correctness
reference.  They run on any device.  The dispatchers in
:mod:`repro_torch.kernels.ops` send CPU tensors here; on the card they are
called only to check the kernels.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core import rope as rope_lib

NEG_INF = -1e30

# Calls of each plain version; the serving path on the card must leave
# these at 0.
LAUNCHES: Dict[str, int] = {
    "paged_residual_attention_ref": 0,
    "paged_residual_attention_mixed_ref": 0,
    "paged_residual_attention_prefill_ref": 0,
}


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B, Sq, Hq, D), k: (B, Sk, Hkv, D) -> (B, Hq, Sq, Sk)."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    qg = q.reshape(b, sq, hkv, group, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                     k.to(torch.float32))
    return s.reshape(b, hq, sq, k.shape[1])


def _gqa_out(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p: (B, Hq, Sq, Sk), v: (B, Sk, Hkv, D) -> (B, Sq, Hq, D)."""
    b, hq, sq, sk = p.shape
    hkv = v.shape[2]
    group = hq // hkv
    pg = p.reshape(b, hkv, group, sq, sk)
    o = torch.einsum("bhgqk,bkhd->bqhgd", pg, v.to(torch.float32))
    return o.reshape(b, sq, hq, v.shape[-1])


def reconstruct(k_base, v_base, k_res, v_res, b_k, b_v, sin, cos):
    """Materialise full K, V from disaggregated parts.

    k_base/v_base: (B, Sk, Hkv, D); k_res/v_res: (B, Sk, R)
    b_k/b_v: (B, R, Hkv*D) per-request adapter up-projections
    sin/cos: (B, Sk, D//2)
    """
    bsz, sk, hkv, d = k_base.shape
    k_lora = torch.einsum("bsr,brn->bsn", k_res.to(torch.float32),
                          b_k.to(torch.float32)).reshape(bsz, sk, hkv, d)
    k_lora = rope_lib.apply_rope(k_lora, sin, cos)
    v_lora = torch.einsum("bsr,brn->bsn", v_res.to(torch.float32),
                          b_v.to(torch.float32)).reshape(bsz, sk, hkv, d)
    k = k_base.to(torch.float32) + k_lora
    v = v_base.to(torch.float32) + v_lora
    return k.to(k_base.dtype), v.to(v_base.dtype)


def _gather_paged_kv(q, kb_pool, vb_pool, kr_pool, vr_pool, b_k, b_v,
                     bt_b, bt_r, *, rope_theta: float, use_rope: bool,
                     kb_scale=None, vb_scale=None):
    """Gather block-table pages into contiguous (B, Sk, ...) views and, for
    the disaggregated layout, reconstruct full K/V.  ``kb_scale`` /
    ``vb_scale`` ((P, page, Hkv) f32, or None) mark the base pools as int8:
    pages are dequantized right after the gather, before reconstruction."""
    bsz, d = q.shape[0], q.shape[-1]
    page, hkv = kb_pool.shape[1], kb_pool.shape[2]
    sk = bt_b.shape[1] * page
    bt_b = bt_b.long()
    kb = kb_pool[bt_b].reshape(bsz, sk, hkv, d)
    vb = vb_pool[bt_b].reshape(bsz, sk, hkv, d)
    if kb_scale is not None:
        ks = kb_scale[bt_b].reshape(bsz, sk, hkv)[..., None]
        vs = vb_scale[bt_b].reshape(bsz, sk, hkv)[..., None]
        kb = (kb.to(torch.float32) * ks).to(q.dtype)
        vb = (vb.to(torch.float32) * vs).to(q.dtype)
    if kr_pool is None:
        return kb, vb
    bt_r = bt_r.long()
    kr = kr_pool[bt_r].reshape(bsz, sk, -1)
    vr = vr_pool[bt_r].reshape(bsz, sk, -1)
    kpos = torch.arange(sk, device=q.device).expand(bsz, sk)
    if use_rope:
        sin, cos = rope_lib.rope_sincos(kpos, d, rope_theta)
    else:
        sin = torch.zeros(kpos.shape + (d // 2,), dtype=torch.float32,
                          device=q.device)
        cos = torch.ones(kpos.shape + (d // 2,), dtype=torch.float32,
                         device=q.device)
    return reconstruct(kb, vb, kr, vr, b_k, b_v,
                       sin.to(q.dtype), cos.to(q.dtype))


def _masked_softmax_attention(q, k, v, mask, scale):
    """Numerically-stable masked attention.  q: (B, Sq, Hq, D);
    k/v: (B, Sk, Hkv, D); mask: broadcastable to (B, Hq, Sq, Sk)."""
    s = _gqa_scores(q, k) * scale
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-20)
    return _gqa_out(p, v).to(q.dtype)


def paged_residual_attention_ref(q, kb_pool, vb_pool, kr_pool, vr_pool,
                                 b_k, b_v, bt_b, bt_r, kv_len, *,
                                 scale: Optional[float] = None,
                                 window: int = 0,
                                 rope_theta: float = 10_000.0,
                                 use_rope: bool = True,
                                 kb_scale=None,
                                 vb_scale=None) -> torch.Tensor:
    """Paged decode: one query row per request at position ``kv_len - 1``.

    q: (B, Hq, D); kb/vb: (P, page, Hkv, D); kr/vr: (Pr, page, R) or None
    (base-only); b_k/b_v: (B, R, Hkv*D) or None; bt_b/bt_r: (B, W);
    kv_len: (B,); ``window > 0`` keeps only the trailing ``window``
    positions.  Returns (B, Hq, D).
    """
    LAUNCHES["paged_residual_attention_ref"] += 1
    bsz, hq, d = q.shape
    sk = bt_b.shape[1] * kb_pool.shape[1]
    if scale is None:
        scale = d ** -0.5
    k, v = _gather_paged_kv(q, kb_pool, vb_pool, kr_pool, vr_pool, b_k,
                            b_v, bt_b, bt_r, rope_theta=rope_theta,
                            use_rope=use_rope, kb_scale=kb_scale,
                            vb_scale=vb_scale)
    kp = torch.arange(sk, device=q.device)[None, None, None, :]
    # the query sits at kv_len - 1, so the causal bound and the validity
    # bound coincide: one mask term covers both
    kvl = kv_len.to(q.device)[:, None, None, None]
    mask = kp < kvl
    if window > 0:
        mask = mask & (kp > kvl - 1 - window)
    return _masked_softmax_attention(q[:, None], k, v, mask, scale)[:, 0]


def paged_residual_attention_prefill_ref(q, kb_pool, vb_pool, kr_pool,
                                         vr_pool, b_k, b_v, bt_b, bt_r,
                                         start, kv_len, *,
                                         scale: Optional[float] = None,
                                         window: int = 0,
                                         rope_theta: float = 10_000.0,
                                         use_rope: bool = True,
                                         kb_scale=None, vb_scale=None
                                         ) -> torch.Tensor:
    """Paged chunked prefill with the causal-within-chunk + window +
    validity mask.  q: (B, chunk, Hq, D); start: (B,) absolute position of
    each chunk's first query row; kv_len: (B,) valid tokens incl. the
    chunk's writes.  Returns (B, chunk, Hq, D)."""
    LAUNCHES["paged_residual_attention_prefill_ref"] += 1
    bsz, sq, hq, d = q.shape
    sk = bt_b.shape[1] * kb_pool.shape[1]
    if scale is None:
        scale = d ** -0.5
    k, v = _gather_paged_kv(q, kb_pool, vb_pool, kr_pool, vr_pool, b_k,
                            b_v, bt_b, bt_r, rope_theta=rope_theta,
                            use_rope=use_rope, kb_scale=kb_scale,
                            vb_scale=vb_scale)
    qpos = start.to(q.device)[:, None] + torch.arange(sq, device=q.device)
    qp = qpos[:, None, :, None]
    kp = torch.arange(sk, device=q.device)[None, None, None, :]
    mask = (kp <= qp) & (kp < kv_len.to(q.device)[:, None, None, None])
    if window > 0:
        mask = mask & (kp > qp - window)
    return _masked_softmax_attention(q, k, v, mask, scale)


def paged_residual_attention_mixed_ref(q, kb_pool, vb_pool, kr_pool,
                                       vr_pool, b_k, b_v, bt_b, bt_r,
                                       start, q_len, kv_len, *,
                                       scale: Optional[float] = None,
                                       window: int = 0,
                                       rope_theta: float = 10_000.0,
                                       use_rope: bool = True,
                                       kb_scale=None, vb_scale=None
                                       ) -> torch.Tensor:
    """Unified mixed prefill/decode: the prefill version with a per-row
    ``q_len``.  Rows past it are masked out AND written as exact zeros (a
    fully-masked softmax row would otherwise average V).

    q: (B, chunk, Hq, D); start/q_len/kv_len: (B,) with
    ``kv_len = start + q_len``.  Returns (B, chunk, Hq, D).
    """
    LAUNCHES["paged_residual_attention_mixed_ref"] += 1
    bsz, sq, hq, d = q.shape
    sk = bt_b.shape[1] * kb_pool.shape[1]
    if scale is None:
        scale = d ** -0.5
    k, v = _gather_paged_kv(q, kb_pool, vb_pool, kr_pool, vr_pool, b_k,
                            b_v, bt_b, bt_r, rope_theta=rope_theta,
                            use_rope=use_rope, kb_scale=kb_scale,
                            vb_scale=vb_scale)
    rowidx = torch.arange(sq, device=q.device)[None]          # (1, Sq)
    rowvalid = rowidx < q_len.to(q.device)[:, None]           # (B, Sq)
    qpos = start.to(q.device)[:, None] + rowidx
    qp = qpos[:, None, :, None]
    kp = torch.arange(sk, device=q.device)[None, None, None, :]
    mask = (kp <= qp) & (kp < kv_len.to(q.device)[:, None, None, None]) & \
        rowvalid[:, None, :, None]
    if window > 0:
        mask = mask & (kp > qp - window)
    out = _masked_softmax_attention(q, k, v, mask, scale)
    return torch.where(rowvalid[:, :, None, None], out,
                       torch.zeros_like(out))
