"""Plain PyTorch versions of the ResidualAttention kernels, paged and
dense (port of ``repro/kernels/ref.py``), and of the RG-LRU linear scan.

Computes attention over a *disaggregated* KV cache:

    K = K_base + RoPE(K_res @ B_k)
    V = V_base + V_res @ B_v
    O = softmax(Q K^T / sqrt(d)) V

The CUDA kernels rebuild K/V one page (or key block) at a time on chip
with two accumulators; these versions gather the block-table pages into
contiguous views and materialise everything, which makes them the
correctness reference.  They run on any device.  The dispatchers in
:mod:`repro_torch.kernels.ops` send CPU tensors here; on the card they are
called only to check the kernels.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core import rope as rope_lib
from repro_torch.core.attention import NEG_INF, _gqa_out, _gqa_scores

# Calls of each plain version; the serving path on the card must leave
# these at 0.
LAUNCHES: Dict[str, int] = {
    "paged_residual_attention_ref": 0,
    "paged_residual_attention_mixed_ref": 0,
    "paged_residual_attention_prefill_ref": 0,
    "residual_attention_ref": 0,
    "rg_lru_scan_ref": 0,
    "rg_lru_scan_bwd_ref": 0,
}


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


def residual_attention_ref(q, k_base, v_base, k_res, v_res, b_k, b_v,
                           sin, cos, *, qpos: torch.Tensor,
                           kv_len: Optional[torch.Tensor] = None,
                           window: int = 0, causal: bool = True,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Attention over a contiguous disaggregated cache.

    q: (B, Sq, Hq, D), RoPE already applied (queries are computed fresh).
    qpos: (B, Sq) absolute positions of the query rows.
    kv_len: (B,) valid cache lengths (<= Sk), or None for all Sk.
    Returns (B, Sq, Hq, D).
    """
    LAUNCHES["residual_attention_ref"] += 1
    k, v = reconstruct(k_base, v_base, k_res, v_res, b_k, b_v, sin, cos)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = _gqa_scores(q, k) * scale                   # (B, Hq, Sq, Sk)
    kpos = torch.arange(k.shape[1], device=q.device)[None, None, None, :]
    qp = qpos.to(q.device)[:, None, :, None]
    mask = torch.ones(s.shape, dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qp)
    if window > 0:
        mask = mask & (kpos > qp - window)
    if kv_len is not None:
        mask = mask & (kpos < kv_len.to(q.device)[:, None, None, None])
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / torch.sum(p, dim=-1, keepdim=True)
    return _gqa_out(p, v).to(q.dtype)


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


def _carry_dtype(a: torch.Tensor) -> torch.dtype:
    """The scan's carry: f32, or f64 for f64 inputs (``gradcheck``)."""
    return torch.promote_types(a.dtype, torch.float32)


def rg_lru_scan_ref(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """The linear recurrence h_t = a_t * h_{t-1} + b_t, one step at a time
    with an f32 state (f64 for f64 inputs), as the Pallas kernel
    ``repro/kernels/rg_lru.py``
    steps through its blocks.

    a, b: (B, S, W); h0: (B, W).  Returns (states (B, S, W) in a's dtype,
    states[:, -1]), as the Pallas entry returns them.
    """
    LAUNCHES["rg_lru_scan_ref"] += 1
    acc = _carry_dtype(a)
    af, bf = a.to(acc), b.to(acc)
    h = h0.to(acc)
    states = torch.empty(a.shape, dtype=acc, device=a.device)
    for t in range(a.shape[1]):
        h = af[:, t] * h + bf[:, t]
        states[:, t] = h
    states = states.to(a.dtype)
    return states, states[:, -1]


def rg_lru_scan_bwd_ref(a: torch.Tensor, states: torch.Tensor,
                        h0: torch.Tensor, dstates: torch.Tensor,
                        dh_last: torch.Tensor):
    """The gradient of :func:`rg_lru_scan_ref`, one step at a time
    backwards with an f32 carry (f64 for f64 inputs; the plain version of
    ``csrc/rg_lru.cu``'s ``rg_lru_scan_bwd_kernel``): with g the gradient
    reaching h_t, g_S = dstates_S + dh_last, g_t = dstates_t + a_{t+1}
    g_{t+1}, db_t = g_t, da_t = g_t h_{t-1} (h_0 := h0, h_{t-1} read from
    the forward's ``states``) and dh0 = a_1 g_1.

    a, states, dstates: (B, S, W); h0 and dh_last: (B, W).  Returns (da,
    db, dh0) in a's, a's and h0's dtypes."""
    LAUNCHES["rg_lru_scan_bwd_ref"] += 1
    acc = _carry_dtype(a)
    af, hf, gs = a.to(acc), states.to(acc), dstates.to(acc)
    c = dh_last.to(acc)
    da = torch.empty_like(af)
    db = torch.empty_like(af)
    for t in range(a.shape[1] - 1, -1, -1):
        g = gs[:, t] + c
        db[:, t] = g
        da[:, t] = g * (hf[:, t - 1] if t > 0 else h0.to(acc))
        c = af[:, t] * g
    return da.to(a.dtype), db.to(a.dtype), c.to(h0.dtype)
