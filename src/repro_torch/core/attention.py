"""Plain attention building blocks (port of ``repro/core/attention.py``).

The grouped-query score/output products shared by the plain kernel
versions (:mod:`repro_torch.kernels.ref`) and the gather-to-contiguous
serving path, and the blocked ``flash_attention`` that path takes for
long sequences.  This is plain PyTorch on purpose: the reference computes
it with XLA, outside any Pallas kernel.

All functions take (batch, seq, heads, head_dim)-shaped tensors ("BSHD").
GQA is handled by grouping the query heads of each KV head in the einsum.
"""
from __future__ import annotations

import torch

from repro_torch.core import rope as rope_lib

NEG_INF = -1e30
# sequences at least this long on both sides take the blocked path, so the
# (Sq, Sk) score tensor is never materialised whole
FLASH_THRESHOLD = 1024
# key positions at or above this mark empty slots (masked out)
EMPTY_POS = 1 << 30


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B, Sq, Hq, D), k: (B, Sk, Hkv, D) -> (B, Hq, Sq, Sk), f32."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    qg = q.reshape(b, sq, hkv, group, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                     k.to(torch.float32))
    return s.reshape(b, hq, sq, k.shape[1])


def _gqa_out(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p: (B, Hq, Sq, Sk), v: (B, Sk, Hkv, D) -> (B, Sq, Hq, D), f32."""
    b, hq, sq, sk = p.shape
    hkv = v.shape[2]
    group = hq // hkv
    pg = p.reshape(b, hkv, group, sq, sk)
    o = torch.einsum("bhgqk,bkhd->bqhgd", pg, v.to(torch.float32))
    return o.reshape(b, sq, hq, v.shape[-1])


def flash_attention(q, k, v, *, qpos, kpos, window: int = 0,
                    causal: bool = True, scale=None,
                    k_res=None, v_res=None, b_k=None, b_v=None,
                    rope_theta: float = 10_000.0, use_rope: bool = True,
                    q_block: int = 512, kv_block: int = 1024
                    ) -> torch.Tensor:
    """Blocked masked attention with an online softmax: q blocks outer,
    kv blocks inner (the reference's two ``lax.scan`` s as loops).

    q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D); qpos: (B, Sq) and kpos:
    (B, Sk) absolute positions (kpos >= ``EMPTY_POS`` marks an empty slot).
    k_res/v_res: (B, Sk, R) with b_k/b_v: (B, R, Hkv*D) rebuild the
    disaggregated K/V per kv block, RoPE deferred onto the K residual.
    Returns (B, Sq, Hq, D) in q's dtype.
    """
    bsz, sq, hq, d = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = d ** -0.5
    qb = min(q_block, sq)
    kb = min(kv_block, sk)
    outs = []
    for q0 in range(0, sq, qb):
        q_blk, qp = q[:, q0:q0 + qb], qpos[:, q0:q0 + qb]
        n = q_blk.shape[1]
        m = torch.full((bsz, hq, n), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((bsz, hq, n), dtype=torch.float32, device=q.device)
        acc = torch.zeros((bsz, hq, n, d), dtype=torch.float32,
                          device=q.device)
        for k0 in range(0, sk, kb):
            k_blk, v_blk = k[:, k0:k0 + kb], v[:, k0:k0 + kb]
            kp = kpos[:, k0:k0 + kb]
            if k_res is not None:
                k_lora = torch.einsum(
                    "bsr,brn->bsn", k_res[:, k0:k0 + kb].to(torch.float32),
                    b_k.to(torch.float32)).reshape(k_blk.shape)
                if use_rope:
                    sin, cos = rope_lib.rope_sincos(
                        torch.where(kp >= EMPTY_POS, 0, kp), d, rope_theta)
                    k_lora = rope_lib.apply_rope(k_lora, sin, cos)
                v_lora = torch.einsum(
                    "bsr,brn->bsn", v_res[:, k0:k0 + kb].to(torch.float32),
                    b_v.to(torch.float32)).reshape(v_blk.shape)
                k_blk = (k_blk.to(torch.float32) + k_lora).to(k.dtype)
                v_blk = (v_blk.to(torch.float32) + v_lora).to(v.dtype)
            s = _gqa_scores(q_blk, k_blk) * scale          # (B,Hq,qb,kb)
            qq = qp[:, None, :, None]
            kk = kp[:, None, None, :]
            mask = kk < EMPTY_POS
            if causal:
                mask = mask & (kk <= qq)
            if window > 0:
                mask = mask & (kk > qq - window)
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None]) * mask
            l = l * alpha + torch.sum(p, dim=-1)
            acc = acc * alpha[..., None] + _gqa_out(
                p, v_blk).transpose(1, 2)                   # (B,Hq,qb,D)
            m = m_new
        out = acc / torch.clamp(l, min=1e-20)[..., None]
        outs.append(out.transpose(1, 2))                   # (B,qb,Hq,D)
    return torch.cat(outs, dim=1).to(q.dtype)
