"""Plain attention building blocks (port of ``repro/core/attention.py``).

The grouped-query score/output products shared by the plain kernel
versions (:mod:`repro_torch.kernels.ref`), the gather-to-contiguous
serving path and the dense model; masked attention (``mha``) for the
dense model's unified caches; and the blocked ``flash_attention`` and
``banded_window_attention`` that long sequences take.  This is plain
PyTorch on purpose: the reference computes it with XLA, outside any
Pallas kernel.

All functions take (batch, seq, heads, head_dim)-shaped tensors ("BSHD").
GQA is handled by grouping the query heads of each KV head in the einsum.
"""
from __future__ import annotations

from typing import Optional

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


def attention_mask(sq: int, sk: int, *, causal: bool = True,
                   window: int = 0, q_offset: int = 0,
                   device=None) -> torch.Tensor:
    """Boolean (sq, sk) mask.  ``q_offset`` = absolute position of q row 0
    minus that of k row 0 (for decode / chunked prefill).  ``window`` > 0
    restricts to a sliding window of that many past tokens (inclusive)."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window > 0:
        mask = mask & (kpos > qpos - window)
    return mask


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: int = 0, q_offset: int = 0,
        kv_len: Optional[torch.Tensor] = None,
        scale: Optional[float] = None) -> torch.Tensor:
    """Masked (grouped-query) attention.

    kv_len: optional (batch,) valid KV lengths (padding mask for decode).
    Sequences of ``FLASH_THRESHOLD`` or more queries and keys take the
    blocked path, so the (Sq, Sk) score tensor is never materialised whole.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    bsz, sq = q.shape[0], q.shape[1]
    sk = k.shape[1]
    dev = q.device
    if sq >= FLASH_THRESHOLD and sk >= FLASH_THRESHOLD:
        if window > 0 and causal and q_offset == 0 and kv_len is None \
                and sq == sk:
            # contiguous positions: the banded path skips out-of-window
            # blocks
            return banded_window_attention(q, k, v, window=window,
                                           scale=scale)
        qpos = (torch.arange(sq, device=dev) + q_offset).expand(bsz, sq)
        kpos = torch.arange(sk, device=dev).expand(bsz, sk)
        if kv_len is not None:
            kpos = torch.where(kpos < kv_len.to(dev)[:, None], kpos,
                               EMPTY_POS)
        return flash_attention(q, k, v, qpos=qpos, kpos=kpos, window=window,
                               causal=causal, scale=scale)
    s = _gqa_scores(q, k) * scale                      # (B, H, Sq, Sk)
    mask = attention_mask(sq, sk, causal=causal, window=window,
                          q_offset=q_offset, device=dev)
    if kv_len is not None:
        valid = torch.arange(sk, device=dev)[None, :] < \
            kv_len.to(dev)[:, None]                    # (B, Sk)
        mask = mask[None, None] & valid[:, None, None, :]
    else:
        mask = mask[None, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / torch.sum(p, dim=-1, keepdim=True)
    return _gqa_out(p, v).to(q.dtype)


def _products_on_meta(q, k, v, k_res, v_res, b_k, b_v, rebuilds: int):
    """The matrix products of a blocked loop below, on meta tensors (the
    dry run's abstract steps, :mod:`repro_torch.launch.steps`, which
    compute shapes only), in one call each instead of one per block, so a
    FLOP count of the step sees the loop's products without its thousands
    of dispatches: Q.K^T and P.V over every (q, k) pair the loop computes
    (k, v: the keys every q row meets, whole or one band), and the
    residual's rebuild of those keys ``rebuilds`` times (once per q block,
    as the loop rebuilds them).  Returns (B, Sq, Hq, D) in q's dtype."""
    f32 = torch.float32
    if k_res is not None:
        def rebuilt(t, r, b):         # on the graph: a backward counts it
            lora = torch.einsum(
                "qbsr,brn->qbsn",
                r.to(f32).expand((rebuilds,) + tuple(r.shape)), b.to(f32))
            return (t.to(f32) + lora.sum(0).reshape(t.shape)).to(t.dtype)
        k, v = rebuilt(k, k_res, b_k), rebuilt(v, v_res, b_v)
    return _gqa_out(_gqa_scores(q, k), v).to(q.dtype)


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
    if q.device.type == "meta":       # every block, as the loop computes
        return _products_on_meta(q, k, v, k_res, v_res, b_k, b_v,
                                 -(-sq // qb))
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


def banded_window_attention(q, k, v, *, window: int, scale=None,
                            k_res=None, v_res=None, b_k=None, b_v=None,
                            rope_theta: float = 10_000.0,
                            use_rope: bool = True,
                            q_block: int = 512) -> torch.Tensor:
    """Causal sliding-window attention over CONTIGUOUS positions 0..S-1.

    Each q block attends only to its (window + q_block) band of keys, so a
    window that masks all but the diagonal band costs only the band.
    k_res/v_res with b_k/b_v rebuild the disaggregated K/V per band, as in
    :func:`flash_attention`.  Returns (B, Sq, Hq, D) in q's dtype.
    """
    bsz, sq, hq, d = q.shape
    if scale is None:
        scale = d ** -0.5
    qb = min(q_block, sq)
    pq = (-sq) % qb
    band = window + qb
    if q.device.type == "meta":       # each q block against its band
        def banded(t):       # on t's graph, so a backward counts dK, dV
            return t[:, :1].expand((bsz, band) + tuple(t.shape[2:]))
        return _products_on_meta(
            q, banded(k), banded(v), None if k_res is None else banded(k_res),
            None if v_res is None else banded(v_res), b_k, b_v,
            -(-sq // qb))

    def pad(t):
        # left by `window` (padded index j holds position j - window) and
        # right so every band slice is in range
        widths = [0, 0] * (t.dim() - 2) + [window, pq + window]
        return torch.nn.functional.pad(t, widths)

    kp, vp = pad(k), pad(v)
    if k_res is not None:
        krp, vrp = pad(k_res), pad(v_res)
    outs = []
    for q0 in range(0, sq, qb):
        q_blk = q[:, q0:q0 + qb]
        n = q_blk.shape[1]
        k_band = kp[:, q0:q0 + band]
        v_band = vp[:, q0:q0 + band]
        kpos = q0 - window + torch.arange(band, device=q.device)
        if k_res is not None:
            k_lora = torch.einsum(
                "bsr,brn->bsn", krp[:, q0:q0 + band].to(torch.float32),
                b_k.to(torch.float32)).reshape(k_band.shape)
            if use_rope:
                sin, cos = rope_lib.rope_sincos(
                    torch.clamp(kpos, min=0)[None], d, rope_theta)
                k_lora = rope_lib.apply_rope(k_lora, sin, cos)
            v_lora = torch.einsum(
                "bsr,brn->bsn", vrp[:, q0:q0 + band].to(torch.float32),
                b_v.to(torch.float32)).reshape(v_band.shape)
            k_band = (k_band.to(torch.float32) + k_lora).to(k.dtype)
            v_band = (v_band.to(torch.float32) + v_lora).to(v.dtype)
        s = _gqa_scores(q_blk, k_band) * scale          # (B,Hq,n,band)
        qpos = q0 + torch.arange(n, device=q.device)
        mask = (kpos[None, :] <= qpos[:, None]) & \
            (kpos[None, :] > qpos[:, None] - window) & (kpos >= 0)[None]
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
        p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
        p = p / torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-20)
        outs.append(_gqa_out(p, v_band))                # (B,n,Hq,D)
    return torch.cat(outs, dim=1).to(q.dtype)
