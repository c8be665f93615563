"""Llama-family transformer, the serving subset (port of
``repro/models/transformer.py``).

Only what :class:`~repro_torch.serving.executor.PagedExecutor` calls is
here: parameter and LoRA-stack init for the dense SiLU family, the
projections with per-row (BGMV-style) LoRA, the MLP, embedding and
unembedding, and the masked attention over contiguous K/V that the
executor's gather path (``use_paged_kernel=False``) runs.  Parameters keep the reference's layout: layer-stacked with a
leading L axis, weights ``(d_in, d_out)`` used as ``x @ W``; LoRA stacks are
``(L, N, d, r)`` / ``(L, N, r, out)`` with ``scaling`` ``(L, N)``.  The
matrix products stay ``torch.matmul``/``einsum``, as the reference left them
to XLA.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.core import attention as attn_lib
from repro_torch.core import rope as rope_lib
from repro_torch.core.config import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.kernels import ref as ref_mod
from repro_torch.models import base

Params = Dict[str, Any]


def _generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device: Optional[Union[str, torch.device]] = None) -> Params:
    """Random weights for the dense SiLU family, drawn from ``seed`` on
    ``device`` (None: the CUDA device).  They do not reproduce JAX's draws;
    the tests carry those across with :mod:`repro_torch.bridge`."""
    if cfg.num_experts:
        raise NotImplementedError(
            "MoE params are not ported yet (ROADMAP Queue 1, item 11)")
    if cfg.mlp_activation != "silu":
        raise NotImplementedError(
            "only the SiLU MLP is ported (ROADMAP Queue 1, item 11)")
    dev = resolve_device(device)
    gen = _generator(seed, dev)
    dt = cfg.activation_dtype
    d, L = cfg.d_model, cfg.num_layers
    layers: Params = {
        "ln1": torch.zeros((L, d), dtype=dt, device=dev),
        "ln2": torch.zeros((L, d), dtype=dt, device=dev),
        "wq": base.dense_init(gen, (L, d, cfg.q_dim), dt),
        "wk": base.dense_init(gen, (L, d, cfg.kv_dim), dt),
        "wv": base.dense_init(gen, (L, d, cfg.kv_dim), dt),
        "wo": base.dense_init(gen, (L, cfg.q_dim, d), dt),
        "w_gate": base.dense_init(gen, (L, d, cfg.d_ff), dt),
        "w_up": base.dense_init(gen, (L, d, cfg.d_ff), dt),
        "w_down": base.dense_init(gen, (L, cfg.d_ff, d), dt),
    }
    params: Params = {
        "embed": base.dense_init(gen, (cfg.vocab_size, d), dt),
        "final_norm": torch.zeros((d,), dtype=dt, device=dev),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        params["unembed"] = base.dense_init(gen, (d, cfg.vocab_size), dt)
    return params


def init_lora_stacks(cfg: ModelConfig, seed: int, n_adapters: int,
                     nonzero: bool = True, *,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> Params:
    """Stacked LoRA adapters for q/k/v over all layers: BGMV layout."""
    dev = resolve_device(device)
    gen = _generator(seed, dev)
    dt = cfg.activation_dtype
    d, L, r = cfg.d_model, cfg.num_layers, cfg.lora.rank
    scale_b = 0.05 if nonzero else 0.0

    def mk(d_out):
        a = torch.randn((L, n_adapters, d, r), generator=gen,
                        dtype=torch.float32, device=dev) / math.sqrt(d)
        b = torch.randn((L, n_adapters, r, d_out), generator=gen,
                        dtype=torch.float32, device=dev)
        b = b * scale_b / math.sqrt(r)
        return a.to(dt), b.to(dt)

    a_q, b_q = mk(cfg.q_dim)
    a_k, b_k = mk(cfg.kv_dim)
    a_v, b_v = mk(cfg.kv_dim)
    return {"a_q": a_q, "b_q": b_q, "a_k": a_k, "b_k": b_k,
            "a_v": a_v, "b_v": b_v,
            "scaling": torch.full((L, n_adapters), cfg.lora.scaling,
                                  dtype=torch.float32, device=dev)}


# --------------------------------------------------------------------------
# Building blocks
# --------------------------------------------------------------------------
def _bgmv(x, a_l, b_l, scaling, adapter_ids):
    """Per-row LoRA offset: x (B,S,d) -> (B,S,d_out); a_l (N,d,r), b_l (N,r,o)."""
    a = a_l[adapter_ids]                      # (B, d, r)
    b = b_l[adapter_ids]                      # (B, r, o)
    s = scaling[adapter_ids].to(x.dtype)      # (B,)
    r = torch.einsum("bsd,bdr->bsr", x, a.to(x.dtype))
    return torch.einsum("bsr,bro->bso", r, b.to(x.dtype)) * s[:, None, None]


def _bgmv_down(x, a_l, scaling, adapter_ids):
    a = a_l[adapter_ids]
    s = scaling[adapter_ids].to(x.dtype)
    return torch.einsum("bsd,bdr->bsr", x, a.to(x.dtype)) * s[:, None, None]


def mlp(p_l, x, cfg: ModelConfig):
    if cfg.mlp_activation != "silu":
        raise NotImplementedError(
            "only the SiLU MLP is ported (ROADMAP Queue 1, item 11)")
    h = F.silu(x @ p_l["w_gate"]) * (x @ p_l["w_up"])
    return h @ p_l["w_down"]


def ffn(p_l, x, cfg: ModelConfig):
    if "router" in p_l:
        raise NotImplementedError(
            "MoE layers are not ported yet (ROADMAP Queue 1, item 11)")
    return mlp(p_l, x, cfg)


def _qkv(p_l, x, cfg, lora, adapter_ids, positions):
    """Project q (RoPE'd, with LoRA); returns (q, sin, cos) in x.dtype."""
    bsz, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p_l["wq"]
    if lora is not None:
        q = q + _bgmv(x, lora["a_q"], lora["b_q"], lora["scaling"],
                      adapter_ids)
    q = q.reshape(bsz, s, cfg.num_heads, hd)
    if cfg.use_rope:
        sin, cos = rope_lib.rope_sincos(positions, hd, cfg.rope_theta)
        q = rope_lib.apply_rope(q, sin.to(x.dtype), cos.to(x.dtype))
    else:
        # identity rotation so the deferred-RoPE reconstruction is a no-op
        sin = torch.zeros(positions.shape + (hd // 2,), dtype=torch.float32,
                          device=x.device)
        cos = torch.ones(positions.shape + (hd // 2,), dtype=torch.float32,
                         device=x.device)
    return q, sin.to(x.dtype), cos.to(x.dtype)


def _attend(q, k, v, k_res, v_res, bk_rows, bv_rows, kmask_pos, valid_len,
            qpos, window, scale, cfg, use_disagg):
    """Masked attention over contiguous K/V (the gather path).

    q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D); k_res/v_res: (B, Sk, R) and
    bk_rows/bv_rows: (B, R, Hkv*D) when ``use_disagg``; kmask_pos: (B, Sk)
    key positions; valid_len: (B,) or None; qpos: (B, Sq).  Long sequences
    take the blocked :func:`~repro_torch.core.attention.flash_attention`.
    """
    hd = cfg.resolved_head_dim
    if valid_len is not None:
        in_range = torch.arange(k.shape[1], device=k.device)[None] < \
            valid_len[:, None]
        kmask_pos_f = torch.where(in_range, kmask_pos, attn_lib.EMPTY_POS)
    else:
        kmask_pos_f = kmask_pos
    if q.shape[1] >= attn_lib.FLASH_THRESHOLD and \
            k.shape[1] >= attn_lib.FLASH_THRESHOLD:
        return attn_lib.flash_attention(
            q, k, v, qpos=qpos, kpos=kmask_pos_f, window=window, causal=True,
            scale=scale,
            k_res=k_res if use_disagg else None,
            v_res=v_res if use_disagg else None,
            b_k=bk_rows, b_v=bv_rows, rope_theta=cfg.rope_theta,
            use_rope=cfg.use_rope)
    if use_disagg:
        if cfg.use_rope:
            sin_k, cos_k = rope_lib.rope_sincos(
                torch.where(kmask_pos >= attn_lib.EMPTY_POS, 0, kmask_pos),
                hd, cfg.rope_theta)
        else:
            sin_k = torch.zeros(kmask_pos.shape + (hd // 2,),
                                dtype=torch.float32, device=q.device)
            cos_k = torch.ones(kmask_pos.shape + (hd // 2,),
                               dtype=torch.float32, device=q.device)
        return _masked_residual_attention(
            q, k, v, k_res, v_res, bk_rows, bv_rows,
            sin_k.to(q.dtype), cos_k.to(q.dtype), qpos, kmask_pos,
            valid_len, window, scale)
    return _masked_mha(q, k, v, qpos, kmask_pos, valid_len, window, scale)


def _build_mask(qpos, kmask_pos, valid_len, window):
    qp = qpos[:, :, None]                          # (B, Sq, 1)
    kp = kmask_pos[:, None, :]                     # (B, 1, Sk)
    mask = kp <= qp
    if window > 0:
        mask = mask & (kp > qp - window)
    if valid_len is not None:
        mask = mask & (kp < valid_len[:, None, None])
    return mask[:, None]                           # (B, 1, Sq, Sk)


def _masked_mha(q, k, v, qpos, kmask_pos, valid_len, window, scale):
    s = attn_lib._gqa_scores(q, k) * scale
    mask = _build_mask(qpos, kmask_pos, valid_len, window)
    s = torch.where(mask, s, torch.full_like(s, attn_lib.NEG_INF))
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-20)
    return attn_lib._gqa_out(p, v).to(q.dtype)


def _masked_residual_attention(q, k_base, v_base, k_res, v_res, b_k, b_v,
                               sin, cos, qpos, kmask_pos, valid_len, window,
                               scale):
    k, v = ref_mod.reconstruct(k_base, v_base, k_res, v_res, b_k, b_v,
                               sin, cos)
    return _masked_mha(q, k, v, qpos, kmask_pos, valid_len, window, scale)


def embed_tokens(params, tokens, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"][tokens]


def unembed(params, x, cfg: ModelConfig) -> torch.Tensor:
    x = base.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["unembed"]
