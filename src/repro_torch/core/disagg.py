"""Disaggregated KV cache math (paper §5.1; port of
``repro/core/disagg.py``).

For a LoRA-adapted K/V projection ``Y = xW + (x A_i) B_i * s``:

* ``bCache``: the base projection.  For K, RoPE is applied *before*
  caching (positions are absolute, so the cached entry is final).  For V
  the base projection is cached as it is.
* ``rCache``: the rank-r residual ``x A_i * s``, stored WITHOUT RoPE
  (dimension mismatch).  Reconstruction up-projects with ``B`` and applies
  RoPE then (deferred RoPE, exact by linearity).

The pure math layer, for the tests; the serving runtime keeps these
tensors in paged pools and the kernels rebuild K/V on chip.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import rope as rope_lib
from repro_torch.core.lora import LoRAWeights, lora_down, lora_up


class DisaggKV(NamedTuple):
    """Disaggregated cache entries for one attention layer / one request."""

    k_base: torch.Tensor    # (seq, kv_heads, head_dim)   RoPE applied
    v_base: torch.Tensor    # (seq, kv_heads, head_dim)
    k_res: torch.Tensor     # (seq, r)                    no RoPE, scaled
    v_res: torch.Tensor     # (seq, r)


def project_base(x: torch.Tensor, w_k: torch.Tensor, w_v: torch.Tensor,
                 sin: torch.Tensor, cos: torch.Tensor, kv_heads: int,
                 head_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Base projections -> (k_base with RoPE, v_base).  x: (..., seq, d)."""
    k = (x @ w_k).reshape(x.shape[:-1] + (kv_heads, head_dim))
    v = (x @ w_v).reshape(x.shape[:-1] + (kv_heads, head_dim))
    return rope_lib.apply_rope(k, sin, cos), v


def project_residual(x: torch.Tensor, lora_k: LoRAWeights,
                     lora_v: LoRAWeights
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Residual (rCache) projections: ``x A * s`` for K and V."""
    return lora_down(x, lora_k), lora_down(x, lora_v)


def reconstruct_k(k_base: torch.Tensor, k_res: torch.Tensor,
                  lora_k: LoRAWeights, sin: torch.Tensor, cos: torch.Tensor,
                  kv_heads: int, head_dim: int) -> torch.Tensor:
    """K = K_base + RoPE(K_res @ B_k)  (paper Alg. 1 lines 8-9)."""
    k_lora = lora_up(k_res, lora_k)
    k_lora = k_lora.reshape(k_res.shape[:-1] + (kv_heads, head_dim))
    k_lora = rope_lib.apply_rope(k_lora, sin, cos)
    return (k_base + k_lora).to(k_base.dtype)


def reconstruct_v(v_base: torch.Tensor, v_res: torch.Tensor,
                  lora_v: LoRAWeights, kv_heads: int,
                  head_dim: int) -> torch.Tensor:
    """V = V_base + V_res @ B_v."""
    v_lora = lora_up(v_res, lora_v)
    v_lora = v_lora.reshape(v_res.shape[:-1] + (kv_heads, head_dim))
    return (v_base + v_lora).to(v_base.dtype)


def unified_kv(x: torch.Tensor, w_k: torch.Tensor, w_v: torch.Tensor,
               lora_k: Optional[LoRAWeights], lora_v: Optional[LoRAWeights],
               sin: torch.Tensor, cos: torch.Tensor, kv_heads: int,
               head_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The unified (baseline) cache: RoPE(xW_k + xA_kB_k), xW_v + xA_vB_v."""
    k = x @ w_k
    v = x @ w_v
    if lora_k is not None:
        k = k + lora_up(lora_down(x, lora_k), lora_k)
    if lora_v is not None:
        v = v + lora_up(lora_down(x, lora_v), lora_v)
    k = k.reshape(x.shape[:-1] + (kv_heads, head_dim))
    v = v.reshape(x.shape[:-1] + (kv_heads, head_dim))
    k = rope_lib.apply_rope(k, sin, cos)
    return k.to(x.dtype), v.to(x.dtype)


def memory_ratio(n_agents: int, rank: int, kv_dim: int) -> float:
    """Paper Eq. 3: M_R = 1/N + r/n."""
    return 1.0 / n_agents + rank / kv_dim
