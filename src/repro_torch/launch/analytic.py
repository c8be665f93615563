"""Analytic roofline cost model (exact FLOPs, first-order bytes/collectives),
port of ``repro/launch/analytic.py``, line for line: arithmetic on the
config and the mesh's axis sizes, so with the same sizes every number
equals the reference's.  The card's constants enter only in
``roofline.roofline_terms``.

Why it exists in the reference: XLA's ``cost_analysis()`` counts while-loop
bodies once, so scanned models are undercounted.  The port's FLOP count
(``roofline.step_flops``, torch's FlopCounterMode over the step on meta
tensors) counts every layer and loop pass, and the dry run records both;
so does it with collective bytes (``roofline.collective_bytes`` over the
step run on DTensors, beside this model's ``coll_bytes_dev``).  The
roofline terms come from this model, as the reference's do: its bytes have
no counterpart, and the counted collectives are DTensor's choices, not
GSPMD's.

All FLOPs are exact matmul FLOPs of the implementation as written (e.g. the
blocked flash path computes *all* kv blocks including fully-masked ones — we
count what the code does, not an idealized causal half).  Bytes and
collective volumes are first-order: dominant terms only, constants
documented inline.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.core.config import ModelConfig, ShapeConfig
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import mesh_axis_sizes, mesh_devices

F32, BF16 = 4, 2


def _mesh_sizes(mesh) -> Dict[str, int]:
    return mesh_axis_sizes(mesh)


def _dtype_bytes(cfg) -> int:
    return 2 if cfg.dtype == "bfloat16" else 4


# --------------------------------------------------------------------------
# FLOPs (global, one step)
# --------------------------------------------------------------------------
def _attn_layer_flops(cfg, B, s_new, k_eff, with_lora) -> float:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    f = 2 * B * s_new * d * (cfg.q_dim + 2 * cfg.kv_dim)      # qkv proj
    f += 2 * B * s_new * cfg.q_dim * d                         # o proj
    f += 4 * B * cfg.num_heads * s_new * k_eff * hd            # QK^T + PV
    if with_lora:
        r = cfg.lora.rank
        f += 2 * B * s_new * (3 * d * r + r * (cfg.q_dim + 2 * cfg.kv_dim))
    return f


def _mlp_flops(cfg, B, s_new) -> float:
    n_mats = 3 if cfg.mlp_activation == "silu" else 2
    return 2 * n_mats * B * s_new * cfg.d_model * cfg.d_ff


def _moe_layer_flops(cfg, B, s_new) -> float:
    d = cfg.d_model
    ffe = cfg.moe_d_ff or cfg.d_ff
    t = B * s_new
    slots = t * cfg.num_experts_per_tok * 1.25      # capacity factor
    f = 2 * 3 * slots * d * ffe                     # expert matmuls (silu)
    f += 2 * t * d * cfg.num_experts                # router
    if cfg.moe_shared_expert:
        f += 2 * 3 * t * d * ffe
    return f


def _ssm_layer_flops(cfg, B, s_new, decode: bool) -> float:
    d = cfg.d_model
    inner = cfg.ssm_expand * d
    heads = cfg.ssm_heads or max(1, inner // 64)
    p = inner // heads
    n = cfg.ssm_state
    in_dim = 2 * inner + 2 * n + heads
    f = 2 * B * s_new * d * in_dim                  # in_proj
    f += 2 * B * s_new * inner * d                  # out_proj
    f += 2 * B * s_new * (inner + 2 * n) * cfg.ssm_conv   # conv
    if decode:
        f += 4 * B * heads * p * n                  # state update + readout
    else:
        q = 64                                      # SSD chunk
        f += 2 * B * s_new * q * n                  # intra scores
        f += 2 * B * s_new * q * heads * p          # intra apply
        f += 4 * B * s_new * heads * p * n          # chunk states + inter
    return f


def _rglru_layer_flops(cfg, B, s_new) -> float:
    d = cfg.d_model
    w = cfg.lru_width or d
    f = 2 * B * s_new * d * w * 2                   # gelu + recurrent branch
    f += 2 * B * s_new * w * w * 2                  # r/i gates
    f += 2 * B * s_new * w * d                      # out proj
    f += 10 * B * s_new * w                         # scan elementwise
    return f


def _unembed_flops(cfg, B, s_new) -> float:
    return 2 * B * s_new * cfg.d_model * cfg.vocab_size


def forward_flops(cfg: ModelConfig, B: int, s_new: int,
                  cache_len: int = 0, with_lora: bool = False,
                  decode: bool = False,
                  banded_window: bool = False) -> float:
    """One forward pass, global FLOPs.

    banded_window: §Perf optimization — windowed attention attends only a
    (window + q_block) band instead of every kv block (what the optimized
    code path computes).
    """
    L = cfg.num_layers
    total = _unembed_flops(cfg, B, s_new)

    def k_eff(window):
        if decode:
            smax = cache_len
            return min(smax, window) if window else smax
        full = s_new if not cache_len else cache_len   # flash loops all blocks
        if window and banded_window:
            return min(full, window + 512)             # banded path
        return full

    if cfg.family == "ssm":
        total += L * _ssm_layer_flops(cfg, B, s_new, decode)
        return total
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import layer_kinds
        for kind in layer_kinds(cfg):
            if kind == "rglru":
                total += _rglru_layer_flops(cfg, B, s_new)
            else:
                total += _attn_layer_flops(cfg, B, s_new,
                                           k_eff(cfg.local_window), with_lora)
            total += _mlp_flops(cfg, B, s_new)
        return total
    if cfg.family == "audio":
        # decoder self + cross; encoder counted by caller for prefill/train
        for _ in range(L):
            total += _attn_layer_flops(cfg, B, s_new, k_eff(0), with_lora)
            total += _attn_layer_flops(cfg, B, s_new, cfg.encoder_seq, False)
            total += _mlp_flops(cfg, B, s_new)
        return total
    # llama-family (dense / moe / vlm)
    ke = k_eff(cfg.sliding_window)
    total += L * _attn_layer_flops(cfg, B, s_new, ke, with_lora)
    if cfg.num_experts:
        L_moe = L // cfg.moe_interleave
        total += L_moe * _moe_layer_flops(cfg, B, s_new)
        total += (L - L_moe) * _mlp_flops(cfg, B, s_new)
    else:
        total += L * _mlp_flops(cfg, B, s_new)
    return total


def encoder_flops(cfg: ModelConfig, B: int) -> float:
    if cfg.family != "audio":
        return 0.0
    se = cfg.encoder_seq
    f = 0.0
    for _ in range(cfg.num_encoder_layers):
        f += _attn_layer_flops(cfg, B, se, se, False)
        f += 2 * 2 * B * se * cfg.d_model * cfg.d_ff     # gelu mlp
    return f


# --------------------------------------------------------------------------
# Per-device bytes and collectives (first order)
# --------------------------------------------------------------------------
def _param_bytes(cfg) -> float:
    return cfg.num_params * _dtype_bytes(cfg)


def _param_shards(cfg, sizes, purpose, strategy="baseline") -> int:
    n_model = sizes.get("model", 1)
    n_data = sizes.get("data", 1)
    n_pod = sizes.get("pod", 1)
    if purpose == "decode":
        if cfg.num_params > shd.BIG_MODEL:
            return n_model * n_data * n_pod          # 2D/3D TP
        return n_model
    if strategy == "optimized":
        if purpose == "train" and cfg.num_params < shd.SMALL_MODEL:
            return 1                                 # fully replicated
        if purpose == "prefill" and cfg.num_params <= shd.BIG_MODEL:
            return n_model                           # FSDP over model axis
    if cfg.num_params > 2e11:
        return n_model * n_data * n_pod              # FSDP over pod+data
    return n_model * n_data                          # FSDP over data


def _cache_bytes_dev(cfg, B, S, sizes, disagg) -> float:
    """Per-device KV/state cache bytes."""
    n_data = sizes.get("data", 1)
    n_pod = sizes.get("pod", 1)
    n_model = sizes.get("model", 1)
    bshard = n_data * n_pod if B % (n_data * n_pod) == 0 else (
        n_data if B % n_data == 0 else 1)
    dt = _dtype_bytes(cfg)
    L = cfg.num_layers
    if cfg.family == "ssm":
        inner = cfg.ssm_expand * cfg.d_model
        heads = cfg.ssm_heads or max(1, inner // 64)
        per = (cfg.ssm_conv - 1) * (inner + 2 * cfg.ssm_state) * 4 + \
            heads * (inner // heads) * cfg.ssm_state * 4
        return L * B * per / bshard
    smax = min(S, cfg.sliding_window) if cfg.sliding_window else S
    if cfg.kv_quant == "int8":
        kv = 2 * smax * cfg.kv_dim * 1 + 2 * smax * cfg.num_kv_heads * 4
    else:
        kv = 2 * smax * cfg.kv_dim * dt
    if disagg:
        kv += 2 * smax * cfg.lora.rank * dt
    total = 0.0
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import layer_kinds
        w = cfg.lru_width or cfg.d_model
        sl = min(S, cfg.local_window) if cfg.local_window else S
        kv_l = 2 * sl * cfg.kv_dim * dt + (2 * sl * cfg.lora.rank * dt
                                           if disagg else 0)
        for kind in layer_kinds(cfg):
            total += B * (kv_l if kind == "local" else
                          (3 * w * dt + w * 4))
        return total / bshard
    total = L * B * kv
    if cfg.family == "audio":
        total += L * B * 2 * cfg.encoder_seq * cfg.kv_dim * dt
    # kv head/head_dim sharding over the model axis when divisible
    hshard = n_model if (cfg.num_kv_heads % n_model == 0 or
                         cfg.resolved_head_dim % n_model == 0) else 1
    return total / (bshard * hshard)


def analytic_costs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                   purpose: Optional[str] = None,
                   strategy: str = "baseline") -> Dict[str, float]:
    sizes = _mesh_sizes(mesh)
    chips = mesh_devices(mesh)
    n_model = sizes.get("model", 1)
    n_data = sizes.get("data", 1)
    n_pod = sizes.get("pod", 1)
    B, S = shape.global_batch, shape.seq_len
    purpose = purpose or shape.mode
    if purpose == "train":
        purpose = "train"
    dt = _dtype_bytes(cfg)
    pbytes = _param_bytes(cfg)
    pshards = _param_shards(cfg, sizes, purpose, strategy)
    small_dp = (strategy == "optimized" and purpose == "train" and
                cfg.num_params < shd.SMALL_MODEL)
    prefill_fsdp = (strategy == "optimized" and purpose == "prefill" and
                    cfg.num_params <= shd.BIG_MODEL)
    api_lora = cfg.family != "ssm"

    bshard = n_data * n_pod if B % (n_data * n_pod) == 0 else (
        n_data if B % n_data == 0 else 1)
    tokens_local = B * S / bshard

    banded = strategy == "optimized"
    if shape.mode == "train":
        fwd = forward_flops(cfg, B, S, with_lora=False,
                            banded_window=banded) + \
            encoder_flops(cfg, B)
        mult = 4.0 if cfg.remat else 3.0            # fwd + bwd (+ recompute)
        flops = fwd * mult
        # bytes: params traffic (fwd+bwd+recompute) x accum + optimizer
        from repro_torch.launch.steps import accum_for
        accum = accum_for(cfg, strategy)
        opt_b = 24 if cfg.optimizer == "adamw" else 9   # B/param (fp32 m,v)
        bytes_dev = (pbytes / pshards) * mult * accum + \
            cfg.num_params * opt_b / pshards
        # activations: ~12 B/token/feature through each layer (r+w, f32 ln)
        bytes_dev += 12 * tokens_local * cfg.d_model * cfg.num_layers * dt / \
            max(n_model // 4, 1)
        # collectives: FSDP AG (fwd+recompute+bwd) + RS grads + TP ARs
        coll = 0.0
        if small_dp:
            coll = 2 * pbytes                        # grad all-reduce only
        else:
            if pshards > n_model:                    # FSDP active
                coll += (pbytes / n_model) * \
                    (1 - 1 / (pshards / n_model)) * (mult - 1) * accum
            if n_model > 1:
                coll += 2 * 2 * cfg.num_layers * tokens_local * \
                    cfg.d_model * dt * accum / accum
            if n_pod > 1 and pshards <= n_data * n_model:
                coll += 2 * pbytes / pshards         # pod grad all-reduce
    elif shape.mode == "prefill":
        fwd = forward_flops(cfg, B, S, with_lora=api_lora,
                            banded_window=banded) + \
            encoder_flops(cfg, B)
        flops = fwd
        cache_dev = _cache_bytes_dev(cfg, B, S, sizes,
                                     disagg=cfg.family != "ssm")
        # flash re-reads K/V per q-block (q_block=512)
        nq = max(1, S // 512)
        kv_reread = cfg.num_layers * nq * (2 * S * cfg.kv_dim * dt) \
            * (B / bshard) / max(n_model, 1)
        bytes_dev = pbytes / pshards + \
            8 * tokens_local * cfg.d_model * cfg.num_layers * dt / \
            max(n_model // 4, 1) + cache_dev + kv_reread
        coll = 0.0
        if prefill_fsdp:
            # one weight all-gather per layer over the model axis; no
            # per-token TP all-reduces
            coll = pbytes * (1 - 1 / max(n_model, 1))
        else:
            if pshards > n_model:
                coll += (pbytes / n_model) * (1 - n_model / pshards)
            if n_model > 1:
                coll += 2 * 2 * cfg.num_layers * tokens_local * \
                    cfg.d_model * dt
    else:  # decode
        window = cfg.sliding_window or (cfg.local_window
                                        if cfg.family == "hybrid" else 0)
        cache_len = min(S, window) if window else S
        fwd = forward_flops(cfg, B, 1, cache_len=cache_len,
                            with_lora=api_lora, decode=True)
        flops = fwd
        cache_dev = _cache_bytes_dev(cfg, B, S, sizes,
                                     disagg=cfg.family != "ssm")
        bytes_dev = pbytes / pshards + cache_dev     # read params + full cache
        coll = 0.0
        if n_model > 1:
            b_eff = B / bshard if pshards <= n_model else B
            coll += 2 * 2 * cfg.num_layers * b_eff * cfg.d_model * dt

    flops_dev = flops / chips
    return {
        "flops_global": flops,
        "flops_dev": flops_dev,
        "bytes_dev": bytes_dev,
        "coll_bytes_dev": coll,
        "param_bytes_dev": pbytes / pshards,
        "param_shards": pshards,
    }
