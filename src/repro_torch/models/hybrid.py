"""Griffin-style hybrid blocks (RecurrentGemma): RG-LRU + local attention
(port of ``repro/models/hybrid.py``).

Layer pattern (``cfg.block_pattern``, default ("rglru", "rglru", "local"))
is tiled over ``cfg.num_layers``.  RG-LRU layers carry a fixed-size
recurrent state (no KV cache, so ForkKV does not apply to them);
local-attention layers use a sliding-window ring KV cache where ForkKV's
disaggregation does apply: they reuse :func:`transformer.attention`,
LoRA and rCache included.  [arXiv:2402.19427]

Parameters keep the reference's layout: ``params["layers"]`` is a list of
per-layer dicts (the layers differ in kind), weights ``(d_in, d_out)``
used as ``x @ W``.  LoRA stacks cover only the local-attention layers,
with a leading axis over them.  Caches are a list of per-layer dicts,
written in place and returned, as in the port's dense path.  The RG-LRU
scan of modes "full" and "prefill" goes through
:func:`repro_torch.kernels.ops.rg_lru_scan` (the CUDA kernel on the card,
the plain version on the CPU); the one-step decode update stays plain
tensor code, as in the reference.  ``logical_axes`` and
``cache_logical_axes`` name each dimension's logical axis for the
sharding layer (:mod:`repro_torch.launch.sharding`), as the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.core.config import ModelConfig
from repro_torch.core import shards
from repro_torch.core.device import resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import base
from repro_torch.models import transformer as tfm

Params = Dict[str, Any]
Device = Optional[Union[str, torch.device]]

LRU_C = 8.0


def layer_kinds(cfg: ModelConfig) -> List[str]:
    pat = cfg.block_pattern or ("rglru", "rglru", "local")
    return [pat[i % len(pat)] for i in range(cfg.num_layers)]


def _lru_width(cfg: ModelConfig) -> int:
    return cfg.lru_width or cfg.d_model


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device: Device = None) -> Params:
    """Random weights drawn from ``seed`` on ``device`` (None: the CUDA
    device).  They do not reproduce JAX's draws; the tests carry those
    across with :mod:`repro_torch.bridge`."""
    dev = resolve_device(device)
    gen = tfm._generator(seed, dev)
    dt = cfg.activation_dtype
    d = cfg.d_model
    w = _lru_width(cfg)

    def const(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    layers = []
    for kind in layer_kinds(cfg):
        l: Params = {"ln1": const((d,), 0.0, dt), "ln2": const((d,), 0.0, dt)}
        if kind == "rglru":
            l.update({
                "w_gelu": base.dense_init(gen, (d, w), dt),
                "w_rec": base.dense_init(gen, (d, w), dt),
                "conv_w": base.dense_init(gen, (4, w), dt, 0.2),
                "conv_b": const((w,), 0.0, dt),
                "w_rgate": base.dense_init(gen, (w, w), dt),
                "b_rgate": const((w,), 0.0, torch.float32),
                "w_igate": base.dense_init(gen, (w, w), dt),
                "b_igate": const((w,), 0.0, torch.float32),
                "lam": const((w,), -1.0, torch.float32),   # softplus'd
                "w_out": base.dense_init(gen, (w, d), dt),
            })
        else:                                       # local attention
            l.update({
                "wq": base.dense_init(gen, (d, cfg.q_dim), dt),
                "wk": base.dense_init(gen, (d, cfg.kv_dim), dt),
                "wv": base.dense_init(gen, (d, cfg.kv_dim), dt),
                "wo": base.dense_init(gen, (cfg.q_dim, d), dt),
            })
        # MLP after every mixer
        l.update({
            "w_gate": base.dense_init(gen, (d, cfg.d_ff), dt),
            "w_up": base.dense_init(gen, (d, cfg.d_ff), dt),
            "w_down": base.dense_init(gen, (cfg.d_ff, d), dt),
        })
        layers.append(l)
    return {
        "embed": base.dense_init(gen, (cfg.vocab_size, d), dt),
        "final_norm": const((d,), 0.0, dt),
        "layers": layers,                            # heterogeneous: a list
        "unembed": base.dense_init(gen, (d, cfg.vocab_size), dt),
    }


def logical_axes(cfg: ModelConfig) -> Params:
    """The logical axes of every parameter (:func:`init_params`: a list of
    per-layer dicts), the reference's tree key for key."""
    layers = []
    for kind in layer_kinds(cfg):
        l: Params = {"ln1": ("embed",), "ln2": ("embed",)}
        if kind == "rglru":
            l.update({
                "w_gelu": ("embed", "inner"), "w_rec": ("embed", "inner"),
                "conv_w": (None, "inner"), "conv_b": ("inner",),
                "w_rgate": ("inner_in", "inner"), "b_rgate": ("inner",),
                "w_igate": ("inner_in", "inner"), "b_igate": ("inner",),
                "lam": ("inner",), "w_out": ("inner", "embed"),
            })
        else:
            l.update({"wq": ("embed", "q_out"), "wk": ("embed", "kv_out"),
                      "wv": ("embed", "kv_out"), "wo": ("q_out", "embed")})
        l.update({"w_gate": ("embed", "ff"), "w_up": ("embed", "ff"),
                  "w_down": ("ff", "embed")})
        layers.append(l)
    return {"embed": ("vocab", "embed"), "final_norm": ("embed",),
            "layers": layers, "unembed": ("embed", "vocab")}


def num_attention_layers(cfg: ModelConfig) -> int:
    return sum(1 for k in layer_kinds(cfg) if k == "local")


def init_lora_stacks(cfg: ModelConfig, seed: int, n_adapters: int,
                     nonzero: bool = True, *, device: Device = None
                     ) -> Params:
    """LoRA stacks for the attention layers only (leading dim = number of
    attention layers)."""
    sub = dataclasses.replace(cfg, num_layers=num_attention_layers(cfg))
    return tfm.init_lora_stacks(sub, seed, n_adapters, nonzero,
                                device=device)


def _rglru_block(p_l, x, cfg: ModelConfig, cache_l, mode: str):
    """Recurrent mixer.  cache_l: {"conv": (B, 3, W), "h": (B, W)}, written
    in place.  Returns (out, cache_l)."""
    w = _lru_width(cfg)
    s = x.shape[1]
    # jax.nn.gelu's default is the tanh approximation
    gelu_branch = F.gelu(x @ p_l["w_gelu"], approximate="tanh")
    y = x @ p_l["w_rec"]
    # linear causal conv (no activation) over the last k-1 inputs + these
    k = p_l["conv_w"].shape[0]
    pad = cache_l["conv"] if cache_l is not None else \
        torch.zeros(y.shape[:1] + (k - 1,) + y.shape[2:], dtype=y.dtype,
                    device=y.device)
    yp = torch.cat([pad, y], dim=1)
    y = sum(yp[:, i:i + s] * p_l["conv_w"][i] for i in range(k)) \
        + p_l["conv_b"]
    new_conv = yp[:, -(k - 1):]

    r = torch.sigmoid((y @ p_l["w_rgate"]).to(torch.float32)
                      + p_l["b_rgate"])
    i = torch.sigmoid((y @ p_l["w_igate"]).to(torch.float32)
                      + p_l["b_igate"])
    log_a = -LRU_C * F.softplus(p_l["lam"]) * r           # (B,S,W), <0
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (
        i * y.to(torch.float32))
    h0 = cache_l["h"].to(torch.float32) if cache_l is not None else \
        torch.zeros((x.shape[0], w), dtype=torch.float32, device=x.device)
    if mode == "decode":
        h = a[:, 0] * h0 + gated[:, 0]
        states, h_last = h[:, None], h
    else:
        states, h_last = kernel_ops.rg_lru_scan(a, gated, h0)
    out = (states.to(x.dtype) * gelu_branch) @ p_l["w_out"]
    if cache_l is not None:
        shards.copy_into(cache_l["conv"], new_conv)
        shards.copy_into(cache_l["h"], h_last)
    return out, cache_l


def _layer(p_l, kind: str, x, cfg: ModelConfig, *, positions, mode: str,
           cache_l, kv_len, lora_l, adapter_ids, disagg: bool,
           chunk_start=None):
    h = base.rms_norm(x, p_l["ln1"], cfg.norm_eps)
    if kind == "rglru":
        mix, _ = _rglru_block(p_l, h, cfg, cache_l, mode)
        x = x + mix
    else:
        attn_out, _ = tfm.attention(
            p_l, h, cfg, positions=positions, mode=mode, cache=cache_l,
            kv_len=kv_len, lora=lora_l, adapter_ids=adapter_ids,
            disagg=disagg, window=cfg.local_window,
            chunk_start=chunk_start)
        x = x + attn_out.reshape(x.shape[0], x.shape[1], -1) @ p_l["wo"]
    h = base.rms_norm(x, p_l["ln2"], cfg.norm_eps)
    return x + (F.silu(h @ p_l["w_gate"]) * (h @ p_l["w_up"])) @ \
        p_l["w_down"]


def _apply(params, x, cfg: ModelConfig, *, positions, mode: str, cache,
           kv_len, lora, adapter_ids, disagg: bool, chunk_start=None):
    """The layers as a plain loop; with ``cfg.remat`` in mode "full", while
    grad mode is on, each layer runs under ``torch.utils.checkpoint``, as
    the reference wraps it in ``jax.checkpoint``.  The LoRA stacks are
    indexed by a running count of attention layers.  Returns (x, cache)."""
    attn_idx = 0
    for li, (p_l, kind) in enumerate(zip(params["layers"],
                                         layer_kinds(cfg))):
        l_l = None
        if kind == "local":
            if lora is not None:
                l_l = {k: t[attn_idx] for k, t in lora.items()}
            attn_idx += 1

        def run(x, p_l=p_l, kind=kind, l_l=l_l, li=li):
            return _layer(p_l, kind, x, cfg, positions=positions, mode=mode,
                          cache_l=cache[li] if cache is not None else None,
                          kv_len=kv_len, lora_l=l_l, adapter_ids=adapter_ids,
                          disagg=disagg, chunk_start=chunk_start)

        x = base.remat(run, x, on=cfg.remat and mode == "full")
    return x, cache


def forward(params, tokens, cfg: ModelConfig, *, lora=None,
            adapter_ids=None, disagg: bool = False) -> torch.Tensor:
    """Full causal pass -> logits (B, S, V).  (The reference also takes an
    ``extra_embeds`` it never reads; the port leaves it out.)"""
    x = shards.lookup(params["embed"], tokens)
    bsz, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(bsz, s)
    x, _ = _apply(params, x, cfg, positions=positions, mode="full",
                  cache=None, kv_len=None, lora=lora,
                  adapter_ids=adapter_ids, disagg=disagg)
    x = base.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["unembed"]


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               disagg: bool = False, dtype=None, *,
               device: Device = None) -> list:
    """Zeroed per-layer caches on ``device`` (None: the CUDA device): an
    RG-LRU layer keeps its conv inputs (B, 3, W) and f32 state (B, W); a
    local layer a ring of ``min(max_len, local_window)`` slots."""
    if cfg.kv_quant == "int8":
        raise NotImplementedError(
            "int8 caches for the hybrid family: the reference's hybrid "
            "init_cache holds no scales, so its local layers cannot run "
            "over int8 K/V")
    dev = resolve_device(device)
    dt = dtype or cfg.activation_dtype
    w = _lru_width(cfg)
    hd = cfg.resolved_head_dim
    smax = min(max_len, cfg.local_window) if cfg.local_window else max_len
    zeros = lambda *shape, dtype=dt: torch.zeros(  # noqa: E731
        shape, dtype=dtype, device=dev)
    caches = []
    for kind in layer_kinds(cfg):
        if kind == "rglru":
            caches.append({"conv": zeros(batch, 3, w),
                           "h": zeros(batch, w, dtype=torch.float32)})
        else:
            c = {"k": zeros(batch, smax, cfg.num_kv_heads, hd),
                 "v": zeros(batch, smax, cfg.num_kv_heads, hd)}
            if disagg:
                c["k_res"] = zeros(batch, smax, cfg.lora.rank)
                c["v_res"] = zeros(batch, smax, cfg.lora.rank)
            caches.append(c)
    return caches


def cache_logical_axes(cfg: ModelConfig, disagg: bool = False) -> list:
    """The logical axes of the per-layer caches (:func:`init_cache`)."""
    axes = []
    for kind in layer_kinds(cfg):
        if kind == "rglru":
            axes.append({"conv": ("batch", None, "inner"),
                         "h": ("batch", "inner")})
        else:
            c = {"k": ("batch", None, "kv_heads", "kv_head_dim"),
                 "v": ("batch", None, "kv_heads", "kv_head_dim")}
            if disagg:
                c["k_res"] = ("batch", None, "rank")
                c["v_res"] = ("batch", None, "rank")
            axes.append(c)
    return axes


def prefill(params, tokens, cache, cfg: ModelConfig, *, start: int = 0,
            lora=None, adapter_ids=None, disagg: bool = False):
    """Populate the caches with the prompt (in place); returns (last-token
    logits (B, 1, V), cache)."""
    x = shards.lookup(params["embed"], tokens)
    bsz, s, _ = x.shape
    positions = torch.arange(start, start + s, device=x.device).expand(bsz, s)
    x, cache = _apply(params, x, cfg, positions=positions, mode="prefill",
                      cache=cache, kv_len=None, lora=lora,
                      adapter_ids=adapter_ids, disagg=disagg,
                      chunk_start=start)
    x = base.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return x @ params["unembed"], cache


def decode_step(params, tokens, cache, kv_len, cfg: ModelConfig, *,
                lora=None, adapter_ids=None, disagg: bool = False):
    """One decode step (caches written in place).  tokens: (B,), kv_len:
    (B,) tokens already cached.  Returns (logits (B, V), cache)."""
    x = shards.lookup(params["embed"], tokens)[:, None]
    x, cache = _apply(params, x, cfg, positions=kv_len, mode="decode",
                      cache=cache, kv_len=kv_len, lora=lora,
                      adapter_ids=adapter_ids, disagg=disagg)
    x = base.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["unembed"])[:, 0], cache
