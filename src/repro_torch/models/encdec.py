"""Whisper-style encoder-decoder backbone (port of
``repro/models/encdec.py``).  [arXiv:2212.04356]

The audio frontend (mel spectrogram and conv feature extractor) is a stub,
as in the reference: the encoder takes precomputed frame embeddings (B,
encoder_seq, d).  The backbone is a bidirectional encoder and a causal
decoder with self- and cross-attention; encoder positions are learned,
decoder positions sinusoidal (computed on the fly).

ForkKV applies to the decoder's self-attention, which is the port's
:func:`repro_torch.models.transformer.attention` (LoRA'd K/V, unified or
disaggregated caches; ``use_rope=False`` gives it identity sin/cos
tables).  The encoder's self-attention and the cross-attention against
the encoder output go through :func:`repro_torch.core.attention.mha`, as
the reference computes them outside any Pallas kernel.  ``forward`` runs
the decoder's self-attention through plain ``mha`` too and takes no LoRA,
as the reference's does.  Parameters and caches keep the reference's keys,
shapes and layout (layer-stacked, a leading L axis), so
:mod:`repro_torch.bridge` carries the weights across; the layer scans are
loops, and ``prefill``/``decode_step``/``fill_cross_cache`` write the cache
in place and return it.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.core import attention as attn_lib
from repro_torch.core.config import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import base
from repro_torch.models import transformer as tfm

Params = Dict[str, Any]
Device = Optional[Union[str, torch.device]]


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device: Device = None) -> Params:
    """Random weights drawn from ``seed`` on ``device`` (None: the CUDA
    device), with the reference's keys and shapes.  They do not reproduce
    JAX's draws; the tests carry those across with
    :mod:`repro_torch.bridge`."""
    dev = resolve_device(device)
    gen = tfm._generator(seed, dev)
    dt = cfg.activation_dtype
    d = cfg.d_model
    Le, Ld = cfg.num_encoder_layers, cfg.num_layers

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    def attn_block(L, prefix=""):
        shapes = {"wq": (L, d, cfg.q_dim), "wk": (L, d, cfg.kv_dim),
                  "wv": (L, d, cfg.kv_dim), "wo": (L, cfg.q_dim, d)}
        return {prefix + k: base.dense_init(gen, s, dt)
                for k, s in shapes.items()}

    def mlp_block(L):
        return {"w_up": base.dense_init(gen, (L, d, cfg.d_ff), dt),
                "w_down": base.dense_init(gen, (L, cfg.d_ff, d), dt)}

    enc = {"ln1": zeros(Le, d), "ln2": zeros(Le, d)}
    enc.update(attn_block(Le))
    enc.update(mlp_block(Le))
    dec = {"ln1": zeros(Ld, d), "ln2": zeros(Ld, d), "ln3": zeros(Ld, d)}
    dec.update(attn_block(Ld))
    dec.update(attn_block(Ld, "x_"))
    dec.update(mlp_block(Ld))
    return {
        "enc_pos": base.dense_init(gen, (cfg.encoder_seq, d), dt),
        "embed": base.dense_init(gen, (cfg.vocab_size, d), dt),
        "enc_layers": enc,
        "dec_layers": dec,
        "enc_norm": zeros(d),
        "final_norm": zeros(d),
    }


def logical_axes(cfg: ModelConfig) -> Params:
    """The logical axes of every parameter (:func:`init_params`), the
    reference's tree key for key."""
    def attn(prefix=""):
        return {prefix + "wq": ("layers", "embed", "q_out"),
                prefix + "wk": ("layers", "embed", "kv_out"),
                prefix + "wv": ("layers", "embed", "kv_out"),
                prefix + "wo": ("layers", "q_out", "embed")}

    mlp = {"w_up": ("layers", "embed", "ff"),
           "w_down": ("layers", "ff", "embed")}
    enc = {"ln1": ("layers", "embed"), "ln2": ("layers", "embed")}
    enc.update(attn())
    enc.update(mlp)
    dec = {"ln1": ("layers", "embed"), "ln2": ("layers", "embed"),
           "ln3": ("layers", "embed")}
    dec.update(attn())
    dec.update(attn("x_"))
    dec.update(mlp)
    return {"enc_pos": (None, "embed"),
            "embed": ("vocab", "embed"), "enc_layers": enc,
            "dec_layers": dec, "enc_norm": ("embed",),
            "final_norm": ("embed",)}


def _sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal position embedding in f32; positions (...,) -> (..., d)."""
    half = d // 2
    step = torch.tensor(math.log(10000.0), dtype=torch.float32) / \
        max(half - 1, 1)
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=positions.device) * step.to(
        positions.device))
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _heads(x, w, n, hd):
    return (x @ w).reshape(x.shape[:2] + (n, hd))


def _mlp(p_l, x, cfg: ModelConfig):
    """Pre-norm GELU MLP (the tanh form, as ``jax.nn.gelu`` computes it)."""
    h = base.rms_norm(x, p_l["ln2"], cfg.norm_eps)
    return x + F.gelu(h @ p_l["w_up"], approximate="tanh") @ p_l["w_down"]


def _cross(p_l, x, xk, xv, cfg: ModelConfig):
    """Cross-attention of the decoder against the encoder's K/V."""
    hd = cfg.resolved_head_dim
    h = base.rms_norm(x, p_l["ln3"], cfg.norm_eps)
    q = _heads(h, p_l["x_wq"], cfg.num_heads, hd)
    a = attn_lib.mha(q, xk, xv, causal=False)
    return x + a.reshape(h.shape[:2] + (-1,)) @ p_l["x_wo"]


def encode(params, frame_embeds, cfg: ModelConfig) -> torch.Tensor:
    """Bidirectional encoder over stubbed frame embeddings (B, Se, d)."""
    x = frame_embeds + params["enc_pos"][None, :frame_embeds.shape[1]]
    hd = cfg.resolved_head_dim
    layers = params["enc_layers"]

    def layer(x, p_l):
        h = base.rms_norm(x, p_l["ln1"], cfg.norm_eps)
        q = _heads(h, p_l["wq"], cfg.num_heads, hd)
        k = _heads(h, p_l["wk"], cfg.num_kv_heads, hd)
        v = _heads(h, p_l["wv"], cfg.num_kv_heads, hd)
        a = attn_lib.mha(q, k, v, causal=False)
        x = x + a.reshape(h.shape[:2] + (-1,)) @ p_l["wo"]
        return _mlp(p_l, x, cfg)

    for i in range(cfg.num_encoder_layers):
        # the reference checkpoints every encoder layer under cfg.remat
        x = base.remat(layer, x, {k: t[i] for k, t in layers.items()},
                       on=cfg.remat)
    return base.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _dec_layer(p_l, x, cfg: ModelConfig, *, positions, mode, cache_l, kv_len,
               lora_l, adapter_ids, disagg):
    """Decoder layer: causal self-attention (cached, ForkKV-capable), then
    cross-attention against the cached encoder K/V, then the MLP."""
    h = base.rms_norm(x, p_l["ln1"], cfg.norm_eps)
    self_cache = {k: v for k, v in cache_l.items()
                  if k in ("k", "v", "k_res", "v_res")}
    attn_out, _ = tfm.attention(
        p_l, h, cfg, positions=positions, mode=mode, cache=self_cache,
        kv_len=kv_len, lora=lora_l, adapter_ids=adapter_ids, disagg=disagg)
    x = x + attn_out.reshape(x.shape[0], x.shape[1], -1) @ p_l["wo"]
    x = _cross(p_l, x, cache_l["xk"], cache_l["xv"], cfg)
    return _mlp(p_l, x, cfg)


def _apply_decoder(params, x, cfg: ModelConfig, *, positions, mode, cache,
                   kv_len, lora, adapter_ids, disagg):
    """The decoder as a loop over its stacked layers; each writes its slice
    of the cache in place.  Returns (x, cache)."""
    layers = params["dec_layers"]
    for i in range(cfg.num_layers):
        p_l = {k: t[i] for k, t in layers.items()}
        c_l = {k: t[i] for k, t in cache.items()}
        l_l = {k: t[i] for k, t in lora.items()} if lora is not None else None
        x = base.remat(
            lambda x, p_l=p_l, c_l=c_l, l_l=l_l: _dec_layer(
                p_l, x, cfg, positions=positions, mode=mode, cache_l=c_l,
                kv_len=kv_len, lora_l=l_l, adapter_ids=adapter_ids,
                disagg=disagg), x, on=cfg.remat and mode == "full")
    return x, cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               disagg: bool = False, dtype=None, *,
               device: Device = None) -> Params:
    """Zeroed caches on ``device`` (None: the CUDA device): the decoder's
    self-attention K/V (L, B, max_len, Hkv, hd), the cross K/V (L, B,
    encoder_seq, Hkv, hd) and, with ``disagg``, the residual caches (L, B,
    max_len, R)."""
    dev = resolve_device(device)
    dt = dtype or cfg.activation_dtype
    hd = cfg.resolved_head_dim
    L = cfg.num_layers

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    cache = {
        "k": zeros(L, batch, max_len, cfg.num_kv_heads, hd),
        "v": zeros(L, batch, max_len, cfg.num_kv_heads, hd),
        "xk": zeros(L, batch, cfg.encoder_seq, cfg.num_kv_heads, hd),
        "xv": zeros(L, batch, cfg.encoder_seq, cfg.num_kv_heads, hd),
    }
    if disagg:
        cache["k_res"] = zeros(L, batch, max_len, cfg.lora.rank)
        cache["v_res"] = zeros(L, batch, max_len, cfg.lora.rank)
    return cache


def cache_logical_axes(cfg: ModelConfig, disagg: bool = False) -> Params:
    """The logical axes of the caches (:func:`init_cache`)."""
    axes = {"k": ("layers", "batch", None, "kv_heads", "kv_head_dim"),
            "v": ("layers", "batch", None, "kv_heads", "kv_head_dim"),
            "xk": ("layers", "batch", None, "kv_heads", "kv_head_dim"),
            "xv": ("layers", "batch", None, "kv_heads", "kv_head_dim")}
    if disagg:
        axes["k_res"] = ("layers", "batch", None, "rank")
        axes["v_res"] = ("layers", "batch", None, "rank")
    return axes


def fill_cross_cache(params, enc_out, cache, cfg: ModelConfig) -> Params:
    """Project the encoder output into each layer's cross K/V (once per
    request), in place; returns the cache."""
    hd = cfg.resolved_head_dim
    layers = params["dec_layers"]
    for i in range(cfg.num_layers):
        cache["xk"][i] = _heads(enc_out, layers["x_wk"][i],
                                cfg.num_kv_heads, hd)
        cache["xv"][i] = _heads(enc_out, layers["x_wv"][i],
                                cfg.num_kv_heads, hd)
    return cache


def _embed(params, tokens, positions, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"][tokens] + \
        _sinusoid(positions, cfg.d_model).to(params["embed"].dtype)


def forward(params, tokens, cfg: ModelConfig, *, extra_embeds=None,
            lora=None, adapter_ids=None, disagg: bool = False
            ) -> torch.Tensor:
    """Teacher-forced full pass -> logits (B, S, V); ``extra_embeds`` are the
    encoder's frame embeddings.  Its self-attention is plain causal ``mha``
    over the un-adapted projections, whatever ``lora`` and ``disagg`` say,
    as in the reference."""
    if extra_embeds is None:
        raise ValueError("whisper needs frame embeddings (extra_embeds)")
    enc_out = encode(params, extra_embeds, cfg)
    bsz, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(bsz, s)
    x = _embed(params, tokens, positions, cfg)
    # full mode still needs the cross K/V: a cache of one self slot
    cache = fill_cross_cache(params, enc_out, init_cache(
        cfg, bsz, 1, dtype=x.dtype, device=x.device), cfg)
    hd = cfg.resolved_head_dim
    layers = params["dec_layers"]

    def layer(x, p_l, xk, xv):
        h = base.rms_norm(x, p_l["ln1"], cfg.norm_eps)
        q, k, v = (_heads(h, p_l[w], n, hd) for w, n in (
            ("wq", cfg.num_heads), ("wk", cfg.num_kv_heads),
            ("wv", cfg.num_kv_heads)))
        a = attn_lib.mha(q, k, v, causal=True)
        x = x + a.reshape(h.shape[:2] + (-1,)) @ p_l["wo"]
        x = _cross(p_l, x, xk, xv, cfg)
        return _mlp(p_l, x, cfg)

    for i in range(cfg.num_layers):
        # checkpointed under cfg.remat, as the reference's full pass is
        x = base.remat(layer, x, {k: t[i] for k, t in layers.items()},
                       cache["xk"][i], cache["xv"][i], on=cfg.remat)
    x = base.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["embed"].T                     # tied unembedding


def prefill(params, tokens, cache, cfg: ModelConfig, *, start: int = 0,
            extra_embeds=None, lora=None, adapter_ids=None,
            disagg: bool = False):
    """Decode the prompt into the cache (in place): with ``extra_embeds``
    the encoder runs first and fills the cross cache; a later chunk without
    them keeps it.  Returns (last-token logits (B, 1, V), cache)."""
    if extra_embeds is not None:                     # first chunk
        fill_cross_cache(params, encode(params, extra_embeds, cfg), cache,
                         cfg)
    bsz, s = tokens.shape
    positions = torch.arange(start, start + s,
                             device=tokens.device).expand(bsz, s)
    x = _embed(params, tokens, positions, cfg)
    x, cache = _apply_decoder(params, x, cfg, positions=positions,
                              mode="prefill", cache=cache, kv_len=None,
                              lora=lora, adapter_ids=adapter_ids,
                              disagg=disagg)
    x = base.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return x @ params["embed"].T, cache


def decode_step(params, tokens, cache, kv_len, cfg: ModelConfig, *,
                lora=None, adapter_ids=None, disagg: bool = False):
    """One token per request at position ``kv_len`` (B,) (cache written in
    place).  Returns (logits (B, V), cache)."""
    x = _embed(params, tokens, kv_len, cfg)[:, None]
    x, cache = _apply_decoder(params, x, cfg, positions=kv_len,
                              mode="decode", cache=cache, kv_len=kv_len,
                              lora=lora, adapter_ids=adapter_ids,
                              disagg=disagg)
    x = base.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["embed"].T)[:, 0], cache
