"""Mamba2 (SSD, state-space duality) blocks (port of ``repro/models/ssm.py``).
[arXiv:2405.21060]

Attention-free: no KV cache exists, so ForkKV's disaggregation does not
apply to this family; it is served with its native bounded state cache (the
causal conv's window and the SSM state).  The chunked SSD algorithm runs
prefill and training, the O(1) recurrent update decode.

The reference computes all of it as plain ``jnp`` code outside any Pallas
kernel, so it stays plain PyTorch here.  Parameters and caches keep the
reference's keys, shapes and layout (layer-stacked with a leading L axis;
weights ``(d_in, d_out)`` used as ``x @ W``), so
:mod:`repro_torch.bridge` carries the weights across.  Differences that do
not change the result:

* the reference's 3- and 4-operand einsums are written as explicit
  pairwise products, since ``torch.einsum`` contracts left to right
  without ``opt_einsum``, and the (B, nc, Q, Q, H, P) term a left-to-right
  contraction of the intra-chunk product would build is never formed;
* its ``lax.scan`` over layers is a loop over the stacked leaves (each
  layer under ``base.remat`` in a training pass, as the reference
  checkpoints it), and its scan over chunks a loop over them;
* ``prefill`` and ``decode_step`` write the state cache in place and
  return it, as the port's transformer does.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.core.config import ModelConfig
from repro_torch.core import shards
from repro_torch.core.device import resolve_device
from repro_torch.models import base
from repro_torch.models.transformer import _generator

Params = Dict[str, Any]
Device = Optional[Union[str, torch.device]]

CHUNK = 64


def _dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    heads = cfg.ssm_heads or max(1, d_inner // 64)
    head_p = d_inner // heads
    n = cfg.ssm_state
    return d_inner, heads, head_p, n


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device: Device = None) -> Params:
    """Random weights drawn from ``seed`` on ``device`` (None: the CUDA
    device), with the reference's keys and shapes.  They do not reproduce
    JAX's draws; the tests carry those across with
    :mod:`repro_torch.bridge`."""
    dev = resolve_device(device)
    gen = _generator(seed, dev)
    dt = cfg.activation_dtype
    d, L = cfg.d_model, cfg.num_layers
    d_inner, heads, _, n = _dims(cfg)
    conv_dim = d_inner + 2 * n                      # x, B, C all convolved
    in_dim = 2 * d_inner + 2 * n + heads            # z, x, B, C, dt

    def const(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    layers = {
        "ln": const((L, d), 0.0, dt),
        "w_in": base.dense_init(gen, (L, d, in_dim), dt),
        "conv_w": base.dense_init(gen, (L, cfg.ssm_conv, conv_dim), dt, 0.2),
        "conv_b": const((L, conv_dim), 0.0, dt),
        "a_log": const((L, heads), 0.0, torch.float32),   # A = -exp(a_log)
        "d_skip": const((L, heads), 1.0, torch.float32),
        "dt_bias": const((L, heads), 0.0, torch.float32),
        "gate_ln": const((L, d_inner), 0.0, dt),
        "w_out": base.dense_init(gen, (L, d_inner, d), dt),
    }
    return {
        "embed": base.dense_init(gen, (cfg.vocab_size, d), dt),
        "final_norm": const((d,), 0.0, dt),
        "layers": layers,
        "unembed": base.dense_init(gen, (d, cfg.vocab_size), dt),
    }


def logical_axes(cfg: ModelConfig) -> Params:
    """The logical axes of every parameter (:func:`init_params`), the
    reference's tree key for key."""
    return {
        "embed": ("vocab", "embed"),
        "final_norm": ("embed",),
        "unembed": ("embed", "vocab"),
        "layers": {
            "ln": ("layers", "embed"),
            "w_in": ("layers", "embed", "inner"),
            "conv_w": ("layers", None, "inner"),
            "conv_b": ("layers", "inner"),
            "a_log": ("layers", None),
            "d_skip": ("layers", None),
            "dt_bias": ("layers", None),
            "gate_ln": ("layers", "inner"),
            "w_out": ("layers", "inner", "embed"),
        },
    }


def _split_proj(proj, cfg: ModelConfig):
    d_inner, _, _, n = _dims(cfg)
    return torch.split(proj, [d_inner, d_inner, n, n,
                              proj.shape[-1] - 2 * d_inner - 2 * n], dim=-1)


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv.  x: (B, S, C), w: (K, C), state: (B, K-1, C)
    (stored f32, used in x's type).  Returns (silu(conv + b), new state)."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros(x.shape[:1] + (k - 1,) + x.shape[2:],
                          dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                 # (B, S+K-1, C)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))
    new_state = xp[:, -(k - 1):]
    return F.silu(out + b), new_state


def _ssd_chunked(x, dt, a, bm, cm, d_skip, h0):
    """Chunked SSD scan.

    x:  (B, S, H, P)  values
    dt: (B, S, H)     discretization (softplus'd, > 0)
    a:  (H,)          negative decay rates
    bm/cm: (B, S, N)  input/output projections (single group)
    h0: (B, H, P, N)  initial state
    Returns (y (B, S, H, P) in x's type, h_final (B, H, P, N) f32).
    """
    bsz, s, h, p = x.shape
    n = bm.shape[-1]
    q = min(CHUNK, s)
    pad = (-s) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bm = F.pad(bm, (0, 0, 0, pad))
        cm = F.pad(cm, (0, 0, 0, pad))
    sp = s + pad
    nc = sp // q
    f32 = torch.float32
    xc = x.reshape(bsz, nc, q, h, p).to(f32)
    dtc = dt.reshape(bsz, nc, q, h).to(f32)
    bc = bm.reshape(bsz, nc, q, n).to(f32)
    cc = cm.reshape(bsz, nc, q, n).to(f32)

    la = dtc * a                                    # (B, nc, Q, H) log-decays
    cs = torch.cumsum(la, dim=2)                    # within-chunk cumsum
    # intra-chunk (quadratic, attention-like): scores (B, nc, Q, Q, H)
    decay = torch.exp(cs[:, :, :, None, :] - cs[:, :, None, :, :])
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                   device=x.device))
    scores = torch.einsum("bcin,bcjn->bcij", cc, bc)[..., None] * decay
    scores = torch.where(causal[None, None, :, :, None], scores, 0.0)
    # "bcijh,bcjh,bcjhp->bcihp" as two products
    y_intra = torch.einsum("bcijh,bcjhp->bcihp",
                           scores * dtc[:, :, None, :, :], xc)

    # chunk states: contribution of each chunk to the running state,
    # "bcjh,bcjh,bcjn,bcjhp->bchpn" as two products
    tail = torch.exp(cs[:, :, -1:, :] - cs)         # decay to chunk end
    state_c = torch.einsum("bcjhp,bcjn->bchpn",
                           xc * (tail * dtc)[..., None], bc)

    # inter-chunk recurrence over nc; h_in is the state entering each chunk
    chunk_decay = torch.exp(torch.sum(la, dim=2))   # (B, nc, H)
    hprev = h0.to(f32)
    h_in = []
    for c in range(nc):
        h_in.append(hprev)
        hprev = hprev * chunk_decay[:, c, :, None, None] + state_c[:, c]
    h_in = torch.stack(h_in, dim=1)                 # (B, nc, H, P, N)
    # "bcin,bchpn,bcih->bcihp" as a product and a scale
    y_inter = torch.einsum("bcin,bchpn->bcihp", cc, h_in) * \
        torch.exp(cs)[..., None]
    y = y_intra + y_inter + d_skip[None, None, None, :, None] * xc
    y = y.reshape(bsz, sp, h, p)[:, :s]
    return y.to(x.dtype), hprev


def _layer(p_l, x, cfg: ModelConfig, cache_l, mode: str):
    """One mamba2 block.  cache_l: {"conv": (B, K-1, C), "ssm": (B, H, P,
    N)}, written in place.  Returns (out, cache_l)."""
    d_inner, heads, head_p, n = _dims(cfg)
    h = base.rms_norm(x, p_l["ln"], cfg.norm_eps)
    proj = h @ p_l["w_in"]
    z, xin, bm, cm, dt = _split_proj(proj, cfg)
    conv_in = torch.cat([xin, bm, cm], dim=-1)
    conv_state = cache_l["conv"] if cache_l is not None else None
    conv_out, new_conv = _causal_conv(conv_in, p_l["conv_w"], p_l["conv_b"],
                                      conv_state)
    xin, bm, cm = torch.split(conv_out, [d_inner, n, n], dim=-1)
    dt = F.softplus(dt.to(torch.float32) + p_l["dt_bias"][None, None, :])
    a = -torch.exp(p_l["a_log"])                     # (H,)
    xv = xin.reshape(xin.shape[:2] + (heads, head_p))

    h0 = cache_l["ssm"].to(torch.float32) if cache_l is not None else \
        torch.zeros((x.shape[0], heads, head_p, n), dtype=torch.float32,
                    device=x.device)

    if mode == "decode":                             # S == 1: O(1) update
        f32 = torch.float32
        dt1 = dt[:, 0]                               # (B, H)
        dec = torch.exp(dt1 * a[None, :])            # (B, H)
        x1 = xv[:, 0].to(f32)                        # (B, H, P)
        # "bh,bn,bhp->bhpn"
        upd = (dt1[:, :, None] * x1)[..., None] * \
            bm[:, 0].to(f32)[:, None, None, :]
        h_new = h0 * dec[..., None, None] + upd
        y = torch.einsum("bn,bhpn->bhp", cm[:, 0].to(f32), h_new)
        y = y + p_l["d_skip"][None, :, None] * x1
        y = y[:, None].to(x.dtype)                   # (B, 1, H, P)
    else:
        y, h_new = _ssd_chunked(xv, dt, a, bm, cm, p_l["d_skip"], h0)

    y = y.reshape(y.shape[:2] + (d_inner,))
    y = base.rms_norm(y * F.silu(z), p_l["gate_ln"], cfg.norm_eps)
    out = x + y @ p_l["w_out"]
    if cache_l is not None:
        shards.copy_into(cache_l["conv"], new_conv)
        shards.copy_into(cache_l["ssm"], h_new)
    return out, cache_l


def _apply(params, x, cfg: ModelConfig, cache, mode: str):
    """The layer stack as a loop over the stacked leaves; each layer writes
    its slice of the cache in place.  With ``cfg.remat`` in mode "full",
    while grad mode is on, each layer runs under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``).
    Returns (x, cache)."""
    lp = params["layers"]
    for i in range(cfg.num_layers):
        p_l = {k: t[i] for k, t in lp.items()}
        c_l = {k: t[i] for k, t in cache.items()} \
            if cache is not None else None
        x = base.remat(lambda x, p_l=p_l, c_l=c_l: _layer(
            p_l, x, cfg, c_l, mode)[0], x, on=cfg.remat and mode == "full")
    return x, cache


def forward(params, tokens, cfg: ModelConfig, **_) -> torch.Tensor:
    """Full pass -> logits (B, S, V)."""
    x = shards.lookup(params["embed"], tokens)
    x, _ = _apply(params, x, cfg, None, "full")
    x = base.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["unembed"]


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               disagg: bool = False, dtype=None, *,
               device: Device = None) -> Params:
    """Zeroed state caches on ``device`` (None: the CUDA device), f32
    whatever ``dtype``, as the reference keeps them: the conv window (L, B,
    K-1, C) and the SSM state (L, B, H, P, N).  ``max_len`` and ``disagg``
    are taken for the uniform API and not used."""
    dev = resolve_device(device)
    d_inner, heads, head_p, n = _dims(cfg)
    conv_dim = d_inner + 2 * n
    L = cfg.num_layers
    return {"conv": torch.zeros((L, batch, cfg.ssm_conv - 1, conv_dim),
                                dtype=torch.float32, device=dev),
            "ssm": torch.zeros((L, batch, heads, head_p, n),
                               dtype=torch.float32, device=dev)}


def cache_logical_axes(cfg: ModelConfig, disagg: bool = False) -> Params:
    """The logical axes of the state caches (:func:`init_cache`)."""
    return {"conv": ("layers", "batch", None, "inner"),
            "ssm": ("layers", "batch", None, "inner_head", "state")}


def prefill(params, tokens, cache, cfg: ModelConfig, *, start: int = 0,
            lora=None, adapter_ids=None, disagg: bool = False,
            extra_embeds=None):
    """Run the prompt from the cached state (in place); returns (last-token
    logits (B, 1, V), cache).  The LoRA and position arguments are taken
    for the uniform API and, as in the reference, not used."""
    x = shards.lookup(params["embed"], tokens)
    x, cache = _apply(params, x, cfg, cache, "prefill")
    x = base.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return x @ params["unembed"], cache


def decode_step(params, tokens, cache, kv_len, cfg: ModelConfig, *,
                lora=None, adapter_ids=None, disagg: bool = False):
    """One token per request (cache written in place).  tokens: (B,).
    Returns (logits (B, V), cache)."""
    x = shards.lookup(params["embed"], tokens)[:, None]
    x, cache = _apply(params, x, cfg, cache, "decode")
    x = base.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["unembed"])[:, 0], cache
