"""Llama-family transformer: dense, MoE and VLM-backbone variants (port of
``repro/models/transformer.py``).

Covers starcoder2, internlm2, h2o-danube (SWA), llama3-405b, the mistral
backbone of llava-next, dbrx and llama4 (MoE), and the paper's own models.
Parameter and LoRA-stack init, the projections with per-row (BGMV-style)
LoRA, the feed-forward blocks (the SiLU-gated and the GELU MLP, the
capacity MoE with top-k routing and an optional shared expert, and
llama4's interleave of dense and MoE layers, ``layer_params``), embedding
(with the VLM's projected ``extra_embeds`` before the tokens) and
unembedding, one attention layer over unified or disaggregated caches,
and the model API:

  * ``forward``      — full causal pass (training / teacher-forcing)
  * ``init_cache``   — contiguous per-request caches, ring buffers for SWA
  * ``prefill``      — populate a cache (unified or disaggregated)
  * ``decode_step``  — one token per request against the cache

The serving executor (:class:`~repro_torch.serving.executor.PagedExecutor`)
calls the blocks, and ``_attend`` on its gather path.  Parameters keep the
reference's layout: layer-stacked with a leading L axis, weights
``(d_in, d_out)`` used as ``x @ W``; LoRA stacks are ``(L, N, d, r)`` /
``(L, N, r, out)`` with ``scaling`` ``(L, N)``; caches are ``(L, B, Smax,
...)``.  The matrix products stay ``torch.matmul``/``einsum``, as the
reference left them to XLA; ``forward`` with ``disagg=True`` reaches the
dense ResidualAttention kernels through :mod:`repro_torch.kernels.ops`.
Unlike the reference, whose arrays are immutable, ``prefill`` and
``decode_step`` write the cache in place (and return it), so a step holds
one cache and not two.  With ``cfg.kv_quant == "int8"`` the caches hold int8
K/V with f32 per-(position, head) scales (``k_scale``/``v_scale``),
quantized on every write and dequantized before attention, as in the
reference.  The expert products are ``einsum`` s over the (E, capacity,
d) dispatch buffer, plain matrix products that the reference also leaves
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
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import ref as ref_mod
from repro_torch.models import base

Params = Dict[str, Any]


def _generator(seed: int, device: torch.device) -> torch.Generator:
    return base.generator(seed, device)


def _expert_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    """An (L, E, ...) expert stack drawn one expert at a time: f32 draws of
    the whole stack would take 4 bytes per weight at once (21.5 GB for one
    of llama4's)."""
    out = torch.empty(tuple(shape), dtype=dtype, device=gen.device)
    if out.device.type == "meta":       # shapes only: nothing to draw
        return out
    for layer in out:
        for expert in layer:
            expert.copy_(base.dense_init(gen, expert.shape, dtype))
    return out


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device: Optional[Union[str, torch.device]] = None) -> Params:
    """Random weights drawn from ``seed`` on ``device`` (None: the CUDA
    device), with the reference's keys and shapes: the MoE keys (router,
    expert stacks, the shared expert's ``*_s`` and, with ``moe_interleave``
    > 1, the dense layers' MLP) for an MoE config, no ``w_gate`` for the
    GELU MLP, ``mm_projector`` for the vision stub.  They do not reproduce
    JAX's draws; the tests carry those across with
    :mod:`repro_torch.bridge`."""
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
    }
    if cfg.num_experts:
        ffe, E = cfg.moe_d_ff or cfg.d_ff, cfg.num_experts
        L_moe = L // cfg.moe_interleave
        layers.update({
            "router": base.dense_init(gen, (L_moe, d, E), dt),
            "w_gate_e": _expert_init(gen, (L_moe, E, d, ffe), dt),
            "w_up_e": _expert_init(gen, (L_moe, E, d, ffe), dt),
            "w_down_e": _expert_init(gen, (L_moe, E, ffe, d), dt),
        })
        if cfg.moe_shared_expert:
            layers["w_gate_s"] = base.dense_init(gen, (L_moe, d, ffe), dt)
            layers["w_up_s"] = base.dense_init(gen, (L_moe, d, ffe), dt)
            layers["w_down_s"] = base.dense_init(gen, (L_moe, ffe, d), dt)
        if cfg.moe_interleave > 1:          # interleaved dense MLP layers
            L_dense = L - L_moe
            layers["w_gate"] = base.dense_init(gen, (L_dense, d, cfg.d_ff),
                                               dt)
            layers["w_up"] = base.dense_init(gen, (L_dense, d, cfg.d_ff), dt)
            layers["w_down"] = base.dense_init(gen, (L_dense, cfg.d_ff, d),
                                               dt)
    else:
        if cfg.mlp_activation == "silu":
            layers["w_gate"] = base.dense_init(gen, (L, d, cfg.d_ff), dt)
        layers["w_up"] = base.dense_init(gen, (L, d, cfg.d_ff), dt)
        layers["w_down"] = base.dense_init(gen, (L, cfg.d_ff, d), dt)
    params: Params = {
        "embed": base.dense_init(gen, (cfg.vocab_size, d), dt),
        "final_norm": torch.zeros((d,), dtype=dt, device=dev),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        params["unembed"] = base.dense_init(gen, (d, cfg.vocab_size), dt)
    if cfg.frontend == "vision_stub":
        # projector from (stubbed) vision features to d_model
        params["mm_projector"] = base.dense_init(gen, (d, d), dt)
    return params


def logical_axes(cfg: ModelConfig) -> Params:
    """The logical axis of each dimension of every parameter (the tree of
    :func:`init_params`), which :mod:`repro_torch.launch.sharding` maps
    onto a mesh; the reference's tree, key for key."""
    layers = {
        "ln1": ("layers", "embed"),
        "ln2": ("layers", "embed"),
        "wq": ("layers", "embed", "q_out"),
        "wk": ("layers", "embed", "kv_out"),
        "wv": ("layers", "embed", "kv_out"),
        "wo": ("layers", "q_out", "embed"),
    }
    if cfg.num_experts:
        layers.update({
            "router": ("layers", "embed", None),
            "w_gate_e": ("layers", "expert_w", "embed", "ff"),
            "w_up_e": ("layers", "expert_w", "embed", "ff"),
            "w_down_e": ("layers", "expert_w", "ff", "embed"),
        })
        if cfg.moe_shared_expert:
            layers["w_gate_s"] = ("layers", "embed", "ff")
            layers["w_up_s"] = ("layers", "embed", "ff")
            layers["w_down_s"] = ("layers", "ff", "embed")
        if cfg.moe_interleave > 1:
            layers["w_gate"] = ("layers", "embed", "ff")
            layers["w_up"] = ("layers", "embed", "ff")
            layers["w_down"] = ("layers", "ff", "embed")
    else:
        if cfg.mlp_activation == "silu":
            layers["w_gate"] = ("layers", "embed", "ff")
        layers["w_up"] = ("layers", "embed", "ff")
        layers["w_down"] = ("layers", "ff", "embed")
    axes = {
        "embed": ("vocab", "embed"),
        "final_norm": ("embed",),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        axes["unembed"] = ("embed", "vocab")
    if cfg.frontend == "vision_stub":
        axes["mm_projector"] = ("embed", "embed")
    return axes


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
        a = base.randn(gen, (L, n_adapters, d, r)) / math.sqrt(d)
        b = base.randn(gen, (L, n_adapters, r, d_out))
        b = b * scale_b / math.sqrt(r)
        return a.to(dt), b.to(dt)

    a_q, b_q = mk(cfg.q_dim)
    a_k, b_k = mk(cfg.kv_dim)
    a_v, b_v = mk(cfg.kv_dim)
    return {"a_q": a_q, "b_q": b_q, "a_k": a_k, "b_k": b_k,
            "a_v": a_v, "b_v": b_v,
            "scaling": torch.full((L, n_adapters), cfg.lora.scaling,
                                  dtype=torch.float32, device=dev)}


def lora_logical_axes() -> Params:
    """The logical axes of the LoRA stacks (:func:`init_lora_stacks`)."""
    return {"a_q": ("layers", None, "embed", "rank"),
            "b_q": ("layers", None, "rank", "q_out"),
            "a_k": ("layers", None, "embed", "rank"),
            "b_k": ("layers", None, "rank", "kv_out"),
            "a_v": ("layers", None, "embed", "rank"),
            "b_v": ("layers", None, "rank", "kv_out"),
            "scaling": ("layers", None)}


# --------------------------------------------------------------------------
# KV-cache int8 quantization
# --------------------------------------------------------------------------
def quantize_kv(x: torch.Tensor):
    """Per-(position, head) symmetric int8.  x: (..., Hkv, hd).  Returns
    (int8 values, f32 scales (..., Hkv)): ``scale = max(amax|x| / 127,
    1e-8)``, values ``clip(round(x / scale), ±127)`` with round half to
    even, bit for bit the reference's ``quantize_kv``."""
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


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
    """SwiGLU, or the plain two-matrix GELU MLP (starcoder2).  GELU is the
    tanh form, which is what ``jax.nn.gelu`` computes by default."""
    if cfg.mlp_activation == "silu":
        h = F.silu(x @ p_l["w_gate"]) * (x @ p_l["w_up"])
    else:
        h = F.gelu(x @ p_l["w_up"], approximate="tanh")
    return h @ p_l["w_down"]


def _top_k(probs: torch.Tensor, k: int):
    """The k largest of the last dim, ties toward the lower index, as
    ``jax.lax.top_k`` breaks them (``torch.topk`` does not say how it
    does): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_route(p_l, xf, cfg: ModelConfig, capacity_factor: float = 0.0):
    """Top-k routing of ``xf`` (t, d) into per-expert capacity slots, the
    reference's arithmetic exactly: f32 softmax over the router logits,
    top-k (ties to the lower expert), gates renormalised over the k;
    capacity ``cap = max(8, ceil8(t·k/E·cf))``; the (t·k) assignments take
    slots in flat order by cumsum, and one past ``cap`` overflows.  Returns
    (gates (t·k,), dest (t·k,) slot in an (E·cap + 1)-row buffer whose last
    row is the overflow, valid (t·k,) bool, cap)."""
    capacity_factor = capacity_factor or cfg.moe_capacity_factor
    t = xf.shape[0]
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    logits = (xf @ p_l["router"]).to(torch.float32)          # (t, E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = _top_k(probs, k)                            # (t, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    cap = int(max(8, ((t * k / E) * capacity_factor + 7) // 8 * 8))
    flat_e = idx.reshape(-1)                                 # (t*k,)
    onehot = F.one_hot(flat_e, E)
    pos = torch.cumsum(onehot, dim=0) - 1
    pos = torch.gather(pos, 1, flat_e[:, None])[:, 0]
    valid = pos < cap
    dest = torch.where(valid, flat_e * cap + pos,
                       torch.full_like(pos, E * cap))        # overflow slot
    return gates.reshape(-1), dest, valid, cap


def moe_ffn(p_l, x, cfg: ModelConfig, capacity_factor: float = 0.0):
    """Scatter-based capacity MoE: tokens are dispatched to an (E, C, d)
    buffer (``moe_route``), run through their experts' SwiGLU and gathered
    back weighted by their gates; an assignment past its expert's capacity
    adds nothing.  Plus the always-on shared expert where the layer has one
    (llama4)."""
    bsz, s, d = x.shape
    t = bsz * s
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    xf = x.reshape(t, d)
    gates, dest, valid, cap = moe_route(p_l, xf, cfg, capacity_factor)
    token_of = torch.arange(t * k, device=x.device) // k
    buf = torch.zeros((E * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[dest] = xf[token_of]
    h = buf[:-1].reshape(E, cap, d)
    a = F.silu(torch.einsum("ecd,edf->ecf", h, p_l["w_gate_e"]))
    a = a * torch.einsum("ecd,edf->ecf", h, p_l["w_up_e"])
    o = torch.einsum("ecf,efd->ecd", a, p_l["w_down_e"])
    o_flat = torch.cat([o.reshape(E * cap, d),
                        torch.zeros((1, d), dtype=x.dtype, device=x.device)])
    y = o_flat[dest] * (gates * valid).to(x.dtype)[:, None]
    y = y.reshape(t, k, d).sum(dim=1).reshape(bsz, s, d)
    if "w_gate_s" in p_l:   # shared (always-on) expert, llama4-style
        y = y + (F.silu(x @ p_l["w_gate_s"]) *
                 (x @ p_l["w_up_s"])) @ p_l["w_down_s"]
    return y


def moe_aux_loss(p_l, x, cfg: ModelConfig) -> torch.Tensor:
    """Switch-style load-balance loss for one layer."""
    xf = x.reshape(-1, x.shape[-1])
    probs = torch.softmax((xf @ p_l["router"]).to(torch.float32), dim=-1)
    _, idx = _top_k(probs, cfg.num_experts_per_tok)
    frac_tokens = F.one_hot(idx, cfg.num_experts).to(torch.float32).mean(
        dim=(0, 1))
    frac_probs = probs.mean(dim=0)
    return cfg.num_experts * torch.sum(frac_tokens * frac_probs)


def ffn(p_l, x, cfg: ModelConfig):
    # dispatch on the params present, so an interleaved MoE stack (dense
    # sublayers between MoE sublayers, llama4-style) runs one layer body
    return moe_ffn(p_l, x, cfg) if "router" in p_l else mlp(p_l, x, cfg)


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


def _ring_kpos(kv_len: torch.Tensor, window: int) -> torch.Tensor:
    """Absolute positions held by each slot of a ring buffer. (B, W).

    Slot s holds the largest position p < n with p ≡ s (mod W); empty slots
    (p < 0, i.e. cache not yet wrapped) get a sentinel that fails every
    causal mask.
    """
    slots = torch.arange(window, device=kv_len.device)[None, :]
    n = kv_len[:, None]
    p = (n - 1) - torch.remainder(n - 1 - slots, window)
    return torch.where(p >= 0, p, attn_lib.EMPTY_POS)


def attention(p_l, x, cfg: ModelConfig, *, positions, mode: str,
              cache=None, kv_len=None, lora=None, adapter_ids=None,
              disagg: bool = False, window: int = 0, chunk_start=None):
    """One attention layer.  Returns (out, cache).

    mode: "full"    — no cache, causal over x (training)
          "prefill" — write the cache at ``positions``, causal
          "decode"  — x is (B, 1, d); write the cache at ``kv_len``
    cache: dict with "k", "v" [, "k_res", "v_res"] [, "k_scale",
    "v_scale" under int8] (layer slice, no L dim), written in place.
    """
    bsz, s, _ = x.shape
    hd = cfg.resolved_head_dim
    scale = hd ** -0.5
    if positions.dim() == 1:
        positions = positions[:, None]            # decode: (B,) -> (B, 1)
    q, sin, cos = _qkv(p_l, x, cfg, lora, adapter_ids, positions)

    k_base = (x @ p_l["wk"]).reshape(bsz, s, cfg.num_kv_heads, hd)
    v_base = (x @ p_l["wv"]).reshape(bsz, s, cfg.num_kv_heads, hd)
    if cfg.use_rope:
        k_base = rope_lib.apply_rope(k_base, sin, cos)

    use_dis = disagg and lora is not None
    if use_dis:
        k_res = _bgmv_down(x, lora["a_k"], lora["scaling"], adapter_ids)
        v_res = _bgmv_down(x, lora["a_v"], lora["scaling"], adapter_ids)
        bk_rows = lora["b_k"][adapter_ids].reshape(bsz, cfg.lora.rank, -1)
        bv_rows = lora["b_v"][adapter_ids].reshape(bsz, cfg.lora.rank, -1)
    else:
        if lora is not None:   # unified: fold LoRA into cached K/V exactly
            k_off = _bgmv(x, lora["a_k"], lora["b_k"], lora["scaling"],
                          adapter_ids).reshape(bsz, s, cfg.num_kv_heads, hd)
            v_off = _bgmv(x, lora["a_v"], lora["b_v"], lora["scaling"],
                          adapter_ids).reshape(bsz, s, cfg.num_kv_heads, hd)
            if cfg.use_rope:
                k_off = rope_lib.apply_rope(k_off, sin, cos)
            k_base = k_base + k_off
            v_base = v_base + v_off
        k_res = v_res = bk_rows = bv_rows = None

    if mode == "full":
        if not use_dis:
            out = attn_lib.mha(q, k_base, v_base, causal=True, window=window,
                               scale=scale)
        elif s >= attn_lib.FLASH_THRESHOLD and window > 0:
            out = attn_lib.banded_window_attention(
                q, k_base, v_base, window=window, scale=scale, k_res=k_res,
                v_res=v_res, b_k=bk_rows, b_v=bv_rows,
                rope_theta=cfg.rope_theta, use_rope=cfg.use_rope)
        elif s >= attn_lib.FLASH_THRESHOLD:
            out = attn_lib.flash_attention(
                q, k_base, v_base, qpos=positions, kpos=positions,
                window=window, causal=True, scale=scale, k_res=k_res,
                v_res=v_res, b_k=bk_rows, b_v=bv_rows,
                rope_theta=cfg.rope_theta, use_rope=cfg.use_rope)
        else:
            # attention over reconstructed K/V: train/serve parity.  The
            # reference passes kv_len=None, which means all of Sk is valid
            out = kernel_ops.residual_attention(
                q, k_base, v_base, k_res, v_res, bk_rows, bv_rows, sin, cos,
                qpos=positions, kv_len=None, window=window, causal=True,
                scale=scale)
        return out, None

    if cache is None:
        raise ValueError(f"mode {mode!r} needs a cache")
    smax = cache["k"].shape[1]
    is_ring = window > 0 and smax == window
    quant = cfg.kv_quant == "int8"

    def write(slot, *pairs):
        """Scatter (B, n, ...) rows into cache slots (B, n), in place."""
        bidx = torch.arange(bsz, device=x.device)[:, None]
        for name, t in pairs:
            cache[name][bidx, slot.long()] = t.to(cache[name].dtype)

    def write_kv(slot, k, v):
        """The base K/V write, quantized with its scales under int8."""
        if not quant:
            write(slot, ("k", k), ("v", v))
            return
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        write(slot, ("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs))

    if mode == "prefill":
        new_len = positions[:, -1] + 1
        banded = is_ring and chunk_start == 0 and \
            s >= attn_lib.FLASH_THRESHOLD and s >= window
        if is_ring and not banded:
            # a chunk may overwrite ring slots its own earlier queries still
            # need: attend over [old cache ‖ fresh chunk], concatenated
            # before the writes below
            old_kpos = _ring_kpos(positions[:, 0], window)   # state@start
            k_old, v_old = _cache_kv(cache, cfg, q.dtype)
            k_all = torch.cat([k_old, k_base.to(k_old.dtype)], dim=1)
            v_all = torch.cat([v_old, v_base.to(v_old.dtype)], dim=1)
            kpos_all = torch.cat([old_kpos, positions], dim=1)
            kr_all = vr_all = None
            if use_dis:
                rdt = cache["k_res"].dtype
                kr_all = torch.cat([cache["k_res"], k_res.to(rdt)], dim=1)
                vr_all = torch.cat([cache["v_res"], v_res.to(rdt)], dim=1)
        if is_ring and s >= window:
            # only the last `window` chunk tokens survive: write exactly one
            # token per ring slot (duplicate scatter indices are undefined)
            slot = positions[:, -window:] % window
            last = slice(s - window, s)
        else:
            slot = (positions % window) if is_ring else positions
            last = slice(0, s)
        write_kv(slot, k_base[:, last], v_base[:, last])
        if k_res is not None:
            write(slot, ("k_res", k_res[:, last]), ("v_res", v_res[:, last]))
        if banded:
            # first chunk fills the whole ring: banded self-attention over
            # the fresh chunk (no old cache to attend to)
            out = attn_lib.banded_window_attention(
                q, k_base, v_base, window=window, scale=scale,
                k_res=k_res, v_res=v_res, b_k=bk_rows, b_v=bv_rows,
                rope_theta=cfg.rope_theta, use_rope=cfg.use_rope)
        elif is_ring:
            out = _attend(q, k_all, v_all, kr_all, vr_all, bk_rows, bv_rows,
                          kpos_all, None, positions, window, scale, cfg,
                          use_dis)
        else:
            # attention over the *updated* cache (covers chunked prefill)
            out = _cached_attention(q, cache, positions, new_len, cfg,
                                    bk_rows, bv_rows, window, is_ring, scale,
                                    use_dis)
        return out, cache

    # decode: s == 1
    slot = (kv_len % window) if is_ring else kv_len
    write_kv(slot[:, None], k_base, v_base)
    if k_res is not None:
        write(slot[:, None], ("k_res", k_res), ("v_res", v_res))
    out = _cached_attention(q, cache, positions, kv_len + 1, cfg, bk_rows,
                            bv_rows, window, is_ring, scale, use_dis)
    return out, cache


def _cache_kv(cache, cfg: ModelConfig, dtype: torch.dtype):
    """A layer cache's K/V, dequantized to ``dtype`` under int8 (the
    reference's ``dequantize_kv`` before attention)."""
    if cfg.kv_quant != "int8":
        return cache["k"], cache["v"]
    return (dequantize_kv(cache["k"], cache["k_scale"], dtype),
            dequantize_kv(cache["v"], cache["v_scale"], dtype))


def _cached_attention(q, cache, qpos, kv_len, cfg, bk_rows, bv_rows,
                      window, is_ring, scale, use_disagg):
    """Attention of q against a (possibly ring) cache."""
    k, v = _cache_kv(cache, cfg, q.dtype)
    bsz, smax = k.shape[0], k.shape[1]
    if is_ring:
        kmask_pos = _ring_kpos(kv_len, smax)      # (B, W) absolute positions
        valid_len = None
    else:
        kmask_pos = torch.arange(smax, device=k.device).expand(bsz, smax)
        valid_len = kv_len
    return _attend(q, k, v, cache.get("k_res"), cache.get("v_res"),
                   bk_rows, bv_rows, kmask_pos, valid_len, qpos, window,
                   scale, cfg, use_disagg)


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


# --------------------------------------------------------------------------
# Full model
# --------------------------------------------------------------------------
def _layer_window(cfg: ModelConfig) -> int:
    return cfg.sliding_window


def embed_tokens(params, tokens, cfg: ModelConfig,
                 extra_embeds: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Token embeddings, with ``extra_embeds`` (B, P, d) (the VLM's stubbed
    patch embeddings, through ``mm_projector`` where the model has one)
    before them.  The projection runs in the wider of the two types, as
    JAX promotes a mixed product."""
    x = params["embed"][tokens]
    if extra_embeds is not None:
        if "mm_projector" in params:
            proj = params["mm_projector"]
            wide = torch.promote_types(extra_embeds.dtype, proj.dtype)
            extra_embeds = extra_embeds.to(wide) @ proj.to(wide)
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    return x


def unembed(params, x, cfg: ModelConfig) -> torch.Tensor:
    x = base.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["unembed"]


def _layer_fn(x, p_l, cfg, *, positions, mode, cache_l, kv_len, lora_l,
              adapter_ids, disagg, chunk_start=None):
    h = base.rms_norm(x, p_l["ln1"], cfg.norm_eps)
    attn_out, new_cache = attention(
        p_l, h, cfg, positions=positions, mode=mode, cache=cache_l,
        kv_len=kv_len, lora=lora_l, adapter_ids=adapter_ids, disagg=disagg,
        window=_layer_window(cfg), chunk_start=chunk_start)
    x = x + attn_out.reshape(x.shape[0], x.shape[1], -1) @ p_l["wo"]
    h = base.rms_norm(x, p_l["ln2"], cfg.norm_eps)
    x = x + ffn(p_l, h, cfg)
    return x, new_cache


_ATTN_KEYS = ("ln1", "ln2", "wq", "wk", "wv", "wo")
_DENSE_KEYS = ("w_gate", "w_up", "w_down")
_MOE_KEYS = ("router", "w_gate_e", "w_up_e", "w_down_e",
             "w_gate_s", "w_up_s", "w_down_s")


def layer_params(params, cfg: ModelConfig, li: int) -> Params:
    """Layer ``li``'s parameters, as the model's schedule runs it.  Every
    layer has its own attention keys.  With ``moe_interleave`` = iv > 1
    (llama4) the layers come in groups of iv: iv - 1 dense-MLP sublayers,
    then one MoE sublayer, so layer li = g·iv + j takes dense MLP g·(iv-1) +
    j for j < iv - 1 and MoE layer g for j = iv - 1 (the reference's
    ``_apply_layers_interleaved``).  Otherwise every leaf is sliced at
    ``li``."""
    layers = params["layers"]
    iv = cfg.moe_interleave if cfg.num_experts else 1
    if iv == 1:
        return {k: t[li] for k, t in layers.items()}
    g, j = divmod(li, iv)
    p_l = {k: layers[k][li] for k in _ATTN_KEYS}
    if j == iv - 1:
        p_l.update({k: layers[k][g] for k in _MOE_KEYS if k in layers})
    else:
        p_l.update({k: layers[k][g * (iv - 1) + j] for k in _DENSE_KEYS})
    return p_l


def remat_unit(cfg: ModelConfig) -> int:
    """Layers per ``jax.checkpoint`` unit of the reference's layer scan:
    one layer; a group of ``moe_interleave`` layers for interleaved MoE
    stacks; L / ``scan_groups`` layers under the two-level scan."""
    iv = cfg.moe_interleave if cfg.num_experts else 1
    if iv > 1:
        return iv
    g = cfg.scan_groups
    if cfg.scan_layers and g and g > 1 and cfg.num_layers % g == 0:
        return cfg.num_layers // g
    return 1


def apply_layers(params, x, cfg: ModelConfig, *, positions, mode: str,
                 cache=None, kv_len=None, lora=None, adapter_ids=None,
                 disagg: bool = False, chunk_start=None):
    """The layer stack as a plain loop over ``layer_params`` (the reference
    scans it, and scans interleaved MoE stacks by group; running eagerly
    needs neither).  With ``cfg.remat`` in mode "full", while grad mode is
    on, each of the reference's checkpoint units (``remat_unit``) runs
    under ``torch.utils.checkpoint``.  cache/lora leaves carry a leading L
    dim; each layer writes its slice of the cache in place.  Returns (x,
    cache)."""
    def run(lo: int, hi: int, x):
        for i in range(lo, hi):
            p_l = layer_params(params, cfg, i)
            c_l = {k: t[i] for k, t in cache.items()} \
                if cache is not None else None
            l_l = {k: t[i] for k, t in lora.items()} \
                if lora is not None else None
            x, _ = _layer_fn(x, p_l, cfg, positions=positions, mode=mode,
                             cache_l=c_l, kv_len=kv_len, lora_l=l_l,
                             adapter_ids=adapter_ids, disagg=disagg,
                             chunk_start=chunk_start)
        return x

    unit = remat_unit(cfg)
    for lo in range(0, cfg.num_layers, unit):
        x = base.remat(run, lo, min(lo + unit, cfg.num_layers), x,
                       on=cfg.remat and mode == "full")
    return x, cache


def forward(params, tokens, cfg: ModelConfig, *, extra_embeds=None,
            lora=None, adapter_ids=None, disagg: bool = False
            ) -> torch.Tensor:
    """Full causal pass -> logits (B, S_total, V): with ``extra_embeds``
    (B, P, d) the P patch positions come first, and positions run over the
    whole sequence."""
    x = embed_tokens(params, tokens, cfg, extra_embeds)
    bsz, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(bsz, s)
    x, _ = apply_layers(params, x, cfg, positions=positions, mode="full",
                        lora=lora, adapter_ids=adapter_ids, disagg=disagg)
    return unembed(params, x, cfg)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               disagg: bool = False, dtype=None, *,
               device: Optional[Union[str, torch.device]] = None) -> Params:
    """Zeroed contiguous caches (L, batch, Smax, ...) on ``device`` (None:
    the CUDA device); a sliding-window model keeps a ring of
    ``min(max_len, window)`` slots.  Under ``kv_quant == "int8"`` K/V are
    int8 with f32 ``k_scale``/``v_scale`` of shape (L, batch, Smax, Hkv);
    the residual caches stay in ``dtype``."""
    dev = resolve_device(device)
    dt = dtype or cfg.activation_dtype
    hd = cfg.resolved_head_dim
    L = cfg.num_layers
    w = cfg.sliding_window
    smax = min(max_len, w) if w else max_len
    shape = (L, batch, smax, cfg.num_kv_heads, hd)
    kv_dt = torch.int8 if cfg.kv_quant == "int8" else dt
    cache = {"k": torch.zeros(shape, dtype=kv_dt, device=dev),
             "v": torch.zeros(shape, dtype=kv_dt, device=dev)}
    if cfg.kv_quant == "int8":
        cache["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=dev)
        cache["v_scale"] = torch.zeros_like(cache["k_scale"])
    if disagg:
        res = (L, batch, smax, cfg.lora.rank)
        cache["k_res"] = torch.zeros(res, dtype=dt, device=dev)
        cache["v_res"] = torch.zeros(res, dtype=dt, device=dev)
    return cache


def cache_logical_axes(cfg: ModelConfig, disagg: bool = False) -> Params:
    """The logical axes of the caches (:func:`init_cache`)."""
    axes = {"k": ("layers", "batch", None, "kv_heads", "kv_head_dim"),
            "v": ("layers", "batch", None, "kv_heads", "kv_head_dim")}
    if cfg.kv_quant == "int8":
        axes["k_scale"] = ("layers", "batch", None, "kv_heads")
        axes["v_scale"] = ("layers", "batch", None, "kv_heads")
    if disagg:
        axes["k_res"] = ("layers", "batch", None, "rank")
        axes["v_res"] = ("layers", "batch", None, "rank")
    return axes


def prefill(params, tokens, cache, cfg: ModelConfig, *, start: int = 0,
            extra_embeds=None, lora=None, adapter_ids=None,
            disagg: bool = False):
    """Populate the cache with the prompt (in place); returns (last-token
    logits (B, 1, V), cache)."""
    x = embed_tokens(params, tokens, cfg, extra_embeds)
    bsz, s, _ = x.shape
    positions = torch.arange(start, start + s, device=x.device).expand(bsz, s)
    x, cache = apply_layers(params, x, cfg, positions=positions,
                            mode="prefill", cache=cache, lora=lora,
                            adapter_ids=adapter_ids, disagg=disagg,
                            chunk_start=start)
    return unembed(params, x[:, -1:], cfg), cache


def decode_step(params, tokens, cache, kv_len, cfg: ModelConfig, *,
                lora=None, adapter_ids=None, disagg: bool = False):
    """One decode step (cache written in place).  tokens: (B,), kv_len:
    (B,) tokens already cached.  Returns (logits (B, V), cache)."""
    x = params["embed"][tokens][:, None]          # (B, 1, d)
    x, cache = apply_layers(params, x, cfg, positions=kv_len,
                            mode="decode", cache=cache, kv_len=kv_len,
                            lora=lora, adapter_ids=adapter_ids, disagg=disagg)
    return unembed(params, x, cfg)[:, 0], cache
