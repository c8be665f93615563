"""Paged model executor over pooled KV pages (port of
``repro/serving/executor.py``).

The pools are tensors of shape (L, num_pages, page_size, ...); requests
address them through block tables.  In ForkKV mode two pools exist — the
shared bCache pool and the per-agent rCache pool — and attention runs over
the disaggregated layout.

Decode, the unified mixed prefill/decode step, the phase-separated batched
prefill and the broadcast-fork base trajectory are page-native: each layer
hands the pools and per-request block tables straight to the dispatchers
in :mod:`repro_torch.kernels.ops`, which launch the CUDA kernels on the
card and the plain versions on the CPU.  ``ServeConfig.use_paged_kernel =
False`` keeps the reference's gather-to-contiguous path instead (every
request's pages gathered into a ``max_pages_per_req``-wide view and
attended by :func:`repro_torch.models.transformer._attend`); each executor
call that takes it increments ``fallback_gather_calls``.  Shapes are
bucketed exactly as in the reference — batches pad to powers of two, paged
block tables to the power-of-two bucket of the batch's live page count —
so the number of distinct shapes stays logarithmic (one CUDA graph per
bucket is later work).  Executor methods return DEVICE tensors; the engine
reads them back once per step.

Pool writes are in place (``index_put_`` through advanced-index
assignment) where the reference donated the pools to ``.at[].set``.
Padding rows and CoW-inherited positions all write to the reserved dump
page, so the index lists hold duplicates; that is harmless, since the dump
page is never read at a valid position.

With ``ModelConfig.kv_quant == "int8"`` the bCache pools are int8 with f32
per-(token, head) scale pools ``kb_s``/``vb_s``: every base write is
quantized (``transformer.quantize_kv``, as the reference does), the paged
kernels take the scales and dequantize each page on chip, and the gather
path dequantizes the gathered view.  The rCache stays full precision.
``export_pages``/``import_pages`` move whole pages between the pools and
host numpy blobs for the host/disk tiers and persist/restore; int8 pages
travel with their scales.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core import rope as rope_lib
from repro_torch.core.config import ModelConfig, ServeConfig
from repro_torch.core.device import resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import paged_residual_attention as pra
from repro_torch.kernels import residual_attention as ra
from repro_torch.models import base
from repro_torch.models import transformer as tfm
from repro_torch.serving.sampling import sample_tokens
from repro_torch.serving.tiers import BFLOAT16

Params = Dict


def _pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1)."""
    return 1 << max(0, n - 1).bit_length()


class Pools(NamedTuple):
    kb: torch.Tensor            # (L, Pb, page, Hkv, hd)  base K (RoPE'd)
    vb: torch.Tensor            # (L, Pb, page, Hkv, hd)  base V
    kr: Optional[torch.Tensor]  # (L, Pr, page, R)        residual K (no RoPE)
    vr: Optional[torch.Tensor]
    # int8 bCache pages: per-(token, head) f32 dequant scales, written with
    # every kb/vb write; None on the full-precision path
    kb_s: Optional[torch.Tensor] = None   # (L, Pb, page, Hkv)
    vb_s: Optional[torch.Tensor] = None


def make_pools(cfg: ModelConfig, num_pages: int, num_res_pages: int,
               page_size: int, disagg: bool, dtype=None,
               device=None) -> Pools:
    dev = resolve_device(device)
    dt = dtype or cfg.activation_dtype
    L, hd = cfg.num_layers, cfg.resolved_head_dim
    quant = cfg.kv_quant == "int8"
    kb = torch.zeros((L, num_pages, page_size, cfg.num_kv_heads, hd),
                     dtype=torch.int8 if quant else dt, device=dev)
    vb = torch.zeros_like(kb)
    if disagg:
        kr = torch.zeros((L, num_res_pages, page_size, cfg.lora.rank),
                         dtype=dt, device=dev)
        vr = torch.zeros_like(kr)
    else:
        kr = vr = None
    kb_s = vb_s = None
    if quant:
        kb_s = torch.zeros(kb.shape[:-1], dtype=torch.float32, device=dev)
        vb_s = torch.zeros_like(kb_s)
    return Pools(kb, vb, kr, vr, kb_s, vb_s)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def pool_bytes(pools: Pools) -> Dict[str, int]:
    out = {"base": _nbytes(pools.kb) + _nbytes(pools.vb)}
    if pools.kb_s is not None:
        out["base"] += _nbytes(pools.kb_s) + _nbytes(pools.vb_s)
    out["residual"] = _nbytes(pools.kr) + _nbytes(pools.vr) \
        if pools.kr is not None else 0
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host copy; bf16 comes back as its bit patterns tagged ``BFLOAT16``
    (numpy has no bf16)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(BFLOAT16)
    return t.cpu().numpy()


def _from_numpy(a: np.ndarray, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """Inverse of :func:`_to_numpy`: a bf16 pool's blobs are its 16-bit
    patterns."""
    a = np.ascontiguousarray(a)
    if dtype == torch.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(dtype).to(device)
    return torch.from_numpy(a).to(device)


def check_card_geometry(cfg: ModelConfig, serve_cfg: ServeConfig,
                        disagg: bool) -> None:
    """The paged kernels' geometry, which a card server must fit: the head
    and page geometry (``pra.check_heads``) and, with the residual stream,
    a LoRA rank of at least 1 (every such rank runs: above 64 the chunked
    instances).  Raises ValueError."""
    pra.check_heads(cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
                    serve_cfg.page_size)
    if disagg:
        ra.rank_instance(cfg.lora.rank)


class PagedExecutor:
    """Paged decode, prefill and mixed prefill/decode for llama-family
    models."""

    def __init__(self, cfg: ModelConfig, params: Params,
                 lora: Optional[Params], serve_cfg: ServeConfig,
                 disagg: bool, max_pages_per_req: int, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and serve_cfg.use_paged_kernel:
            # refused here and not at the first step, whose errors the
            # engine isolates
            check_card_geometry(cfg, serve_cfg, disagg and lora is not None)
        if self.device.type == "cuda" and self.device.index is None:
            # an explicit index, which a thread other than this one binds
            # (``bind_thread``)
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.cfg = cfg
        self.params = params
        self.lora = lora
        self.sc = serve_cfg
        self.disagg = disagg and lora is not None
        self.page = serve_cfg.page_size
        self.max_pages_per_req = max_pages_per_req
        # page-native attention (pools + block tables into the kernels), or
        # the gather-to-contiguous path kept for parity testing
        self.use_paged = serve_cfg.use_paged_kernel
        self.min_table_pages = serve_cfg.min_table_pages
        # int8 bCache pages: quantize at write time, dequantize per page on
        # chip in the kernels, or after the gather on the gather path
        self.kv_quant = cfg.kv_quant == "int8"
        # executor calls that took the gather-to-contiguous path (0 whenever
        # use_paged_kernel=True; surfaced via Engine.metrics())
        self.fallback_gather_calls = 0
        res_factor = max(1, cfg.kv_dim // max(cfg.lora.rank, 1)) \
            if self.disagg else 1
        self.num_res_pages = serve_cfg.max_pages * res_factor \
            if self.disagg else serve_cfg.max_pages
        self.pools = make_pools(cfg, serve_cfg.max_pages, self.num_res_pages,
                                self.page, self.disagg, device=self.device)
        # reserved scratch pages (the engine overwrites these with the pages
        # it actually allocated); residual pool has its OWN dump page
        self.dump_page = serve_cfg.max_pages - 1
        self.dump_page_r = self.num_res_pages - 1
        # distinct decode shapes seen: (batch bucket, width bucket, sampled)
        self._decode_shapes: Set[Tuple[int, int, bool]] = set()

    # ------------------------------------------------ tiered KV offload
    def _page_pools(self, kind: str) -> List[Tuple[str, torch.Tensor]]:
        """(blob key, pool) pairs of one page kind: "base" (kb/vb, and the
        scales ks/vs of int8 pages) or "res" (kr/vr)."""
        p = self.pools
        if kind != "base":
            return [("k", p.kr), ("v", p.vr)]
        pairs = [("k", p.kb), ("v", p.vb)]
        if self.kv_quant:
            pairs += [("ks", p.kb_s), ("vs", p.vb_s)]
        return pairs

    @torch.no_grad()
    def export_pages(self, kind: str,
                     page_ids: Sequence[int]) -> List[Dict]:
        """Device→host copy of whole KV pages (DESIGN.md §10).

        ``kind`` selects the pool ("base" → kb/vb, "res" → kr/vr).  Returns
        one blob per page — ``{"k": (L, page, ...), "v": ...}`` numpy arrays
        holding the exact bytes (plus ``"ks"``/``"vs"`` scales of int8
        pages), so a later :meth:`import_pages` restores the cache
        bit-identically.
        """
        ids = torch.tensor(list(page_ids), dtype=torch.long,
                           device=self.device)
        arrays = [(key, _to_numpy(pool[:, ids]))
                  for key, pool in self._page_pools(kind)]
        # per-page COPIES, not views: each blob must be independently
        # freeable or the HostTier's byte accounting undercounts (a
        # surviving 1-page view would pin the whole n-page export)
        return [{key: a[:, i].copy() for key, a in arrays}
                for i in range(len(page_ids))]

    @torch.no_grad()
    def import_pages(self, kind: str, page_ids: Sequence[int],
                     blobs: Sequence[Dict]) -> None:
        """Host→device copy: write blobs back into freshly allocated pages
        (the promotion half of the tier lifecycle), in place.  The
        reference pads the page count to a power of two and donates the
        pools only to bound XLA recompiles; writing ``pool[:, ids]`` in
        place gives the same pools."""
        ids = torch.tensor(list(page_ids), dtype=torch.long,
                           device=self.device)
        for key, pool in self._page_pools(kind):
            pool[:, ids] = _from_numpy(
                np.stack([b[key] for b in blobs], axis=1), pool.dtype,
                self.device)

    # ------------------------------------------------------------ helpers
    def _layer_params(self, li):
        # the model's own schedule (``tfm.layer_params``): an interleaved
        # MoE stack (llama4) runs its dense sublayers too; the reference
        # slices every leaf at ``li``, which JAX clamps past the MoE stack
        return tfm.layer_params(self.params, self.cfg, li)

    def _lora_layer(self, li):
        if self.lora is None:
            return None
        return {k: v[li] for k, v in self.lora.items()}

    def _i32(self, values) -> torch.Tensor:
        return torch.tensor(values, dtype=torch.int32, device=self.device)

    def _project_kv(self, p_l, lora_l, h, sin, cos, adapter_ids):
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        bsz, s, _ = h.shape
        k_base = (h @ p_l["wk"]).reshape(bsz, s, cfg.num_kv_heads, hd)
        v_base = (h @ p_l["wv"]).reshape(bsz, s, cfg.num_kv_heads, hd)
        if cfg.use_rope:
            k_base = rope_lib.apply_rope(k_base, sin, cos)
        if self.disagg:
            k_res = tfm._bgmv_down(h, lora_l["a_k"], lora_l["scaling"],
                                   adapter_ids)
            v_res = tfm._bgmv_down(h, lora_l["a_v"], lora_l["scaling"],
                                   adapter_ids)
            bk = lora_l["b_k"][adapter_ids]
            bv = lora_l["b_v"][adapter_ids]
            return k_base, v_base, k_res, v_res, bk, bv
        if lora_l is not None:   # unified: fold LoRA exactly into K/V
            k_off = tfm._bgmv(h, lora_l["a_k"], lora_l["b_k"],
                              lora_l["scaling"], adapter_ids)
            v_off = tfm._bgmv(h, lora_l["a_v"], lora_l["b_v"],
                              lora_l["scaling"], adapter_ids)
            k_off = k_off.reshape(bsz, s, cfg.num_kv_heads, hd)
            v_off = v_off.reshape(bsz, s, cfg.num_kv_heads, hd)
            if cfg.use_rope:
                k_off = rope_lib.apply_rope(k_off, sin, cos)
            k_base = k_base + k_off
            v_base = v_base + v_off
        return k_base, v_base, None, None, None, None

    def _write_base(self, li, wp, woff, k, v):
        """Write base K/V rows into layer ``li``'s pools in place,
        quantized with their scales under int8 (the reference's
        ``_maybe_quant``).  Returns the layer's (kb, vb, kb_s, vb_s), the
        scales None on the full-precision path."""
        pools = self.pools
        kbp, vbp = pools.kb[li], pools.vb[li]
        if not self.kv_quant:
            kbp[wp, woff] = k
            vbp[wp, woff] = v
            return kbp, vbp, None, None
        ksp, vsp = pools.kb_s[li], pools.vb_s[li]
        kq, ks = tfm.quantize_kv(k)
        vq, vs = tfm.quantize_kv(v)
        kbp[wp, woff] = kq
        vbp[wp, woff] = vq
        ksp[wp, woff] = ks
        vsp[wp, woff] = vs
        return kbp, vbp, ksp, vsp

    def _gather(self, li, bt_b, bt_r=None, bk=None, bv=None):
        """The gather path: layer ``li``'s pages of every row copied into
        contiguous (B, W·page, ...) views; int8 pages are dequantized to
        the activation dtype after the gather.  Returns (k, v, k_res,
        v_res, b_k, b_v); the residual parts are None when ``bt_r`` is."""
        cfg, pools = self.cfg, self.pools
        bsz, w = bt_b.shape[0], bt_b.shape[1] * self.page
        btb = bt_b.long()
        kc, vc = pools.kb[li][btb], pools.vb[li][btb]
        if self.kv_quant:
            dt = cfg.activation_dtype
            kc = tfm.dequantize_kv(kc, pools.kb_s[li][btb], dt)
            vc = tfm.dequantize_kv(vc, pools.vb_s[li][btb], dt)
        kc = kc.reshape(bsz, w, cfg.num_kv_heads, -1)
        vc = vc.reshape(bsz, w, cfg.num_kv_heads, -1)
        if bt_r is None:
            return kc, vc, None, None, None, None
        btr = bt_r.long()
        krc = pools.kr[li][btr].reshape(bsz, w, -1)
        vrc = pools.vr[li][btr].reshape(bsz, w, -1)
        return kc, vc, krc, vrc, bk.reshape(bsz, cfg.lora.rank, -1), \
            bv.reshape(bsz, cfg.lora.rank, -1)

    def _pad_table(self, pages: Sequence[int], width: int,
                   dump: int) -> List[int]:
        """Crop/pad one block table to ``width`` entries."""
        bt = list(pages)[:width]
        return bt + [dump] * (width - len(bt))

    def _bucket_width(self, need: int) -> int:
        """Block-table width bucket for a batch needing ``need`` live
        pages: next power of two, floor ``min_table_pages``, capped at
        ``max_pages_per_req`` — shared by decode and mixed shapes."""
        return min(self.max_pages_per_req,
                   max(min(self.min_table_pages, self.max_pages_per_req),
                       _pow2(need)))

    def _table_width(self, need: int) -> int:
        """Block-table width of one call: the bucketed live width on the
        paged path; ``max_pages_per_req`` on the gather path, which counts
        the call in ``fallback_gather_calls``."""
        if self.use_paged:
            return self._bucket_width(need)
        self.fallback_gather_calls += 1
        return self.max_pages_per_req

    def _select(self, logits, poison, temps, top_ks, top_ps, seeds, spos,
                sampled: bool):
        """Quarantine guard + token choice.  ``poison`` rows get NaN logits
        (fault injection); ``row_ok`` is the per-row isfinite guard that
        rides the engine's one host read per step."""
        logits = torch.where(poison[:, None] > 0,
                             torch.full_like(logits, float("nan")), logits)
        row_ok = torch.isfinite(logits).all(dim=-1)
        if sampled:
            next_tok = sample_tokens(logits, temps, top_ks, top_ps, seeds,
                                     spos)
        else:
            next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return logits, next_tok, row_ok

    # ------------------------------------------------------------- decode
    @torch.no_grad()
    def _decode_fn(self, tokens, kv_len, adapter_ids, bt_b, bt_r, wpage_b,
                   wpage_r, woff, temps, top_ks, top_ps, seeds, spos,
                   poison, *, sampled):
        """One decode step for a padded batch; writes the new token's KV
        into the pools in place.

        tokens/kv_len/adapter_ids: (B,); bt_*: (B, W) bucketed block
        tables; wpage_*: (B,) page to write the new token's KV into (dump
        page for inactive rows); woff: (B,) in-page offsets; the sampling
        params and ``poison`` are (B,).  Returns ``(next_tok, logits,
        row_ok)``.
        """
        cfg = self.cfg
        pools = self.pools
        bsz = tokens.shape[0]
        wpb, wpr, wof = wpage_b.long(), wpage_r.long(), woff.long()
        x = self.params["embed"][tokens.long()][:, None]
        bt_r = bt_r if self.disagg else None
        kmask_pos = torch.arange(bt_b.shape[1] * self.page,
                                 device=self.device).expand(bsz, -1)
        for li in range(cfg.num_layers):
            p_l = self._layer_params(li)
            lora_l = self._lora_layer(li)
            h = base.rms_norm(x, p_l["ln1"], cfg.norm_eps)
            q, sin, cos = tfm._qkv(p_l, h, cfg, lora_l, adapter_ids,
                                   kv_len[:, None])
            kb_, vb_, kr_, vr_, bk, bv = self._project_kv(
                p_l, lora_l, h, sin, cos, adapter_ids)
            # write the new token in place (the reference's donated .at[].set)
            kbp, vbp, ksp, vsp = self._write_base(li, wpb, wof, kb_[:, 0],
                                                  vb_[:, 0])
            if self.disagg:
                krp, vrp = pools.kr[li], pools.vr[li]
                krp[wpr, wof] = kr_[:, 0]
                vrp[wpr, wof] = vr_[:, 0]
            if self.use_paged:
                attn = kernel_ops.paged_residual_attention(
                    q[:, 0], kbp, vbp,
                    krp if self.disagg else None,
                    vrp if self.disagg else None,
                    bk if self.disagg else None,
                    bv if self.disagg else None,
                    bt_b, bt_r, kv_len + 1,
                    scale=cfg.resolved_head_dim ** -0.5,
                    window=cfg.sliding_window,
                    rope_theta=cfg.rope_theta, use_rope=cfg.use_rope,
                    kb_scale=ksp, vb_scale=vsp)
            else:
                attn = tfm._attend(
                    q, *self._gather(li, bt_b, bt_r, bk, bv), kmask_pos,
                    kv_len + 1, kv_len[:, None], cfg.sliding_window,
                    cfg.resolved_head_dim ** -0.5, cfg, self.disagg)
            x = x + attn.reshape(bsz, 1, -1) @ p_l["wo"]
            h = base.rms_norm(x, p_l["ln2"], cfg.norm_eps)
            x = x + tfm.ffn(p_l, h, cfg)
        logits = tfm.unembed(self.params, x, cfg)[:, 0]
        logits, next_tok, row_ok = self._select(
            logits, poison, temps, top_ks, top_ps, seeds, spos, sampled)
        return next_tok, logits, row_ok

    def decode(self, tokens, kv_len, adapter_ids, base_tables, res_tables,
               wpage_b, wpage_r, woff, temps=None, top_ks=None,
               top_ps=None, seeds=None, spos=None, poison=None):
        """One decode step over ``len(tokens)`` live rows.

        ``base_tables``/``res_tables`` are RAW per-request page lists; this
        method owns the shape policy: the batch pads to the next power of
        two (<= ``max_batch``) and block tables crop/pad to the bucketed
        live width (the gather path: to ``max_pages_per_req``).  Returns
        DEVICE tensors ``(next_tok, logits, row_ok)``; rows past the live
        count are padding.
        """
        bsz = len(tokens)
        if bsz > self.sc.max_batch:
            raise ValueError(f"decode batch {bsz} > max_batch "
                             f"{self.sc.max_batch}")
        bpad = min(_pow2(bsz), self.sc.max_batch)
        width = self._table_width(max(kvl // self.page + 1
                                      for kvl in kv_len))
        bt_b = [self._pad_table(p, width, self.dump_page)
                for p in base_tables]
        bt_r = [self._pad_table(p, width, self.dump_page_r)
                for p in res_tables]
        temps = list(temps) if temps is not None else [0.0] * bsz
        top_ks = list(top_ks) if top_ks is not None else [0] * bsz
        top_ps = list(top_ps) if top_ps is not None else [1.0] * bsz
        seeds = list(seeds) if seeds is not None else [0] * bsz
        spos = list(spos) if spos is not None else [0] * bsz
        poison = list(poison) if poison is not None else [0] * bsz
        pad = bpad - bsz
        tokens = list(tokens) + [0] * pad
        kv_len = list(kv_len) + [0] * pad
        adapter_ids = list(adapter_ids) + [0] * pad
        bt_b += [[self.dump_page] * width] * pad
        bt_r += [[self.dump_page_r] * width] * pad
        wpage_b = list(wpage_b) + [self.dump_page] * pad
        wpage_r = list(wpage_r) + [self.dump_page_r] * pad
        woff = list(woff) + [0] * pad
        temps += [0.0] * pad
        top_ks += [0] * pad
        top_ps += [1.0] * pad
        seeds += [0] * pad
        spos += [0] * pad
        poison += [0] * pad
        sampled = any(t > 0 for t in temps)
        self._decode_shapes.add((bpad, width, sampled))
        f32 = dict(dtype=torch.float32, device=self.device)
        return self._decode_fn(
            self._i32(tokens), self._i32(kv_len), self._i32(adapter_ids),
            self._i32(bt_b), self._i32(bt_r), self._i32(wpage_b),
            self._i32(wpage_r), self._i32(woff), torch.tensor(temps, **f32),
            self._i32(top_ks), torch.tensor(top_ps, **f32),
            self._i32(seeds), self._i32(spos), self._i32(poison),
            sampled=sampled)

    def bind_thread(self) -> None:
        """Make this executor's CUDA device the calling thread's current
        one: a new thread starts on the default device whatever device the
        executor was built on, and the kernels launch on the current one
        (the HTTP front end's pump steps the engine from its own thread)."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    def decode_cache_size(self) -> int:
        """Number of distinct decode shape buckets seen (the count of CUDA
        graphs a per-bucket capture would hold)."""
        return len(self._decode_shapes)

    # ------------------------------------------------------------ prefill
    @torch.no_grad()
    def _prefill_fn(self, tokens, start, n_valid, adapter_ids, bt_b, bt_r,
                    wpages_b, wpages_r, temps, top_ks, top_ps, seeds, spos,
                    poison, *, chunk, sampled, unified=False, verify=False):
        """Chunked prefill for a PADDED batch of requests.

        tokens: (B, chunk) padded; start: (B,) absolute position of each
        row's tokens[0]; n_valid: (B,) real tokens per row (0 for padding
        rows); wpages_*: (B, chunk) page to write each token into (dump
        page where the cache is inherited — CoW: shared pages are never
        written).  Each layer writes the chunk's K/V into the pools before
        attending, so the causal mask inside the chunk is pure masking.

        ``unified`` routes the paged attention through the mixed
        prefill/decode grid: each row's ``n_valid`` rides into the kernel
        as its q-length, so decode rows padded to the chunk width and full
        prefill chunks share one launch, with padding rows exact-zeroed.
        The phase-separated prefill grid instead leaves rows past
        ``n_valid`` as rows the caller ignores; both take their logits at
        row ``n_valid - 1``, so outputs agree.

        ``verify`` additionally unembeds EVERY row position and reduces the
        longest greedy-accepted draft prefix on the device: draft
        ``d_{j+1}`` is accepted iff it equals the argmax after consuming
        ``[t0, d_1..d_j]`` and every earlier draft was.  Returns
        ``(next_tok, logits, row_ok)``, or with ``verify``
        ``(next_tok, logits, greedy_all, n_acc, row_ok)``.
        """
        cfg = self.cfg
        pools = self.pools
        bsz = tokens.shape[0]
        ar = torch.arange(chunk, device=self.device)
        positions = start[:, None] + ar[None]                 # (B, chunk)
        x = self.params["embed"][tokens.long()]               # (B, chunk, d)
        woff = (positions % self.page).long()
        valid = ar[None] < n_valid[:, None]                   # (B, chunk)
        wp_b = torch.where(valid, wpages_b, self.dump_page).long()
        wp_r = torch.where(valid, wpages_r, self.dump_page_r).long()
        kv_len = start + n_valid
        bt_r = bt_r if self.disagg else None
        kmask_pos = torch.arange(bt_b.shape[1] * self.page,
                                 device=self.device).expand(bsz, -1)
        kw = dict(scale=cfg.resolved_head_dim ** -0.5,
                  window=cfg.sliding_window, rope_theta=cfg.rope_theta,
                  use_rope=cfg.use_rope)
        for li in range(cfg.num_layers):
            p_l = self._layer_params(li)
            lora_l = self._lora_layer(li)
            h = base.rms_norm(x, p_l["ln1"], cfg.norm_eps)
            q, sin, cos = tfm._qkv(p_l, h, cfg, lora_l, adapter_ids,
                                   positions)
            kb_, vb_, kr_, vr_, bk, bv = self._project_kv(
                p_l, lora_l, h, sin, cos, adapter_ids)
            kbp, vbp, ksp, vsp = self._write_base(li, wp_b, woff, kb_, vb_)
            krp = vrp = None
            if self.disagg:
                krp, vrp = pools.kr[li], pools.vr[li]
                krp[wp_r, woff] = kr_
                vrp[wp_r, woff] = vr_
            # bk/bv are None unless disaggregated (_project_kv)
            paged = (q, kbp, vbp, krp, vrp, bk, bv, bt_b, bt_r, start)
            if self.use_paged and unified:
                attn = kernel_ops.paged_residual_attention_mixed(
                    *paged, n_valid, kv_len, kb_scale=ksp, vb_scale=vsp,
                    **kw)
            elif self.use_paged:
                attn = kernel_ops.paged_residual_attention_prefill(
                    *paged, kv_len, kb_scale=ksp, vb_scale=vsp, **kw)
            else:
                attn = tfm._attend(
                    q, *self._gather(li, bt_b, bt_r, bk, bv), kmask_pos,
                    kv_len, positions, cfg.sliding_window,
                    cfg.resolved_head_dim ** -0.5, cfg, self.disagg)
            x = x + attn.reshape(bsz, chunk, -1) @ p_l["wo"]
            h = base.rms_norm(x, p_l["ln2"], cfg.norm_eps)
            x = x + tfm.ffn(p_l, h, cfg)
        # per-row logits of the LAST VALID token
        idx = torch.clamp(n_valid - 1, min=0).long()
        rows = torch.arange(bsz, device=self.device)
        if verify:
            logits_all = tfm.unembed(self.params, x, cfg)     # (B, chunk, V)
            greedy_all = torch.argmax(logits_all, dim=-1).to(torch.int32)
            logits = logits_all[rows, idx]
            ok = (tokens[:, 1:] == greedy_all[:, :-1]) & \
                (ar[None, 1:] < n_valid[:, None])
            n_acc = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1)
        else:
            x_last = x[rows, idx][:, None]
            logits = tfm.unembed(self.params, x_last, cfg)[:, 0]   # (B, V)
        logits, next_tok, row_ok = self._select(
            logits, poison, temps, top_ks, top_ps, seeds, spos, sampled)
        if verify:
            return next_tok, logits, greedy_all, n_acc, row_ok
        return next_tok, logits, row_ok

    def _padded_prefill(self, chunks, starts, adapter_ids, base_tables,
                        res_tables, wpages_b, wpages_r, temps, top_ks,
                        top_ps, seeds, spos, poison, *, bpad, qpad, width,
                        **kw):
        """Pad ``len(chunks)`` rows to ``bpad`` rows of ``qpad`` tokens and
        block tables to ``width`` pages, then run :meth:`_prefill_fn`.
        Padding rows have no valid token and write only to the dump
        pages."""
        bsz = len(chunks)
        pad = bpad - bsz
        toks, nvalid, wb, wr, btb, btr = [], [], [], [], [], []
        for i in range(bsz):
            row = list(chunks[i])
            n_pad = qpad - len(row)
            toks.append(row + [0] * n_pad)
            nvalid.append(len(row))
            wb.append(list(wpages_b[i]) + [self.dump_page] * n_pad)
            wr.append(list(wpages_r[i]) + [self.dump_page_r] * n_pad)
            btb.append(self._pad_table(base_tables[i], width,
                                       self.dump_page))
            btr.append(self._pad_table(res_tables[i], width,
                                       self.dump_page_r))
        toks += [[0] * qpad] * pad
        nvalid += [0] * pad
        wb += [[self.dump_page] * qpad] * pad
        wr += [[self.dump_page_r] * qpad] * pad
        btb += [[self.dump_page] * width] * pad
        btr += [[self.dump_page_r] * width] * pad

        def fill(vals, default):
            vals = list(vals) if vals is not None else [default] * bsz
            return vals + [default] * pad
        temps = fill(temps, 0.0)
        f32 = dict(dtype=torch.float32, device=self.device)
        return self._prefill_fn(
            self._i32(toks), self._i32(fill(starts, 0)), self._i32(nvalid),
            self._i32(fill(adapter_ids, 0)), self._i32(btb),
            self._i32(btr), self._i32(wb), self._i32(wr),
            torch.tensor(temps, **f32), self._i32(fill(top_ks, 0)),
            torch.tensor(fill(top_ps, 1.0), **f32),
            self._i32(fill(seeds, 0)), self._i32(fill(spos, 0)),
            self._i32(fill(poison, 0)), chunk=qpad,
            sampled=any(t > 0 for t in temps), **kw)

    def _live_width(self, chunks, starts) -> int:
        """Table width covering every row's post-chunk kv extent."""
        return self._table_width(max(-(-(st + len(c)) // self.page)
                                     for c, st in zip(chunks, starts)))

    # --------------------------------------------- phase-separated prefill
    def prefill_plan(self, n_rows: int):
        """Shape policy for a batched prefill of ``n_rows`` requests:
        returns ``(bpad, chunk)`` — the power-of-two padded batch and the
        per-row token budget (``max_prefill_tokens`` split across the
        PADDED batch, so shapes stay logarithmic and B=1 degenerates to a
        single-request chunk).  The engine slices prompts with this BEFORE
        calling :meth:`prefill_batch`, which pads with the same plan."""
        bpad = _pow2(max(1, n_rows))
        return bpad, max(1, self.sc.max_prefill_tokens // bpad)

    def prefill_batch(self, chunks, starts, adapter_ids, base_tables,
                      res_tables, wpages_b, wpages_r, chunk_size,
                      temps=None, top_ks=None, top_ps=None, seeds=None,
                      spos=None, poison=None):
        """Batched chunked prefill (the phase-separated loop):
        ``len(chunks)`` rows padded per :meth:`prefill_plan`, each row
        padded to ``chunk_size`` tokens.  Block tables arrive as RAW page
        lists and cover the batch's largest post-chunk kv extent, bucketed
        like decode widths.  Returns DEVICE tensors ``(next_tok, logits,
        row_ok)`` — the engine reads them once per step, not per chunk."""
        return self._padded_prefill(
            chunks, starts, adapter_ids, base_tables, res_tables, wpages_b,
            wpages_r, temps, top_ks, top_ps, seeds, spos, poison,
            bpad=self.prefill_plan(len(chunks))[0], qpad=chunk_size,
            width=self._live_width(chunks, starts))

    # ------------------------------------------------------- mixed batch
    def mixed_step(self, chunks, starts, adapter_ids, base_tables,
                   res_tables, wpages_b, wpages_r, temps=None, top_ks=None,
                   top_ps=None, seeds=None, spos=None, poison=None,
                   verify=False, qfloor=0):
        """One iteration-level mixed batch: decode rows
        (``chunks[i] == [last_token]``, ``starts[i] == kv_len``) and
        chunked-prefill rows side by side, executed as a SINGLE call.

        A plan whose rows are all single-token and fit the decode batch
        delegates to :meth:`decode`.  Truly mixed plans pad rows to the
        power-of-two chunk width of the LONGEST row and run the unified
        grid, each row's real length riding in as its q-length.  Returns
        DEVICE tensors ``(next_tok, logits, row_ok)``; rows past
        ``len(chunks)`` are padding.  ``verify=True`` returns
        ``(next_tok, logits, greedy_all, n_acc, row_ok)``; ``qfloor``
        overrides the q-tile floor for verify-only plans.
        """
        bsz = len(chunks)
        qmax = max(len(c) for c in chunks)
        if not verify and qmax == 1 and bsz <= self.sc.max_batch:
            # decode-shaped plan: write position == starts, attend over
            # starts+1 tokens — exactly the decode contract
            return self.decode(
                [c[0] for c in chunks], list(starts), adapter_ids,
                base_tables, res_tables,
                [w[0] for w in wpages_b], [w[0] for w in wpages_r],
                [s % self.page for s in starts], temps=temps,
                top_ks=top_ks, top_ps=top_ps, seeds=seeds, spos=spos,
                poison=poison)
        # shape buckets with FLOORS, as in the reference: the batch floors
        # at the steady-state size and the q tile at the prefill chunk cap,
        # so the schedule's timing cannot spray one shape per combination
        qfloor = qfloor if qfloor > 0 else min(self.sc.max_prefill_tokens,
                                               32)
        return self._padded_prefill(
            chunks, starts, adapter_ids, base_tables, res_tables, wpages_b,
            wpages_r, temps, top_ks, top_ps, seeds, spos, poison,
            bpad=_pow2(max(bsz, min(self.sc.max_batch, 4))),
            qpad=_pow2(max(qmax, qfloor)),
            width=self._live_width(chunks, starts), unified=True,
            verify=verify)

    # ------------------------------------------------- broadcast fork
    @torch.no_grad()
    def _prefill_broadcast_fn(self, tokens, start, n_valid, adapter_ids,
                              bt_b, wpages_b, wpages_r, *, chunk):
        """Broadcast fork: ONE base-trajectory pass over a shared chunk
        computes the rCaches of ``n_agents`` adapters at once (the
        residuals are rank-r projections of the same x).

        tokens: (chunk,); start/n_valid: (1,); adapter_ids: (n_agents,);
        bt_b: (W,); wpages_b: (chunk,); wpages_r: (n_agents, chunk).
        Attention runs over the base cache only (the approximation); the
        bCache is written once, via ``wpages_b``.
        """
        cfg = self.cfg
        pools = self.pools
        hd = cfg.resolved_head_dim
        ar = torch.arange(chunk, device=self.device)
        positions = start + ar                                 # (chunk,)
        x = self.params["embed"][tokens.long()][None]          # (1, chunk, d)
        woff = (positions % self.page).long()
        valid = ar < n_valid
        wp_b = torch.where(valid, wpages_b, self.dump_page).long()
        wp_r = torch.where(valid[None], wpages_r, self.dump_page_r).long()
        ids = adapter_ids.long()
        kv_len = start + n_valid
        for li in range(cfg.num_layers):
            p_l = self._layer_params(li)
            lora_l = self._lora_layer(li)
            h = base.rms_norm(x, p_l["ln1"], cfg.norm_eps)
            # base trajectory: no q-LoRA
            q, sin, cos = tfm._qkv(p_l, h, cfg, None, None, positions[None])
            kb_ = (h @ p_l["wk"]).reshape(1, chunk, cfg.num_kv_heads, hd)
            vb_ = (h @ p_l["wv"]).reshape(1, chunk, cfg.num_kv_heads, hd)
            if cfg.use_rope:
                kb_ = rope_lib.apply_rope(kb_, sin, cos)
            # every agent's residuals from the SAME x: (n_agents, chunk, r)
            sc = lora_l["scaling"][ids].to(x.dtype)[:, None, None]
            kr_ = torch.einsum("sd,kdr->ksr", h[0],
                               lora_l["a_k"][ids].to(x.dtype)) * sc
            vr_ = torch.einsum("sd,kdr->ksr", h[0],
                               lora_l["a_v"][ids].to(x.dtype)) * sc
            kbp, vbp, ksp, vsp = self._write_base(li, wp_b, woff, kb_[0],
                                                  vb_[0])
            pools.kr[li][wp_r, woff[None]] = kr_
            pools.vr[li][wp_r, woff[None]] = vr_
            if self.use_paged:
                attn = kernel_ops.paged_residual_attention_prefill(
                    q, kbp, vbp, None, None, None, None, bt_b[None], None,
                    start, kv_len, scale=hd ** -0.5,
                    window=cfg.sliding_window, rope_theta=cfg.rope_theta,
                    use_rope=cfg.use_rope, kb_scale=ksp, vb_scale=vsp)
            else:
                kc, vc, *_ = self._gather(li, bt_b[None])
                kmask_pos = torch.arange(kc.shape[1], device=self.device)
                attn = tfm._attend(q, kc, vc, None, None, None, None,
                                   kmask_pos[None], kv_len, positions[None],
                                   cfg.sliding_window, hd ** -0.5, cfg,
                                   False)
            x = x + attn.reshape(1, chunk, -1) @ p_l["wo"]
            h = base.rms_norm(x, p_l["ln2"], cfg.norm_eps)
            x = x + tfm.ffn(p_l, h, cfg)

    def prefill_broadcast(self, tokens, start, adapter_ids, bt_b, wpages_b,
                          wpages_r_list, chunk_size):
        """One broadcast-fork pass: ``tokens`` at ``start`` prefilled once
        on the base trajectory, padded to ``chunk_size``, writing the bCache
        through ``wpages_b`` and each agent's rCache through its row of
        ``wpages_r_list``.  ``bt_b`` is the writer's block table, cropped or
        padded to the call's table width.  Emits no logits."""
        n = len(tokens)
        pad = chunk_size - n
        bt_b = self._pad_table(bt_b, self._table_width(
            -(-(start + n) // self.page)), self.dump_page)
        self._prefill_broadcast_fn(
            self._i32(list(tokens) + [0] * pad), self._i32([start]),
            self._i32([n]), self._i32(list(adapter_ids)), self._i32(bt_b),
            self._i32(list(wpages_b) + [self.dump_page] * pad),
            self._i32([list(w) + [self.dump_page_r] * pad
                       for w in wpages_r_list]),
            chunk=chunk_size)
