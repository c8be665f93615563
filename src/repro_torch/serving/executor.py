"""Paged model executor over pooled KV pages (port of
``repro/serving/executor.py``).

The pools are tensors of shape (L, num_pages, page_size, ...); requests
address them through block tables.  In ForkKV mode two pools exist — the
shared bCache pool and the per-agent rCache pool — and attention runs over
the disaggregated layout.

Decode and the unified mixed prefill/decode step are page-native: each
layer hands the pools and per-request block tables straight to the
dispatchers in :mod:`repro_torch.kernels.ops`, which launch the CUDA
kernels on the card and the plain versions on the CPU.  Shapes are
bucketed exactly as in the reference — batches pad to powers of two, block
tables to the power-of-two bucket of the batch's live page count — so the
number of distinct shapes stays logarithmic (one CUDA graph per bucket is
later work).  Executor methods return DEVICE tensors; the engine reads
them back once per step.

Pool writes are in place (``index_put_`` through advanced-index
assignment) where the reference donated the pools to ``.at[].set``.
Padding rows and CoW-inherited positions all write to the reserved dump
page, so the index lists hold duplicates; that is harmless, since the dump
page is never read at a valid position.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Set, Tuple

import torch

from repro_torch.core import rope as rope_lib
from repro_torch.core.config import ModelConfig, ServeConfig
from repro_torch.core.device import resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import base
from repro_torch.models import transformer as tfm
from repro_torch.serving.sampling import sample_tokens

Params = Dict


def _pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1)."""
    return 1 << max(0, n - 1).bit_length()


class Pools(NamedTuple):
    kb: torch.Tensor            # (L, Pb, page, Hkv, hd)  base K (RoPE'd)
    vb: torch.Tensor            # (L, Pb, page, Hkv, hd)  base V
    kr: Optional[torch.Tensor]  # (L, Pr, page, R)        residual K (no RoPE)
    vr: Optional[torch.Tensor]


def make_pools(cfg: ModelConfig, num_pages: int, num_res_pages: int,
               page_size: int, disagg: bool, dtype=None,
               device=None) -> Pools:
    if cfg.kv_quant == "int8":
        raise NotImplementedError(
            "int8 bCache pools are not ported yet (ROADMAP Queue 1, item 7)")
    dev = resolve_device(device)
    dt = dtype or cfg.activation_dtype
    L, hd = cfg.num_layers, cfg.resolved_head_dim
    kb = torch.zeros((L, num_pages, page_size, cfg.num_kv_heads, hd),
                     dtype=dt, device=dev)
    vb = torch.zeros_like(kb)
    if disagg:
        kr = torch.zeros((L, num_res_pages, page_size, cfg.lora.rank),
                         dtype=dt, device=dev)
        vr = torch.zeros_like(kr)
    else:
        kr = vr = None
    return Pools(kb, vb, kr, vr)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def pool_bytes(pools: Pools) -> Dict[str, int]:
    out = {"base": _nbytes(pools.kb) + _nbytes(pools.vb)}
    out["residual"] = _nbytes(pools.kr) + _nbytes(pools.vr) \
        if pools.kr is not None else 0
    return out


class PagedExecutor:
    """Paged decode and mixed prefill/decode for llama-family models."""

    def __init__(self, cfg: ModelConfig, params: Params,
                 lora: Optional[Params], serve_cfg: ServeConfig,
                 disagg: bool, max_pages_per_req: int, device=None):
        if not serve_cfg.use_paged_kernel:
            raise NotImplementedError(
                "use_paged_kernel=False (the gather-to-contiguous path) is "
                "not ported (ROADMAP Queue 1, item 8)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.lora = lora
        self.sc = serve_cfg
        self.disagg = disagg and lora is not None
        self.page = serve_cfg.page_size
        self.max_pages_per_req = max_pages_per_req
        self.min_table_pages = serve_cfg.min_table_pages
        # executor calls that took a gather-to-contiguous path; the port has
        # none, so this stays 0 (surfaced via Engine.metrics())
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

    # ------------------------------------------------------------ helpers
    def _layer_params(self, li):
        return {k: v[li] for k, v in self.params["layers"].items()}

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
        for li in range(cfg.num_layers):
            p_l = self._layer_params(li)
            lora_l = self._lora_layer(li)
            h = base.rms_norm(x, p_l["ln1"], cfg.norm_eps)
            q, sin, cos = tfm._qkv(p_l, h, cfg, lora_l, adapter_ids,
                                   kv_len[:, None])
            kb_, vb_, kr_, vr_, bk, bv = self._project_kv(
                p_l, lora_l, h, sin, cos, adapter_ids)
            # write the new token in place (the reference's donated .at[].set)
            kbp, vbp = pools.kb[li], pools.vb[li]
            kbp[wpb, wof] = kb_[:, 0]
            vbp[wpb, wof] = vb_[:, 0]
            if self.disagg:
                krp, vrp = pools.kr[li], pools.vr[li]
                krp[wpr, wof] = kr_[:, 0]
                vrp[wpr, wof] = vr_[:, 0]
            attn = kernel_ops.paged_residual_attention(
                q[:, 0], kbp, vbp,
                krp if self.disagg else None,
                vrp if self.disagg else None,
                bk if self.disagg else None,
                bv if self.disagg else None,
                bt_b, bt_r if self.disagg else None, kv_len + 1,
                scale=cfg.resolved_head_dim ** -0.5,
                window=cfg.sliding_window,
                rope_theta=cfg.rope_theta, use_rope=cfg.use_rope)
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
        live width.  Returns DEVICE tensors ``(next_tok, logits, row_ok)``;
        rows past the live count are padding.
        """
        bsz = len(tokens)
        if bsz > self.sc.max_batch:
            raise ValueError(f"decode batch {bsz} > max_batch "
                             f"{self.sc.max_batch}")
        bpad = min(_pow2(bsz), self.sc.max_batch)
        width = self._bucket_width(max(kvl // self.page + 1
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

    def decode_cache_size(self) -> int:
        """Number of distinct decode shape buckets seen (the count of CUDA
        graphs a per-bucket capture would hold)."""
        return len(self._decode_shapes)

    # ------------------------------------------------------ mixed prefill
    @torch.no_grad()
    def _prefill_fn(self, tokens, start, n_valid, adapter_ids, bt_b, bt_r,
                    wpages_b, wpages_r, temps, top_ks, top_ps, seeds, spos,
                    poison, *, chunk, sampled, verify=False):
        """Unified mixed prefill/decode step for a PADDED batch (the
        reference's ``_prefill_fn(unified=True)``).

        tokens: (B, chunk) padded; start: (B,) absolute position of each
        row's tokens[0]; n_valid: (B,) real tokens per row (its q-length;
        0 for padding rows); wpages_*: (B, chunk) page to write each token
        into (dump page where the cache is inherited — CoW: shared pages
        are never written).  Each row's ``n_valid`` rides into the
        attention as its q-length, so decode rows padded to the chunk width
        and full prefill chunks share one launch, with padding rows
        exact-zeroed.

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
        for li in range(cfg.num_layers):
            p_l = self._layer_params(li)
            lora_l = self._lora_layer(li)
            h = base.rms_norm(x, p_l["ln1"], cfg.norm_eps)
            q, sin, cos = tfm._qkv(p_l, h, cfg, lora_l, adapter_ids,
                                   positions)
            kb_, vb_, kr_, vr_, bk, bv = self._project_kv(
                p_l, lora_l, h, sin, cos, adapter_ids)
            kbp, vbp = pools.kb[li], pools.vb[li]
            kbp[wp_b, woff] = kb_
            vbp[wp_b, woff] = vb_
            if self.disagg:
                krp, vrp = pools.kr[li], pools.vr[li]
                krp[wp_r, woff] = kr_
                vrp[wp_r, woff] = vr_
            attn = kernel_ops.paged_residual_attention_mixed(
                q, kbp, vbp,
                krp if self.disagg else None,
                vrp if self.disagg else None,
                bk if self.disagg else None,
                bv if self.disagg else None,
                bt_b, bt_r if self.disagg else None, start, n_valid, kv_len,
                scale=cfg.resolved_head_dim ** -0.5,
                window=cfg.sliding_window, rope_theta=cfg.rope_theta,
                use_rope=cfg.use_rope)
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
        qpad = _pow2(max(qmax, qfloor))
        bpad = _pow2(max(bsz, min(self.sc.max_batch, 4)))
        temps = list(temps) if temps is not None else [0.0] * bsz
        top_ks = list(top_ks) if top_ks is not None else [0] * bsz
        top_ps = list(top_ps) if top_ps is not None else [1.0] * bsz
        seeds = list(seeds) if seeds is not None else [0] * bsz
        spos = list(spos) if spos is not None else [0] * bsz
        poison = list(poison) if poison is not None else [0] * bsz
        w = self._bucket_width(max(
            -(-(starts[i] + len(chunks[i])) // self.page)
            for i in range(bsz)))
        toks, nvalid, wb, wr, btb, btr = [], [], [], [], [], []
        for i in range(bpad):
            if i < bsz:
                row = list(chunks[i])
                pad = qpad - len(row)
                toks.append(row + [0] * pad)
                nvalid.append(len(row))
                wb.append(list(wpages_b[i]) + [self.dump_page] * pad)
                wr.append(list(wpages_r[i]) + [self.dump_page_r] * pad)
                btb.append(self._pad_table(base_tables[i], w,
                                           self.dump_page))
                btr.append(self._pad_table(res_tables[i], w,
                                           self.dump_page_r))
            else:               # padding row: q_len 0, writes to the dump
                toks.append([0] * qpad)
                nvalid.append(0)
                wb.append([self.dump_page] * qpad)
                wr.append([self.dump_page_r] * qpad)
                btb.append([self.dump_page] * w)
                btr.append([self.dump_page_r] * w)
        pad = bpad - bsz
        starts = list(starts) + [0] * pad
        adapter_ids = list(adapter_ids) + [0] * pad
        temps += [0.0] * pad
        top_ks += [0] * pad
        top_ps += [1.0] * pad
        seeds += [0] * pad
        spos += [0] * pad
        poison += [0] * pad
        f32 = dict(dtype=torch.float32, device=self.device)
        return self._prefill_fn(
            self._i32(toks), self._i32(starts), self._i32(nvalid),
            self._i32(adapter_ids), self._i32(btb), self._i32(btr),
            self._i32(wb), self._i32(wr), torch.tensor(temps, **f32),
            self._i32(top_ks), torch.tensor(top_ps, **f32),
            self._i32(seeds), self._i32(spos), self._i32(poison),
            chunk=qpad, sampled=any(t > 0 for t in temps), verify=verify)
