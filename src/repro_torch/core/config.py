"""Configuration for the PyTorch/CUDA port of the ForkKV serving system.

:class:`LoRAConfig`, :class:`ModelConfig`, :class:`ShapeConfig` (with
``INPUT_SHAPES``) and :class:`ServeConfig` carry the same fields and
defaults as the JAX package's configs, so one configuration describes the
same model and server on either side; only ``ModelConfig.activation_dtype``
returns a ``torch.dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

Dtype = torch.dtype


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    """LoRA adapter configuration (paper §2.2)."""

    rank: int = 16
    alpha: float = 32.0
    # Which projections carry adapters.  ForkKV disaggregates the KV cache,
    # so k/v adapters are the interesting ones; q is applied on the fly.
    targets: Tuple[str, ...] = ("q", "k", "v")

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description covering all six assigned families."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                   # query heads (0 for attn-free archs)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    # --- attention flavour -------------------------------------------------
    sliding_window: int = 0          # >0 -> sliding-window attention (SWA)
    rope_theta: float = 10_000.0
    use_rope: bool = True            # whisper uses learned abs. positions
    max_position: int = 1_048_576
    # --- MoE ---------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0                # per-expert hidden (0 -> d_ff)
    moe_interleave: int = 1          # every Nth layer is MoE (llama4: 2)
    moe_shared_expert: bool = False  # always-on shared expert (llama4)
    moe_capacity_factor: float = 1.25
    # --- SSM (mamba2 SSD) ---------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_heads: int = 0               # mamba2 value heads
    ssm_expand: int = 2
    # --- hybrid (griffin / recurrentgemma) ----------------------------------
    # block pattern, e.g. ("rglru", "rglru", "local") repeated.
    block_pattern: Tuple[str, ...] = ()
    lru_width: int = 0               # RG-LRU recurrent width (0 -> d_model)
    local_window: int = 0            # local attention window for hybrid
    # --- enc-dec (whisper) ---------------------------------------------------
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq: int = 1500          # whisper: 30s audio -> 1500 frames
    # --- modality frontend stub ----------------------------------------------
    frontend: str = "none"           # none | vision_stub | audio_stub
    num_patches: int = 0             # vlm: patch embeddings per image
    # --- misc ----------------------------------------------------------------
    mlp_activation: str = "silu"     # silu (swiglu) | gelu (plain 2-matmul)
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    lora: LoRAConfig = dataclasses.field(default_factory=LoRAConfig)
    # KV-cache quantization (beyond-paper, §Perf): "none" | "int8".
    # int8 halves bCache bytes (the decode roofline's dominant term);
    # rCache stays in model dtype (it is rank-r, ~1.5% of the cache).
    kv_quant: str = "none"
    # scan configuration for deep stacks: layers are scanned in
    # (outer, inner) groups with remat on the inner scan.
    scan_layers: bool = True
    scan_groups: int = 0             # 0 -> single-level scan
    optimizer: str = "adamw"         # adamw | adafactor
    remat: bool = True
    citation: str = ""

    # ------------------------------------------------------------------ utils
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads:
            return self.d_model // self.num_heads
        return 0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.resolved_head_dim

    @property
    def activation_dtype(self) -> Dtype:
        return getattr(torch, self.dtype)

    @property
    def num_params(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6·N·D)."""
        d, L = self.d_model, self.num_layers
        attn = d * (self.q_dim + 2 * self.kv_dim + self.q_dim)
        if self.family == "ssm":
            inner = self.ssm_expand * d
            per_layer = d * (2 * inner + inner) + inner * self.ssm_state * 2
            mlp = 0
            attn = 0
            per_layer += mlp
            body = L * per_layer
        else:
            eff_ff = self.moe_d_ff or self.d_ff
            n_mats = 3 if self.mlp_activation == "silu" else 2
            if self.num_experts:
                L_moe = L // self.moe_interleave
                L_dense = L - L_moe
                moe = self.num_experts * n_mats * d * eff_ff + \
                    d * self.num_experts
                if self.moe_shared_expert:
                    moe += n_mats * d * eff_ff
                mlp_total = L_moe * moe + L_dense * n_mats * d * self.d_ff
                body = L * attn + mlp_total
            else:
                mlp = n_mats * d * self.d_ff
                per_layer = attn + mlp
                body = L * per_layer
            if self.is_encoder_decoder:
                # encoder layers + decoder cross-attention
                body += self.num_encoder_layers * (attn + 2 * d * self.d_ff)
                body += L * attn  # cross attn
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return body + embed

    @property
    def active_params(self) -> int:
        """Active parameters per token (MoE: only routed experts)."""
        if not self.num_experts:
            return self.num_params
        d, L = self.d_model, self.num_layers
        L_moe = L // self.moe_interleave
        eff_ff = self.moe_d_ff or self.d_ff
        n_mats = 3 if self.mlp_activation == "silu" else 2
        dense_moe = self.num_experts * n_mats * d * eff_ff
        active_moe = self.num_experts_per_tok * n_mats * d * eff_ff
        return self.num_params - L_moe * (dense_moe - active_moe)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input shapes."""

    name: str
    seq_len: int
    global_batch: int
    mode: str                        # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.mode == "decode"


INPUT_SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeConfig:
    for s in INPUT_SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown input shape {name!r}")


# NVIDIA H100 SXM roofline constants (per card, dense, at the 700 W limit;
# NVIDIA's data sheet).
PEAK_FLOPS_BF16 = 989e12          # FLOP/s
HBM_BW = 3.35e12                  # bytes/s


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving engine configuration (paper §6/§7)."""

    page_size: int = 16              # tokens per KV block
    max_pages: int = 4096            # pool capacity (per cache kind)
    max_pages_per_req: int = 64      # block-table length (Smax/page)
    max_batch: int = 64              # decode batch upper bound
    max_prefill_tokens: int = 8192   # chunked-prefill budget per step
    # batched prefill: max requests co-scheduled into one padded (B, chunk)
    # prefill call; the token budget above is split across the
    # power-of-two-padded batch (0 = no cap beyond the budget)
    max_prefill_batch: int = 8
    # page-native serving (DESIGN.md §12/§13): hand pools + block tables to
    # the paged ResidualAttention kernel dispatcher — decode AND chunked
    # prefill — with batch/width bucketing.  Sliding-window (SWA) models
    # serve through the same kernels (window clamping skips out-of-window
    # page DMAs).  False keeps the legacy gather-to-contiguous paths for
    # bit-parity testing (same tokens, O(B·smax) HBM traffic; every such
    # executor call increments the ``fallback_gather_calls`` metric).
    use_paged_kernel: bool = True
    # floor for the bucketed block-table width, in pages (decode and
    # prefill): keeps the compiled-variant count small for short contexts
    # without giving up the kv_len-proportional HBM scaling.
    min_table_pages: int = 4
    # iteration-level continuous batching (DESIGN.md §14): each engine step
    # runs ONE token-budget batch plan — all runnable decode rows first
    # (q=1 each), then chunked-prefill rows filling the remaining budget —
    # executed as a single mixed executor call through the unified kernel
    # grid, so a long prompt can never head-of-line-block in-flight token
    # streams.  False keeps the legacy phase-separated step loop (one
    # batched prefill call + one decode call per step) for parity testing,
    # mirroring how ``use_paged_kernel`` gates the paged kernels.
    mixed_batching: bool = True
    # total tokens one iteration may compute (decode rows cost 1 each,
    # prefill rows their chunk length).  0 derives
    # ``max_prefill_tokens + max_batch`` — a full decode batch ON TOP of
    # the full legacy prefill budget, so flipping ``mixed_batching`` on
    # never shrinks per-step throughput relative to the old phase loop.
    iteration_token_budget: int = 0
    mode: str = "forkkv"             # forkkv | prefix | full_reuse
    # beyond-paper features (DESIGN.md §9); defaults are paper-faithful.
    broadcast_fork: bool = False
    adaptive_fallback: bool = False
    adaptive_high_watermark: float = 0.85
    # tiered KV offload (DESIGN.md §10): > 0 enables HBM→host demotion with
    # this many bytes of host budget; 0 keeps destroy-on-evict.
    host_tier_bytes: int = 0
    # policy knob: max pages promoted host→device per prefix match
    # (0 = unlimited) — bounds the H2D copy burst a single admission pays.
    tier_promote_limit: int = 0
    # blob codec applied on demote / reversed on promote (DESIGN.md §18):
    # "identity" (bit-identical), "int8" (per-row-scale quantization,
    # ~4x smaller host/disk footprint, bounded error), "zstd" (lossless
    # compression; falls back to zlib when zstandard is not installed).
    kv_codec: str = "identity"
    # disk tier below the host tier: > 0 adds a file-backed third tier of
    # this many bytes — host-LRU pressure SPILLS nodes to disk instead of
    # destroying them, and matches promote disk-tier nodes straight back.
    disk_tier_bytes: int = 0
    # directory holding disk-tier blob files, and — when set — the
    # persist()/restore() manifest: a server restarted with the same
    # ``persist_dir`` rehydrates its radix trees from the manifest into
    # the host tier instead of re-prefilling shared agent context.
    # Empty with disk_tier_bytes > 0 uses a temp directory (non-persistent).
    persist_dir: str = ""
    # stall detection: after this many consecutive engine steps with work
    # waiting but nothing admitted, prefilled, or decoded, the head waiting
    # request is failed with a ``stalled`` error instead of the engine
    # silently spinning until the caller's step budget runs out.
    stall_limit: int = 64
    # ---- multi-tenant admission (DESIGN.md §15) ----------------------------
    # admission-order policy: "fifo" (the seed behaviour — strict arrival
    # order) or "fairshare" (weighted fair queuing across tenants + SRPT
    # bias + aging + prefix-hit discount; serving/fairshare.py).
    admission: str = "fifo"
    # per-tenant WFQ weights as ((tenant, weight), ...); unnamed tenants
    # get weight 1.0.  Higher weight = more service before the tenant's
    # virtual clock catches up.
    tenant_weights: Tuple[Tuple[str, float], ...] = ()
    # per-tenant budgets, each 0 = unlimited: admitted-but-unfinished
    # requests; prompt+max_new tokens of those requests; device pages held
    # pinned by the tenant's live AgentSessions.
    tenant_max_concurrent: int = 0
    tenant_max_tokens_in_flight: int = 0
    tenant_max_pinned_pages: int = 0
    # fair-share score terms (see the formula in serving/fairshare.py):
    # SRPT bias multiplier on the request's expected compute, and the
    # aging credit in cost-tokens per waiting second (bounds starvation).
    fair_srpt_weight: float = 1.0
    fair_aging_tokens_per_s: float = 50.0
    # overload shedding, each 0 = unbounded: waiting-queue depth and
    # wait-time bounds past which requests are rejected with
    # ``finish_reason="rejected"`` + a retry-after hint (HTTP 429).
    max_queue_depth: int = 0
    max_queue_wait_s: float = 0.0
    # ---- speculative decoding on CoW forks (DESIGN.md §16) ----------------
    # draft-free speculation: propose up to spec_k tokens per decode step
    # (prompt-lookup / n-gram cache), verify them in ONE mixed-grid pass
    # (a q_len=k+1 row), commit the accepted prefix, drop the rest via CoW
    # refcounts.  Greedy requests only — accepted tokens are bit-identical
    # to the non-speculative stream.  Per-request override via
    # ``SamplingParams.speculate``/``spec_k``.
    speculate: bool = False
    spec_k: int = 4                  # max drafted tokens per verify step
    spec_proposer: str = "prompt_lookup"   # prompt_lookup | ngram_cache
    # adaptive draft length: per-request EMA acceptance controller backs
    # the draft cap off toward 1 when acceptance drops (speculate.py)
    spec_adaptive: bool = True
    spec_min_ngram: int = 2          # shortest suffix n-gram matched
    spec_cache_entries: int = 8192   # ngram_cache bound (LRU-evicted)
    # ---- fault tolerance (DESIGN.md §17) -----------------------------------
    # preempt–restore under pool pressure: when admission has been blocked
    # on pages for ``preempt_after_steps`` consecutive steps, the policy
    # picks a victim among running requests (worst fair-share score; never
    # a broadcast-fork writer), checkpoints its computed KV into the radix
    # tree (demotable to the host tier, or recomputed if that's full too)
    # and requeues it; on re-admission match_prefix restores the prefix and
    # only the uncovered suffix re-prefills.
    preempt: bool = True
    preempt_after_steps: int = 4
    # request quarantine: an on-device isfinite guard on final logits rides
    # the existing single host sync; poisoned rows finish with
    # ``finish_reason="error"`` and their pages are reclaimed while the
    # rest of the batch continues.
    quarantine: bool = True
    # deterministic fault injection (serving/faults.py): plan grammar
    # "site:trigger,trigger;site2:trigger" with sites pool_alloc /
    # tier_demote / tier_promote / nan_logits / pump_stall / executor and
    # triggers cN (Nth call), rKEY (key match), pX (seeded probability),
    # * (always).  Empty string = no injection (env FORKKV_FAULT_PLAN /
    # FORKKV_FAULT_SEED are the fallback wiring for smoke/CI).
    fault_plan: str = ""
    fault_seed: int = 0
    # pump watchdog: the frontend trips (and counts) when the engine has
    # pending work but its step loop hasn't advanced for this many
    # seconds; 0 disables the watchdog thread.
    watchdog_s: float = 10.0
