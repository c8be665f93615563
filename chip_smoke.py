#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of ForkKV on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA device and the
CUDA toolkit.  Phases, each of which fails the run (non-zero exit) on any
error:

1. environment: the card's name and power limit, torch/CUDA versions;
   TF32 is switched off for matmul and cuDNN so f32 runs are IEEE f32;
2. build: nvcc compiles ``src/repro_torch/kernels/csrc/*.cu`` for sm_90a,
   one process per source (four), all started together; one line per
   kernel with its registers, stack and spill bytes from ptxas;
3. kernels: every launch is checked to have run the kernel its type
   routes it to (bf16 launches of the chunked prefills #6 and #5, of the
   mixed grids #3 and #1 and of the dense prefill #7: their tensor-core
   kernels, counted as ``<entry>[_int8]_mma``; every launch of the decodes
   #4 and #2 and bf16 launches of the dense decode #8: their split-K
   decodes, ``<entry>[_int8]_splitk``, whose split count, grids and
   workspace bytes each record logs; f32 launches of the others: the
   scalar kernels);
   the six paged attention kernels (mixed, decode and chunked
   prefill, each disaggregated and base-only) and their six int8 variants
   (int8 pages quantized by the port's ``quantize_kv``, with f32 scales)
   at Llama3-8B's head geometry, q in f32 and bf16, against their plain
   PyTorch versions on the same inputs, with times, the card's bound for
   the same work, and ``scaled_dot_product_attention`` as a yardstick
   (over K/V gathered beforehand, untimed: int8 pages dequantized, a
   disaggregated cache rebuilt by the plain ``reconstruct``); an int8
   variant must also stay within 5% of the plain
   version on the full-precision pages; the prefill cases hold a chunk
   starting mid-page, padded chunks and a padding row with n_valid = 0,
   and run with and without a window that straddles pages; #6 and #3 and
   #4 (and their int8 variants) also at page sizes 8 and 32, head_dim 64
   and a group of 64 heads, #4 also on one row at kv_len 32768 over 2048
   pages and on rows at kv_len 0, 1 and 17 beside a 2048 row (a window of
   300 leaves some of their splits empty); #5, #1 and #2 at the same edges
   and at ranks 5, 8 and 32, #5 also on rows at kv_len 0, 1 and 17 beside
   a 512-token chunk, #1 on ragged mixed rows (q_len 0, 1, 17 and 512;
   kv_len 0, 1 and 17; the q_len 0 row at kv_len 0 must come back exactly
   0); all-decode mixed-grid launches (#3, #1) are timed beside #4 and #2
   on the same rows, and #4 and #2 on rows at kv_len 1 (their launch
   floors).  Then the two dense kernels (prefill and decode over
   contiguous caches) at the CPU tests' cases with R 16 at D 128 (MHA,
   GQA, MQA) and at D 256 (RecurrentGemma-9B's MQA with G 16, and GQA):
   window 0 and 5; a chunk at an offset; kv_len None; Sq and Sk of 150;
   and a ragged decode over 2048 keys, f32 and bf16; the prefill also at
   the edges of the tensor-core tile, window 0 and 100: Sq and Sk off the
   tile's multiples, ranks 8, 32 and 5, head_dim 64, a group of 64 heads,
   D 256 at ranks 24 and (bf16 only) 32; the decode at D 64, 128 and 256
   with groups of 4 and 16 at Sk 1 (``forward`` at S 1) and at Sk 4096
   (B 4; timed in bf16 against its bound), window 0 and 300, at rank 5,
   a group of 64 and (bf16 only) D 256 at rank 32.  Then the RG-LRU
   scan kernel at tests/test_kernels.py's shapes (the ragged one as it
   is), at S 1 and at W 200, f32 and bf16, h0 non-zero.  Then every
   kernel at head_dim 32 (``tiny_serving_model()``'s at its defaults):
   the six paged kernels and their int8 variants at groups of 2 and 4,
   page 16, rank 8 on the fixed rows, and the dense prefill and decode
   (``DENSE_D32``), f32 and bf16, with and without a window, each naming
   the kernel that ran; the bf16 cases are timed (the ``d32_times``
   line); then the dense prefill and decode at head_dim 120
   (h2o-danube-3-4b's heads, ``DENSE_D120``: in bf16 D 128's tile in the
   split-half layout), f32 and bf16, windows 0 and 300, ranks 5, 16 and
   32, each naming the kernel that ran, the bf16 4 x 1000 prefill and Sk
   4096 decode timed against their bound at D 120 and SDPA (the
   ``d120_times`` line); the six paged kernels and their int8 variants at
   h2o-danube-3-4b's heads (``DANUBE_GEOM``: D 120, run in D 128's tile
   with the halves split, #4 in D 128's lane map) on the fixed rows, f32
   and bf16, windows 4096 and 300 (the bf16 cases at window 4096 timed
   into ``d120_times``), and at ``D120_EDGES`` (kv_len 0/1/17 rows, ragged
   mixed rows, a 32768-key row, ranks 5 and 32); every paged kernel and
   int8 variant at pages of 64 tokens (run as sub-pages of 32,
   ``pra.sub_pages``); the dense prefill and decode without RoPE (identity
   sin/cos tables) at whisper-large-v3's decoder heads (20 over 20, D 64);
   then LoRA ranks above 32, which run the RP 64 instances: #5, #1 and #2
   with their int8 variants at Llama3-8B's, h2o-danube-3-4b's and D 32's
   heads, #7 and #8 also at RecurrentGemma-9B's (D 256: the tensor-core
   prefill in 64 query rows, the f32 scalar kernel in 16), on the fixed
   rows, f32 and bf16, windows 0 and 300, ranks 33, 48 and 64 (the f32
   dense kernels at D 256 also at 32), each naming its kernel and RP; the
   bf16 cases at D 128 timed at ranks 32 and 64 with their bound and SDPA
   (the ``rank64_times`` line); then ranks above 64, which run the
   chunked instances (``_rchunk``): #5, #1 and #2 with their int8
   variants at Llama3-8B's heads (ranks 65, 128, 256), h2o-danube-3-4b's
   (128) and D 32's (65), #7 and #8 at D 128 and D 256 (65, 128, 256) and
   D 120 (128), f32 and bf16, windows 0 and 300, and the f32 scalar
   kernel at D 256 with a group of 32 heads at rank 64; the bf16 prefills
   at the edges of their clusters (ranks 65 and 128; ``RCHUNK_EDGES``,
   ``RCHUNK_DENSE_EDGES``); the bf16 cases at D 128 timed at ranks 64,
   128 and 256 with their bound, SDPA, the factor over SDPA and the time
   before the redesign (``RCHUNK_WAS_MS``; the ``rchunk_times`` line); the
   RG-LRU scan's backward kernel against
   ``rg_lru_scan_bwd_ref`` at the scan's shapes, at S 1 and at
   RecurrentGemma-9B's width (B 4, S 1000, W 4096; timed), f32 and bf16,
   h0 non-zero; and the grad guard: #7 on an input that requires grad
   must raise;
4. a small f32 model served on the card and on the CPU: identical greedy
   tokens in forkkv and prefix mode, under the mixed and the
   phase-separated loop (``mixed_batching=False``), with broadcast fork
   and on the gather path (``use_paged_kernel=False``), whose tokens must
   also equal the paged path's on the card, all with full-precision and
   again with int8 bCache pages (``kv_quant="int8"``: only int8 variants
   launch); then ``tiny_serving_model()`` at its defaults (head_dim 32)
   on the card and on the CPU in forkkv, prefix and full_reuse under both
   loops, identical greedy tokens; the same at rank 64 and at rank 128
   (the chunked instances) in forkkv under both loops; then the small f32
   model's dense API:
   ``forward(disagg=True)`` logits card vs CPU, and greedy tokens from
   ``prefill`` + ``decode_step`` identical, over full-precision and over
   int8 caches;
   then a 2-layer f32 model at h2o-danube-3-4b's head geometry (Hq 32 over
   Hkv 8, head_dim 120) card vs CPU in forkkv, prefix and full_reuse under
   both loops, and over int8 pages in forkkv and prefix, identical greedy
   tokens, each serve's D 120 kernels launched; mamba2-130m's and
   whisper-large-v3's ``tiny()`` (whisper with frame embeddings, 4
   adapters, ``disagg=True``) greedy ``prefill`` + ``decode_step`` tokens
   identical card vs CPU, launching no kernel (neither reaches a Pallas
   kernel in the reference);
   then the same for a 6-layer f32 hybrid at head_dim 256 (the scan
   kernel and the dense kernels at D 256), with a prompt that wraps the
   local ring; then the tiers: tests/test_tiers.py's ReAct run of
   ``serving/workflows.py`` under page pressure with the host tier on and
   int8 pages, outputs and tier counters equal on card and CPU with tier
   hits; an ``export_pages`` → ``import_pages`` round trip of bf16 and of
   int8 pages (with scales) bit-identical on the card; and ``persist`` →
   a fresh engine → ``restore`` serving the same greedy tokens as the
   uninterrupted run, from tier hits; then the serve launcher as users
   run it, ``python -m repro_torch.launch.serve --http --port 0`` as a
   process of its own: its port line parsed, a 128-token stream opened,
   SIGTERM sent, a fresh request refused with 503 ``draining``, the
   stream finished, the process gone with exit code 0 and no watchdog
   trip;
5. Llama3-8B at full width and depth (random bf16 weights from seed 0)
   serving one 2048-token session with 8 staggered forks over 4 LoRA
   adapters, in forkkv and prefix mode under the mixed loop, then under
   the phase-separated loop, then a broadcast fan-out (three forks under
   adapters 1-3 with one shared instruction, submitted together, sharing
   one base-trajectory prefill pass); the launch counters, zeroed before
   each serve and read after it, show each path went through its kernels
   and never through a plain version, and every launch's geometry is
   recorded.  The four staggered serves again with int8 bCache pages
   (only int8 variants may launch), with peak pages and bytes per page;
   in bf16 (int8 pages too) the prefix serves and the broadcast pass must
   run #6's and #3's tensor-core kernels and the forkkv serves #5's and
   #1's, never their template instances, and in every type #4 and #2 only
   as split-K decodes;
   then the staggered serve in bf16 at ``max_pages`` 640 (between
   forkkv's peak of 169 base pages and prefix's 937) with a 4 GiB host
   tier, in both modes: every fork finishes, prefix demotes pages, tier
   counters logged.  Then a forkkv server (mixed loop) in an in-process
   ``HttpFrontend``: a completion, a streamed completion and a session
   with 4 forks through ``ForkClient``, then the same requests through
   the same server's in-process API after every page is evicted:
   identical greedy tokens, its kernels launched, time to first token
   and tokens per second of both logged.  Then the dense model API on
   the same weights:
   ``forward(disagg=True)`` on 4 rows x 1000 tokens (adapters 0-3) must
   launch the dense prefill kernel once per layer (in bf16 its
   tensor-core kernel, on f32 copies the scalar one), and ``forward`` on one
   token the dense decode kernel once per layer (in bf16 its split-K
   decode, on f32 copies the scalar one); both are timed, with
   ``prefill`` of 600 tokens and 16 ``decode_step`` s over a 1024-slot
   cache, and a profiled decode step (device busy time, kernels per
   step, idle share).  On f32 copies of the same weights the
   disaggregated ``forward`` must agree with the unified one, ``forward``
   at one token with position 0, and prefill/decode with ``forward`` at
   the same positions, within tests/test_models.py's rtol 3e-4 / atol
   5e-4; in bf16 these gaps are logged beside bf16's own floor (the
   unified logits with the embedding one ulp off).  Then, with Llama3-8B
   freed, RecurrentGemma-9B at full width and depth (38 layers: 26 RG-LRU,
   12 local attention; random bf16 weights from seed 0, 4 adapters of
   rank 16 on the local layers): ``forward(disagg=True)`` on 4 x 1000
   tokens must launch the dense prefill kernel (as for Llama3-8B) 12
   times and the scan
   kernel 26 times, ``forward`` on one token the dense decode kernel 12
   times and the scan 26 times, and ``prefill`` of 2500 tokens into a
   4096-slot cache (2048-slot local rings) + 16 ``decode_step`` s the scan
   26 times and no plain version; timed in bf16 with a profiled decode
   step, held in f32 (disaggregated vs unified, prefill/decode vs
   ``forward``) within the same rtol 3e-4 / atol 5e-4.  Then the zoo
   (``ZOO_MODELS``), one model at a time, each freed before the next,
   bf16 at full width, random weights from seed 0, 4 adapters of rank 16:
   dbrx-132b (2 of 40 layers: 16 experts top-4) and starcoder2-3b (30
   layers, GELU, a group of 12) serve a 1024-token session with 4
   staggered forks and 8 greedy tokens in forkkv (#1/#2) and prefix
   (#3/#4) mode under the mixed loop, and run ``forward(disagg=True)`` on
   4 x 1000 tokens (#7 once per layer) and at one token (#8 once per
   layer); h2o-danube-3-4b (24 layers, head_dim 120, window 4096) serves
   the same session in forkkv and prefix mode under the mixed loop (#1/#2,
   #3/#4 at D 120) and under the phase-separated loop (#5/#2, #6/#4), each
   with tokens per second, TTFT and TPOT p50, peak pages and cache bytes,
   and runs the same ``forward`` s (#7 and #8 at D 120) and ``prefill`` of
   600 + 16 ``decode_step`` s;
   llava-next-mistral-7b (32 layers) runs ``forward`` on 2880 patch
   embeddings + 120 tokens, ``forward`` at one token (#8), and
   ``prefill`` of the patches and tokens + 16 ``decode_step`` s;
   llama4-maverick (2 of 48 layers: one dense and one MoE sublayer of 128
   experts with the shared expert) the ``forward`` s and ``prefill`` 600
   + 8 ``decode_step`` s; mamba2-130m (24 layers, through the model API)
   ``forward`` on 4 x 1000 tokens and ``prefill`` 600 + 32
   ``decode_step`` s; whisper-large-v3 (32 encoder and 32 decoder layers,
   1500 stub frame embeddings per row, 4 adapters, ``disagg=True``)
   ``forward`` on 4 x 448 tokens and ``prefill`` of 64 tokens with the
   frames + 32 ``decode_step`` s, neither launching a kernel (a
   ``zoo_seconds`` line gives each model's time).  Each ``zoo`` line logs
   init seconds, ms per
   call, launches by counter, peak memory and, for the MoE models, the
   share of assignments dropped at capacity factor 1.25.  Training, each
   through the port's entry points: Llama3-8B's LoRA fine-tune on the
   serving weights (4 adapters of rank 16, 5 steps of B 4 x S 512:
   losses, ms per step, tokens/s, peak memory; the held-out loss must
   fall and the base weights stay bit-equal; no kernel launches); after
   RecurrentGemma-9B's model API, its LoRA fine-tune at full width and
   depth (3 steps of B 2 x S 1000: each step launches the forward kernel
   26 times, once per RG-LRU layer, the backward 24, once per RG-LRU
   layer after the first adapter's, and under the config's remat the
   forward 24 times more; the first local layer's adapter gradient
   non-zero; the gradients with the plain scan patched in logged in bf16
   beside bf16's one-ulp floor and held within 1% in f32); after
   the zoo, internlm2-1.8b's full-parameter training through ``python -m
   repro_torch.launch.train`` as a process of its own (5 steps of B 8 x S
   128, bf16, AdamW: finite lines, exit 0), and a small f32 hybrid
   (remat on) and dense model trained 3 AdamW steps on card and CPU from
   the same weights: losses within 1e-5, gradient norms within 1e-4 and
   parameters within AdamW's noise bound at lr 1e-3, parameters within
   1e-4 at lr 1e-5 (the ``train_summary`` line).  Also on Llama3-8B: the
   forkkv mixed-loop serve with 4 adapters of rank 128 (#1's and #2's
   chunked instances, ``_rchunk``; ``serve_rank128`` beside the rank-16
   serve), and ``launch/steps.py``'s steps on ``make_local_mesh()`` (the
   1x1 mesh on the card): the prefill step (B 4 x S 4096) and the serve
   step (B 32 over a 4096-token cache), 8 adapters of rank 16,
   disaggregated; after the launcher, internlm2-1.8b's train step (B 16 x
   S 512 in ``accum_for``'s 16 microbatches): ms, launches, the analytic
   bound on the 1x1 mesh and its share, the FLOP counter beside the
   analytic FLOPs (``built_step``); the Llama3-8B prefill and serve steps
   again through the DTensor path on the same 1x1 NCCL mesh
   (``steps.shard_args``/``run_sharded``): the plain call's ids, no
   collective counted, ms beside the plain call's (``built_step_dtensor``).
   The dry run (``python -m repro_torch.launch.dryrun --arch all --shape
   all --mesh both``, no card visible, one worker process per host core)
   runs as a process of its own after phase 6, so that it overlaps no
   timing, and must exit 0 with 66 pairs ok and 14 skipped, each ok pair
   with the collectives counted from its sharded step (``dryrun``);
6. the kernels again, at every launch geometry the serves of 5. gave
   them (batch, query width, table width, per-row start and q_len), in
   f32 and bf16 against their plain versions (int8 pages for the int8
   variants, also held to 5% of full precision); each is timed in bf16,
   and the heaviest one's numbers make the kernels line; the dense kernels on
   the inputs of their first launch in 5. (bf16), for each model, and on
   random f32 inputs of the same geometry; the scan kernel on the inputs
   of its first launch at each shape of 5. (f32, timed) and on the same
   inputs in bf16; the dense kernels also on the inputs of their first
   launch by h2o-danube-3-4b (D 120), and the six paged kernels at every
   launch geometry of its serves (at its heads, D 120), and #1 and #2 at
   every launch geometry of the rank-128 serve (their chunked
   instances); the scan's
   backward on the inputs of its first launch in the RecurrentGemma-9B
   fine-tune (f32, timed) and on the same inputs in bf16;
7. the kernels line (#1–#6, their int8 variants, #7–#9 and #9's backward
   ``rg_lru_scan_bwd`` with its launches in the fine-tune, each named by the
   counter of the kernel the bf16 main path ran: ``_mma`` for #1, #3, #5,
   #6, their int8 variants and #7, ``_splitk`` for #2, #4, their int8
   variants and #8; #7 and #8 at D 128, at D 256 (``_d256``) and at D 120
   (``_d120``); #1–#6 also at D 120 (``_d120``), at h2o-danube-3-4b's
   heaviest serving launch with its serves' launch counts), the card line
   and the result line.
"""
import dataclasses
import gc
import itertools
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

F32_TOL = 1e-4        # f32 kernel vs plain version (summation order only)
BF16_RTOL = 1e-2      # bf16, as a share of the plain version's max |value|:
                      # the output's own rounding is one ulp, 2^-8 of a
                      # value, and the plain version rounds K/V and sin/cos
                      # to bf16 where the kernel rebuilds K in f32
PLAIN_SCORE_BYTES = 2 << 30   # f32 score block of one plain-version call
PEAK = {torch.float32: 67e12, torch.bfloat16: 989e12}   # H100 SXM, dense
HBM_BW = 3.35e12
LLAMA_GEOM = dict(hq=32, hkv=8, d=128, r=16, page=16)


def log(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_kernels(text):
    """{kernel: registers, stack and spill bytes} from an ``nvcc
    -Xptxas=-v`` log, each kernel by its demangled name (``c++filt``, or the
    mangled one where that is missing)."""
    use, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            use.setdefault(name, {}).update(
                stack=int(m[1]), spill_stores=int(m[2]),
                spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            use.setdefault(name, {})["registers"] = int(m[1])
    try:
        names = subprocess.run(["c++filt"], input="\n".join(use),
                               capture_output=True, text=True, check=True,
                               timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        names = list(use)
    return {n.replace("(anonymous namespace)::", ""): v
            for n, v in zip(names, use.values())}


# ---------------------------------------------------------------- timing
_FLUSH = None


def time_ms(fn, reps=10, warmup=2):
    """Mean device time of one call, L2 flushed before each call (the
    serving path finds each layer's pages cold).  A short device sleep
    ahead of the start event keeps the card busy while the host enqueues
    the call, so the host's own time is not counted."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(reps):
        _FLUSH.zero_()
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


# ------------------------------------------------------- kernel inputs
_KVL = [2048, 1500, 1023, 777, 512, 300, 129, 64]
FIXED = {
    # a 512-wide chunk: full from mid-page 1000, padded (300 valid from
    # 0), 8 valid at 2040, and a padding row with n_valid = 0
    "prefill": dict(start=[1000, 0, 2040, 0], qlen=[512, 300, 8, 0],
                    sq=512, width=128),
    # 8 decode rows, ragged kv_len up to 2048
    "decode": dict(start=[k - 1 for k in _KVL], qlen=[1] * 8, sq=1,
                   width=128),
    # one 512-token prefill row starting mid-page at 1000, 7 decode rows,
    # one q_len=0 row
    "mixed": dict(start=[1000] + [k - 1 for k in _KVL[:7]] + [0],
                  qlen=[512] + [1] * 7 + [0], sq=512, width=128),
}


def make_case(kind, dtype, window, seed, start, qlen, sq, width,
              device="cuda", quantize=None, geom=None):
    """Random inputs at Llama3-8B's head geometry (or ``geom``) for rows
    that start at ``start`` with ``qlen`` query positions each (decode:
    qlen 1, sq 1), padded to ``sq`` positions, over block tables ``width``
    pages wide drawn from a shuffled pool.  With ``quantize`` (the port's
    write-time ``quantize_kv``) the base pools are int8 with their scales
    ``ks``/``vs`` and the full-precision pools stay as ``kb_fp``/``vb_fp``."""
    g = geom or LLAMA_GEOM
    bsz = len(start)
    pool = bsz * width + 16
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device) * scale
                ).to(dtype)

    perm = lambda: torch.randperm(pool, generator=gen,  # noqa: E731
                                  device=device)[:bsz * width]
    i32 = lambda v: torch.tensor(v, dtype=torch.int32,  # noqa: E731
                                 device=device)
    c = dict(
        kb=rn(pool, g["page"], g["hkv"], g["d"]),
        vb=rn(pool, g["page"], g["hkv"], g["d"]),
        kr=rn(pool, g["page"], g["r"], scale=0.3),
        vr=rn(pool, g["page"], g["r"], scale=0.3),
        b_k=rn(bsz, g["r"], g["hkv"] * g["d"], scale=0.3),
        b_v=rn(bsz, g["r"], g["hkv"] * g["d"], scale=0.3),
        bt_b=perm().reshape(bsz, width).to(torch.int32).contiguous(),
        bt_r=perm().reshape(bsz, width).to(torch.int32).contiguous(),
        start=i32(start), q_len=i32(qlen),
        kv_len=i32([s + n for s, n in zip(start, qlen)]))
    # a chunked prefill row's kv_len is start + n_valid (its q_len here)
    c["q"] = rn(bsz, g["hq"], g["d"]) if kind == "decode" else \
        rn(bsz, sq, g["hq"], g["d"])
    c.update(kind=kind, window=window, scale=g["d"] ** -0.5, dtype=dtype,
             start_l=start, qlen_l=qlen, ks=None, vs=None, geom=g)
    if quantize is not None:
        c["kb_fp"], c["vb_fp"] = c["kb"], c["vb"]
        c["kb"], c["ks"] = quantize(c["kb_fp"])
        c["vb"], c["vs"] = quantize(c["vb_fp"])
    return c


def kernel_call(pra, name, c):
    """The kernel wrapper ``name`` (an int8 variant: its entry's wrapper
    with the scales) on case ``c``."""
    name = name.removesuffix("_int8")
    kw = dict(scale=c["scale"], window=c["window"], kb_scale=c["ks"],
              vb_scale=c["vs"])
    if name == "paged_residual_attention_mixed":
        return lambda: pra.paged_residual_attention_mixed(
            c["q"], c["kb"], c["vb"], c["kr"], c["vr"], c["b_k"], c["b_v"],
            c["bt_b"], c["bt_r"], c["start"], c["q_len"], c["kv_len"], **kw)
    if name == "paged_residual_attention_decode":
        return lambda: pra.paged_residual_attention_decode(
            c["q"], c["kb"], c["vb"], c["kr"], c["vr"], c["b_k"], c["b_v"],
            c["bt_b"], c["bt_r"], c["kv_len"], **kw)
    if name == "paged_residual_attention_prefill":
        return lambda: pra.paged_residual_attention_prefill(
            c["q"], c["kb"], c["vb"], c["kr"], c["vr"], c["b_k"], c["b_v"],
            c["bt_b"], c["bt_r"], c["start"], c["kv_len"], **kw)
    if name == "paged_attention_mixed_base":
        return lambda: pra.paged_attention_mixed_base(
            c["q"], c["kb"], c["vb"], c["bt_b"], c["start"], c["q_len"],
            c["kv_len"], **kw)
    if name == "paged_attention_prefill_base":
        return lambda: pra.paged_attention_prefill_base(
            c["q"], c["kb"], c["vb"], c["bt_b"], c["start"], c["kv_len"],
            **kw)
    return lambda: pra.paged_attention_decode_base(
        c["q"], c["kb"], c["vb"], c["bt_b"], c["kv_len"], **kw)


def plain_call(ref, name, c):
    """The plain version on case ``c``.  It holds several f32 tensors of
    (rows, Hq, Sq, Sk), so a case above ``PLAIN_SCORE_BYTES`` of scores runs
    as one call per slice of batch rows (rows are independent)."""
    res = "residual" in name
    kw = dict(scale=c["scale"], window=c["window"], kb_scale=c["ks"],
              vb_scale=c["vs"])
    bsz = c["bt_b"].shape[0]
    sq = 1 if c["kind"] == "decode" else c["q"].shape[1]
    sk = c["bt_b"].shape[1] * c["geom"]["page"]
    step = max(1, PLAIN_SCORE_BYTES // (c["geom"]["hq"] * sq * sk * 4))

    def rows(sl):
        args = [c["q"][sl], c["kb"], c["vb"]] + (
            [c["kr"], c["vr"], c["b_k"][sl], c["b_v"][sl]] if res
            else [None] * 4) + [c["bt_b"][sl], c["bt_r"][sl] if res else None]
        if c["kind"] == "mixed":
            return ref.paged_residual_attention_mixed_ref(
                *args, c["start"][sl], c["q_len"][sl], c["kv_len"][sl], **kw)
        if c["kind"] == "prefill":
            return ref.paged_residual_attention_prefill_ref(
                *args, c["start"][sl], c["kv_len"][sl], **kw)
        return ref.paged_residual_attention_ref(*args, c["kv_len"][sl], **kw)

    if step >= bsz:
        return lambda: rows(slice(0, bsz))
    return lambda: torch.cat([rows(slice(lo, lo + step))
                              for lo in range(0, bsz, step)])


def library_call(ref, name, c):
    """``scaled_dot_product_attention`` over the same K/V laid out
    contiguously beforehand (not timed): the base pages (int8 dequantized
    to q's type), for a disaggregated kernel rebuilt with the residual
    pages by the plain ``reconstruct`` (``ref._gather_paged_kv``), GQA
    heads expanded, the paged masks as a boolean mask: a yardstick, never
    used by the port."""
    g = c["geom"]
    bsz, width, page = c["bt_b"].shape[0], c["bt_b"].shape[1], g["page"]
    sk = width * page
    rep = g["hq"] // g["hkv"]
    k, v = ref._gather_paged_kv(
        c["q"], c["kb"], c["vb"], c["kr"] if "residual" in name else None,
        c["vr"], c["b_k"], c["b_v"], c["bt_b"], c["bt_r"],
        rope_theta=10_000.0, use_rope=True, kb_scale=c["ks"],
        vb_scale=c["vs"])
    k, v = (x.reshape(bsz, sk, g["hkv"], g["d"]).transpose(1, 2)
            .repeat_interleave(rep, dim=1).contiguous() for x in (k, v))
    q = c["q"][:, :, None] if c["kind"] == "decode" else \
        c["q"].transpose(1, 2)
    q = q.contiguous()
    sq = q.shape[2]
    dev = c["q"].device
    qpos = c["start"][:, None] + torch.arange(sq, device=dev)[None]
    kpos = torch.arange(sk, device=dev)
    mask = (kpos[None, None] <= qpos[..., None]) & \
        (kpos[None, None] < c["kv_len"][:, None, None])
    if c["window"]:
        mask &= kpos[None, None] > qpos[..., None] - c["window"]
    mask = mask[:, None].contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(q, k, v, attn_mask=mask, scale=c["scale"])


def work(name, c):
    """Bytes the function must move and operations it must do on these
    inputs: live pages of each row (the kernel's page-loop bounds; int8
    pages one byte per element plus an f32 scale per token and head), the
    q rows below q_len and B_k/B_v read once, all of out (padding rows are
    zeroed) written once; one QK and one PV product per unmasked
    (query, key) pair and head, plus the rank-R reconstruction: K_r.B_k
    per live key, and V's residual by the cheaper of two routes, P.V_r
    per pair then acc_r.B_v per row, or V_r.B_v per live key."""
    g = c["geom"]
    res = "residual" in name
    esize = torch.tensor([], dtype=c["dtype"]).element_size()
    page, d, hq, hkv, r = g["page"], g["d"], g["hq"], g["hkv"], g["r"]
    w = c["window"]
    pages, pairs, live_tokens, rows = set(), 0, 0, 0
    for b, (st, ql) in enumerate(zip(c["start_l"], c["qlen_l"])):
        if ql == 0:
            continue
        kvl = st + ql
        lo = max(st - (w - 1), 0) // page if w else 0
        hi = (kvl - 1) // page
        for j in range(lo, hi + 1):
            pages.add((b, j))
        live_tokens += (hi - lo + 1) * page
        rows += ql
        for qp in range(st, st + ql):
            first = max(0, qp - w + 1) if w else 0
            pairs += qp - first + 1
    page_token = hkv * (d + 4) if c["ks"] is not None else hkv * d * esize
    nbytes = len(pages) * page * page_token * 2
    nbytes += rows * hq * d * esize                         # live q rows
    nbytes += c["q"].numel() * esize                        # all of out
    ops = pairs * hq * 4 * d
    if res:
        nbytes += len(pages) * page * r * esize * 2
        nbytes += 2 * c["b_k"].numel() * esize
        ops += live_tokens * hkv * 2 * r * d                # K_r . B_k
        ops += min(pairs * hq * 2 * r + rows * hq * 2 * r * d,
                   live_tokens * hkv * 2 * r * d)           # V's residual
    t_bytes, t_ops = nbytes / HBM_BW * 1e3, ops / PEAK[c["dtype"]] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


PALLAS = "src/repro/kernels/paged_residual_attention.py"
PAGED_SOURCE = "src/repro_torch/kernels/csrc/paged_residual_attention.cu"
DISAGG_SOURCE = "src/repro_torch/kernels/csrc/paged_residual_disagg.cu"
KERNELS = {
    # name: (case kind, replaces)
    "paged_residual_attention_mixed": (
        "mixed", "src/repro/kernels/paged_residual_attention.py:764"),
    "paged_residual_attention_decode": (
        "decode", "src/repro/kernels/paged_residual_attention.py:206"),
    "paged_residual_attention_prefill": (
        "prefill", "src/repro/kernels/paged_residual_attention.py:488"),
    "paged_attention_mixed_base": (
        "mixed", "src/repro/kernels/paged_residual_attention.py:910"),
    "paged_attention_decode_base": (
        "decode", "src/repro/kernels/paged_residual_attention.py:345"),
    "paged_attention_prefill_base": (
        "prefill", "src/repro/kernels/paged_residual_attention.py:633"),
}
# the int8 variants: each entry's ``quant = kb_scale is not None`` branch
KERNELS_INT8 = {
    f"{n}_int8": (kind, f"{PALLAS}:{line}")
    for (n, (kind, _)), line in zip(KERNELS.items(),
                                    (787, 231, 516, 922, 363, 645))}
ALL_KERNELS = {**KERNELS, **KERNELS_INT8}
QUANT_TOL = 0.05      # int8 vs full-precision pages, as a share of the
                      # full-precision output's max |value| (the bound of
                      # tests/test_kv_quant.py)
DTYPES = ((torch.float32, F32_TOL), (torch.bfloat16, BF16_RTOL))


def launched(mod, before):
    """The launch counters of ``mod`` that moved since ``before``."""
    return {k: v - before[k] for k, v in mod.LAUNCHES.items()
            if v != before[k]}


def compare(pra, ref, name, c, tol, case):
    """The kernel against its plain version on ``c``; raises on a
    non-zero row at or past q_len or an error past ``tol`` (f32: absolute;
    bf16: a share of the plain version's max |value|).  A chunked
    prefill's rows at or past n_valid are padding its caller ignores, which
    the plain version computes and the kernel zeroes: only the rows below
    n_valid are compared.  An int8 case also holds the kernel within
    ``QUANT_TOL`` of the plain version on the full-precision pages.
    The launch must have gone to the kernel ``pra.kernel_name`` names (a
    bf16 launch of a tensor-core entry to its ``_mma`` kernel, f32 to the
    template; the base-only decode to its ``_splitk`` kernel, whose split
    count, grid and workspace bytes the record carries).  A decode row
    at kv_len 0 (q_len 0) must come back 0 and is not compared.  Returns
    the record to log."""
    before = dict(pra.LAUNCHES)
    got = kernel_call(pra, name, c)()
    ran = launched(pra, before)
    kernel = pra.kernel_name(name.removesuffix("_int8"), c["dtype"],
                             c["ks"] is not None, c["geom"]["r"])
    if ran != {kernel: 1}:
        raise AssertionError(f"{name} {case} {c['dtype']}: ran {ran}, "
                             f"not {kernel}")
    want = plain_call(ref, name, c)()
    full = None if c["ks"] is None else plain_call(ref, name, dict(
        c, kb=c["kb_fp"], vb=c["vb_fp"], ks=None, vs=None))()
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name} {case}: non-finite output")
    qlen = torch.tensor(c["qlen_l"], device=got.device)
    # (B, Sq) rows below q_len; a decode row sees no key at kv_len 0 (q_len
    # 0 here), where the kernel gives 0 and the plain version averages V
    rows = qlen > 0 if c["kind"] == "decode" else \
        torch.arange(got.shape[1], device=got.device)[None] < qlen[:, None]
    pad = got[~rows]
    if pad.numel() and pad.abs().max().item() != 0.0:
        raise AssertionError(f"{name} {case}: a row past q_len is not 0")
    got, want = got[rows], want[rows]
    full = None if full is None else full[rows]
    err = (got.float() - want.float()).abs().max().item()
    ref_max = want.float().abs().max().item()
    limit = tol * ref_max if c["dtype"] == torch.bfloat16 else tol
    rec = dict(kernel=name, ran=kernel, dtype=str(c["dtype"]).split(".")[1],
               case=case, window=c["window"], max_abs_err=err,
               ref_max_abs=ref_max, limit=limit)
    if kernel.endswith("_splitk"):
        g, (bsz, width) = c["geom"], c["bt_b"].shape
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        rec["split"] = pra.res_split_plan(
            bsz, g["hq"], g["hkv"], g["d"], g["r"], width, g["page"],
            c["ks"] is not None, sms) if "residual" in name else \
            pra.split_plan(bsz, g["hq"], g["hkv"], g["d"], width, g["page"],
                           sms)
    if full is not None:
        rec["vs_full_precision"] = (got.float() - full.float()).abs().max(
        ).item() / full.float().abs().max().item()
        rec["vs_full_precision_limit"] = QUANT_TOL
    del got, want, full
    if rec.get("vs_full_precision", 0.0) > QUANT_TOL:
        log("kernel", **rec, ok=False)
        raise AssertionError(f"{name} {case} {c['dtype']}: int8 pages move "
                             f"the output {rec['vs_full_precision']} of its "
                             f"max, > {QUANT_TOL}")
    if err > limit:
        log("kernel", **rec, ok=False)
        raise AssertionError(f"{name} {case} {c['dtype']} window="
                             f"{c['window']}: max abs err {err} > {limit}")
    return rec


def measure(pra, ref, name, c, rec):
    """Adds the kernel's, the plain version's and the library call's times
    and the bound on ``c`` to ``rec``."""
    rec["kernel_ms"] = time_ms(kernel_call(pra, name, c))
    rec["plain_ms"] = time_ms(plain_call(ref, name, c), reps=3, warmup=1)
    rec["library_ms"] = time_ms(library_call(ref, name, c))
    (rec["bound_ms"], rec["bound_by"], rec["bytes"],
     rec["ops"]) = work(name, c)
    return rec


def check_kernels(pra, ref, quantize, kernels=ALL_KERNELS):
    """Phase 3: every kernel against its plain version, f32 and bf16, at
    the fixed cases, without and with a sliding window, each timed; the
    int8 variants on the same cases with int8 pages (``quantize``)."""
    for dtype, tol in DTYPES:
        for window in (0, 300):
            for quant in (False, True):
                cases = {k: make_case(k, dtype, window, seed=1 + window,
                                      quantize=quantize if quant else None,
                                      **FIXED[k]) for k in FIXED}
                for name, (kind, _) in kernels.items():
                    if name.endswith("_int8") != quant:
                        continue
                    c = cases[kind]
                    rec = compare(pra, ref, name, c, tol, kind)
                    log("kernel", **measure(pra, ref, name, c, rec), ok=True)
                del cases
                torch.cuda.empty_cache()


# #6 and #3 at the edges of their tensor-core tile (bf16; the same cases in
# f32 run the template) and #4 at the same geometries (the split-K decode in
# both types): page sizes 8 and 32, head_dim 64, and a group of 64 heads
# (one position per tile), on the fixed rows with block tables covering
# their 2048 positions
PREFILL_EDGES = {
    "page 8": dict(LLAMA_GEOM, page=8),
    "page 32": dict(LLAMA_GEOM, page=32),
    "D 64": dict(LLAMA_GEOM, d=64),
    "G 64, D 64": dict(hq=64, hkv=1, d=64, r=16, page=16),
}
# (label, geometry, rows, table width) of #3's edges: the fixed mixed rows at
# each geometry
MIXED_EDGES = [(label, geom, FIXED["mixed"], 2048 // geom["page"])
               for label, geom in PREFILL_EDGES.items()]
# #4's (and #2's) edges: the fixed decode rows at each geometry; one row at
# kv_len 32768 over 2048 pages (what split-K is for); rows at kv_len 0, 1
# and 17 beside a 2048 row.  Every one runs again with a window of 300,
# which leaves some of a long row's splits without a key.
DECODE_EDGES = [(label, geom, FIXED["decode"], 2048 // geom["page"])
                for label, geom in PREFILL_EDGES.items()] + [
    ("long row", LLAMA_GEOM, dict(start=[32767], qlen=[1], sq=1), 2048),
    ("kv_len 2048, 0, 1, 17", LLAMA_GEOM,
     dict(start=[2047, 0, 0, 16], qlen=[1, 0, 1, 1], sq=1), 128),
]


# #5 and #2 (the disaggregated chunked prefill's tile and decode's
# split-K kernel) also at ranks whose K_r rows are not 16-byte multiples
# (5, zero-padded to 16 in the tile), 8 (one 16-byte copy, padded) and 32
# (the RP 32 instances), and #5 on rows at kv_len 0, 1, 17 (a row of 8
# from position 9) beside a 512-token chunk from 1000
RANK_EDGES = {f"R {r}": dict(LLAMA_GEOM, r=r) for r in (5, 8, 32)}
RES_PREFILL_ROWS = dict(start=[0, 0, 9, 1000], qlen=[0, 1, 8, 512], sq=512)
# #1 (on #5's tile with q_len given) on ragged mixed rows: a q_len 0 row at
# kv_len 0 (exactly 0), a decode row at kv_len 1, 17 positions from 0, a
# decode row at kv_len 17, 17 positions from mid-page 40, a full 512 row
RES_MIXED_ROWS = dict(start=[0, 0, 0, 16, 40, 1000],
                      qlen=[0, 1, 17, 1, 17, 512], sq=512)


def check_edges(pra, ref, quantize):
    """Phase 3: the base-only chunked prefill (#6) at ``PREFILL_EDGES``, the
    mixed grid (#3) at ``MIXED_EDGES`` and the decode (#4) at
    ``DECODE_EDGES``; the disaggregated chunked prefill (#5), mixed grid
    (#1) and decode (#2) at the same edges and at ``RANK_EDGES``, #5 also
    on ``RES_PREFILL_ROWS``, #1 on ``RES_MIXED_ROWS``; each with its int8
    variant, f32 and bf16, without and with a window."""
    sets = [("paged_attention_prefill_base", label, geom,
             dict(FIXED["prefill"], width=2048 // geom["page"]))
            for label, geom in PREFILL_EDGES.items()]
    sets += [("paged_attention_mixed_base", label, geom, dict(rows, width=w))
             for label, geom, rows, w in MIXED_EDGES]
    sets += [("paged_attention_decode_base", label, geom, dict(rows, width=w))
             for label, geom, rows, w in DECODE_EDGES]
    sets += [("paged_residual_attention_prefill", label, geom,
              dict(FIXED["prefill"], width=2048 // geom["page"]))
             for label, geom in {**PREFILL_EDGES, **RANK_EDGES}.items()]
    sets += [("paged_residual_attention_prefill", "kv_len 0, 1, 17",
              LLAMA_GEOM, dict(RES_PREFILL_ROWS, width=128))]
    sets += [("paged_residual_attention_mixed", label, geom,
              dict(rows, width=w)) for label, geom, rows, w in MIXED_EDGES]
    sets += [("paged_residual_attention_mixed", label, geom,
              dict(FIXED["mixed"], width=128))
             for label, geom in RANK_EDGES.items()]
    sets += [("paged_residual_attention_mixed",
              "q_len 0, 1, 17, 512; kv_len 0, 1, 17", LLAMA_GEOM,
              dict(RES_MIXED_ROWS, width=128))]
    sets += [("paged_residual_attention_decode", label, geom,
              dict(rows, width=w)) for label, geom, rows, w in DECODE_EDGES]
    sets += [("paged_residual_attention_decode", label, geom,
              dict(FIXED["decode"], width=128))
             for label, geom in RANK_EDGES.items()]
    for entry, label, geom, rows in sets:
        kind = KERNELS[entry][0]
        for dtype, tol in DTYPES:
            for window in (0, 300):
                for quant in (False, True):
                    name = entry + ("_int8" if quant else "")
                    c = make_case(kind, dtype, window, seed=7,
                                  quantize=quantize if quant else None,
                                  geom=geom, **rows)
                    log("kernel", **compare(pra, ref, name, c, tol,
                                            f"edge {label}"), ok=True)
                    del c
        torch.cuda.empty_cache()


# Head_dim 32, the width of ``tiny_serving_model()`` at its defaults (d_model
# 256 over 8 heads): Llama-like groups of 2 and 4 query heads per kv head,
# page 16, rank 8 (the reference's serve launcher)
D32_GEOMS = {"D 32 G 2": dict(hq=8, hkv=4, d=32, r=8, page=16),
             "D 32 G 4": dict(hq=8, hkv=2, d=32, r=8, page=16)}


def check_d32(pra, ref, quantize):
    """Phase 3, head_dim 32: the six paged kernels and their int8 variants
    at ``D32_GEOMS`` on the fixed rows, f32 and bf16, without and with a
    window, each against its plain version (int8 also within
    ``QUANT_TOL`` of full precision), each naming the kernel that ran; the
    bf16 cases without a window are timed.  Returns the timed records."""
    timed = []
    for (label, geom), (dtype, tol) in itertools.product(D32_GEOMS.items(),
                                                        DTYPES):
        for window, quant in itertools.product((0, 300), (False, True)):
            cases = {k: make_case(k, dtype, window, seed=31 + window,
                                  quantize=quantize if quant else None,
                                  geom=geom, **FIXED[k]) for k in FIXED}
            for name, (kind, _) in ALL_KERNELS.items():
                if name.endswith("_int8") != quant:
                    continue
                c = cases[kind]
                rec = compare(pra, ref, name, c, tol, f"{label} {kind}")
                if dtype == torch.bfloat16 and not window:
                    timed.append(measure(pra, ref, name, c, rec))
                log("kernel_d32", **rec, ok=True)
            del cases
    torch.cuda.empty_cache()
    return timed


# h2o-danube-3-4b's heads: head_dim 120, which the tensor-core tiles (#6,
# #3, #5, #1) and #2's group tile run in D 128's columns with the halves
# split, #4 in D 128's lane map; its window of 4096 (on rows of at most
# 2048 keys it lets every key through, on the kernels' windowed path) and
# 300, which straddles pages and shares
DANUBE_GEOM = dict(hq=32, hkv=8, d=120, r=16, page=16)
D120_WINDOWS = (4096, 300)
# the edge lengths at D 120, windows 0 and 300: #5/#6 on rows at kv_len 0,
# 1 and 17 beside a 512-token chunk, #1/#3 on ragged mixed rows, #2/#4 on
# rows at kv_len 0, 1 and 17 beside a 2048 row and on one row at 32768,
# and #5/#1/#2 at ranks 5 and 32
_D120_DECODE_EDGE = dict(start=[2047, 0, 0, 16], qlen=[1, 0, 1, 1], sq=1,
                         width=128)
D120_EDGES = [
    (entry, label, DANUBE_GEOM, rows)
    for label, rows, entries in (
        ("kv_len 0, 1, 17", dict(RES_PREFILL_ROWS, width=128),
         ("paged_residual_attention_prefill", "paged_attention_prefill_base")),
        ("q_len 0, 1, 17, 512; kv_len 0, 1, 17",
         dict(RES_MIXED_ROWS, width=128),
         ("paged_residual_attention_mixed", "paged_attention_mixed_base")),
        ("kv_len 2048, 0, 1, 17", _D120_DECODE_EDGE,
         ("paged_residual_attention_decode", "paged_attention_decode_base")),
        ("long row", dict(start=[32767], qlen=[1], sq=1, width=2048),
         ("paged_residual_attention_decode", "paged_attention_decode_base")))
    for entry in entries] + [
    (entry, f"R {r}", dict(DANUBE_GEOM, r=r), dict(FIXED[kind], width=128))
    for r in (5, 32)
    for entry, kind in (("paged_residual_attention_prefill", "prefill"),
                        ("paged_residual_attention_mixed", "mixed"),
                        ("paged_residual_attention_decode", "decode"))]


def check_d120(pra, ref, quantize):
    """Phase 3, head_dim 120: the six paged kernels and their int8 variants
    at h2o-danube-3-4b's heads (``DANUBE_GEOM``) on the fixed rows, f32
    and bf16, windows ``D120_WINDOWS``, each against its plain version
    (int8 also within ``QUANT_TOL`` of full precision), each naming the
    kernel that ran; then at ``D120_EDGES``, windows 0 and 300.  The bf16
    cases over bf16 pages at window 4096 are timed, their bound counted at
    D 120 (``work``).  Returns the timed records."""
    timed = []
    for (dtype, tol), window, quant in itertools.product(
            DTYPES, D120_WINDOWS, (False, True)):
        cases = {k: make_case(k, dtype, window, seed=41 + window,
                              quantize=quantize if quant else None,
                              geom=DANUBE_GEOM, **FIXED[k]) for k in FIXED}
        for name, (kind, _) in ALL_KERNELS.items():
            if name.endswith("_int8") != quant:
                continue
            c = cases[kind]
            rec = compare(pra, ref, name, c, tol, f"D 120 {kind}")
            if dtype == torch.bfloat16 and window == 4096 and not quant:
                timed.append(measure(pra, ref, name, c, rec))
            log("kernel_d120", **rec, ok=True)
        del cases
        torch.cuda.empty_cache()
    for (entry, label, geom, rows), (dtype, tol), window, quant in \
            itertools.product(D120_EDGES, DTYPES, (0, 300), (False, True)):
        name = entry + ("_int8" if quant else "")
        c = make_case(KERNELS[entry][0], dtype, window, seed=43,
                      quantize=quantize if quant else None, geom=geom,
                      **rows)
        log("kernel_d120", **compare(pra, ref, name, c, tol,
                                     f"D 120 edge {label}"), ok=True)
        del c
    torch.cuda.empty_cache()
    return timed


def check_page64(pra, ref, quantize):
    """Phase 3, pages of 64 tokens, above the kernels' 32: each wrapper
    serves them as sub-pages of 32 (``pra.sub_pages``: views of the pools,
    tables expanded), every kernel and int8 variant at Llama3-8B's heads on
    the fixed rows (tables of 32 pages of 64), f32 and bf16, windows 0 and
    300, against its plain version on the 64-token pages."""
    geom = dict(LLAMA_GEOM, page=64)
    for (dtype, tol), window, quant in itertools.product(
            DTYPES, (0, 300), (False, True)):
        cases = {k: make_case(k, dtype, window, seed=47,
                              quantize=quantize if quant else None,
                              geom=geom, **dict(FIXED[k], width=32))
                 for k in FIXED}
        for name, (kind, _) in ALL_KERNELS.items():
            if name.endswith("_int8") == quant:
                log("kernel_page64", **compare(pra, ref, name, cases[kind],
                                               tol, f"page 64 {kind}"),
                    ok=True)
        del cases
    torch.cuda.empty_cache()


def time_decode_launches(pra, ref, quantize):
    """Phase 3, bf16, bf16 and int8 pages: a mixed-grid launch (#3) whose
    rows are all decode rows (the fixed decode rows, Sq 1) fills G of the
    tensor-core tile's 128 rows: its time beside the decode kernel's (#4)
    on the same rows; and #4's floor, 8 rows at kv_len 1 over 133-page
    tables (two launches and a chain of dependent loads, next to no
    bytes); the same three for the disaggregated mixed grid and decode
    (#1, #2)."""
    floor = dict(start=[0] * 8, qlen=[1] * 8, sq=1, width=133)
    for quant in (False, True):
        rec = {}
        for label, entry, rows in (
                ("mixed", "paged_attention_mixed_base", FIXED["decode"]),
                ("decode", "paged_attention_decode_base", FIXED["decode"]),
                ("decode floor", "paged_attention_decode_base", floor),
                ("res mixed", "paged_residual_attention_mixed",
                 FIXED["decode"]),
                ("res decode", "paged_residual_attention_decode",
                 FIXED["decode"]),
                ("res decode floor", "paged_residual_attention_decode",
                 floor)):
            name = entry + ("_int8" if quant else "")
            c = make_case(KERNELS[entry][0], torch.bfloat16, 0, seed=8,
                          quantize=quantize if quant else None, **rows)
            r = compare(pra, ref, name, c, BF16_RTOL, label)
            rec[label] = dict(ran=r["ran"], max_abs_err=r["max_abs_err"],
                              kernel_ms=time_ms(kernel_call(pra, name, c)),
                              bound_ms=work(name, c)[0])
            del c
        log("decode_launches", pages="int8" if quant else "bf16", **rec,
            ok=True)


def check_serving_shapes(pra, ref, recorded, quantize, geom=None):
    """Phase 6: each kernel at every distinct launch geometry of the
    serves, f32 and bf16, on random inputs (int8 pages for the int8
    variants) at the serving model's heads (``geom``; Llama3-8B's by
    default).  Of launches with the same
    (batch, query width, table width, window) the one with the most
    (query, key) pairs stands for them.  Each is timed in bf16, what the
    server runs; returns the record of the heaviest per kernel."""
    results = {}
    for name, launches in recorded.items():
        kind = ALL_KERNELS[name][0]
        quant = quantize if name.endswith("_int8") else None
        best = {}
        for launch in launches:
            bsz, sq, width, window, start, qlen = launch
            pairs = sum((s + n) * n for s, n in zip(start, qlen))
            if launch[:4] not in best or pairs > best[launch[:4]][0]:
                best[launch[:4]] = (pairs, launch)
        heaviest = max(best.values())[1]
        for _, launch in best.values():
            bsz, sq, width, window, start, qlen = launch
            case = f"serve B={bsz} Sq={sq} W={width}"
            for dtype, tol in DTYPES:
                c = make_case(kind, dtype, window, seed=5, start=list(start),
                              qlen=list(qlen), sq=sq, width=width,
                              quantize=quant, geom=geom)
                rec = compare(pra, ref, name, c, tol, case)
                rec.update(start=list(start), q_len=list(qlen), width=width)
                if dtype == torch.bfloat16:
                    measure(pra, ref, name, c, rec)
                    if launch is heaviest:
                        results[name] = rec
                log("kernel", **rec, ok=True)
                del c
                torch.cuda.empty_cache()
    return results


# the decode-only entry beside each mixed entry (#2 beside #1, #4 beside #3)
DECODE_TWIN = {"paged_residual_attention_mixed":
               "paged_residual_attention_decode",
               "paged_attention_mixed_base": "paged_attention_decode_base"}


def verify_as_decode(pra, ref, name, rec):
    """Phase 6: the rows of the verify launch ``rec`` (a mixed entry's
    heaviest verify geometry) as one decode row each over the same keys
    (kv_len = start + q_len; a q_len 0 row stays empty), through the
    decode-only twin in bf16: checked against its plain version and
    timed.  Returns the fields to add to ``rec``."""
    twin = DECODE_TWIN[name]
    start = [s + n - 1 if n else 0 for s, n in zip(rec["start"],
                                                   rec["q_len"])]
    qlen = [1 if n else 0 for n in rec["q_len"]]
    c = make_case("decode", torch.bfloat16, rec["window"], seed=5,
                  start=start, qlen=qlen, sq=1, width=rec["width"])
    dec = compare(pra, ref, twin, c, BF16_RTOL, "verify rows as decode")
    dec["kernel_ms"] = time_ms(kernel_call(pra, twin, c))
    log("kernel", **dec, ok=True)
    del c
    return dict(decode_kernel=dec["ran"], decode_ms=dec["kernel_ms"],
                verify_over_decode=rec["kernel_ms"] / dec["kernel_ms"])


# ------------------------------------------------------ dense kernels
DENSE_KERNELS = {
    # name: replaces
    "residual_attention_prefill":
        "src/repro/kernels/residual_attention.py:111",
    "residual_attention_decode":
        "src/repro/kernels/residual_attention.py:267",
}
DENSE_SOURCE = "src/repro_torch/kernels/csrc/residual_attention.cu"
# (hq, hkv, d, r): the CPU tests' heads (tests/test_torch_dense_kernels.py)
# at D 128 and R 16, Llama3-8B's, and RecurrentGemma-9B's local attention
# (MQA, G 16, D 256) with a GQA variant at D 256
DENSE_HEADS = {"mha": (4, 4, 128, 16), "gqa": (8, 2, 128, 16),
               "mqa": (4, 1, 128, 16), "llama": (32, 8, 128, 16),
               "rg mqa": (16, 1, 256, 16), "rg gqa": (16, 2, 256, 16)}
_DKV = [2048, 1500, 777, 64]
# (label, heads, sq, sk, start, kv_len): the CPU tests' cases (a forward's
# positions 0..S-1 with kv_len None, a chunk at an offset with kv_len < Sk,
# a ragged decode, Sq = Sk = 150) at D 128 and at D 256, and a ragged
# decode over 2048 keys at Llama3-8B's and RecurrentGemma-9B's heads (the
# "Sk=2048" cases are timed)
DENSE_FIXED = [
    (f"{h} {label}", h, sq, sk, start, kvl)
    for h in ("mha", "gqa", "mqa", "rg mqa", "rg gqa")
    for label, sq, sk, start, kvl in (
        ("full", 12, 12, [0, 0], None),
        ("chunk", 5, 16, [7, 3], [12, 8]),
        ("decode", 1, 16, [2, 15, 8], [3, 16, 9]))
] + [("gqa Sq=Sk=150", "gqa", 150, 150, [0], [150]),
     ("rg mqa Sq=Sk=150", "rg mqa", 150, 150, [0], [150]),
     ("llama decode Sk=2048", "llama", 1, 2048, [k - 1 for k in _DKV],
      _DKV),
     ("rg mqa decode Sk=2048", "rg mqa", 1, 2048, [k - 1 for k in _DKV],
      _DKV)]


# (label, (hq, hkv, d, r), sq, sk, start, kv_len): #7 at the edges of its
# tensor-core tile (bf16; the same cases in f32 run the scalar kernel): Sq
# not a multiple of the tile's positions, Sk not a multiple of the 64-key
# block, ranks 8, 32 and 5 (K_r rows not 16-byte aligned), head_dim 64, a
# group of 64 heads, and D 256 at rank 24 (zero-padded to 32); each run
# without and with a window of 100, which straddles key blocks
DENSE_EDGES = [
    ("edge R 8, Sq 37, Sk 97", (32, 8, 128, 8), 37, 97, [3, 60], [40, 97]),
    ("edge R 32, Sq 130, Sk 200", (32, 8, 128, 32), 130, 200, [70, 0],
     [200, 130]),
    ("edge R 5", (12, 3, 128, 5), 37, 97, [3, 60], [40, 97]),
    ("edge D 64", (8, 2, 64, 16), 130, 200, [70, 0], [200, 130]),
    ("edge G 64", (64, 1, 128, 16), 37, 97, [3, 60], [40, 97]),
    ("edge D 256, R 24", (16, 1, 256, 24), 300, 300, [0], None),
]
# and in bf16 only: D 256 at rank 32, which the tensor-core kernel takes
# and the scalar kernel refuses (its shared memory holds R <= ~26 at D 256)
DENSE_EDGES_BF16 = [
    ("edge D 256, R 32", (16, 1, 256, 32), 300, 300, [0], None),
]
# #8 (in bf16 the split-K decode) at D 64, 128 and 256 with groups of 4 and
# 16: at Sk 1 (``forward`` at S 1: one range, no combine) and at Sk 4096
# (B 4: ranges and a combine; timed in bf16 against its bound); ragged rows
# at rank 5 and with a group of 64 (four 16-head tiles); each with window 0
# and 300
DECODE_HEADS = {"D 64 G 4": (8, 2, 64, 16), "D 128 G 4": (32, 8, 128, 16),
                "D 128 G 16": (16, 1, 128, 16),
                "D 256 G 16": (16, 1, 256, 16), "D 256 G 4": (8, 2, 256, 16)}
_RAGGED = ([296, 40, 0, 16], [297, 41, 1, 17])
DENSE_DECODE = [
    (f"decode {label} Sk {sk}", heads, 1, sk, [sk - 1] * 4, [sk] * 4)
    for label, heads in DECODE_HEADS.items() for sk in (1, 4096)
] + [("decode R 5 ragged", (32, 8, 128, 5), 1, 300, *_RAGGED),
     ("decode G 64 ragged", (64, 1, 128, 16), 1, 300, *_RAGGED)]
# and in bf16 only: D 256 at rank 32 (the scalar kernel refuses it)
DENSE_DECODE_BF16 = [
    ("decode D 256 R 32 ragged", (16, 1, 256, 32), 1, 300, *_RAGGED),
]


# #7 and #8 at head_dim 32 (``D32_GEOMS``' heads at rank 8): the prefill on
# a chunk at an offset and across the tile's edges, the decode at Sk 1 (one
# range, its CTA finishes the row with 8 columns a warp) and at Sk 4096
# (ranges and a combine), and on ragged rows; windows 0 and 100 (prefill)
# or 300 (decode).  The "Sq=Sk=1024" prefill and the Sk 4096 decodes are
# timed in bf16.
DENSE_D32 = [
    case for g, heads in (("G 2", (8, 4, 32, 8)), ("G 4", (8, 2, 32, 8)))
    for case in (
        (f"D 32 {g} Sq 130, Sk 200", heads, 130, 200, [70, 0], [200, 130]),
        (f"D 32 {g} Sq 37, Sk 97", heads, 37, 97, [3, 60], [40, 97]),
        (f"D 32 {g} Sq=Sk=1024", heads, 1024, 1024, [0], None),
        (f"decode D 32 {g} Sk 1", heads, 1, 1, [0] * 4, [1] * 4),
        (f"decode D 32 {g} Sk 4096", heads, 1, 4096, [4095] * 4, [4096] * 4),
        (f"decode D 32 {g} ragged", heads, 1, 300, *_RAGGED))]


def check_dense_d32(ra, ref):
    """Phase 3, head_dim 32: the dense prefill (#7) and decode (#8) at
    ``DENSE_D32``, f32 and bf16, against their plain version; returns the
    timed bf16 records."""
    timed = []
    for (dtype, tol), (i, case) in itertools.product(DTYPES,
                                                     enumerate(DENSE_D32)):
        for window in ((0, 300) if case[2] == 1 else (0, 100)):
            c = make_dense_case(*case, dtype=dtype, window=window,
                                seed=140 + i)
            rec = compare_dense(ra, ref, c, tol)
            if dtype == torch.bfloat16 and not window and \
                    case[0].endswith(("Sq=Sk=1024", "Sk 4096")):
                timed.append(measure_dense(ra, ref, c, rec))
            log("dense_kernel_d32", **rec, ok=True)
            del c
    torch.cuda.empty_cache()
    return timed


# #7 and #8 at head_dim 120 (h2o-danube-3-4b's heads, Hq 32, Hkv 8; the bf16
# kernels in D 128's tile with split halves): the prefill on a chunk at an
# offset and across the tile's edges, and on 4 rows x 1000 tokens (the
# zoo's ``forward``; timed in bf16), the decode at Sk 1 (one range, the
# CTA finishes the row), at Sk 4096 (ranges and a combine; timed in bf16)
# and on ragged rows; rank 16, and ranks 5 and 32 on the chunk and the
# ragged decode; each with window 0 and 300.
D120 = 120
DENSE_D120 = [
    (f"D 120 R {r} {label}", (32, 8, D120, r), *rest)
    for r, label, *rest in (
        (16, "Sq 130, Sk 200", 130, 200, [70, 0], [200, 130]),
        (16, "Sq 37, Sk 97", 37, 97, [3, 60], [40, 97]),
        (16, "Sq=Sk=1000", 1000, 1000, [0] * 4, None),
        (16, "decode Sk 1", 1, 1, [0] * 4, [1] * 4),
        (16, "decode Sk 4096", 1, 4096, [4095] * 4, [4096] * 4),
        (16, "decode ragged", 1, 300, *_RAGGED),
        (5, "Sq 37, Sk 97", 37, 97, [3, 60], [40, 97]),
        (5, "decode ragged", 1, 300, *_RAGGED),
        (32, "Sq 37, Sk 97", 37, 97, [3, 60], [40, 97]),
        (32, "decode ragged", 1, 300, *_RAGGED))]


def check_dense_d120(ra, ref):
    """Phase 3, head_dim 120: the dense prefill (#7) and decode (#8) at
    ``DENSE_D120``, f32 and bf16, windows 0 and 300, against their plain
    version, each naming the kernel that ran; returns the timed bf16
    records (window 0), whose bound is counted at D 120."""
    timed = []
    for (dtype, tol), (i, case), window in itertools.product(
            DTYPES, enumerate(DENSE_D120), (0, 300)):
        c = make_dense_case(*case, dtype=dtype, window=window, seed=170 + i)
        rec = compare_dense(ra, ref, c, tol)
        if dtype == torch.bfloat16 and not window and \
                case[0].endswith(("Sq=Sk=1000", "Sk 4096")):
            timed.append(measure_dense(ra, ref, c, rec))
        log("dense_kernel_d120", **rec, ok=True)
        del c
    torch.cuda.empty_cache()
    return timed


# whisper-large-v3's decoder self-attention: 20 heads over 20 kv heads
# (group 1) at head_dim 64, rank 16, no RoPE (identity sin 0 / cos 1
# tables, as ``transformer._qkv`` gives them with ``use_rope=False``): a
# 448-token prefill (its decoder length) and a decode over 512 keys
WHISPER_HEADS = (20, 20, 64, 16)
DENSE_IDENTITY = [
    ("whisper prefill Sq=Sk=448", WHISPER_HEADS, 448, 448, [0] * 4, None),
    ("whisper decode Sk 512", WHISPER_HEADS, 1, 512, [511, 300, 63, 0],
     [512, 301, 64, 1]),
]


def check_dense_identity(ra, ref):
    """Phase 3, no RoPE: the dense prefill (#7) and decode (#8) at
    ``DENSE_IDENTITY`` with identity sin/cos tables, f32 and bf16, windows
    0 and 100, against their plain version, each naming the kernel that
    ran (the geometry and tables of whisper's decoder self-attention; the
    reference's whisper model API itself reaches neither kernel)."""
    for (dtype, tol), (i, case), window in itertools.product(
            DTYPES, enumerate(DENSE_IDENTITY), (0, 100)):
        c = make_dense_case(*case, dtype=dtype, window=window, seed=190 + i)
        c["sin"] = torch.zeros_like(c["sin"])
        c["cos"] = torch.ones_like(c["cos"])
        log("dense_kernel_identity", **compare_dense(ra, ref, c, tol),
            ok=True)
        del c
    torch.cuda.empty_cache()


def rope_tables(bsz, sk, d, dtype, device="cuda"):
    """sin/cos (B, Sk, D/2) of positions 0..Sk-1, theta 10000."""
    half = d // 2
    inv = 1.0 / (10_000.0 ** (torch.arange(half, device=device,
                                           dtype=torch.float32) / half))
    ang = torch.arange(sk, device=device, dtype=torch.float32)[:, None] * inv
    return tuple(t.expand(bsz, sk, half).to(dtype).contiguous()
                 for t in (torch.sin(ang), torch.cos(ang)))


def make_dense_case(label, heads, sq, sk, start, kv_len, dtype, window,
                    seed):
    """Random contiguous-cache inputs; ``heads`` names an entry of
    ``DENSE_HEADS`` or is (hq, hkv, d, r).  ``sq == 1`` with a kv_len list
    is a decode case (the query at kv_len - 1)."""
    hq, hkv, d, r = heads if isinstance(heads, tuple) else \
        DENSE_HEADS[heads]
    bsz = len(start)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dtype)

    sin, cos = rope_tables(bsz, sk, d, dtype)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32,  # noqa: E731
                                 device="cuda")
    return dict(
        label=label, decode=sq == 1 and kv_len is not None, dtype=dtype,
        window=window, causal=True, scale=d ** -0.5,
        q=rn(bsz, sq, hq, d), k_base=rn(bsz, sk, hkv, d),
        v_base=rn(bsz, sk, hkv, d), k_res=rn(bsz, sk, r, scale=0.3),
        v_res=rn(bsz, sk, r, scale=0.3), b_k=rn(bsz, r, hkv * d, scale=0.3),
        b_v=rn(bsz, r, hkv * d, scale=0.3), sin=sin, cos=cos,
        qpos=(i32(start)[:, None] + torch.arange(sq, device="cuda",
                                                 dtype=torch.int32)[None]),
        kv_len=None if kv_len is None else i32(kv_len))


_CACHE_ARGS = ("k_base", "v_base", "k_res", "v_res", "b_k", "b_v", "sin",
               "cos")


def dense_name(c):
    return "residual_attention_decode" if c["decode"] else \
        "residual_attention_prefill"


def dense_kernel_call(ra, c):
    cache = [c[k] for k in _CACHE_ARGS]
    if c["decode"]:
        q = c["q"][:, 0].contiguous()
        return lambda: ra.residual_attention_decode(
            q, *cache, c["kv_len"], scale=c["scale"],
            window=c["window"])[:, None]
    return lambda: ra.residual_attention_prefill(
        c["q"], *cache, c["qpos"], c["kv_len"], scale=c["scale"],
        causal=c["causal"], window=c["window"])


def dense_plain_call(ref, c):
    return lambda: ref.residual_attention_ref(
        c["q"], *[c[k] for k in _CACHE_ARGS], qpos=c["qpos"],
        kv_len=c["kv_len"], window=c["window"], causal=c["causal"],
        scale=c["scale"])


def dense_mask(c):
    """(B, Sq, Sk) keys each query row sees."""
    sk = c["k_base"].shape[1]
    kpos = torch.arange(sk, device="cuda")[None, None]
    qp = c["qpos"][..., None]
    mask = torch.ones((c["q"].shape[0], c["q"].shape[1], sk),
                      dtype=torch.bool, device="cuda")
    if c["kv_len"] is not None:
        mask &= kpos < c["kv_len"][:, None, None]
    if c["causal"]:
        mask &= kpos <= qp
    if c["window"]:
        mask &= kpos > qp - c["window"]
    return mask


def dense_library_call(ref, c):
    """``scaled_dot_product_attention`` over K/V reconstructed beforehand
    (not timed), GQA heads expanded, the mask as a boolean mask: a
    yardstick, never used by the port."""
    k, v = ref.reconstruct(*[c[n] for n in _CACHE_ARGS])
    rep = c["q"].shape[2] // k.shape[2]
    k, v = (t.transpose(1, 2).repeat_interleave(rep, dim=1).contiguous()
            for t in (k, v))
    q = c["q"].transpose(1, 2).contiguous()
    mask = dense_mask(c)[:, None].contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(q, k, v, attn_mask=mask, scale=c["scale"])


def dense_work(c):
    """Bytes and operations the function needs on these inputs: q, B_k,
    B_v (and the prefill's qpos) read once, out written once, and of the
    cache only the keys some query row sees (K_b, V_b, K_r, V_r, sin,
    cos); one QK and one PV product per visible (query, key) pair and
    head, the rank-R rebuild of each visible key's K, and V's residual by
    the cheaper of P.V_r then acc_r.B_v, or V_r.B_v per visible key."""
    hq, d = c["q"].shape[2], c["q"].shape[3]
    hkv, r = c["k_base"].shape[2], c["k_res"].shape[2]
    esize = torch.tensor([], dtype=c["dtype"]).element_size()
    mask = dense_mask(c)
    pairs = int(mask.sum().item())
    live = int(mask.any(dim=1).sum().item())        # (row, key) seen
    rows = c["q"].shape[0] * c["q"].shape[1]
    nbytes = 2 * c["q"].numel() * esize                  # q in, out
    nbytes += live * (2 * hkv * d + 2 * r + d) * esize   # K/V, K_r/V_r,
    nbytes += 2 * c["b_k"].numel() * esize               # sin/cos; B_k/B_v
    if not c["decode"]:
        nbytes += c["qpos"].numel() * 4
    ops = pairs * hq * 4 * d + live * hkv * 2 * r * d + min(
        pairs * hq * 2 * r + rows * hq * 2 * r * d, live * hkv * 2 * r * d)
    t_bytes, t_ops = nbytes / HBM_BW * 1e3, ops / PEAK[c["dtype"]] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def compare_dense(ra, ref, c, tol):
    """The dense kernel against its plain version on ``c``; raises on a
    non-finite output or an error past ``tol`` (f32: absolute; bf16: a
    share of the plain version's max |value|).  A decode row at kv_len 0
    must come back 0 and is not compared.  A bf16 prefill must have run
    the tensor-core kernel and a bf16 decode the split-K decode (whose
    plan the record carries), an f32 launch the scalar kernel.  Returns
    the record to log."""
    before = dict(ra.LAUNCHES)
    got = dense_kernel_call(ra, c)()
    want = dense_plain_call(ref, c)()
    torch.cuda.synchronize()
    name = dense_name(c)
    hq, hkv = c["q"].shape[2], c["k_base"].shape[2]
    at = (c["k_res"].shape[2], c["q"].shape[3], hq // hkv)
    kernel = ra.decode_kernel(c["dtype"], *at) if c["decode"] else \
        ra.prefill_kernel(c["dtype"], *at)
    if launched(ra, before) != {kernel: 1}:
        raise AssertionError(f"{name} {c['label']} {c['dtype']}: ran "
                             f"{launched(ra, before)}, not {kernel}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name} {c['label']}: non-finite output")
    if c["kv_len"] is not None and c["decode"] and \
            not torch.all(c["kv_len"] > 0):
        # a decode row at kv_len 0 sees no key: the kernel gives 0, the
        # plain version averages V there
        live = c["kv_len"] > 0
        if got[~live].abs().max().item() != 0.0:
            raise AssertionError(f"{name} {c['label']}: a row at kv_len 0 "
                                 f"is not 0")
        got, want = got[live], want[live]
    err = (got.float() - want.float()).abs().max().item()
    ref_max = want.float().abs().max().item()
    limit = tol * ref_max if c["dtype"] == torch.bfloat16 else tol
    rec = dict(kernel=name, ran=kernel, dtype=str(c["dtype"]).split(".")[1],
               case=c["label"], window=c["window"], causal=c["causal"],
               shape=list(c["q"].shape) + [c["k_base"].shape[1]],
               max_abs_err=err, ref_max_abs=ref_max, limit=limit)
    if kernel.endswith("_splitk"):
        bsz, _, hq, d = c["q"].shape
        rec["split"] = ra.decode_split_plan(
            bsz, hq, c["k_base"].shape[2], d, c["k_res"].shape[2],
            c["k_base"].shape[1], c["window"],
            torch.cuda.get_device_properties(0).multi_processor_count)
    del got, want
    if err > limit:
        log("dense_kernel", **rec, ok=False)
        raise AssertionError(f"{name} {c['label']} {c['dtype']} window="
                             f"{c['window']}: max abs err {err} > {limit}")
    return rec


def measure_dense(ra, ref, c, rec):
    rec["kernel_ms"] = time_ms(dense_kernel_call(ra, c))
    rec["plain_ms"] = time_ms(dense_plain_call(ref, c), reps=3, warmup=1)
    rec["library_ms"] = time_ms(dense_library_call(ref, c))
    (rec["bound_ms"], rec["bound_by"], rec["bytes"],
     rec["ops"]) = dense_work(c)
    return rec


def check_dense_kernels(ra, ref):
    """Phase 3, dense: both kernels against their plain version at the
    fixed cases, f32 and bf16, window 0 and 5, the prefill at
    ``DENSE_EDGES`` (bf16 also ``DENSE_EDGES_BF16``), window 0 and 100,
    causal and not, and the decode at ``DENSE_DECODE`` (bf16 also
    ``DENSE_DECODE_BF16``), window 0 and 300; the 2048- and 4096-key
    decodes are timed in bf16."""
    for dtype, tol in DTYPES:
        groups = [((0, 5), DENSE_FIXED, 20, (True,)),
                  ((0, 100), DENSE_EDGES, 60, (True, False)),
                  ((0, 300), DENSE_DECODE, 90, (True,))]
        if dtype == torch.bfloat16:
            groups += [((0, 100), DENSE_EDGES_BF16, 80, (True, False)),
                       ((0, 300), DENSE_DECODE_BF16, 120, (True,))]
        for windows, cases, seed, causals in groups:
            for window, causal, (i, case) in itertools.product(
                    windows, causals, enumerate(cases)):
                c = make_dense_case(*case, dtype=dtype, window=window,
                                    seed=seed + i)
                c["causal"] = causal
                rec = compare_dense(ra, ref, c, tol)
                if case[0].endswith(("Sk=2048", "Sk 4096")) and \
                        dtype == torch.bfloat16:
                    measure_dense(ra, ref, c, rec)
                log("dense_kernel", **rec, ok=True)
                del c
    torch.cuda.empty_cache()


class FirstLaunch:
    """While entered, keeps a copy of the inputs of the first launch of
    each dense kernel, as a case for ``compare_dense``/``measure_dense``.
    It wraps the module's functions and calls through, so the launch
    counters are untouched."""

    def __init__(self, ra):
        self.ra, self.cases, self.orig = ra, {}, {}

    def __enter__(self):
        for name in DENSE_KERNELS:
            self.orig[name] = getattr(self.ra, name)
            setattr(self.ra, name, self._wrap(name, self.orig[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.ra, name, fn)

    def _wrap(self, name, fn):
        decode = name == "residual_attention_decode"

        def call(*args, **kw):
            if name not in self.cases:
                q, cache = args[0], [a.clone() for a in args[1:9]]
                kv_len = args[9] if decode else args[10]
                bsz, sk = q.shape[0], cache[0].shape[1]
                if decode:
                    last = kv_len.long() - 1 if kv_len is not None else \
                        torch.full((bsz,), sk - 1, device=q.device)
                    qpos = last.to(torch.int32)[:, None]
                    q = q[:, None]
                else:
                    qpos = args[9]
                self.cases[name] = dict(
                    label="main path", decode=decode, dtype=q.dtype,
                    window=kw.get("window", 0),
                    causal=kw.get("causal", True), scale=kw["scale"],
                    q=q.clone(), qpos=qpos.clone(),
                    kv_len=None if kv_len is None else kv_len.clone(),
                    **dict(zip(_CACHE_ARGS, cache)))
            return fn(*args, **kw)
        return call


# ------------------------------------------------------- RG-LRU scan
SCAN_SOURCE = "src/repro_torch/kernels/csrc/rg_lru.cu"
SCAN_REPLACES = "src/repro/kernels/rg_lru.py:48"
SCAN_F32_TOL = 1e-5   # f32 kernel vs plain version: one FMA against a
                      # multiply and an add per step, in a contracting
                      # recurrence
# (label, B, S, W): tests/test_kernels.py's shapes (the ragged one as it
# is, not padded), one step, and W not a multiple of the 128-lane CTA
SCAN_FIXED = [
    ("test_kernels 2x128x128", 2, 128, 128),
    ("test_kernels ragged 1x200x96", 1, 200, 96),
    ("S=1", 3, 1, 4096),
    ("W=200", 2, 77, 200),
]


def make_scan_case(label, bsz, s, w, dtype, seed):
    """a = sigmoid(N(0,1)) in (0, 1) as the gates give it, b = 0.2 N(0,1),
    h0 = 0.5 N(0,1), drawn in f32 on the card and cast to ``dtype``."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    rn = lambda *shape: torch.randn(shape, generator=gen,  # noqa: E731
                                    device="cuda")
    return dict(label=label, dtype=dtype,
                a=torch.sigmoid(rn(bsz, s, w)).to(dtype),
                b=(rn(bsz, s, w) * 0.2).to(dtype),
                h0=(rn(bsz, w) * 0.5).to(dtype))


def compare_scan(rg, ref, c):
    """The scan kernel against its plain version on ``c``: states within
    ``SCAN_F32_TOL`` (f32) or ``BF16_RTOL`` of the plain version's max
    |value| (bf16), and the last state equal to ``states[:, -1]``.
    Returns the record to log."""
    got, got_last = rg.rg_lru_scan(c["a"], c["b"], c["h0"])
    want, want_last = ref.rg_lru_scan_ref(c["a"], c["b"], c["h0"])
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"rg_lru_scan {c['label']}: non-finite output")
    if not torch.equal(got_last, got[:, -1]):
        raise AssertionError(f"rg_lru_scan {c['label']}: the last state "
                             f"is not states[:, -1]")
    err = max((got.float() - want.float()).abs().max().item(),
              (got_last.float() - want_last.float()).abs().max().item())
    ref_max = want.float().abs().max().item()
    limit = BF16_RTOL * ref_max if c["dtype"] == torch.bfloat16 else \
        SCAN_F32_TOL
    rec = dict(kernel="rg_lru_scan", dtype=str(c["dtype"]).split(".")[1],
               case=c["label"], shape=list(c["a"].shape), max_abs_err=err,
               ref_max_abs=ref_max, limit=limit)
    del got, want
    if err > limit:
        log("scan_kernel", **rec, ok=False)
        raise AssertionError(f"rg_lru_scan {c['label']} {c['dtype']}: max "
                             f"abs err {err} > {limit}")
    return rec


def scan_work(c):
    """Bytes and operations of the scan on these inputs: a, b and h0 read
    once, the states and the last state written once; one FMA (2
    operations, f32 on the CUDA cores whatever the input type) per
    element."""
    esize = c["a"].element_size()
    bsz, s, w = c["a"].shape
    nbytes = 3 * bsz * s * w * esize + 2 * bsz * w * esize
    ops = 2 * bsz * s * w
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = ops / PEAK[torch.float32] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def measure_scan(rg, ref, c, rec):
    """Adds the kernel's and the plain version's times and the bound.  No
    single PyTorch call computes this recurrence (a cumprod/cumsum rewrite
    divides by a running product that underflows): no library time."""
    args = (c["a"], c["b"], c["h0"])
    rec["kernel_ms"] = time_ms(lambda: rg.rg_lru_scan(*args))
    rec["plain_ms"] = time_ms(lambda: ref.rg_lru_scan_ref(*args), reps=3,
                              warmup=1)
    rec["library_ms"] = None
    (rec["bound_ms"], rec["bound_by"], rec["bytes"],
     rec["ops"]) = scan_work(c)
    return rec


def check_scan_kernels(rg, ref):
    """Phase 3, scan: the kernel against its plain version at the fixed
    cases, f32 and bf16, h0 non-zero."""
    for dtype in (torch.float32, torch.bfloat16):
        for i, case in enumerate(SCAN_FIXED):
            c = make_scan_case(*case, dtype=dtype, seed=40 + i)
            log("scan_kernel", **compare_scan(rg, ref, c), ok=True)
            del c
    torch.cuda.empty_cache()


class ScanLaunches:
    """While entered, keeps a copy of the inputs of the first launch of the
    scan kernel at each distinct shape, as cases for ``compare_scan`` /
    ``measure_scan``.  It wraps the module's function and calls through,
    so the launch counter is untouched."""

    def __init__(self, rg):
        self.rg, self.cases, self.orig = rg, {}, None

    def __enter__(self):
        self.orig = self.rg.rg_lru_scan
        self.rg.rg_lru_scan = self._call
        return self

    def __exit__(self, *exc):
        self.rg.rg_lru_scan = self.orig

    def _call(self, a, b, h0):
        if tuple(a.shape) not in self.cases:
            self.cases[tuple(a.shape)] = dict(
                label="main path B={} S={} W={}".format(*a.shape),
                dtype=a.dtype, a=a.clone(), b=b.clone(), h0=h0.clone())
        return self.orig(a, b, h0)


def check_scan_main_path(rg, ref, cases):
    """Phase 6, scan: the kernel on the inputs of its first launch at each
    main-path shape, in f32 as the model runs it, and on the same inputs
    cast to bf16, each timed with its bound.  Returns the f32 record of
    the first shape recorded (the forward's launch)."""
    first = None
    for c in cases.values():
        rec = compare_scan(rg, ref, c)
        log("scan_kernel", **measure_scan(rg, ref, c, rec), ok=True)
        first = first or rec
        bf = dict(c, dtype=torch.bfloat16, **{
            k: c[k].to(torch.bfloat16) for k in ("a", "b", "h0")})
        rec = compare_scan(rg, ref, bf)
        log("scan_kernel", **measure_scan(rg, ref, bf, rec), ok=True)
        del bf
    torch.cuda.empty_cache()
    return first


# ------------------------------------------------------- LoRA rank 64
# Ranks above 32 run the RP 64 instances: #5, #1 and #2 (and their int8
# variants) at Llama3-8B's heads (D 128), h2o-danube-3-4b's (D 120) and D
# 32 (G 4), #7 and #8 also at RecurrentGemma-9B's (D 256, G 16: the
# tensor-core prefill in 64 query rows, the scalar kernel in 16), on the
# fixed rows, windows 0 and 300, at ranks 33, 48 and 64
RANK64_RANKS = (33, 48, 64)
RANK64_GEOMS = {"D 128": LLAMA_GEOM, "D 120": DANUBE_GEOM,
                "D 32": D32_GEOMS["D 32 G 4"]}
RANK64_PAGED = ("paged_residual_attention_mixed",
                "paged_residual_attention_decode",
                "paged_residual_attention_prefill")
RANK64_DENSE_HEADS = {"D 128": (32, 8, 128), "D 120": (32, 8, D120),
                      "D 32": (8, 2, 32), "D 256": (16, 1, 256)}
# (label, sq, sk, start, kv_len) of the dense cases: a chunk at an offset
# across the tile's edges, and a ragged decode
RANK64_DENSE_ROWS = (("Sq 130, Sk 200", 130, 200, [70, 0], [200, 130]),
                     ("decode ragged", 1, 300, *_RAGGED))
# the timed rows (bf16, D 128, window 0) at ranks 32 and 64: 4 x 1000
# prefill rows (a forward's) and a decode over 4096 keys
RANK64_TIMED = (("Sq=Sk=1000", 1000, 1000, [0] * 4, None),
                ("decode Sk 4096", 1, 4096, [4095] * 4, [4096] * 4))


def rp_of(r):
    """The RP instance a rank runs in (``rank_instance`` of the port)."""
    return next(rp for rp in (16, 32, 64) if r <= rp)


def check_rank64(pra, ref, ra, quantize):
    """Phase 3, LoRA ranks above 32: the paged kernels (#5, #1, #2 and
    their int8 variants) at ``RANK64_GEOMS`` and the dense ones (#7, #8) at
    ``RANK64_DENSE_HEADS`` on ``RANK64_DENSE_ROWS``, ranks
    ``RANK64_RANKS``, f32 and bf16, windows 0 and 300, each against its
    plain version, naming the kernel and its RP instance; the f32 dense
    kernels at D 256 also at rank 32; then the bf16 cases at D 128, window
    0, timed at ranks 32 and 64 (the paged kernels on the fixed rows over
    bf16 pages, the dense ones on ``RANK64_TIMED``).  Returns the timed
    records."""
    n = 0
    for (glabel, geom), r, (dtype, tol), window, quant in itertools.product(
            RANK64_GEOMS.items(), RANK64_RANKS, DTYPES, (0, 300),
            (False, True)):
        g = dict(geom, r=r)
        cases = {k: make_case(k, dtype, window, seed=61 + r,
                              quantize=quantize if quant else None, geom=g,
                              **FIXED[k]) for k in FIXED}
        for entry in RANK64_PAGED:
            name = entry + ("_int8" if quant else "")
            rec = compare(pra, ref, name, cases[KERNELS[entry][0]], tol,
                          f"rank {r} {glabel}")
            log("kernel_rank64", **rec, rank=r, rp=rp_of(r), ok=True)
            n += 1
        del cases
        torch.cuda.empty_cache()
    dense = [(f"{hl} R {r} {label}", heads + (r,), *rest)
             for hl, heads in RANK64_DENSE_HEADS.items()
             for r in RANK64_RANKS for label, *rest in RANK64_DENSE_ROWS]
    dense += [(f"D 256 R 32 {label}", (16, 1, 256, 32), *rest)
              for label, *rest in RANK64_DENSE_ROWS]
    for (i, case), (dtype, tol), window in itertools.product(
            enumerate(dense), DTYPES, (0, 300)):
        if case[0].startswith("D 256 R 32") and dtype != torch.float32:
            continue            # bf16 at D 256 R 32: phase 3's DENSE_EDGES
        c = make_dense_case(*case, dtype=dtype, window=window, seed=200 + i)
        rec = compare_dense(ra, ref, c, tol)
        r = case[1][3]
        if dtype == torch.float32:
            rec["rows_per_cta"] = ra.tile_rows(case[1][2],
                                               case[1][0] // case[1][1], r)
        elif not c["decode"]:
            rec["rows_per_cta"] = ra.mma_rows(case[1][2], r)
        log("dense_kernel_rank64", **rec, rank=r, rp=rp_of(r), ok=True)
        n += 1
        del c
    torch.cuda.empty_cache()
    timed = []
    for r in (32, 64):
        g = dict(LLAMA_GEOM, r=r)
        for entry in RANK64_PAGED:
            kind = KERNELS[entry][0]
            c = make_case(kind, torch.bfloat16, 0, seed=71, geom=g,
                          **FIXED[kind])
            rec = compare(pra, ref, entry, c, BF16_RTOL, f"rank {r} timed")
            timed.append(dict(measure(pra, ref, entry, c, rec), rank=r))
            del c
        for i, (label, *rest) in enumerate(RANK64_TIMED):
            c = make_dense_case(f"D 128 R {r} {label}", (32, 8, 128, r),
                                *rest, dtype=torch.bfloat16, window=0,
                                seed=80 + i)
            rec = compare_dense(ra, ref, c, BF16_RTOL)
            timed.append(dict(measure_dense(ra, ref, c, rec), rank=r))
            del c
        torch.cuda.empty_cache()
    log("rank64_checked", cases=n, ok=True)
    return timed


# ------------------------------------- the dry run and the built steps
DRYRUN_PAIRS = 66     # the 33 applicable (arch, shape) pairs on both meshes
DRYRUN_SKIPPED = 14   # long_500k on the 7 full-attention archs, both meshes


def run_dryrun(card, timeout=600):
    """Runs ``python -m repro_torch.launch.dryrun --arch all --shape all
    --mesh both`` as a process of its own with no card visible (it needs
    none: its steps run on meta tensors, its meshes over the fake
    backend), after the card's phases, so that it overlaps no timing.  It
    must exit 0 with every applicable pair ``ok`` and the rest
    ``skipped``.  Logs its counts, its own seconds (its last line) and
    those of the process, and, per (arch, shape) on the single-pod mesh,
    the counted and analytic FLOPs, the analytic roofline's dominant term,
    and the collectives counted from the sharded step (bytes per device by
    kind, ``count``, ``total``, the depths counted) beside the analytic
    model's collective bytes per device."""
    out = ROOT / "build" / "dryrun.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           "all", "--shape", "all", "--mesh", "both", "--out", str(out)]
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)
    stdout, stderr = proc.stdout, proc.stderr
    seconds = time.perf_counter() - t0
    recs = json.loads(out.read_text()) if out.exists() else []
    counts = {k: sum(r["status"] == k for r in recs)
              for k in ("ok", "skipped", "error")}
    ok = proc.returncode == 0 and counts["error"] == 0 and \
        counts["ok"] == DRYRUN_PAIRS and counts["skipped"] == DRYRUN_SKIPPED
    done = re.search(r"== done: .* in ([0-9.]+)s", stdout or "")
    log("dryrun", card=card, cmd="python -m repro_torch.launch.dryrun "
        "--arch all --shape all --mesh both", returncode=proc.returncode,
        own_seconds=float(done[1]) if done else None,
        process_seconds=seconds, ok_pairs=counts["ok"],
        skipped_pairs=counts["skipped"], failed_pairs=counts["error"],
        last_line=stdout.strip().splitlines()[-2:] if stdout else [],
        pairs=[{k: r.get(k) for k in ("arch", "shape", "flops")} | {
            "analytic_flops": r["analytic"]["flops_global"],
            "dominant": r["analytic"]["terms"]["dominant"],
            "bound_s": r["analytic"]["terms"]["bound_s"],
            "collectives": r["collectives"],
            "analytic_coll_bytes_dev": r["analytic"]["coll_bytes_dev"],
            "counted_over_analytic": r["collectives"]["total"] /
            r["analytic"]["coll_bytes_dev"],
            "depths": r["collectives_counted"]["depths"],
            "collectives_s": r["collectives_counted"]["seconds"]}
            for r in recs if r["status"] == "ok" and r["mesh"] == "single"],
        errors=[{k: r.get(k) for k in ("arch", "shape", "mesh", "error")}
                for r in recs if r["status"] == "error"],
        stderr=stderr[-2000:] if not ok else "", ok=ok)
    if not ok:
        raise AssertionError(f"dry run: exit {proc.returncode}, {counts}")


def run_built_step(label, cfg, shape, built, call, abstract, mods, rf,
                   ana, card, reps=5):
    """One built step on the card: ``call`` once to warm up, then ``reps``
    times, each on the host clock up to a synchronise; the launches of the
    first timed run (the counts zeroed before it; no plain version may
    run); its analytic costs on the 1x1 mesh and their roofline on the
    card's constants, the bound's share of the measured median, and the
    FLOP counter's count (``roofline.step_flops`` over ``abstract``, the
    same step built on meta tensors) beside the analytic FLOPs.
    Returns (record, the last call's outputs)."""
    out = call()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, launches = [], {}
    for i in range(reps):
        out = None              # a train step's last outputs: 20 GB
        if i == 0:
            reset_counts(*mods)
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if i == 0:
            launches = {k: v for mod in mods for k, v in mod.LAUNCHES.items()
                        if v}
    if any(k.endswith("_ref") for k in launches):
        raise AssertionError(f"{label}: a plain version ran: {launches}")
    ms = 1e3 * sorted(times)[reps // 2]
    costs = ana.analytic_costs(cfg, shape, {"data": 1, "model": 1})
    terms = rf.roofline_terms(costs["flops_dev"], costs["bytes_dev"],
                              costs["coll_bytes_dev"], 1)
    counted = rf.step_flops(abstract.step_fn, *abstract.abstract_args)[0]
    rec = dict(step=label, model=cfg.name, description=built.description,
               batch=shape.global_batch, seq=shape.seq_len,
               ms=ms, ms_all=[1e3 * t for t in times], launches=launches,
               analytic_flops=costs["flops_global"],
               analytic_bytes=costs["bytes_dev"],
               dominant=terms["dominant"], bound_ms=1e3 * terms["bound_s"],
               bound_share=1e3 * terms["bound_s"] / ms,
               counted_flops=counted,
               counted_over_analytic=counted / costs["flops_global"],
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log("built_step", card=card, **rec, ok=True)
    return rec, out


def built_step_dtensor(label, built, mesh, args, plain_ids, plain_ms,
                       steps_lib, rf, card, reps=3):
    """Phase 5: a built step through the DTensor path
    (``steps.shard_args`` and ``steps.run_sharded``) on the same 1x1 NCCL
    mesh and inputs as its plain call: the collectives it issues
    (``roofline.collective_bytes``, none on one card; that call is also the
    warm-up), its median time over ``reps`` calls beside the plain call's,
    and its ids, which must equal the plain call's."""
    dargs = steps_lib.shard_args(built, mesh, args)
    got = {}

    def run(*a):
        got["out"] = steps_lib.run_sharded(built, mesh, *a)

    coll = rf.collective_bytes(run, *dargs)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        got.clear()
        t0 = time.perf_counter()
        run(*dargs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ids = got["out"][0].full_tensor()
    same = bool(torch.equal(ids, plain_ids))
    ms = 1e3 * sorted(times)[reps // 2]
    rec = dict(step=label, ms=ms, ms_all=[1e3 * t for t in times],
               plain_ms=plain_ms, over_plain=ms / plain_ms,
               collectives=coll, ids_equal=same)
    log("built_step_dtensor", card=card, **rec, ok=same and
        coll["count"] == 0)
    if not same:
        raise AssertionError(f"{label}: the DTensor path's ids differ from "
                             f"the plain call's")
    if coll["count"]:
        raise AssertionError(f"{label}: {coll} on a 1x1 mesh")
    del got, dargs
    return rec


def built_steps_llama(cfg, params, tfm, steps_lib, mesh_lib, rf, ana,
                      ShapeConfig, mods, card):
    """Phase 5: ``launch/steps.py``'s Llama3-8B prefill step (B 4 x S
    4096) and serve step (B 32 over a 4096-token cache, ~17 GB beside the
    16 GB of weights), each with 8 adapters of rank 16 and ``disagg``, on
    ``make_local_mesh()`` (the 1x1 mesh on the card), on the serving
    phase's weights (``run_built_step``).  The prefill's argmax ids must
    lie in the vocabulary; the serve step writes every row's new key.
    Each step then runs through the DTensor path on the same mesh and
    inputs (``built_step_dtensor``): the plain call's ids, no collective."""
    mesh = mesh_lib.make_local_mesh()
    lora8 = tfm.init_lora_stacks(cfg, 2, 8)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    ids8 = torch.arange(32, dtype=torch.int32, device="cuda") % 8
    recs = {}
    shape = ShapeConfig("prefill_4k", 4096, 4, "prefill")
    built = steps_lib.build_prefill_step(cfg, mesh, shape, disagg=True)
    tokens = torch.randint(0, cfg.vocab_size, (4, 4096), generator=gen,
                           device="cuda", dtype=torch.int32)
    args = (params, lora8, {"tokens": tokens}, ids8[:4])
    recs["prefill"], (ids, cache) = run_built_step(
        "prefill_step", cfg, shape, built, lambda: built.step_fn(*args),
        steps_lib.build_step(cfg, {"data": 1, "model": 1}, shape,
                             disagg=True),
        mods, rf, ana, card)
    if not bool(((ids >= 0) & (ids < cfg.vocab_size)).all()):
        raise AssertionError(f"prefill_step ids out of range: {ids}")
    del cache
    recs["prefill"]["dtensor"] = built_step_dtensor(
        "prefill_step", built, mesh, args, ids, recs["prefill"]["ms"],
        steps_lib, rf, card)
    torch.cuda.empty_cache()
    shape = ShapeConfig("decode_4k", 4096, 32, "decode")
    built = steps_lib.build_serve_step(cfg, mesh, shape, disagg=True)
    cache = tfm.init_cache(cfg, 32, 4096, disagg=True)
    for t in cache.values():
        t.normal_(0.0, 0.3, generator=gen)
    tok = torch.randint(0, cfg.vocab_size, (32,), generator=gen,
                        device="cuda", dtype=torch.int32)
    kv_len = torch.full((32,), 4095, dtype=torch.int32, device="cuda")
    args = (params, lora8, cache, tok, kv_len, ids8)
    recs["serve"], (ids, _) = run_built_step(
        "serve_step", cfg, shape, built, lambda: built.step_fn(*args),
        steps_lib.build_step(cfg, {"data": 1, "model": 1}, shape,
                             disagg=True),
        mods, rf, ana, card)
    if not bool(((ids >= 0) & (ids < cfg.vocab_size)).all()):
        raise AssertionError(f"serve_step ids out of range: {ids}")
    # every call writes the same key into the same slot, so the DTensor
    # path sees the cache the plain calls left
    recs["serve"]["dtensor"] = built_step_dtensor(
        "serve_step", built, mesh, args, ids, recs["serve"]["ms"],
        steps_lib, rf, card)
    del cache, lora8, args
    torch.cuda.empty_cache()
    return recs


def built_step_train(configs, registry, optimizer, steps_lib, mesh_lib, rf,
                     ana, ShapeConfig, mods, card):
    """Phase 5: ``launch/steps.py``'s internlm2-1.8b train step (B 16 x S
    512, ``accum_for``'s 16 microbatches, AdamW) on ``make_local_mesh()``
    (``run_built_step``), from random bf16 weights; the loss must be
    finite."""
    cfg = configs.get_config("internlm2-1.8b")
    mesh = mesh_lib.make_local_mesh()
    shape = ShapeConfig("train_512", 512, 16, "train")
    built = steps_lib.build_train_step(cfg, mesh, shape)
    params = registry.get_model(cfg).init_params(0)
    opt = optimizer.get_optimizer(cfg.optimizer)[0](params)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(22)
    batch = {k: torch.randint(0, cfg.vocab_size, (16, 512), generator=gen,
                              device="cuda", dtype=torch.int32)
             for k in ("tokens", "labels")}
    rec, (_, _, metrics) = run_built_step(
        "train_step", cfg, shape, built,
        lambda: built.step_fn(params, opt, batch),
        steps_lib.build_step(cfg, {"data": 1, "model": 1}, shape, accum=1),
        mods, rf, ana, card)
    if not bool(torch.isfinite(metrics["loss"])):
        raise AssertionError(f"train_step loss {metrics['loss']}")
    rec["loss"] = float(metrics["loss"])
    del params, opt
    torch.cuda.empty_cache()
    torch.distributed.destroy_process_group()      # make_local_mesh's
    return rec


# ------------------------------------------------ LoRA ranks above 64
# Ranks above 64 run the chunked instances (``csrc/rank_chunk.cuh``,
# counted as ``<counter>_rchunk``): #5, #1 and #2 with their int8 variants
# at Llama3-8B's heads (ranks 65, 128, 256), h2o-danube-3-4b's (128) and D
# 32's (65); #7 and #8 at D 128 and D 256 (G 16), ranks 65, 128 and 256,
# and at D 120 (128); f32 and bf16, windows 0 and 300, on the fixed rows;
# the f32 scalar kernel at D 256 with a group of 32 heads at rank 64 (its
# chunked instance: the unchunked layout cannot hold 32 rows there); then
# the bf16 cases at D 128, window 0, timed at ranks 64, 128 and 256
RCHUNK_RANKS = (65, 128, 256)
RCHUNK_GEOMS = [("D 128", LLAMA_GEOM, RCHUNK_RANKS),
                ("D 120", DANUBE_GEOM, (128,)),
                ("D 32", D32_GEOMS["D 32 G 4"], (65,))]
RCHUNK_DENSE = [("D 128", (32, 8, 128), RCHUNK_RANKS),
                ("D 256", (16, 1, 256), RCHUNK_RANKS),
                ("D 120", (32, 8, D120), (128,))]
# The chunked prefills at the edges of their clusters of q tiles (4 tiles
# of 128 rows; ``residual_attention.chunk_prefill_map``), bf16 (f32 runs
# the scalar kernels), windows 0 and 300: #5 and #1 with bf16 and int8
# pages on 200-position rows (7 tiles at G 4: a cluster with a padding
# CTA), #1 with a q_len 0 row, rows past q_len and tiles of a cluster with
# no row below q_len, #5 with kv_len 0, 1 and 17 rows, at Llama3-8B's heads
# (ranks 65 and 128), h2o-danube-3-4b's (128) and D 32's (65); #7 on one
# tile (three padding CTAs), three tiles from an offset, 33 tiles, a
# non-causal case, and at D 256 (5 tiles of 8 positions), D 32 and D 120
RCHUNK_EDGE_ROWS = {
    "paged_residual_attention_mixed": dict(
        start=[0, 0, 0, 16, 40, 1000], qlen=[0, 1, 17, 1, 17, 200], sq=200,
        width=128),
    "paged_residual_attention_prefill": dict(
        start=[0, 0, 9, 1000], qlen=[0, 1, 8, 200], sq=200, width=128),
}
RCHUNK_EDGES = [("D 128", LLAMA_GEOM, (65, 128)),
                ("D 120", DANUBE_GEOM, (128,)),
                ("D 32", D32_GEOMS["D 32 G 4"], (65,))]
# (label, heads with rank, sq, sk, start, kv_len, causal)
RCHUNK_DENSE_EDGES = [
    ("1 tile", (32, 8, 128, 128), 20, 20, [0, 0], None, True),
    ("3 tiles from 230", (32, 8, 128, 65), 70, 300, [230, 100], [300, 170],
     True),
    ("3 tiles, not causal", (32, 8, 128, 128), 70, 300, [230, 100],
     [300, 170], False),
    ("33 tiles", (32, 8, 128, 128), 1040, 1040, [0], None, True),
    ("D 256 5 tiles", (16, 1, 256, 128), 36, 300, [264, 0], [300, 36],
     True),
    ("D 32 3 tiles", (8, 2, 32, 65), 70, 100, [30, 0], [100, 70], True),
    ("D 120 3 tiles", (32, 8, D120, 128), 70, 100, [30, 0], [100, 70],
     True),
]
# bf16 ms per launch before the redesigns of the chunked prefills and
# decodes, on the timed cases (rank 64: the RP 64 instances; ranks 128 and
# 256: the first chunked instances, K and V rebuilt per key block; NVIDIA
# H100 80GB HBM3, 700 W; PERF.md names the runs)
RCHUNK_WAS_MS = {
    "paged_residual_attention_mixed": {64: 0.2818, 128: 0.6911, 256: 1.2665},
    "paged_residual_attention_decode": {64: 0.0682, 128: 0.2737,
                                        256: 0.4997},
    "paged_residual_attention_prefill": {64: 0.2780, 128: 0.7095,
                                         256: 1.2862},
    "residual_attention_prefill": {64: 0.3430, 128: 0.8434, 256: 1.5142},
    "residual_attention_decode": {64: 0.0633, 128: 0.2453, 256: 0.4326},
}


def check_rchunk_edges(pra, ref, ra, quantize):
    """The chunked prefills at ``RCHUNK_EDGES``/``RCHUNK_EDGE_ROWS`` and
    ``RCHUNK_DENSE_EDGES``, bf16, windows 0 and 300, each against its plain
    version and naming the chunked instance; returns the cases run."""
    n = 0
    for (glabel, geom, ranks), window, quant in itertools.product(
            RCHUNK_EDGES, (0, 300), (False, True)):
        for r, (entry, rows) in itertools.product(ranks,
                                                  RCHUNK_EDGE_ROWS.items()):
            name = entry + ("_int8" if quant else "")
            c = make_case(KERNELS[entry][0], torch.bfloat16, window,
                          seed=41 + r, quantize=quantize if quant else None,
                          geom=dict(geom, r=r), **rows)
            rec = compare(pra, ref, name, c, BF16_RTOL,
                          f"cluster edge rank {r} {glabel}")
            if not rec["ran"].endswith("_rchunk"):
                raise AssertionError(f"{name} rank {r}: ran {rec['ran']}")
            log("kernel_rchunk_edge", **rec, rank=r, ok=True)
            n += 1
            del c
    for (i, (label, heads, sq, sk, start, kvl, causal)), window in \
            itertools.product(enumerate(RCHUNK_DENSE_EDGES), (0, 300)):
        c = make_dense_case(label, heads, sq, sk, start, kvl,
                            dtype=torch.bfloat16, window=window,
                            seed=360 + i)
        c["causal"] = causal
        rec = compare_dense(ra, ref, c, BF16_RTOL)
        if rec["ran"] != "residual_attention_prefill_mma_rchunk":
            raise AssertionError(f"{label}: ran {rec['ran']}")
        log("dense_kernel_rchunk_edge", **rec, rank=heads[3], ok=True)
        n += 1
        del c
    torch.cuda.empty_cache()
    return n


# The chunked decodes at the edges of their rank route (``DecodePipe`` in
# csrc/rank_chunk.cuh), bf16, windows 0 and 300: rows at kv_len 0, 1, 17,
# 64, 65 and 2128 (several CTAs per row: share and block boundaries) and
# at 0, 1, 17 and 64 over a table of 64 keys (one CTA per row; #8's
# one-range epilogue, no combine), #2 with bf16 and int8 pages at
# Llama3-8B's, h2o-danube-3-4b's and D 32's heads and at D 64 with a
# group of 16, #8 at D 128, 256, 120, 32 and at D 64 with a group of 32
# (two head tiles), ranks 65, 128 and 256, and 512 (above the route: the
# rebuild instance) at D 128.  A row at kv_len 0 must come back exactly 0
# (the plain versions average V there; not compared).
RDECODE_KV = {"several CTAs": [0, 1, 17, 64, 65, 2128],
              "one CTA": [0, 1, 17, 64]}
RDECODE_PAGED = [("D 128", LLAMA_GEOM, (65, 128, 256, 512)),
                 ("D 120", DANUBE_GEOM, (65, 128, 256)),
                 ("D 32", D32_GEOMS["D 32 G 4"], (65, 128, 256)),
                 ("D 64 G 16", dict(hq=32, hkv=2, d=64, r=16, page=16),
                  (65, 128, 256))]
RDECODE_DENSE = [("D 128", (32, 8, 128), (65, 128, 256, 512)),
                 ("D 256", (16, 1, 256), (65, 128, 256)),
                 ("D 120", (32, 8, D120), (65, 128, 256)),
                 ("D 32", (8, 2, 32), (65, 128, 256)),
                 ("D 64 G 32", (32, 1, 64), (65, 128, 256))]


def check_rchunk_decode_edges(pra, ref, ra, quantize):
    """The chunked decodes at ``RDECODE_KV`` (``RDECODE_PAGED``,
    ``RDECODE_DENSE``), bf16, windows 0 and 300, each against its plain
    version and naming the ``_splitk_rchunk`` instance that ran (with the
    plan's n_split); returns the cases run."""
    n = 0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for (glabel, geom, ranks), (rows, kvl), window, quant in \
            itertools.product(RDECODE_PAGED, RDECODE_KV.items(), (0, 300),
                              (False, True)):
        width = -(-max(kvl) // geom["page"])
        for r in ranks:
            name = "paged_residual_attention_decode" + (
                "_int8" if quant else "")
            c = make_case("decode", torch.bfloat16, window, seed=400 + r,
                          quantize=quantize if quant else None,
                          geom=dict(geom, r=r),
                          start=[max(k - 1, 0) for k in kvl],
                          qlen=[int(k > 0) for k in kvl], sq=1, width=width)
            rec = compare(pra, ref, name, c, BF16_RTOL,
                          f"decode edge {rows} rank {r} {glabel}")
            if not rec["ran"].endswith("_splitk_rchunk"):
                raise AssertionError(f"{name} rank {r}: ran {rec['ran']}")
            rec["n_split"] = pra.res_split_plan(
                len(kvl), geom["hq"], geom["hkv"], geom["d"], r, width,
                geom["page"], quant, sms)["n_split"]
            log("kernel_rchunk_decode_edge", **rec, rank=r, ok=True)
            n += 1
            del c
    for (hl, heads, ranks), (rows, kvl), window in itertools.product(
            RDECODE_DENSE, RDECODE_KV.items(), (0, 300)):
        for r in ranks:
            c = make_dense_case(f"decode edge {rows} {hl} R {r}",
                                heads + (r,), 1, max(kvl),
                                [max(k - 1, 0) for k in kvl], kvl,
                                dtype=torch.bfloat16, window=window,
                                seed=420 + r)
            rec = compare_dense(ra, ref, c, BF16_RTOL)
            if not rec["ran"].endswith("_splitk_rchunk"):
                raise AssertionError(f"{c['label']}: ran {rec['ran']}")
            rec["n_split"] = ra.decode_split_plan(
                len(kvl), heads[0], heads[1], heads[2], r, max(kvl), window,
                sms)["n_split"]
            log("dense_kernel_rchunk_decode_edge", **rec, rank=r, ok=True)
            n += 1
            del c
    torch.cuda.empty_cache()
    return n


def check_rank_chunks(pra, ref, ra, quantize):
    """Phase 3, LoRA ranks above 64 (``RCHUNK_GEOMS``, ``RCHUNK_DENSE``),
    each kernel against its plain version and naming the chunked instance
    that ran; the f32 scalar kernel at D 256, G 32, rank 64; the timed bf16
    cases at D 128 at ranks 64, 128 and 256.  Returns the timed records."""
    n = 0
    for (glabel, geom, ranks), (dtype, tol), window, quant in \
            itertools.product(RCHUNK_GEOMS, DTYPES, (0, 300), (False, True)):
        for r in ranks:
            g = dict(geom, r=r)
            cases = {k: make_case(k, dtype, window, seed=91 + r,
                                  quantize=quantize if quant else None,
                                  geom=g, **FIXED[k]) for k in FIXED}
            for entry in RANK64_PAGED:
                name = entry + ("_int8" if quant else "")
                rec = compare(pra, ref, name, cases[KERNELS[entry][0]], tol,
                              f"rank {r} {glabel}")
                if not rec["ran"].endswith("_rchunk"):
                    raise AssertionError(f"{name} rank {r}: ran "
                                         f"{rec['ran']}, not a chunked "
                                         f"instance")
                log("kernel_rchunk", **rec, rank=r, ok=True)
                n += 1
            del cases
            torch.cuda.empty_cache()
    dense = [(f"{hl} R {r} {label}", heads + (r,), *rest)
             for hl, heads, ranks in RCHUNK_DENSE for r in ranks
             for label, *rest in RANK64_DENSE_ROWS]
    for (i, case), (dtype, tol), window in itertools.product(
            enumerate(dense), DTYPES, (0, 300)):
        c = make_dense_case(*case, dtype=dtype, window=window, seed=300 + i)
        rec = compare_dense(ra, ref, c, tol)
        if not rec["ran"].endswith("_rchunk"):
            raise AssertionError(f"{case[0]}: ran {rec['ran']}, not a "
                                 f"chunked instance")
        log("dense_kernel_rchunk", **rec, rank=case[1][3], ok=True)
        n += 1
        del c
    # a group of 32 heads at D 256 and rank 64 in f32 (refused before)
    for i, (label, *rest) in enumerate(RANK64_DENSE_ROWS):
        c = make_dense_case(f"D 256 G 32 R 64 {label}", (32, 1, 256, 64),
                            *rest, dtype=torch.float32, window=0,
                            seed=330 + i)
        rec = compare_dense(ra, ref, c, F32_TOL)
        if rec["ran"] != ("residual_attention_decode_rchunk" if c["decode"]
                          else "residual_attention_prefill_rchunk"):
            raise AssertionError(f"{label}: ran {rec['ran']}")
        rec["rows_per_cta"] = ra.tile_rows(256, 32, 64)
        log("dense_kernel_g32", **rec, ok=True)
        n += 1
        del c
    torch.cuda.empty_cache()
    n += check_rchunk_edges(pra, ref, ra, quantize)
    n += check_rchunk_decode_edges(pra, ref, ra, quantize)
    timed = []
    for r in (64,) + RCHUNK_RANKS[1:]:
        g = dict(LLAMA_GEOM, r=r)
        for entry in RANK64_PAGED:
            kind = KERNELS[entry][0]
            c = make_case(kind, torch.bfloat16, 0, seed=71, geom=g,
                          **FIXED[kind])
            rec = compare(pra, ref, entry, c, BF16_RTOL, f"rank {r} timed")
            timed.append(dict(measure(pra, ref, entry, c, rec), rank=r))
            del c
        for i, (label, *rest) in enumerate(RANK64_TIMED):
            c = make_dense_case(f"D 128 R {r} {label}", (32, 8, 128, r),
                                *rest, dtype=torch.bfloat16, window=0,
                                seed=80 + i)
            rec = compare_dense(ra, ref, c, BF16_RTOL)
            timed.append(dict(measure_dense(ra, ref, c, rec), rank=r))
            del c
        torch.cuda.empty_cache()
    for rec in timed:
        rec["was_ms"] = RCHUNK_WAS_MS[rec["kernel"]][rec["rank"]]
        rec["x_sdpa"] = rec["kernel_ms"] / rec["library_ms"]
    log("rchunk_checked", cases=n, ok=True)
    return timed


# ------------------------------------------------ RG-LRU scan backward
# the Pallas package has no backward kernel: in training the reference
# differentiates its associative scan (``_rglru_scan``) with jax.grad
SCAN_BWD_REPLACES = "src/repro/models/hybrid.py:105"
SCAN_BWD_F32_RTOL = 1e-5    # f32: a share of the plain version's max
                            # |value| (one FMA per step against a multiply
                            # and an add)
# tests/test_kernels.py's shapes, S 1, and RecurrentGemma-9B's width (B 4,
# S 1000, W 4096; timed)
SCAN_BWD_FIXED = SCAN_FIXED[:3] + [("RecurrentGemma-9B B4 S1000 W4096", 4,
                                    1000, 4096)]


def make_scan_bwd_case(ref, label, bsz, s, w, dtype, seed):
    """A scan case (``make_scan_case``, h0 non-zero) with the forward's
    states from the plain version and random gradients of both outputs."""
    c = make_scan_case(label, bsz, s, w, dtype, seed)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 1)
    c["states"] = ref.rg_lru_scan_ref(c["a"], c["b"], c["h0"])[0]
    c["dstates"] = torch.randn((bsz, s, w), generator=gen,
                               device="cuda").to(dtype)
    c["dh_last"] = torch.randn((bsz, w), generator=gen,
                               device="cuda").to(dtype)
    return c


def _bwd_args(c):
    return (c["a"], c["states"], c["h0"], c["dstates"], c["dh_last"])


def compare_scan_bwd(rg, ref, c):
    """The backward kernel against ``rg_lru_scan_bwd_ref`` on ``c``: da,
    db and dh0 each within ``SCAN_BWD_F32_RTOL`` (f32) or ``BF16_RTOL``
    (bf16) of the plain version's max |value|.  Returns the record."""
    before = dict(rg.LAUNCHES)
    got = rg.rg_lru_scan_bwd(*_bwd_args(c))
    if launched(rg, before) != {"rg_lru_scan_bwd": 1}:
        raise AssertionError(f"rg_lru_scan_bwd {c['label']}: ran "
                             f"{launched(rg, before)}")
    want = ref.rg_lru_scan_bwd_ref(*_bwd_args(c))
    torch.cuda.synchronize()
    rtol = BF16_RTOL if c["dtype"] == torch.bfloat16 else SCAN_BWD_F32_RTOL
    rec = dict(kernel="rg_lru_scan_bwd", dtype=str(c["dtype"]).split(".")[1],
               case=c["label"], shape=list(c["a"].shape), rtol=rtol)
    err = 0.0
    for name, g, w in zip(("da", "db", "dh0"), got, want):
        if not torch.isfinite(g).all():
            raise AssertionError(f"rg_lru_scan_bwd {c['label']}: "
                                 f"non-finite {name}")
        e = (g.float() - w.float()).abs().max().item()
        m = w.float().abs().max().item()
        rec[f"{name}_err"], rec[f"{name}_max"] = e, m
        err = max(err, e)
        if e > rtol * m:
            log("scan_bwd_kernel", **rec, ok=False)
            raise AssertionError(f"rg_lru_scan_bwd {c['label']} "
                                 f"{c['dtype']}: {name} err {e} > {rtol} * "
                                 f"{m}")
    rec["max_abs_err"] = err
    return rec


def scan_bwd_work(c):
    """Bytes and operations of the backward on these inputs: a, the states
    and their gradient read once, h0 and dh_last read, da and db written
    once, dh0 written (``rg_lru_scan_bwd``'s arguments and outputs); an add, a multiply and an FMA (4 operations, f32 on
    the CUDA cores) per element.  b is not an input: h_{t-1} comes from the
    states."""
    esize = c["a"].element_size()
    bsz, s, w = c["a"].shape
    nbytes = 5 * bsz * s * w * esize + 3 * bsz * w * esize
    ops = 4 * bsz * s * w
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = ops / PEAK[torch.float32] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def measure_scan_bwd(rg, ref, c, rec):
    """Adds the kernel's and the plain version's times and the bound (no
    PyTorch call computes the reverse recurrence: no library time)."""
    args = _bwd_args(c)
    rec["kernel_ms"] = time_ms(lambda: rg.rg_lru_scan_bwd(*args))
    rec["plain_ms"] = time_ms(lambda: ref.rg_lru_scan_bwd_ref(*args),
                              reps=3, warmup=1)
    rec["library_ms"] = None
    (rec["bound_ms"], rec["bound_by"], rec["bytes"],
     rec["ops"]) = scan_bwd_work(c)
    return rec


def check_scan_bwd_kernels(rg, ref):
    """Phase 3, the scan's backward: the kernel against its plain version
    at ``SCAN_BWD_FIXED``, f32 and bf16, h0 and dh_last non-zero; the
    RecurrentGemma-9B case timed.  Returns its f32 record."""
    out = None
    for dtype in (torch.float32, torch.bfloat16):
        for i, case in enumerate(SCAN_BWD_FIXED):
            c = make_scan_bwd_case(ref, *case, dtype=dtype, seed=90 + i)
            rec = compare_scan_bwd(rg, ref, c)
            if case[0].startswith("RecurrentGemma"):
                measure_scan_bwd(rg, ref, c, rec)
                if dtype == torch.float32:
                    out = rec
            log("scan_bwd_kernel", **rec, ok=True)
            del c
    torch.cuda.empty_cache()
    return out


def check_grad_guard(ra):
    """Phase 3: the dense prefill (#7) on an input that requires grad,
    with grad mode on, must raise (it has no backward, as the Pallas
    kernel has none), naming the kernel; under ``torch.no_grad`` the same
    call launches."""
    c = make_dense_case("guard", (32, 8, 128, 16), 37, 97, [3, 60],
                        [40, 97], dtype=torch.bfloat16, window=0, seed=99)
    c["q"].requires_grad_(True)
    before = dict(ra.LAUNCHES)
    try:
        dense_kernel_call(ra, c)()
    except RuntimeError as e:
        if "residual_attention_prefill" not in str(e):
            raise
        msg = str(e)
    else:
        raise AssertionError("#7 took an input that requires grad")
    if launched(ra, before):
        raise AssertionError("the refused call launched")
    with torch.no_grad():
        dense_kernel_call(ra, c)()
    log("grad_guard", kernel="residual_attention_prefill", raised=msg,
        no_grad_launches=launched(ra, before), ok=True)


# f32 logits, held as tests/test_models.py holds the reference's
MODEL_TOL = dict(rtol=3e-4, atol=5e-4)


def logit_gap(got, want):
    """Max abs error, max |want| and whether every element is within
    ``MODEL_TOL`` (|got - want| <= atol + rtol |want|), taken row by row to
    bound the memory; raises on a non-finite value."""
    err = ref_max = 0.0
    excess = -float("inf")
    for g, w in zip(got, want):
        if not (torch.isfinite(g).all() and torch.isfinite(w).all()):
            raise AssertionError("non-finite logits")
        d = (g.float() - w.float()).abs()
        wa = w.float().abs()
        err = max(err, d.max().item())
        ref_max = max(ref_max, wa.max().item())
        excess = max(excess, (d - MODEL_TOL["rtol"] * wa).max().item())
    return dict(max_abs_err=err, ref_max_abs=ref_max,
                within_model_tol=excess <= MODEL_TOL["atol"])


def expect_launches(mods, want):
    """The run just made (counts zeroed before it) launched exactly
    ``want``: every other counter of ``mods`` (the kernel wrappers and the
    plain versions) stayed at 0."""
    counts = {k: v for m in mods for k, v in m.LAUNCHES.items()}
    if counts != {**dict.fromkeys(counts, 0), **want}:
        raise AssertionError(f"launches {counts} != {want}")
    return dict(want)


def tree_map(fn, tree):
    """``fn`` on every tensor of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def greedy(tfm, cfg, params, tokens, n_new, prompt_len, max_len, **kw):
    """``prefill`` of ``prompt_len`` tokens, then greedy ``decode_step`` s
    up to ``n_new`` tokens; returns them (B, n_new)."""
    dev = tokens.device
    cache = tfm.init_cache(cfg, tokens.shape[0], max_len,
                           disagg=kw.get("disagg", False), device=dev)
    lg, cache = tfm.prefill(params, tokens[:, :prompt_len], cache, cfg, **kw)
    out = [lg[:, 0].argmax(-1)]
    kv_len = torch.full((tokens.shape[0],), prompt_len, dtype=torch.int32,
                        device=dev)
    for _ in range(n_new - 1):
        lg, cache = tfm.decode_step(params, out[-1], cache, kv_len, cfg, **kw)
        out.append(lg.argmax(-1))
        kv_len = kv_len + 1
    return torch.stack(out, 1)


def small_dense_card_vs_cpu(tiny, tfm, mods):
    """Phase 4, dense: the small f32 model's ``forward(disagg=True)`` on
    the card (the dense prefill kernel, once per layer) within 1e-4 of the
    CPU's (the plain version), and greedy tokens from ``prefill`` +
    ``decode_step`` equal on card and CPU."""
    cfg = tiny(rank=16, num_layers=2, d_model=256, num_heads=4,
               num_kv_heads=2, vocab_size=512)
    params = tfm.init_params(cfg, 0, device="cpu")
    lora = tfm.init_lora_stacks(cfg, 1, 4, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (4, 40)))
    out = {}
    for dev in ("cuda", "cpu"):
        p, lo = (tree_map(lambda t: t.to(dev), x) for x in (params, lora))
        kw = dict(lora=lo, adapter_ids=torch.arange(4, device=dev),
                  disagg=True)
        reset_counts(*mods)
        logits = tfm.forward(p, tokens.to(dev), cfg, **kw)
        if dev == "cuda":
            torch.cuda.synchronize()
            expect_launches(mods,
                            {"residual_attention_prefill": cfg.num_layers})
        toks = greedy(tfm, cfg, p, tokens.to(dev), 12, 24, 64, **kw)
        out[dev] = (logits.cpu(), toks.cpu())
    err = (out["cuda"][0] - out["cpu"][0]).abs().max().item()
    if err > F32_TOL:
        raise AssertionError(f"dense forward card vs CPU: {err} > {F32_TOL}")
    if not torch.equal(out["cuda"][1], out["cpu"][1]):
        raise AssertionError(f"dense greedy tokens: card "
                             f"{out['cuda'][1].tolist()} != CPU "
                             f"{out['cpu'][1].tolist()}")
    # the same over int8 caches (quantized writes, dequantized reads)
    cfg8 = dataclasses.replace(cfg, kv_quant="int8")
    toks8 = {}
    for dev in ("cuda", "cpu"):
        p, lo = (tree_map(lambda t: t.to(dev), x) for x in (params, lora))
        toks8[dev] = greedy(tfm, cfg8, p, tokens.to(dev), 12, 24, 64,
                            lora=lo, adapter_ids=torch.arange(4, device=dev),
                            disagg=True).cpu()
    if not torch.equal(toks8["cuda"], toks8["cpu"]):
        raise AssertionError(f"int8-cache greedy tokens: card "
                             f"{toks8['cuda'].tolist()} != CPU "
                             f"{toks8['cpu'].tolist()}")
    log("small_dense", forward_max_abs_err=err, limit=F32_TOL,
        tokens=out["cuda"][1].tolist(), int8_cache_tokens=toks8[
            "cuda"].tolist(), ok=True)


def small_hybrid_card_vs_cpu(hybrid, rg9b, mods):
    """Phase 4, hybrid: a 6-layer f32 hybrid at head_dim 256 (4 RG-LRU
    layers, 2 local-attention layers of window 16).  ``forward(disagg=True)``
    on the card (the dense prefill kernel at D 256 once per local layer,
    the scan kernel once per RG-LRU layer) must agree with the CPU's (the
    plain versions) within ``MODEL_TOL``, and greedy tokens from ``prefill``
    of 24 tokens (the 16-slot ring wraps) + ``decode_step`` must be equal
    on card and CPU."""
    cfg = dataclasses.replace(
        rg9b, name="hybrid-small", num_layers=6, d_model=256, num_heads=2,
        num_kv_heads=1, head_dim=256, d_ff=512, vocab_size=512,
        local_window=16, lru_width=256, dtype="float32", remat=False)
    n_local = hybrid.num_attention_layers(cfg)
    params = hybrid.init_params(cfg, 0, device="cpu")
    lora = hybrid.init_lora_stacks(cfg, 1, 4, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (4, 40)))
    out = {}
    for dev in ("cuda", "cpu"):
        p, lo = (tree_map(lambda t: t.to(dev), x) for x in (params, lora))
        kw = dict(lora=lo, adapter_ids=torch.arange(4, device=dev),
                  disagg=True)
        reset_counts(*mods)
        logits = hybrid.forward(p, tokens.to(dev), cfg, **kw)
        if dev == "cuda":
            torch.cuda.synchronize()
            expect_launches(mods, {
                "residual_attention_prefill": n_local,
                "rg_lru_scan": cfg.num_layers - n_local})
        toks = greedy(hybrid, cfg, p, tokens.to(dev), 12, 24, 64, **kw)
        out[dev] = (logits.cpu(), toks.cpu())
    gap = logit_gap(out["cuda"][0], out["cpu"][0])
    if not gap["within_model_tol"]:
        raise AssertionError(f"hybrid forward card vs CPU: {gap}")
    if not torch.equal(out["cuda"][1], out["cpu"][1]):
        raise AssertionError(f"hybrid greedy tokens: card "
                             f"{out['cuda'][1].tolist()} != CPU "
                             f"{out['cpu'][1].tolist()}")
    log("small_hybrid", **gap, tol=MODEL_TOL,
        tokens=out["cuda"][1].tolist(), ok=True)


def prefill_decode(mod, cfg, params, tokens, prompt, steps, max_len, kw):
    """``prefill`` of ``prompt`` tokens into a ``max_len``-slot cache, then
    ``steps`` teacher-forced ``decode_step`` s; returns (logits at positions
    prompt-1 .. prompt+steps-1 (B, steps+1, V), times in ms)."""
    bsz = tokens.shape[0]
    cache = mod.init_cache(cfg, bsz, max_len, disagg=True)
    t0 = time.perf_counter()
    lg, cache = mod.prefill(params, tokens[:, :prompt], cache, cfg,
                            disagg=True, **kw)
    torch.cuda.synchronize()
    ms = {"prefill_ms": (time.perf_counter() - t0) * 1e3}
    logits = [lg[:, 0]]
    kv_len = torch.full((bsz,), prompt, dtype=torch.int32, device="cuda")
    t0 = time.perf_counter()
    for t in range(prompt, prompt + steps):
        lg, cache = mod.decode_step(params, tokens[:, t], cache, kv_len, cfg,
                                    disagg=True, **kw)
        logits.append(lg)
        kv_len = kv_len + 1
    torch.cuda.synchronize()
    ms["decode_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / steps
    return torch.stack(logits, 1), ms


def dense_prefill(cfg):
    """The dense prefill kernel, by its launch counter, that a model in
    ``cfg.dtype`` runs: the tensor-core kernel in bf16, the scalar kernel
    in f32."""
    from repro_torch.kernels import residual_attention as ra
    return ra.prefill_kernel(cfg.activation_dtype)


def dense_decode(cfg):
    """The dense decode kernel, by its launch counter, that a model in
    ``cfg.dtype`` runs: the split-K decode in bf16, the scalar kernel in
    f32."""
    from repro_torch.kernels import residual_attention as ra
    return ra.decode_kernel(cfg.activation_dtype)


def dense_api(tfm, cfg, params, lora, tokens, counted, prompt, steps):
    """The dense model API on ``tokens`` (B x S) over adapters 0..B-1:
    ``forward`` disaggregated (the prefill kernel once per layer) and
    unified, ``forward`` on the first token (the decode kernel once per
    layer), and ``prefill`` of ``prompt`` tokens then ``steps``
    ``decode_step`` s over a 1024-slot cache.  The prefill kernel is the
    tensor-core one in bf16 and the scalar one in f32 (``dense_prefill``),
    the decode kernel the split-K one in bf16 and the scalar one in f32
    (``dense_decode``).
    ``counted(fn, want)`` runs
    ``fn`` with the counts zeroed just before it and checks them just
    after.  Returns (logits, times in ms)."""
    bsz, n = tokens.shape[0], cfg.num_layers
    kw = dict(lora=lora, adapter_ids=torch.arange(bsz, device="cuda"))
    out, ms = {}, {}
    out["forward"], ms["forward_ms"] = counted(
        lambda: tfm.forward(params, tokens, cfg, disagg=True, **kw),
        {dense_prefill(cfg): n})
    out["unified"] = tfm.forward(params, tokens, cfg, **kw)
    out["s1"], ms["forward_s1_ms"] = counted(
        lambda: tfm.forward(params, tokens[:, :1], cfg, disagg=True, **kw),
        {dense_decode(cfg): n})
    out["cache"], times = prefill_decode(tfm, cfg, params, tokens, prompt,
                                         steps, 1024, kw)
    ms.update(times)
    return out, ms


def dense_gaps(out, prompt, steps):
    """Disaggregated vs unified ``forward``, ``forward`` at S 1 vs
    position 0, and prefill/decode vs ``forward`` at the same positions."""
    fwd = out["forward"]
    return {"disagg_vs_unified": logit_gap(fwd, out["unified"]),
            "s1_vs_forward": logit_gap(out["s1"][:, 0], fwd[:, 0]),
            "cache_vs_forward": logit_gap(
                out["cache"], fwd[:, prompt - 1:prompt + steps])}


def profile_decode(tfm, cfg, params, lora, tokens, prompt, max_len=1024):
    """Where a bf16 ``decode_step`` spends its time: after a prefill of
    ``prompt`` tokens into a ``max_len``-slot cache and two warm-up steps,
    three steps on the host clock,
    then the same three under ``torch.profiler``, whose kernel events give
    the device's busy time and the launches per step.  Idle share = 1 -
    busy / host time of the unprofiled steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    bsz = tokens.shape[0]
    kw = dict(lora=lora, adapter_ids=torch.arange(bsz, device="cuda"),
              disagg=True)
    cache = tfm.init_cache(cfg, bsz, max_len, disagg=True)
    _, cache = tfm.prefill(params, tokens[:, :prompt], cache, cfg, **kw)

    def steps(first, n):
        nonlocal cache
        kv_len = torch.full((bsz,), first, dtype=torch.int32, device="cuda")
        for t in range(first, first + n):
            _, cache = tfm.decode_step(params, tokens[:, t], cache, kv_len,
                                       cfg, **kw)
            kv_len = kv_len + 1
        torch.cuda.synchronize()

    steps(prompt, 2)
    t0 = time.perf_counter()
    steps(prompt + 2, 3)
    host_ms = (time.perf_counter() - t0) * 1e3 / 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps(prompt + 2, 3)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise AssertionError("the profiler recorded no device kernel")
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / 3
    del cache
    torch.cuda.empty_cache()
    return dict(host_ms_per_step=host_ms, device_busy_ms_per_step=busy_ms,
                kernels_per_step=len(kernels) / 3,
                device_idle_share=1 - busy_ms / host_ms)


def llama_dense(cfg, params, lora, tfm, mods, first):
    """Phase 5, dense: Llama3-8B's model API on 4 rows x 1000 tokens over
    adapters 0-3, first on the bf16 weights (the main path: launches
    counted, times taken, logits compared and logged), then on f32 copies
    of the same weights, where the logits must agree within
    ``MODEL_TOL``.  In bf16 they cannot be held to the bf16 rule: through
    32 layers of random weights, rounding differences grow as large as
    the move of the unified logits when the embedding is one ulp off,
    which is logged beside them as bf16's own floor.  So bf16 is held to
    the rule at the kernels (phase 6), and the model in f32.  The bf16
    run also profiles a decode step.  Returns the dense kernels' launches
    of the bf16 run."""
    bsz, seq, prompt, steps = 4, 1000, 600, 16
    tokens = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab_size, (bsz, seq))).cuda()
    launches = {}

    def counted(fn, want, tally=None):
        reset_counts(*mods)
        t0 = time.perf_counter()
        with first:
            out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        for k, v in expect_launches(mods, want).items():
            if tally is not None:
                tally[k] = tally.get(k, 0) + v
        return out, ms

    out, ms = dense_api(tfm, cfg, params, lora, tokens,
                        lambda fn, want: counted(fn, want, launches),
                        prompt, steps)
    gaps = dense_gaps(out, prompt, steps)
    # bf16's own floor: the unified forward with the embedding one ulp off
    nudged = dict(params, embed=params["embed"].clone())
    nudged["embed"].view(torch.int16).add_(1)
    gaps["one_ulp_embed_vs_unified"] = logit_gap(tfm.forward(
        nudged, tokens, cfg, lora=lora,
        adapter_ids=torch.arange(bsz, device="cuda")), out["unified"])
    del out, nudged
    torch.cuda.empty_cache()
    log("llama_dense", model=cfg.name, dtype="bfloat16", batch=bsz, seq=seq,
        prefill_tokens=prompt, decode_steps=steps, **ms, **gaps,
        launches=launches, decode_profile=profile_decode(
            tfm, cfg, params, lora, tokens[:, :prompt + 5], prompt),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30, ok=True)

    f32 = lambda t: tree_map(lambda x: x.float(), t)  # noqa: E731
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    out, ms = dense_api(tfm, cfg32, f32(params), f32(lora), tokens, counted,
                        prompt, steps)
    gaps = dense_gaps(out, prompt, steps)
    log("llama_dense", model=cfg.name, dtype="float32", **ms, **gaps,
        tol=MODEL_TOL, ok=all(g["within_model_tol"] for g in gaps.values()))
    for what, g in gaps.items():
        if not g["within_model_tol"]:
            raise AssertionError(f"f32 {what}: {g} not within {MODEL_TOL}")
    del out
    torch.cuda.empty_cache()
    return launches


def hybrid_api(hybrid, cfg, params, lora, tokens, counted, fwd_len, prompt,
               steps, max_len, floor):
    """The hybrid model API over adapters 0..B-1: ``forward`` on
    ``fwd_len`` tokens disaggregated (the dense prefill kernel once per
    local layer, the scan kernel once per RG-LRU layer) and unified,
    ``forward`` on the first token (the dense decode kernel and the scan
    kernel), then ``prefill`` of ``prompt`` tokens into a ``max_len``-slot
    cache and ``steps`` ``decode_step`` s (the scan kernel once per RG-LRU
    layer, in the prefill), held against a disaggregated ``forward`` over
    ``prompt + steps`` tokens.  ``floor`` adds the unified logits with the
    embedding one ulp off.  Each gap is taken as soon as both sides exist,
    and the logits are dropped.  Returns (gaps, times in ms)."""
    bsz = tokens.shape[0]
    n_local = hybrid.num_attention_layers(cfg)
    n_rec = cfg.num_layers - n_local
    kw = dict(lora=lora, adapter_ids=torch.arange(bsz, device="cuda"))
    x = tokens[:, :fwd_len]
    ms, gaps = {}, {}
    fwd, ms["forward_ms"] = counted(
        lambda: hybrid.forward(params, x, cfg, disagg=True, **kw),
        {dense_prefill(cfg): n_local, "rg_lru_scan": n_rec})
    uni = hybrid.forward(params, x, cfg, **kw)
    gaps["disagg_vs_unified"] = logit_gap(fwd, uni)
    s1, ms["forward_s1_ms"] = counted(
        lambda: hybrid.forward(params, x[:, :1], cfg, disagg=True, **kw),
        {dense_decode(cfg): n_local, "rg_lru_scan": n_rec})
    gaps["s1_vs_forward"] = logit_gap(s1[:, 0], fwd[:, 0])
    del fwd, s1
    if floor:
        nudged = dict(params, embed=params["embed"].clone())
        nudged["embed"].view(torch.int16).add_(1)
        gaps["one_ulp_embed_vs_unified"] = logit_gap(
            hybrid.forward(nudged, x, cfg, **kw), uni)
        del nudged
    del uni
    torch.cuda.empty_cache()
    (cached, times), _ = counted(
        lambda: prefill_decode(hybrid, cfg, params, tokens, prompt, steps,
                               max_len, kw),
        {"rg_lru_scan": n_rec})
    ms.update(times)
    long = hybrid.forward(params, tokens[:, :prompt + steps], cfg,
                          disagg=True, **kw)
    gaps["cache_vs_forward"] = logit_gap(
        cached, long[:, prompt - 1:prompt + steps])
    del cached, long
    torch.cuda.empty_cache()
    return gaps, ms


def rg_hybrid(cfg, hybrid, mods, first, scans):
    """Phase 5, hybrid: RecurrentGemma-9B's model API at full width and
    depth over adapters 0-3, first on bf16 weights from seed 0 (the main
    path: launches counted, times taken, a decode step profiled, gaps
    logged beside bf16's own floor), then on f32 copies of the same
    weights (the bf16 copy freed once they are made), where the logits
    must agree within ``MODEL_TOL``: as for Llama3-8B, bf16 through 38
    layers of random weights cannot be held to a tolerance at the output.
    ``forward`` runs on 4 x 1000 tokens, ``prefill`` on 2500 into a
    4096-slot cache (the 2048-slot local rings take the banded path, then
    16 decode steps wrap them).  Returns the kernels' launches of the bf16
    run."""
    bsz, fwd_len, prompt, steps, max_len = 4, 1000, 2500, 16, 4096
    t0 = time.perf_counter()
    params = hybrid.init_params(cfg, 0)
    lora = hybrid.init_lora_stacks(cfg, 1, bsz)
    torch.cuda.synchronize()
    leaves = []
    tree_map(leaves.append, params)
    log("init", model=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
        kinds={k: hybrid.layer_kinds(cfg).count(k)
               for k in ("rglru", "local")},
        seconds=time.perf_counter() - t0, params=cfg.num_params,
        param_gib=sum(t.numel() * t.element_size() for t in leaves) / 2 ** 30)
    del leaves
    tokens = torch.from_numpy(np.random.default_rng(14).integers(
        0, cfg.vocab_size, (bsz, prompt + steps))).cuda()
    launches = {}

    def counted(fn, want, tally=None):
        reset_counts(*mods)
        t0 = time.perf_counter()
        with first, scans:
            out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        for k, v in expect_launches(mods, want).items():
            if tally is not None:
                tally[k] = tally.get(k, 0) + v
        return out, ms

    torch.cuda.reset_peak_memory_stats()
    gaps, ms = hybrid_api(hybrid, cfg, params, lora, tokens,
                          lambda fn, want: counted(fn, want, launches),
                          fwd_len, prompt, steps, max_len, floor=True)
    log("rg_hybrid", model=cfg.name, dtype="bfloat16", batch=bsz,
        forward_tokens=fwd_len, prefill_tokens=prompt, decode_steps=steps,
        cache_slots=max_len, **ms, **gaps, launches=launches,
        decode_profile=profile_decode(
            hybrid, cfg, params, lora, tokens[:, :prompt + 5], prompt,
            max_len),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30, ok=True)

    params = tree_map(lambda t: t.float(), params)
    lora = tree_map(lambda t: t.float(), lora)
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gaps, ms = hybrid_api(hybrid, cfg32, params, lora, tokens, counted,
                          fwd_len, prompt, steps, max_len, floor=False)
    log("rg_hybrid", model=cfg.name, dtype="float32", **ms, **gaps,
        tol=MODEL_TOL, ok=all(g["within_model_tol"] for g in gaps.values()))
    for what, g in gaps.items():
        if not g["within_model_tol"]:
            raise AssertionError(f"f32 {what}: {g} not within {MODEL_TOL}")
    del params, lora
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------- training
class ScanBwdLaunches:
    """While entered, keeps a copy of the inputs of the first launch of the
    scan's backward kernel, as a case for ``compare_scan_bwd`` /
    ``measure_scan_bwd``.  It wraps the module's function and calls
    through, so the launch counter is untouched."""

    def __init__(self, rg):
        self.rg, self.case, self.orig = rg, None, None

    def __enter__(self):
        self.orig = self.rg.rg_lru_scan_bwd
        self.rg.rg_lru_scan_bwd = self._call
        return self

    def __exit__(self, *exc):
        self.rg.rg_lru_scan_bwd = self.orig

    def _call(self, a, states, h0, dstates, dh_last):
        if self.case is None:
            self.case = dict(
                label="main path B={} S={} W={}".format(*a.shape),
                dtype=a.dtype, a=a.clone(), states=states.clone(),
                h0=h0.clone(), dstates=dstates.clone(),
                dh_last=dh_last.clone())
        return self.orig(a, states, h0, dstates, dh_last)


class PlainScan:
    """While entered, the scan's forward and backward on the card run their
    plain versions: the kernel wrappers that ``RgLruScan`` calls are
    replaced by ``ref``'s (restored on exit)."""

    def __init__(self, rg, ref):
        self.rg, self.ref, self.orig = rg, ref, None

    def __enter__(self):
        self.orig = (self.rg.rg_lru_scan, self.rg.rg_lru_scan_bwd)
        self.rg.rg_lru_scan = self._fwd
        self.rg.rg_lru_scan_bwd = self.ref.rg_lru_scan_bwd_ref
        return self

    def __exit__(self, *exc):
        self.rg.rg_lru_scan, self.rg.rg_lru_scan_bwd = self.orig

    def _fwd(self, a, b, h0):
        states, _ = self.ref.rg_lru_scan_ref(a, b, h0)
        return states, states[:, -1].clone()


def check_scan_bwd_main_path(rg, ref, case):
    """Phase 6, the scan's backward on the inputs of its first launch in
    the RecurrentGemma-9B fine-tune, in f32 as the model runs it, and the
    same inputs cast to bf16, each timed with its bound.  Returns the f32
    record."""
    rec = compare_scan_bwd(rg, ref, case)
    log("scan_bwd_kernel", **measure_scan_bwd(rg, ref, case, rec), ok=True)
    bf = dict(case, dtype=torch.bfloat16, **{
        k: case[k].to(torch.bfloat16)
        for k in ("a", "states", "h0", "dstates", "dh_last")})
    rec_bf = compare_scan_bwd(rg, ref, bf)
    log("scan_bwd_kernel", **measure_scan_bwd(rg, ref, bf, rec_bf), ok=True)
    del bf
    torch.cuda.empty_cache()
    return rec


def lora_grads(api, base, params, lora, batch, adapter_id):
    """The LoRA fine-tune's loss (``train_loop``'s, disagg=False) and its
    gradient w.r.t. every adapter leaf on one batch, base weights frozen."""
    tracked = tree_map(lambda t: t.detach().requires_grad_(True), lora)
    tokens = torch.as_tensor(batch["tokens"]).cuda()
    ids = torch.full((tokens.shape[0],), adapter_id, dtype=torch.long,
                     device="cuda")
    loss = base.cross_entropy(
        api.forward(params, tokens, lora=tracked, adapter_ids=ids),
        torch.as_tensor(batch["labels"]).cuda())
    loss.backward()
    return float(loss.detach()), tree_map(lambda t: t.grad, tracked)


def grad_gap(got, want):
    """max |got - want| over max |want| of one gradient leaf."""
    want = want.float()
    return (got.float() - want).abs().max().item() / max(
        want.abs().max().item(), 1e-30)


def lora_finetune(cfg, api, params, lora, train_loop, data, base, mods,
                  steps, bsz, seq, expect, capture=None):
    """Phase 5, training: ``steps`` steps of ``make_lora_train_step``
    (AdamW, adapter 0, base frozen) on the synthetic stream (seed 0), B x
    S tokens each, the counts zeroed before each step and read after it
    (``expect``: the launches one step must make, every other counter 0);
    the loss on a held-out batch (the stream at seed 1) before and after;
    the base weights bit-equal after the steps (held on the host).
    Returns the run's record and the trained stacks."""
    init, step = train_loop.make_lora_train_step(cfg, lr=1e-3, adapter_id=0)
    stream = data.make_stream(cfg.vocab_size, seq, bsz, seed=0)
    held = data.make_stream(cfg.vocab_size, seq, bsz, seed=1)._batch(0)
    ids = torch.zeros(bsz, dtype=torch.long, device="cuda")
    before = [t.cpu() for t in base.leaves(params)]
    loss0 = float(train_loop.eval_loss(cfg, params, held, lora=lora,
                                       adapter_ids=ids))
    opt = init(lora)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms, launches = [], [], {}
    for _, batch in zip(range(steps), stream):
        reset_counts(*mods)
        t0 = time.perf_counter()
        if capture is not None:
            with capture:
                lora, opt, m = step(lora, opt, params, batch)
        else:
            lora, opt, m = step(lora, opt, params, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        for k, v in expect_launches(mods, expect).items():
            launches[k] = launches.get(k, 0) + v
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    loss1 = float(train_loop.eval_loss(cfg, params, held, lora=lora,
                                       adapter_ids=ids))
    unchanged = all(torch.equal(a, b.cpu())
                    for a, b in zip(before, base.leaves(params)))
    del before
    steady = sorted(ms[1:]) if len(ms) > 1 else ms
    ms_step = steady[len(steady) // 2]
    rec = dict(model=cfg.name, dtype=str(cfg.activation_dtype).split(".")[1],
               layers=cfg.num_layers, batch=bsz, seq=seq, steps=steps,
               rank=cfg.lora.rank, adapters=lora["a_q"].shape[1],
               losses=losses, step_ms=ms, ms_per_step=ms_step,
               tokens_per_s=bsz * seq / (ms_step / 1e3),
               held_out_loss_before=loss0, held_out_loss_after=loss1,
               peak_mem_gib=peak, base_unchanged=unchanged,
               launches=launches)
    if not all(np.isfinite(losses)) or not loss1 < loss0 or not unchanged:
        log("train", **rec, ok=False)
        raise AssertionError(f"{cfg.name} LoRA fine-tune: held-out loss "
                             f"{loss0} -> {loss1}, base unchanged "
                             f"{unchanged}, losses {losses}")
    return rec, lora


def train_llama_lora(cfg, params, lora, registry, train_loop, data, base,
                     mods, card):
    """Phase 5, training (1): Llama3-8B's LoRA fine-tune at full width and
    depth on the serving phase's bf16 weights and 4 adapters of rank 16:
    5 steps of B 4 x S 512; the dense family's training reaches no kernel
    (its loss runs disagg=False, as the reference's) and no plain
    version."""
    rec, _ = lora_finetune(cfg, registry.get_model(cfg), params, lora,
                           train_loop, data, base, mods, steps=5, bsz=4,
                           seq=512, expect={})
    log("train", run="llama3-8b lora", card=card, **rec, ok=True)
    return rec


def train_rg_lora(cfg, hybrid, registry, rg, ref, train_loop, data, base,
                  mods, card, capture):
    """Phase 5, training (3): RecurrentGemma-9B's LoRA fine-tune at full
    width and depth (random bf16 weights from seed 0, 4 adapters of rank
    16 on the 12 local-attention layers): 3 steps of B 2 x S 1000.  Each
    step launches the forward kernel once per RG-LRU layer (26) and the
    backward kernel once per RG-LRU layer after the first local layer
    (24: the gradient reaches only the adapters, so layers 0 and 1 need
    none, as under ``jax.grad``); under the config's remat the recompute
    runs each of those 24 layers' forward again.  Then,
    on one batch, the adapter gradients: the first local layer's (layer 2;
    24 RG-LRU layers lie between it and the loss) non-zero; in bf16 their
    gap to the same gradients with the plain scan patched in
    (``PlainScan``) is logged beside bf16's own floor (the kernel's
    gradients with the embedding one ulp off: bf16 through 38 random
    layers is chaotic), and on f32 copies of the weights and stacks every
    leaf must be within 1% of its max |value| of the plain scan's.
    Returns the run's record."""
    t0 = time.perf_counter()
    params = hybrid.init_params(cfg, 0)
    lora = hybrid.init_lora_stacks(cfg, 1, 4)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    kinds = hybrid.layer_kinds(cfg)
    n_lru = kinds.count("rglru")
    n_bwd = kinds[kinds.index("local"):].count("rglru")
    api = registry.get_model(cfg)
    rec, lora = lora_finetune(
        cfg, api, params, lora, train_loop, data, base, mods, steps=3,
        bsz=2, seq=1000, expect={
            "rg_lru_scan": n_lru + (n_bwd if cfg.remat else 0),
            "rg_lru_scan_bwd": n_bwd}, capture=capture)
    batch = data.make_stream(cfg.vocab_size, 1000, 2, seed=0)._batch(0)
    reset_counts(*mods)
    loss_k, g_k = lora_grads(api, base, params, lora, batch, 0)
    with PlainScan(rg, ref):
        loss_p, g_p = lora_grads(api, base, params, lora, batch, 0)
    # bf16's own floor: the kernel's gradients with the embedding one ulp
    # off (bf16 through 38 random layers moves ~6% on a one-ulp change)
    nudged = dict(params, embed=params["embed"].clone())
    nudged["embed"].view(torch.int16).add_(1)
    _, g_n = lora_grads(api, base, nudged, lora, batch, 0)
    del nudged
    torch.cuda.synchronize()
    counts = {k: v for m in mods for k, v in m.LAUNCHES.items() if v}
    layer2 = {k: g_k[k][0, 0].float().abs().max().item()
              for k in ("a_q", "b_q", "a_k", "b_k", "a_v", "b_v")}
    bf16 = {k: dict(kernel_vs_plain=grad_gap(g_k[k], g_p[k]),
                    one_ulp_embed=grad_gap(g_n[k], g_k[k])) for k in g_k}
    del g_k, g_p, g_n
    # the gate, on f32 copies of the same weights and trained stacks
    params = tree_map(lambda t: t.float(), params)
    lora = tree_map(lambda t: t.float(), lora)
    torch.cuda.empty_cache()
    api32 = registry.get_model(dataclasses.replace(cfg, dtype="float32"))
    loss_k32, g_k = lora_grads(api32, base, params, lora, batch, 0)
    with PlainScan(rg, ref):
        loss_p32, g_p = lora_grads(api32, base, params, lora, batch, 0)
    f32 = {k: grad_gap(g_k[k], g_p[k]) for k in g_k}
    layer2_f32 = {k: g_k[k][0, 0].abs().max().item() for k in layer2}
    ok = all(v > 0 for v in list(layer2.values()) + list(
        layer2_f32.values())) and all(v <= BF16_RTOL for v in f32.values())
    rec.update(init_seconds=init_s, rg_lru_layers=n_lru,
               rg_lru_layers_with_gradient=n_bwd, remat=cfg.remat,
               grad_loss_bf16=dict(kernel=loss_k, plain=loss_p),
               grad_loss_f32=dict(kernel=loss_k32, plain=loss_p32),
               layer2_adapter_grad_max=layer2,
               layer2_adapter_grad_max_f32=layer2_f32,
               bf16_grad_gaps=bf16, f32_kernel_vs_plain_grad_gaps=f32,
               f32_grad_tol=BF16_RTOL, grad_launches=counts)
    log("train", run="recurrentgemma-9b lora", card=card, **rec, ok=ok)
    if not ok:
        raise AssertionError(f"RecurrentGemma-9B gradients: layer 2 "
                             f"{layer2} / {layer2_f32}, f32 kernel vs "
                             f"plain {f32}")
    del params, lora, g_k, g_p
    torch.cuda.empty_cache()
    return rec


def train_launcher(card, timeout=900):
    """Phase 5, training (2): internlm2-1.8b full-parameter training at
    full width and depth (bf16, AdamW) through ``python -m
    repro_torch.launch.train`` as users run it, a process of its own: 5
    steps of B 8 x S 128, every step's line finite, exit code 0; its peak
    device memory from its last line.  Returns the record."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "internlm2-1.8b", "--steps", "5", "--batch", "8", "--seq", "128",
           "--log-every", "1"]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)
    seconds = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    steps = [re.match(r"step\s+(\d+) loss=(\S+) gnorm=(\S+) "
                      r"\((\S+)s/step\)$", ln) for ln in lines]
    steps = [m for m in steps if m]
    peak = [float(ln.split("=")[1]) for ln in lines
            if ln.startswith("peak_memory_gib=")]
    # each line gives the mean over the steps so far (the reference's
    # format, 2 decimals): step i took (i + 1) avg_i - i avg_{i-1}
    avg = [float(m[4]) for m in steps]
    step_s = [(i + 1) * a - i * (avg[i - 1] if i else 0.0)
              for i, a in enumerate(avg)]
    steady = sorted(step_s[1:]) or step_s
    rec = dict(cmd=" ".join(cmd[1:]), returncode=proc.returncode,
               seconds=seconds, lines=lines,
               losses=[float(m[2]) for m in steps],
               grad_norms=[float(m[3]) for m in steps],
               s_per_step=avg, step_s=step_s,
               ms_per_step=1e3 * steady[len(steady) // 2],
               tokens_per_s=8 * 128 / steady[len(steady) // 2],
               peak_mem_gib=peak[0] if peak else None)
    ok = proc.returncode == 0 and len(steps) == 5 and all(
        np.isfinite(rec["losses"] + rec["grad_norms"]))
    log("train", run="internlm2-1.8b launcher", card=card, **rec,
        stderr=proc.stderr[-2000:] if not ok else "", ok=ok)
    if not ok:
        raise AssertionError(f"train launcher: exit {proc.returncode}, "
                             f"{len(steps)} step lines")
    return rec


def small_training_card_vs_cpu(cfgs, registry, train_loop, data, base,
                               mods, steps=3):
    """Phase 5, training (4): small f32 models trained on the card and on
    the CPU from the same weights, ``steps`` AdamW steps of B 4 x S 64.
    At lr 1e-3 (the reference tests' rate): the losses within 1e-5 of each
    other (relative), each step's gradient norm within 1e-4, and every
    parameter within AdamW's own bound for rounding noise, 2 * steps * lr:
    AdamW moves an element by ~lr g / (|g| + 1e-8), so an element whose
    gradient lies within rounding of zero moves up to lr either way, and
    the two devices round their sums differently.  Then the same steps at
    lr 1e-5, where that bound is 6e-5: every parameter within 1e-4.  The
    hybrid's card runs launch the scan once per RG-LRU layer per forward
    pass (its remat on: the recompute too) and the backward once per layer
    per step."""
    for label, cfg, lru in cfgs:
        params = registry.get_model(cfg).init_params(0, device="cpu")
        rec = dict(model=label, layers=cfg.num_layers, d_model=cfg.d_model,
                   remat=cfg.remat, steps=steps)
        for lr in (1e-3, 1e-5):
            out = {}
            for dev in ("cuda", "cpu"):
                p = tree_map(lambda t: t.to(dev), params)
                init, step = train_loop.make_train_step(cfg, lr=lr,
                                                        device=dev)
                opt = init(p)
                losses, norms = [], []
                reset_counts(*mods)
                for _, b in zip(range(steps), data.make_stream(
                        cfg.vocab_size, 64, 4, seed=2)):
                    p, opt, m = step(p, opt, b)
                    losses.append(float(m["loss"]))
                    norms.append(float(m["grad_norm"]))
                if dev == "cuda":
                    torch.cuda.synchronize()
                    want = {} if not lru else {
                        "rg_lru_scan": steps * lru * (2 if cfg.remat else 1),
                        "rg_lru_scan_bwd": steps * lru}
                    rec["launches"] = expect_launches(mods, want)
                out[dev] = (losses, norms, [t.cpu() for t in base.leaves(p)])
            gaps = [(a - b).abs() for a, b in zip(out["cuda"][2],
                                                   out["cpu"][2])]
            rec[f"lr {lr:g}"] = dict(
                losses=out["cuda"][0], cpu_losses=out["cpu"][0],
                loss_rel_gap=max(abs(a - b) / abs(b) for a, b in zip(
                    out["cuda"][0], out["cpu"][0])),
                grad_norm_rel_gap=max(abs(a - b) / abs(b) for a, b in zip(
                    out["cuda"][1], out["cpu"][1])),
                param_max_abs_gap=max(g.max().item() for g in gaps),
                params_past_1e_4=sum(int((g > 1e-4).sum()) for g in gaps),
                params=sum(g.numel() for g in gaps))
        hi, lo = rec["lr 0.001"], rec["lr 1e-05"]
        ok = hi["loss_rel_gap"] <= 1e-5 and hi["grad_norm_rel_gap"] <= 1e-4 \
            and hi["param_max_abs_gap"] <= 2 * steps * 1e-3 and \
            lo["loss_rel_gap"] <= 1e-5 and lo["param_max_abs_gap"] <= 1e-4
        log("train_card_vs_cpu", **rec, ok=ok)
        if not ok:
            raise AssertionError(f"{label} trained on card vs CPU: {rec}")


def check_dense_main_path(ra, ref, cases):
    """Phase 6, dense: each kernel on the inputs of its first launch on
    the main path (bf16, timed) and on random f32 inputs of the same
    geometry; returns the bf16 record per kernel."""
    results = {}
    for name, c in cases.items():
        tol = BF16_RTOL if c["dtype"] == torch.bfloat16 else F32_TOL
        rec = compare_dense(ra, ref, c, tol)
        measure_dense(ra, ref, c, rec)
        log("dense_kernel", **rec, ok=True)
        results[name] = rec
        _, sq, hq, d = c["q"].shape
        _, sk, hkv, _ = c["k_base"].shape
        start = c["qpos"][:, 0].tolist()
        kv = None if c["kv_len"] is None else c["kv_len"].tolist()
        f32 = make_dense_case("main path geometry",
                              (hq, hkv, d, c["k_res"].shape[2]), sq, sk,
                              start, kv, torch.float32, c["window"], seed=30)
        f32["decode"] = c["decode"]
        log("dense_kernel", **compare_dense(ra, ref, f32, F32_TOL), ok=True)
        del f32
    torch.cuda.empty_cache()
    return results


# ------------------------------------------------------------- serving
def serve(server, vocab, ctx_len, n_forks, n_adapters, instr_len, max_new,
          seed, sampling_cls):
    """One pinned session of ``ctx_len`` tokens and ``n_forks`` greedy
    forks over ``n_adapters`` adapters, the second half submitted after the
    first half has started decoding, so plans mix decode and prefill rows.
    Returns (outputs, metrics, seconds)."""
    rng = np.random.default_rng(seed)
    ctx = [int(t) for t in rng.integers(0, vocab, ctx_len)]
    instrs = [[int(t) for t in rng.integers(0, vocab, instr_len)]
              for _ in range(n_forks)]
    sp = sampling_cls(max_new_tokens=max_new)
    t0 = time.perf_counter()
    with server.session(ctx, adapter_id=0) as sess:
        half = n_forks // 2
        handles = [sess.fork(i % n_adapters, instrs[i], sp)
                   for i in range(half)]
        eng = server.engine
        while eng.waiting or eng.running:       # until one fork decodes
            if any(r.state == "decode" for r in eng.running):
                break
            server.poll()
        handles += [sess.fork(i % n_adapters, instrs[i], sp)
                    for i in range(half, n_forks)]
        outs = server.wait(handles)
    return (outs,) + drained_metrics(server, t0)


def serve_fanout(server, vocab, ctx_len, adapters, instr_len, max_new, seed,
                 sampling_cls):
    """The map step of a MapReduce fan-out: one pinned session of
    ``ctx_len`` tokens (adapter 0), then one greedy fork per adapter in
    ``adapters`` with the SAME instruction, all submitted before the next
    poll.  Under adapters other than the session's, each fork misses its
    rCache and re-prefills the whole prompt from position 0, so all of them
    stand at the same position of one identical chunk.  Returns (outputs,
    metrics, seconds)."""
    rng = np.random.default_rng(seed)
    ctx = [int(t) for t in rng.integers(0, vocab, ctx_len)]
    instr = [int(t) for t in rng.integers(0, vocab, instr_len)]
    sp = sampling_cls(max_new_tokens=max_new)
    t0 = time.perf_counter()
    with server.session(ctx, adapter_id=0) as sess:
        handles = [sess.fork(a, instr, sp) for a in adapters]
        outs = server.wait(handles)
    return (outs,) + drained_metrics(server, t0)


def serve_rerun(server, vocab, ctx_len, n_adapters, instr_len, max_new,
                seed, sampling_cls):
    """The staggered serve with every agent step run twice: one pinned
    session of ``ctx_len`` tokens, one greedy fork per adapter, the second
    half submitted once a fork of the first half decodes (as ``serve``),
    and each fork run again (same adapter, same instruction) as soon as
    it has finished, while the later forks still decode: a retry or a
    self-consistency sample of the same step.  Returns (outputs: the first
    runs, then the re-runs; metrics; seconds)."""
    rng = np.random.default_rng(seed)
    ctx = [int(t) for t in rng.integers(0, vocab, ctx_len)]
    instrs = [[int(t) for t in rng.integers(0, vocab, instr_len)]
              for _ in range(n_adapters)]
    sp = sampling_cls(max_new_tokens=max_new)
    t0 = time.perf_counter()
    with server.session(ctx, adapter_id=0) as sess:
        half = n_adapters // 2
        first = [sess.fork(i, instrs[i], sp) for i in range(half)]
        eng = server.engine
        while eng.waiting or eng.running:       # until one fork decodes
            if any(r.state == "decode" for r in eng.running):
                break
            server.poll()
        first += [sess.fork(i, instrs[i], sp)
                  for i in range(half, n_adapters)]
        again = {}
        while len(again) < n_adapters:
            for i, h in enumerate(first):
                if h.done and i not in again:
                    again[i] = sess.fork(i, instrs[i], sp)
            if len(again) < n_adapters:
                server.poll()
        outs = server.wait(first + [again[i] for i in range(n_adapters)])
    return (outs,) + drained_metrics(server, t0)


def drained_metrics(server, t0):
    """(metrics, seconds since ``t0``) once the device is idle, with the
    pool's free pages after every tree page is evicted."""
    eng = server.engine
    if eng.executor.device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    m = server.metrics()
    eng._evict(eng.base_pool, eng.base_pool.num_pages)
    if eng.mode == "forkkv":
        eng._evict(eng.res_pool, eng.res_pool.num_pages)
    m["drained_free_base"] = eng.base_pool.free_pages
    m["drained_free_res"] = eng.res_pool.free_pages
    m["total_base"] = eng.base_pool.num_pages
    m["total_res"] = eng.res_pool.num_pages
    return m, seconds


def check_serving(outs, m, max_new, mixed=True, gather=False):
    """Every fork ran to length, nothing failed, no page leaked; a staggered
    serve under the mixed loop (``mixed``) ran at least one mixed plan; the
    gather path (``gather``) and only it counted gather calls."""
    for o in outs:
        if o.finish_reason != "length" or len(o.tokens) != max_new:
            raise AssertionError(f"request {o.rid}: {o.finish_reason} "
                                 f"{len(o.tokens)} tokens {o.error}")
    for key in ("exec_errors", "quarantined"):
        if m[key] != 0:
            raise AssertionError(f"{key} = {m[key]}")
    if (m["fallback_gather_calls"] > 0) != gather:
        raise AssertionError(f"fallback_gather_calls = "
                             f"{m['fallback_gather_calls']}")
    if mixed and m["mixed_steps"] < 1:
        raise AssertionError("no mixed plan ran")
    if m["drained_free_base"] != m["total_base"] - 1 or \
            m["drained_free_res"] != m["total_res"] - 1:
        raise AssertionError("pages leaked after close + evict")


def check_counts(pra, ref, expect_kernels, dtype):
    """The launches of the serve just run (the counts were zeroed before
    it): every kernel in ``expect_kernels`` launched, no plain version ran,
    no template instance of an entry that runs a split-K decode
    (``pra.SPLIT_ENTRIES``: #4, #2) in any type, and in bf16 none of an
    entry whose bf16 launches run a tensor-core kernel
    (``pra.MMA_ENTRIES``: #6, #3, #5, #1).  Returns
    every kernel's non-zero count."""
    ran = {k: v for k, v in pra.LAUNCHES.items() if v}
    missing = [k for k in expect_kernels if k not in ran]
    if missing:
        raise AssertionError(f"kernels not launched: {missing}; ran {ran}")
    if any(ref.LAUNCHES.values()):
        raise AssertionError(f"plain versions ran on the card: "
                             f"{ref.LAUNCHES}")
    # a template launch counts under the entry's own name (+ "_int8")
    template = [k for k in ran if k.removesuffix("_rchunk").removesuffix(
        "_int8") in (pra.SPLIT_ENTRIES + (pra.MMA_ENTRIES
                                          if dtype == torch.bfloat16
                                          else ()))]
    if template:
        raise AssertionError(f"{dtype} serve ran the template instead of the "
                             f"split-K or tensor-core kernel: {template}")
    return ran


class LaunchShapes:
    """Records the geometry of every launch of the kernel wrappers while
    it is entered, under the kernel's name (an entry given scales: its
    int8 variant): batch, query width, table width, window, and each row's
    start and q_len (kept as device copies and read afterwards, so
    recording adds no host sync).  It wraps the module's functions and
    calls through, so the launch counters are untouched."""

    def __init__(self, pra):
        self.pra, self.raw, self.orig = pra, [], {}

    def __enter__(self):
        for name in KERNELS:
            self.orig[name] = getattr(self.pra, name)
            setattr(self.pra, name, self._wrap(name, self.orig[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.pra, name, fn)

    def _wrap(self, name, fn):
        res, decode = "residual" in name, KERNELS[name][0] == "decode"

        def call(*args, **kw):
            q, bt = args[0], args[7 if res else 3]
            # decode: kv_len; mixed: start, q_len; prefill: start, kv_len
            i = 9 if res else 4
            rows = (args[i].clone(),) if decode else \
                (args[i].clone(), args[i + 1].clone())
            label = name if kw.get("kb_scale") is None else f"{name}_int8"
            self.raw.append((label, q.shape[0], 1 if decode else q.shape[1],
                             bt.shape[1], kw.get("window", 0), rows))
            return fn(*args, **kw)
        return call

    def launches(self):
        """{kernel: [(bsz, sq, width, window, start, qlen), ...]},
        distinct launches in order; a chunked prefill row's qlen is its
        n_valid, clamp(kv_len - start, 0, sq)."""
        out = {}
        for name, bsz, sq, width, window, rows in self.raw:
            kind = ALL_KERNELS[name][0]
            if kind == "decode":
                kv = rows[0].tolist()
                start, qlen = tuple(k - 1 for k in kv), (1,) * len(kv)
            elif kind == "prefill":
                start = tuple(rows[0].tolist())
                qlen = tuple(max(0, min(sq, k - st))
                             for st, k in zip(start, rows[1].tolist()))
            else:
                start, qlen = tuple(rows[0].tolist()), tuple(rows[1].tolist())
            key = (bsz, sq, width, window, start, qlen)
            if key not in out.setdefault(name, []):
                out[name].append(key)
        return out


# (label, mode, ServeConfig settings, entries that must launch) of the
# staggered Llama3-8B serves; ``run`` maps each entry to the kernel it runs
# for the model (``pra.kernel_name``: bf16 prefix serves run #3's and #6's
# tensor-core kernel, ``paged_attention_{mixed,prefill}_base_mma``, the
# bf16 forkkv serves #1's and #5's,
# ``paged_residual_attention_{mixed,prefill}_mma``; every serve its decode's
# split-K kernel, ``paged_{attention_decode_base,residual_attention_decode}
# _splitk``, int8 pages the ``_int8_`` twins of all of these)
LLAMA_SERVES = (
    ("forkkv", "forkkv", {}, ("paged_residual_attention_mixed",
                              "paged_residual_attention_decode")),
    ("prefix", "prefix", {}, ("paged_attention_mixed_base",
                              "paged_attention_decode_base")),
    ("forkkv phase-separated", "forkkv", dict(mixed_batching=False),
     ("paged_residual_attention_prefill",
      "paged_residual_attention_decode")),
    ("prefix phase-separated", "prefix", dict(mixed_batching=False),
     ("paged_attention_prefill_base", "paged_attention_decode_base")),
)
# the same four serves with int8 bCache pages: only the int8 variants run
LLAMA_INT8_SERVES = tuple(
    (f"{label} int8", mode, extra, expect)
    for label, mode, extra, expect in LLAMA_SERVES)
# adapters of the fan-out's forks: not the session's adapter 0, so every
# fork re-prefills the whole prompt from position 0
FANOUT = (1, 2, 3)
# the staggered serve under memory pressure: a device budget between
# forkkv's peak (169 base pages) and prefix's (937), the host tier on
PRESSURE = dict(max_pages=640, max_pages_per_req=256,
                host_tier_bytes=4 << 30)


def check_broadcast(exact, n_prefill, n_layers, prompt_len, page):
    """The fan-out ran ONE shared base-trajectory pass: it covers the
    prompt's whole pages but the last (whose logits give the first token),
    it is credited to its writer, each fork prefills only its own tail, and
    the base-only prefill kernel ran ``n_prefill`` times, once per
    layer."""
    shared = prompt_len // page * page
    if shared >= prompt_len:
        shared -= page
    tail = prompt_len - shared
    want = sorted([tail] * (len(FANOUT) - 1) + [shared + tail])
    if exact != want:
        raise AssertionError(f"broadcast prefilled_tokens {exact} != {want}")
    if n_prefill != n_layers:
        raise AssertionError(f"broadcast pass launched the base prefill "
                             f"{n_prefill} times, not once per layer "
                             f"({n_layers})")


def http_vs_in_process(server, vocab, HttpFrontend, ForkClient,
                       SamplingParams, max_new=16, seed=21):
    """Phase 5, HTTP: ``server`` wrapped in an in-process ``HttpFrontend``
    serves, through ``ForkClient``, a completion, a streamed completion
    and a session of ``vocab``-sized random tokens with 4 forks (adapters
    0-3), one request at a time; then, with the front end shut and every
    cached page evicted, the same server serves the same requests in
    process, in the same order, so every step has the same shapes.
    Greedy tokens must be identical.  Returns the record to log: the
    streamed completion's time to first token and tokens per second over
    HTTP and in process (host clock, the client's view)."""
    rng = np.random.default_rng(seed)
    ints = lambda n: [int(t) for t in rng.integers(0, vocab, n)]  # noqa
    prompt_a, prompt_b, ctx = ints(512), ints(512), ints(1024)
    instrs = [ints(32) for _ in range(4)]
    sp = SamplingParams(max_new_tokens=max_new)
    fe = HttpFrontend(server).start_background()
    client = ForkClient(port=fe.port, timeout=600)
    http, timing = {}, {}
    try:
        http["completion"] = client.completion(
            prompt_a, adapter_id=1, max_new_tokens=max_new)["tokens"]
        t0, first, events = time.perf_counter(), None, []
        for ev in client.stream_completion(prompt_b, adapter_id=2,
                                           max_new_tokens=max_new):
            if first is None:
                first = time.perf_counter()
            events.append(ev)
        timing["http"] = (first - t0, time.perf_counter() - t0)
        streamed = [e["token"] for e in events if not e.get("finished")]
        if streamed != events[-1]["tokens"]:
            raise AssertionError("SSE tokens differ from the terminal event")
        http["stream"] = streamed
        sid = client.create_session(ctx, adapter_id=0)
        http["forks"] = [client.fork(sid, instr, adapter_id=i,
                                     max_new_tokens=max_new)["tokens"]
                         for i, instr in enumerate(instrs)]
        client.close_session(sid)
        http_requests = client.metrics()["http_requests_served"]
    finally:
        fe.shutdown()
    eng = server.engine
    eng._evict(eng.base_pool, eng.base_pool.num_pages)
    if eng.mode == "forkkv":
        eng._evict(eng.res_pool, eng.res_pool.num_pages)
    local = {"completion": server.generate(1, prompt_a, sp).result().tokens}
    t0, first, toks = time.perf_counter(), None, []
    for ev in server.generate(2, prompt_b, sp).stream():
        if ev.token is not None:
            first = first or time.perf_counter()
            toks.append(ev.token)
    timing["in_process"] = (first - t0, time.perf_counter() - t0)
    local["stream"] = toks
    with server.session(ctx, adapter_id=0) as sess:
        local["forks"] = [sess.fork(i, instr, sp).result().tokens
                          for i, instr in enumerate(instrs)]
    for key, want in local.items():
        if http[key] != want:
            raise AssertionError(f"HTTP {key} {http[key]} != in-process "
                                 f"{want}")
    rec = dict(max_new_tokens=max_new, prompt=512, context=1024, forks=4,
               http_requests_served=http_requests, tokens=http["stream"])
    for side, (ttft, total) in timing.items():
        rec[f"ttft_ms_{side}"] = ttft * 1e3
        rec[f"tokens_per_s_{side}"] = max_new / total
    return rec


# The port's serve launcher as users run it: ``python -m
# repro_torch.launch.serve --http --port 0`` (tiny_serving_model(), head_dim
# 32, on the card), its port line parsed as scripts parse it
SERVE_LINE = re.compile(r"^serving mode=\S+ admission=\S+ on "
                        r"http://[^:]+:(\d+)$")


def cli_http_drain(ForkClient, HttpError, extra=(), timeout=300):
    """Phase 4, the CLI: start the launcher with ``--http --port 0``
    (``extra`` flags appended), parse its port line, open a 128-token
    stream and, once a token has arrived, read the served configuration
    from ``/v1/metrics`` and send SIGTERM: a fresh request
    must get 503 with ``finish_reason="draining"``, the open stream must
    finish to length, ``watchdog_trips`` must stay 0 (read from /healthz
    while the process lives) and the process must exit 0.  The process is
    killed if anything fails.  Returns the record to log."""
    import signal
    import threading
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--http",
           "--port", "0", *extra]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        port = None
        while port is None:
            line = proc.stdout.readline()
            if not line:
                raise AssertionError(f"launcher exited {proc.wait()}: "
                                     f"{lines[-20:]}")
            lines.append(line.rstrip())
            m = SERVE_LINE.match(line.strip())
            port = int(m[1]) if m else None
            if time.perf_counter() - t0 > timeout:
                raise AssertionError(f"no port line: {lines[-20:]}")
        ready_s = time.perf_counter() - t0
        reader = threading.Thread(target=lambda: lines.extend(
            ln.rstrip() for ln in proc.stdout), daemon=True)
        reader.start()
        client = ForkClient(port=port, timeout=timeout)
        events = []

        def consume():
            for ev in client.stream_completion(list(range(1, 33)),
                                               max_new_tokens=128):
                events.append(ev)

        stream = threading.Thread(target=consume, daemon=True)
        stream.start()
        deadline = time.perf_counter() + timeout
        while not events and stream.is_alive() and \
                time.perf_counter() < deadline:
            time.sleep(0.005)
        if not events or events[0].get("finished"):
            raise AssertionError(f"no token before the drain: {events}")
        served = client.metrics()
        proc.send_signal(signal.SIGTERM)
        trips, state = 0, None
        while state != "draining" and time.perf_counter() < deadline:
            _, _, doc = client._request("GET", "/healthz")
            state, trips = doc["state"], max(trips, doc["watchdog_trips"])
            time.sleep(0.005)
        try:
            client.completion(list(range(2, 30)), max_new_tokens=4)
            raise AssertionError("a request during the drain was admitted")
        except HttpError as exc:
            if exc.status != 503 or exc.doc.get("finish_reason") != \
                    "draining":
                raise AssertionError(f"drain refused with {exc.status} "
                                     f"{exc.doc}") from exc
        while stream.is_alive() and time.perf_counter() < deadline:
            try:
                _, _, doc = client._request("GET", "/healthz")
                trips = max(trips, doc["watchdog_trips"])
            except OSError:
                break                   # drained: the process is leaving
            time.sleep(0.02)
        stream.join(timeout=max(1.0, deadline - time.perf_counter()))
        final = events[-1]
        if not (final.get("finished") and final["finish_reason"] == "length"
                and len(final["tokens"]) == 128):
            raise AssertionError(f"the open stream did not finish: {final}")
        rc = proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
        reader.join(timeout=10)
        if rc != 0 or trips != 0:
            raise AssertionError(f"launcher exit {rc}, watchdog_trips "
                                 f"{trips}: {lines[-20:]}")
        return dict(cmd=" ".join(cmd[1:]), ready_s=ready_s, port=port,
                    stream_tokens=len(final["tokens"]), exit_code=rc,
                    watchdog_trips=trips, refused=503,
                    drain_lines=[ln for ln in lines if "drain" in ln],
                    **{k: served[k] for k in ("admission", "speculate",
                                              "spec_proposer",
                                              "spec_steps")})
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def cli_stats_line(extra, timeout=300):
    """Phase 4, the CLI: the launcher's workflow run (one workflow of two
    agents, ``tiny_serving_model()`` on the card) with ``--stats`` and
    ``extra`` flags appended, as a process of its own; returns its
    speculation stats line, which must read ``speculate=on``."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--workflows",
           "1", "--agents", "2", "--stats", *extra]
    proc = subprocess.run(cmd, cwd=ROOT, env=dict(os.environ,
                                                  PYTHONPATH=str(SRC)),
                          capture_output=True, text=True, timeout=timeout)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("speculate=")]
    if proc.returncode != 0 or not lines or \
            not lines[0].startswith("speculate=on "):
        raise AssertionError(f"launcher exit {proc.returncode}: "
                             f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    return lines[0]


def reset_counts(*mods):
    for mod in mods:
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0


# (mode, ServeConfig settings) of the small model's card-vs-CPU serves
SMALL_SERVES = (
    ("forkkv", {}),
    ("prefix", {}),
    ("forkkv", dict(mixed_batching=False)),
    ("prefix", dict(mixed_batching=False)),
    ("forkkv", dict(broadcast_fork=True)),
    ("forkkv", dict(use_paged_kernel=False)),
)


def small_model_card_vs_cpu(tiny, tfm, ForkServer, ServeConfig,
                            SamplingParams, pra):
    """Phase 4: a 2-layer f32 model (head_dim 64) served on the card and
    on the CPU from the same weights must give the same greedy tokens, in
    every setting of ``SMALL_SERVES``, with full-precision and with int8
    bCache pages (on the card a paged int8 serve launches only int8
    variants, and every f32 launch a template instance, never a
    tensor-core ``_mma`` kernel); on the card the gather path's tokens must
    equal the paged path's."""
    base = tiny(rank=16, num_layers=2, d_model=256, num_heads=4,
                num_kv_heads=2, vocab_size=512)
    params = tfm.init_params(base, 0, device="cpu")
    lora = tfm.init_lora_stacks(base, 1, 4, device="cpu")
    to_cuda = lambda t: {k: to_cuda(v) if isinstance(v, dict)  # noqa
                         else v.cuda() for k, v in t.items()}
    for quant in ("none", "int8"):
        cfg = dataclasses.replace(base, kv_quant=quant)
        card = {}
        for mode, extra in SMALL_SERVES:
            sc = ServeConfig(page_size=16, max_pages=128, max_batch=8,
                             max_prefill_tokens=64, max_pages_per_req=16,
                             mode=mode, **extra)
            toks = {}
            for dev in ("cuda", "cpu"):
                p, lo = (to_cuda(params), to_cuda(lora)) if dev == "cuda" \
                    else (params, lora)
                srv = ForkServer(cfg, p, lo, sc, device=dev)
                reset_counts(pra)
                outs, m, _ = serve(srv, cfg.vocab_size, 72, 4, 4, 9, 6, 3,
                                   SamplingParams)
                check_serving(outs, m, 6, mixed=sc.mixed_batching,
                              gather=not sc.use_paged_kernel)
                ran = {k for k, v in pra.LAUNCHES.items() if v}
                # f32: the kernels f32 routes to (template instances and
                # the split-K decode), never a "_mma" kernel
                f32 = {pra.kernel_name(e, torch.float32, quant == "int8")
                       for e in pra.ENTRIES}
                if dev == "cuda" and sc.use_paged_kernel and (
                        not ran or not ran <= f32):
                    raise AssertionError(f"kv_quant {quant} {mode} {extra} "
                                         f"launched {sorted(ran)}")
                toks[dev] = [o.tokens for o in outs]
            if toks["cuda"] != toks["cpu"]:
                raise AssertionError(f"{quant} {mode} {extra}: card "
                                     f"{toks['cuda']} != CPU {toks['cpu']}")
            card[(mode, tuple(extra))] = toks["cuda"]
            log("small_model", kv_quant=quant, mode=mode, **extra,
                tokens=toks["cuda"], ok=True)
        paged = card[("forkkv", ())]
        gather = card[("forkkv", ("use_paged_kernel",))]
        if gather != paged:
            raise AssertionError(f"{quant}: gather path {gather} != paged "
                                 f"path {paged}")


# (mode, ServeConfig settings, entries that must launch) of the default
# tiny model's card-vs-CPU serves: every mode in both loops
D32_SERVES = tuple(
    (mode, extra, tuple(e.replace("_mixed", "_prefill") if extra else e
                        for e in expect))
    for mode, expect in (("forkkv", LLAMA_SERVES[0][3]),
                         ("prefix", LLAMA_SERVES[1][3]),
                         ("full_reuse", LLAMA_SERVES[1][3]))
    for extra in ({}, dict(mixed_batching=False)))


def serves_card_vs_cpu(cfg, phase, serves, tfm, ForkServer, ServeConfig,
                       SamplingParams, pra):
    """Phase 4: ``cfg`` served on the card and on the CPU from the same
    weights in every (mode, settings, entries) of ``serves``: identical
    greedy tokens, and on the card each serve's entries launched the
    kernels an f32 model runs (``pra.kernel_name``; int8 variants for an
    int8 model).  Logs one ``phase`` line per serve; returns {label:
    tokens}."""
    params = tfm.init_params(cfg, 0, device="cpu")
    lora = tfm.init_lora_stacks(cfg, 1, 8, device="cpu")
    int8 = cfg.kv_quant == "int8"
    got = {}
    for mode, extra, expect in serves:
        sc = ServeConfig(page_size=16, max_pages=128, max_batch=8,
                         max_prefill_tokens=64, max_pages_per_req=16,
                         mode=mode, **extra)
        toks = {}
        for dev in ("cuda", "cpu"):
            p, lo = (tree_map(lambda t: t.to(dev), x) for x in (params, lora))
            srv = ForkServer(cfg, p, lo, sc, device=dev)
            reset_counts(pra)
            outs, m, _ = serve(srv, cfg.vocab_size, 72, 4, 4, 9, 6, 4,
                               SamplingParams)
            check_serving(outs, m, 6, mixed=sc.mixed_batching)
            ran = {k for k, v in pra.LAUNCHES.items() if v}
            want = {pra.kernel_name(e, torch.float32, int8, cfg.lora.rank)
                    for e in expect}
            if dev == "cuda" and not want <= ran:
                raise AssertionError(f"{phase} {mode} {extra}: launched "
                                     f"{sorted(ran)}, not {sorted(want)}")
            toks[dev] = [o.tokens for o in outs]
        if toks["cuda"] != toks["cpu"]:
            raise AssertionError(f"{phase} {mode} {extra}: card "
                                 f"{toks['cuda']} != CPU {toks['cpu']}")
        label = f"{mode}{' phase-separated' if extra else ''}"
        got[label] = toks["cuda"]
        log(phase, mode=mode, **extra, head_dim=cfg.resolved_head_dim,
            kv_quant=cfg.kv_quant, launched=sorted(want),
            tokens=toks["cuda"], ok=True)
    return got


def tiny_d32_card_vs_cpu(tiny, tfm, ForkServer, ServeConfig, SamplingParams,
                         pra):
    """Phase 4: ``tiny_serving_model()`` at its defaults (4 f32 layers,
    d_model 256, 8 heads over 4 kv heads: head_dim 32), the reference
    serve launcher's model, served on the card and on the CPU from the
    same weights in forkkv, prefix and full_reuse, under the mixed and the
    phase-separated loop: identical greedy tokens, and on the card each
    serve's kernels launched (``D32_SERVES``).  Returns {label: tokens}."""
    cfg = tiny()
    if cfg.resolved_head_dim != 32:
        raise AssertionError(f"tiny_serving_model() has head_dim "
                             f"{cfg.resolved_head_dim}, not 32")
    return serves_card_vs_cpu(cfg, "tiny_d32", D32_SERVES, tfm, ForkServer,
                              ServeConfig, SamplingParams, pra)


def small_d120_card_vs_cpu(tiny, tfm, ForkServer, ServeConfig,
                           SamplingParams, pra):
    """Phase 4, head_dim 120: a 2-layer f32 model with h2o-danube-3-4b's
    head geometry (Hq 32 over Hkv 8, head_dim 120; d_model 256) served on
    the card and on the CPU in every mode and loop of ``D32_SERVES``, and
    over int8 pages in forkkv and prefix under both loops: identical
    greedy tokens, each serve's kernels launched at D 120."""
    cfg = dataclasses.replace(tiny(num_layers=2, num_heads=32,
                                   num_kv_heads=8, vocab_size=512),
                              head_dim=120)
    got = serves_card_vs_cpu(cfg, "small_d120", D32_SERVES, tfm, ForkServer,
                             ServeConfig, SamplingParams, pra)
    cfg8 = dataclasses.replace(cfg, kv_quant="int8")
    got.update({f"{k} int8": v for k, v in serves_card_vs_cpu(
        cfg8, "small_d120", [x for x in D32_SERVES if x[0] != "full_reuse"],
        tfm, ForkServer, ServeConfig, SamplingParams, pra).items()})
    return got


def greedy_api(api, params, tokens, n_new, prompt_len, max_len, disagg,
               prefill_kw, kw):
    """``prefill`` of ``prompt_len`` tokens (with ``prefill_kw``, such as
    whisper's frame embeddings) through the model API ``api``, then greedy
    ``decode_step`` s up to ``n_new`` tokens; returns them (B, n_new)."""
    dev = tokens.device
    cache = api.init_cache(tokens.shape[0], max_len, disagg=disagg,
                           device=dev)
    lg, cache = api.prefill(params, tokens[:, :prompt_len], cache,
                            **prefill_kw, **kw)
    out = [lg[:, 0].argmax(-1)]
    kv_len = torch.full((tokens.shape[0],), prompt_len, dtype=torch.int32,
                        device=dev)
    for _ in range(n_new - 1):
        lg, cache = api.decode_step(params, out[-1], cache, kv_len, **kw)
        out.append(lg.argmax(-1))
        kv_len = kv_len + 1
    return torch.stack(out, 1)


def small_families_card_vs_cpu(configs, registry, mods):
    """Phase 4, the SSM and audio families: ``mamba2-130m``'s and
    ``whisper-large-v3``'s ``tiny()`` (f32) on the card and on the CPU from
    the same weights, greedy ``prefill`` + ``decode_step`` tokens identical
    (whisper with its frame embeddings, 4 LoRA adapters and
    ``disagg=True``).  Neither launches a kernel, as neither reaches a
    Pallas kernel in the reference (mamba2's scan is plain code; whisper's
    cached self-attention is the gather path's plain attention and its
    ``forward`` uses plain ``mha``)."""
    for arch in ("mamba2-130m", "whisper-large-v3"):
        cfg = configs.get_tiny_config(arch)
        api = registry.get_model(cfg)
        params = api.init_params(0, device="cpu")
        rng = np.random.default_rng(9)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 24)))
        frames = torch.from_numpy(rng.standard_normal(
            (4, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
        lora = api.init_lora_stacks(1, 4, device="cpu") \
            if api.init_lora_stacks else None
        toks = {}
        for dev in ("cuda", "cpu"):
            p = tree_map(lambda t: t.to(dev), params)
            kw = {} if lora is None else dict(
                lora=tree_map(lambda t: t.to(dev), lora),
                adapter_ids=torch.arange(4, device=dev), disagg=True)
            pre = {"extra_embeds": frames.to(dev)} \
                if cfg.family == "audio" else {}
            reset_counts(*mods)
            toks[dev] = greedy_api(api, p, tokens.to(dev), 12, 16, 32,
                                   lora is not None, pre, kw).cpu()
            if dev == "cuda":
                torch.cuda.synchronize()
                expect_launches(mods, {})
        if not torch.equal(toks["cuda"], toks["cpu"]):
            raise AssertionError(f"{arch} tiny greedy tokens: card "
                                 f"{toks['cuda'].tolist()} != CPU "
                                 f"{toks['cpu'].tolist()}")
        log("small_family", model=cfg.name, family=cfg.family,
            disagg=lora is not None, launches={},
            tokens=toks["cuda"].tolist(), ok=True)


REACT_SC = dict(page_size=16, max_pages=26, max_batch=4,
                max_prefill_tokens=64, mode="forkkv", max_pages_per_req=24,
                host_tier_bytes=64 << 20)
REACT_WF = dict(n_workflows=3, agents_per_workflow=2, rounds=2,
                shared_context_len=256, instr_len=16, tool_obs_len=24,
                max_new_tokens=4, seed=0)
TIER_KEYS = ("tier_hits", "demoted_pages", "promoted_pages",
             "promoted_bytes", "host_evicted_pages", "dropped_device_pages",
             "preemptions", "evicted_pages", "prefilled_tokens", "tasks_done")


def small_tiers_card_vs_cpu(tiny, tfm, Engine, ServeConfig, workflows, pra):
    """Phase 4, tiers: tests/test_tiers.py's ReAct run (3 workflows x 2
    agents x 2 rounds over a 256-token context, 26 device pages, the host
    tier on) with int8 bCache pages, on the card and on the CPU: greedy
    outputs and tier counters equal, pages demoted and promoted back
    (tier_hits > 0), and on the card only int8 variants launched.  The
    model is the test's, ``tiny_serving_model(rank=8)`` (head_dim 32)."""
    cfg = dataclasses.replace(tiny(rank=8), kv_quant="int8")
    params = tfm.init_params(cfg, 0, device="cpu")
    lora = tfm.init_lora_stacks(cfg, 1, 16, device="cpu")
    got = {}
    for dev in ("cuda", "cpu"):
        p, lo = (tree_map(lambda t: t.to(dev), x) for x in (params, lora))
        eng = Engine(cfg, p, lo, ServeConfig(**REACT_SC), device=dev)
        reset_counts(pra)
        rep = workflows.WorkflowDriver(eng, workflows.WorkflowConfig(
            **REACT_WF, vocab=cfg.vocab_size)).run_react()
        ran = {k for k, v in pra.LAUNCHES.items() if v}
        if dev == "cuda" and (not ran or not all("_int8" in k
                                                 for k in ran)):
            raise AssertionError(f"react launched {sorted(ran)}")
        got[dev] = ({k: rep[k] for k in TIER_KEYS},
                    [r.output for r in sorted(eng.done, key=lambda r: r.rid)])
    if got["cuda"] != got["cpu"]:
        raise AssertionError(f"react card {got['cuda']} != CPU {got['cpu']}")
    counters = got["cuda"][0]
    if counters["tier_hits"] < 1 or counters["tasks_done"] != 12:
        raise AssertionError(f"react under pressure: {counters}")
    log("small_tiers", kv_quant="int8", **counters,
        outputs=got["cuda"][1][:3], ok=True)


def page_round_trip(tiny, tfm, Engine, ServeConfig):
    """Phase 4, tiers: on the card, ``export_pages`` → ``import_pages``
    into other pages is bit-identical for bf16 pages and for int8 pages
    with their scales (base and residual pools filled at random)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    src, dst = [3, 5, 6, 9], [20, 11, 30, 2]
    for dtype, quant in (("bfloat16", "none"), ("float32", "int8")):
        cfg = dataclasses.replace(tiny(rank=8, num_layers=2), dtype=dtype,
                                  kv_quant=quant)
        eng = Engine(cfg, tfm.init_params(cfg, 0), tfm.init_lora_stacks(
            cfg, 1, 4), ServeConfig(page_size=16, max_pages=64,
                                     mode="forkkv", host_tier_bytes=1 << 26))
        ex = eng.executor
        pools = {k: v for k, v in ex.pools._asdict().items()
                 if v is not None}
        for t in pools.values():
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, generator=gen,
                                      device="cuda"))
            else:
                t.copy_(torch.rand(t.shape, generator=gen, device="cuda"))
        for kind in ("base", "res"):
            ex.import_pages(kind, dst, ex.export_pages(kind, src))
        torch.cuda.synchronize()
        for name, t in pools.items():
            if not torch.equal(t[:, src].view(torch.uint8),
                               t[:, dst].view(torch.uint8)):
                raise AssertionError(f"{dtype}/{quant} {name}: pages changed "
                                     f"in a round trip")
        log("page_round_trip", dtype=dtype, kv_quant=quant,
            pools=sorted(pools), pages=len(src), ok=True)
        del eng, ex, pools
    torch.cuda.empty_cache()


def persist_restore(tiny, tfm, Engine, Request, ServeConfig):
    """Phase 4, tiers: tests/test_persist.py's acceptance on the card with
    int8 bCache pages and a disk tier below the host tier (its files under
    the persist dir): an engine serves a context then a probe, persists
    every cached prefix; a fresh engine restores the manifest and serves
    the probe with the same greedy tokens, from tier hits (the test's
    model, head_dim 32)."""
    import tempfile
    cfg = dataclasses.replace(tiny(rank=8), kv_quant="int8")
    params = tfm.init_params(cfg, 0)
    lora = tfm.init_lora_stacks(cfg, 1, 16)
    rng = np.random.default_rng(0)
    ctx = [int(t) for t in rng.integers(0, cfg.vocab_size, 64)]
    probe = ctx + [int(t) for t in rng.integers(0, cfg.vocab_size, 8)]

    def run_one(eng, prompt):
        req = Request(rid=0, adapter_id=3, prompt=list(prompt),
                      max_new_tokens=6)
        eng.submit(req)
        while req.state != "done":
            eng.step()
        return req

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        sc = ServeConfig(page_size=16, max_pages=256, max_batch=4,
                         max_prefill_tokens=64, mode="forkkv",
                         max_pages_per_req=12, host_tier_bytes=64 << 20,
                         disk_tier_bytes=64 << 20, persist_dir=d)
        eng1 = Engine(cfg, params, lora, sc)
        run_one(eng1, ctx)
        want = run_one(eng1, probe).output
        n = eng1.persist()
        eng2 = Engine(cfg, params, lora, sc)
        restored = eng2.restore()
        req = run_one(eng2, probe)
    m = eng2.metrics()
    if not (n > 0 and restored == n and req.output == want
            and m["tier_hits"] > 0 and req.prefilled_tokens < len(probe)):
        raise AssertionError(f"persist/restore: {n} pages, {restored} "
                             f"restored, {req.output} vs {want}, tier_hits "
                             f"{m['tier_hits']}, prefilled "
                             f"{req.prefilled_tokens}")
    log("persist_restore", kv_quant="int8", pages=n, tokens=want,
        tier_hits=m["tier_hits"], prefilled_tokens=req.prefilled_tokens,
        ok=True)


# ------------------------------------ speculation, chaos, fair share (§15-17)
# (label, tiny_serving_model settings, adapters) of the speculative serves:
# the defaults (head_dim 32, G 2) and small_model_card_vs_cpu's 2-layer
# model (head_dim 64, G 2)
SPEC_MODELS = (
    ("tiny_d32", {}, 8),
    ("small_d64", dict(rank=16, num_layers=2, d_model=256, num_heads=4,
                       num_kv_heads=2, vocab_size=512), 4),
)
SPEC_PROPOSERS = ("prompt_lookup", "ngram_cache")
SPEC_K = 4
# a verify-only plan pads its q tile to pow2(k + 1); every other plan of
# a mixed launch to at least 32 (the executor's floors)
VERIFY_TILE = 8
# the entry each mode's mixed plans (and so its verify rows) run
MIXED_ENTRY = {"forkkv": "paged_residual_attention_mixed",
               "prefix": "paged_attention_mixed_base",
               "full_reuse": "paged_attention_mixed_base"}
SPEC_KEYS = ("spec_steps", "spec_proposed_tokens", "spec_accepted_tokens",
             "spec_committed_tokens")
SPEC_LINE_KEYS = SPEC_KEYS + ("spec_step_share", "spec_acceptance_rate")
# the re-run serve's instruction length: a context of 2048 tokens and a
# 64-token instruction fill whole pages, and a whole-page prompt hit in
# full (a re-run's) decodes one position past the pages admission gives it
# (ROADMAP Queue 3); with 65 a re-run prefills its last token
RERUN_INSTR = 65
# the launcher's flags for speculation and fair-share admission
SPEC_FLAGS = ("--speculate", "--admission", "fairshare")


def serve_replayed(server, vocab, max_new, sampling_cls):
    """The speculative axis of the reference's parity matrix
    (tests/test_parity_matrix.py:72-125): one pinned 40-token context, two
    staggered forks (adapters 1 and 2) whose instructions quote the
    context, then a replay of the first fork, which the ngram cache,
    warmed when the first finished, drafts whole.  Returns (outputs,
    metrics, seconds)."""
    rng = np.random.default_rng(7)
    ctx = [int(t) for t in rng.integers(0, vocab, 40)]
    sp = sampling_cls(max_new_tokens=max_new)
    t0 = time.perf_counter()
    with server.session(ctx, adapter_id=0) as sess:
        handles = [sess.fork(1, ctx[:5], sp)]
        for _ in range(3):                 # the first fork reaches decode
            server.poll()
        handles.append(sess.fork(2, ctx[:6], sp))
        outs = server.wait(handles)
        outs += server.wait([sess.fork(1, ctx[:5], sp)])
    return (outs,) + drained_metrics(server, t0)


def verify_launches(shapes):
    """{mixed entry: launches} of the launches ``shapes`` recorded whose
    query tile is a verify-only plan's (at most ``VERIFY_TILE`` wide)."""
    out = {}
    for name, _, sq, *_ in shapes.raw:
        if ALL_KERNELS[name][0] == "mixed" and sq <= VERIFY_TILE:
            out[name] = out.get(name, 0) + 1
    return out


def spec_card_vs_cpu(tiny, tfm, ForkServer, ServeConfig, SamplingParams,
                     pra):
    """Phase 4, speculative decoding (DESIGN.md §16): each model of
    ``SPEC_MODELS`` (f32) served in forkkv, prefix and full_reuse under
    the mixed loop with ``speculate=True``, ``spec_k`` 4, fixed k, with
    each proposer: greedy tokens equal on the card, on the CPU and on the
    card with speculation off; the speculation real on both devices with
    the same counters; no gather; both pools back to baseline after close
    and evict; on the card the mode's mixed entry (#1 forkkv, #3 prefix
    and full_reuse) launched at a verify plan's q tile.  Returns
    {(model, mode, proposer): spec counters}."""
    got = {}
    for label, kw, n_adapters in SPEC_MODELS:
        cfg = tiny(**kw)
        params = tfm.init_params(cfg, 0, device="cpu")
        lora = tfm.init_lora_stacks(cfg, 1, n_adapters, device="cpu")
        weights = {dev: tuple(tree_map(lambda t: t.to(dev), x)
                              for x in (params, lora))
                   for dev in ("cuda", "cpu")}
        for mode in MIXED_ENTRY:
            kernel = pra.kernel_name(MIXED_ENTRY[mode], torch.float32, False,
                                     cfg.lora.rank)
            for proposer in SPEC_PROPOSERS:
                toks, counters = {}, {}
                for dev, spec in (("cuda", True), ("cpu", True),
                                  ("cuda", False)):
                    sc = ServeConfig(page_size=16, max_pages=96, max_batch=4,
                                     max_prefill_tokens=48,
                                     max_pages_per_req=8, mode=mode,
                                     speculate=spec, spec_k=SPEC_K,
                                     spec_adaptive=False,
                                     spec_proposer=proposer)
                    srv = ForkServer(cfg, *weights[dev], sc, device=dev)
                    reset_counts(pra)
                    with LaunchShapes(pra) as shapes:
                        outs, m, _ = serve_replayed(srv, cfg.vocab_size, 8,
                                                    SamplingParams)
                    check_serving(outs, m, 8)
                    if spec:
                        counters[dev] = {k: m[k] for k in SPEC_KEYS}
                        if not all(counters[dev].values()):
                            raise AssertionError(
                                f"{label} {mode} {proposer} on {dev}: no "
                                f"accepted draft: {counters[dev]}")
                    elif m["spec_steps"]:
                        raise AssertionError("speculation off ran "
                                             "verify steps")
                    if dev == "cuda" and spec:
                        verify = verify_launches(shapes).get(MIXED_ENTRY[mode],
                                                             0)
                        if not verify or not pra.LAUNCHES[kernel]:
                            raise AssertionError(
                                f"{label} {mode} {proposer}: {kernel} ran "
                                f"{pra.LAUNCHES[kernel]} times, {verify} "
                                f"at a verify q tile")
                    toks[(dev, spec)] = [o.tokens for o in outs]
                if len({str(t) for t in toks.values()}) != 1 or \
                        counters["cuda"] != counters["cpu"]:
                    raise AssertionError(f"{label} {mode} {proposer}: "
                                         f"tokens {toks}, counters "
                                         f"{counters}")
                got[(label, mode, proposer)] = counters["cuda"]
                log("spec_card_vs_cpu", model=label,
                    head_dim=cfg.resolved_head_dim, mode=mode,
                    proposer=proposer, spec_k=SPEC_K, launched=kernel,
                    verify_launches=verify, **counters["cuda"],
                    tokens=toks[("cuda", True)], ok=True)
    return got


# (plan, seed, requests (prompt length, max_new, adapter), drain_after,
# max_pages) of tests/test_chaos.py:105-130
CHAOS_SCHEDULES = {
    "preempt_quarantine": ("nan_logits:r3", 5,
                           [(40, 12, 1), (40, 6, 2), (36, 6, 3), (38, 6, 4)],
                           None, 10),
    "drain_mid_flight": ("", 6, [(40, 10, 1), (40, 10, 2), (40, 10, 3)], 2,
                         10),
    "executor_storm": ("executor:c2,c5;pool_alloc:c5,c6", 7,
                       [(40, 8, 1), (38, 8, 2), (36, 8, 3)], None, 12),
}
TERMINAL = {"stop", "length", "rejected", "stalled", "timeout", "error",
            "draining"}
CHAOS_KEYS = ("exec_errors", "quarantined", "faults_fired",
              "preempted_requests", "restored_requests", "steps", "drained")


def chaos_schedule(ForkServer, ServeConfig, SamplingParams, cfg, params,
                   lora, device, plan, seed, req_specs, drain_after,
                   max_pages):
    """tests/test_chaos.py's ``run_schedule`` on ``device``: submit the
    requests under the fault plan (a small pool, ``preempt_after_steps``
    1), poll to quiescence, calling drain() after ``drain_after`` polls or
    at quiescence, whichever comes first, and hold its invariants: every
    request terminal, drained when drained, no page leaked once the trees
    let go, counters moved only by fired faults, no gather — and every
    executor failure an injected one (``exec_errors ==
    faults_fired["fault_executor"]``), so a failing kernel cannot hide
    among them.  Returns what the two devices must agree on."""
    sc = ServeConfig(page_size=16, max_pages=max_pages, max_batch=4,
                     max_prefill_tokens=64, mode="forkkv",
                     max_pages_per_req=8, preempt_after_steps=1,
                     fault_plan=plan, fault_seed=seed)
    server = ForkServer(cfg, params, lora, sc, device=device)
    eng = server.engine
    rng = np.random.default_rng(seed)
    handles = [server.generate(aid, [int(t) for t in rng.integers(
        0, cfg.vocab_size, plen)], SamplingParams(max_new_tokens=max_new))
        for plen, max_new, aid in req_specs]
    polls, drained_at = 0, None
    while True:
        quiet = not (eng.waiting or eng.running)
        if drain_after is not None and drained_at is None and (
                polls == drain_after or quiet):
            server.drain()
            drained_at = polls
        if quiet:
            break
        server.poll()
        polls += 1
        if polls >= 2000:
            raise AssertionError(f"{plan}: no quiescence in 2000 polls")
    outs = [h.result() for h in handles]
    bad = [o.finish_reason for o in outs
           if o.finish_reason not in TERMINAL or
           (o.finish_reason == "error" and not o.error)]
    if bad or (drained_at is not None and not eng.drained):
        raise AssertionError(f"{plan}: finish reasons {bad}, drained "
                             f"{eng.drained}")
    eng.dual.base.evict(eng.sc.max_pages)
    eng.dual.residual.evict(eng.res_pool.num_pages)
    if eng.base_pool.free_pages != eng.sc.max_pages - 1 or \
            eng.res_pool.free_pages != eng.res_pool.num_pages - 1:
        raise AssertionError(f"{plan}: pages leaked")
    m = server.metrics()
    fired = m["faults_fired"]
    if (m["quarantined"] and not fired.get("fault_nan_logits", 0)) or \
            m["exec_errors"] != fired.get("fault_executor", 0) or \
            m["restored_requests"] > m["preempted_requests"] or \
            m["fallback_gather_calls"]:
        raise AssertionError(f"{plan}: counters "
                             f"{ {k: m[k] for k in CHAOS_KEYS} }")
    return dict(reasons=[o.finish_reason for o in outs],
                tokens=[list(o.tokens) for o in outs], polls=polls,
                drained_at=drained_at, **{k: m[k] for k in CHAOS_KEYS})


def chaos_card_vs_cpu(tiny, tfm, ForkServer, ServeConfig, SamplingParams,
                      pra):
    """Phase 4, fault tolerance (DESIGN.md §17): the three deterministic
    schedules of tests/test_chaos.py on the card and on the CPU, the
    test's model (``tiny_serving_model(rank=8)``, head_dim 32, f32):
    ``chaos_schedule``'s invariants on each device, and the same finish
    reasons, greedy tokens, polls and counters on both; on the card the
    forkkv kernels launched."""
    cfg = tiny(rank=8)
    params = tfm.init_params(cfg, 0, device="cpu")
    lora = tfm.init_lora_stacks(cfg, 1, 16, device="cpu")
    for name, schedule in CHAOS_SCHEDULES.items():
        got = {}
        for dev in ("cuda", "cpu"):
            p, lo = (tree_map(lambda t: t.to(dev), x) for x in (params, lora))
            reset_counts(pra)
            got[dev] = chaos_schedule(ForkServer, ServeConfig,
                                      SamplingParams, cfg, p, lo, dev,
                                      *schedule)
            if dev == "cuda":
                ran = sorted(k for k, v in pra.LAUNCHES.items() if v)
        want = {pra.kernel_name(e, torch.float32, False, cfg.lora.rank)
                for e in LLAMA_SERVES[0][3]}
        if not want <= set(ran):
            raise AssertionError(f"chaos {name} launched {ran}")
        if got["cuda"] != got["cpu"]:
            raise AssertionError(f"chaos {name}: card {got['cuda']} != CPU "
                                 f"{got['cpu']}")
        log("chaos_card_vs_cpu", schedule=name, plan=schedule[0],
            seed=schedule[1], launched=ran, **got["cuda"], ok=True)


# two tenants, the heavier-weighted first, over 16 pages (room for three or
# four of these requests at a time): (tenant, prompt length) in
# submission order
FAIR_REQUESTS = (("a", 40), ("a", 56), ("a", 48), ("a", 64), ("a", 44),
                 ("b", 52), ("b", 36), ("b", 60))
FAIR_SC = dict(page_size=16, max_pages=16, max_batch=4,
               max_prefill_tokens=64, max_pages_per_req=8, mode="forkkv",
               admission="fairshare", tenant_weights=(("a", 3.0),
                                                      ("b", 1.0)),
               fair_aging_tokens_per_s=0.0)


def fairshare_card_vs_cpu(tiny, tfm, ForkServer, ServeConfig, SamplingParams,
                          pra):
    """Phase 4, fair-share admission (DESIGN.md §15): eight requests of
    two tenants weighted 3:1 (``FAIR_REQUESTS``), submitted together to a
    pool that holds three or four, on the card and on the CPU
    (``tiny_serving_model()``, f32).  Aging is off, so each decision
    depends on the served tokens only, not on the host's clock.  The
    admission order (the requests admitted at each poll), the greedy
    tokens and the per-tenant admission counters must be equal, the queue
    must really have waited, and on the card #1 and #2 launched."""
    cfg = tiny()
    params = tfm.init_params(cfg, 0, device="cpu")
    lora = tfm.init_lora_stacks(cfg, 1, 8, device="cpu")
    got = {}
    for dev in ("cuda", "cpu"):
        p, lo = (tree_map(lambda t: t.to(dev), x) for x in (params, lora))
        server = ForkServer(cfg, p, lo, ServeConfig(**FAIR_SC), device=dev)
        eng = server.engine
        rng = np.random.default_rng(13)
        handles = [server.generate(i % 4, [int(t) for t in rng.integers(
            0, cfg.vocab_size, plen)], SamplingParams(max_new_tokens=4),
            tenant=tenant) for i, (tenant, plen) in enumerate(FAIR_REQUESTS)]
        reqs = list(eng.waiting)
        reset_counts(pra)
        order, polls, seen = [], 0, set()
        while eng.waiting or eng.running:
            server.poll()
            polls += 1
            new = sorted(r.rid for r in reqs
                         if r.admitted_at and r.rid not in seen)
            if new:
                order.append((polls, new))
                seen.update(new)
            if polls >= 2000:
                raise AssertionError("fair share: no quiescence")
        outs = [h.result() for h in handles]
        m = server.metrics()
        if any(o.finish_reason != "length" for o in outs) or \
                m["exec_errors"] or len(order) < 2:
            raise AssertionError(f"fair share on {dev}: "
                                 f"{[o.finish_reason for o in outs]}, "
                                 f"order {order}")
        if dev == "cuda":
            ran = sorted(k for k, v in pra.LAUNCHES.items() if v)
        got[dev] = dict(order=order, tokens=[list(o.tokens) for o in outs],
                        tenants=m["tenants"], steps=m["steps"],
                        preemptions=m["preemptions"])
    if got["cuda"] != got["cpu"]:
        raise AssertionError(f"fair share: card {got['cuda']} != CPU "
                             f"{got['cpu']}")
    want = {pra.kernel_name(e, torch.float32, False, cfg.lora.rank)
            for e in LLAMA_SERVES[0][3]}
    if not want <= set(ran):
        raise AssertionError(f"fair share launched {ran}")
    log("fairshare_card_vs_cpu", weights=dict(FAIR_SC["tenant_weights"]),
        submitted=[t for t, _ in FAIR_REQUESTS], launched=ran,
        **got["cuda"], ok=True)


# ------------------------------------------------------------------ zoo
# The transformer family of the model zoo at full width (bf16, random
# weights from seed 0, 4 adapters of rank 16), one model at a time, each
# freed before the next: (arch, layers run or None for all, what it runs).
# Depth is cut where one card's 80 GB cannot hold the model: dbrx-132b's 40
# layers would take ~254 GB of weights, 2 take ~15 GB; llama4-maverick's 48
# ~37 GB per pair of layers (one dense, one MoE sublayer of 128 experts and
# the shared expert), so one pair; llama3-405b's 126 ~6.3 GB each beside
# ~8 GB of embeddings, so 2.
ZOO_MODELS = (
    ("dbrx-132b", 2, ("serve", "dense")),
    ("starcoder2-3b", None, ("serve", "dense")),
    ("internlm2-1.8b", None, ("serve", "dense")),
    ("llama3-405b", 2, ("serve", "dense")),
    ("h2o-danube-3-4b", None, ("serve", "phase-separated", "dense", "cache",
                               "f32")),
    ("llava-next-mistral-7b", None, ("patches",)),
    ("llama4-maverick-400b-a17b", 2, ("dense", "cache")),
    ("mamba2-130m", None, ("ssm",)),
    ("whisper-large-v3", None, ("audio",)),
)
ZOO_SERVE = dict(ctx=1024, forks=4, adapters=4, instr=64, new=8)
ZOO_SERVES = LLAMA_SERVES[:2]          # forkkv and prefix, mixed loop
# with "phase-separated": the same two under the phase-separated loop (#5
# and #2, #6 and #4)
ZOO_PHASE_SERVES = LLAMA_SERVES[2:4]
ZOO_SC = dict(max_pages=1024, max_pages_per_req=128)


class DropShare:
    """While entered, wraps ``tfm.moe_route`` (it calls through) to count
    the (token, expert) assignments routed at every MoE layer call and
    those dropped past an expert's capacity; the drops are summed on the
    card and read once, at exit."""

    def __init__(self, tfm):
        self.tfm, self.routed, self.parts, self.dropped = tfm, 0, [], 0

    def __enter__(self):
        self.orig = self.tfm.moe_route

        def route(*args, **kw):
            out = self.orig(*args, **kw)
            self.routed += out[2].numel()
            self.parts.append((~out[2]).sum())
            return out
        self.tfm.moe_route = route
        return self

    def __exit__(self, *exc):
        self.tfm.moe_route = self.orig
        self.dropped = int(sum(int(p) for p in self.parts))

    def share(self):
        return self.dropped / self.routed if self.routed else None


def zoo_model(arch, depth, runs, tfm, configs, mods, pra, ref, first,
              ForkServer, ServeConfig, SamplingParams, card, shapes):
    """One zoo model at full width (``depth`` layers where given): init,
    then what ``runs`` names, each with the launch counts zeroed just
    before it and checked just after:

    * "serve": the staggered serve (``ZOO_SERVE``: a 1024-token session, 4
      forks over 4 adapters, 8 greedy tokens) through ``ForkServer`` in
      forkkv and prefix mode under the mixed loop, which must launch #1/#2
      and #3/#4 (``check_counts``), each logged with tokens per second,
      TTFT and TPOT p50, peak base and residual pages and cache bytes;
      at head_dim 120 every launch's geometry goes to ``shapes``;
    * "phase-separated": the same serves under the phase-separated loop,
      which must launch #5/#2 and #6/#4;
    * "dense": ``forward(disagg=True)`` on 4 x 1000 tokens over adapters
      0-3 (#7 once per layer; for an MoE model the share of assignments
      dropped at the default capacity factor) and at one token (#8 once
      per layer);
    * "cache": ``prefill`` of 600 tokens + 16 ``decode_step`` s (8 for an
      MoE model) over a 1024-slot cache (no attention kernel: the model
      API's cached attention is the gather path's plain torch);
    * "f32": the model API again on f32 copies of the weights
      (``dense_api``: the scalar kernels), where disaggregated ``forward``
      must agree with the unified one, ``forward`` at one token with
      position 0 and ``prefill`` + 16 ``decode_step`` s with ``forward``,
      within ``MODEL_TOL``;
    * "patches": the VLM's ``forward(disagg=True)`` on 2880 patch
      embeddings (through ``mm_projector``) + 120 tokens (3000 positions:
      the blocked flash path, no kernel), ``forward`` at one token (#8),
      and ``prefill`` of the patches + 120 tokens + 16 ``decode_step`` s.

    Logs one ``zoo`` line (times in ms, peak memory, launches by counter);
    returns the launches of its main path by counter (the serves' paged
    kernels and the dense kernels)."""
    cfg = configs.get_config(arch)
    full = cfg.num_layers
    if depth:
        cfg = dataclasses.replace(cfg, num_layers=depth)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, 0)
    lora = tfm.init_lora_stacks(cfg, 1, 4)
    torch.cuda.synchronize()
    leaves = []
    tree_map(leaves.append, params)
    rec = dict(model=arch, layers=cfg.num_layers, full_layers=full,
               d_model=cfg.d_model, heads=[cfg.num_heads, cfg.num_kv_heads],
               head_dim=cfg.resolved_head_dim, window=cfg.sliding_window,
               experts=cfg.num_experts, mlp=cfg.mlp_activation,
               init_seconds=time.perf_counter() - t0,
               param_gib=sum(t.numel() * t.element_size()
                             for t in leaves) / 2 ** 30)
    del leaves
    n, bsz = cfg.num_layers, 4
    rng = np.random.default_rng(21)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (bsz, 1000))).cuda()
    kw = dict(lora=lora, adapter_ids=torch.arange(bsz, device="cuda"))
    launches, ms, dense = {}, {}, {}

    def counted(label, fn, want, counter=dense):
        reset_counts(*mods)
        t0 = time.perf_counter()
        with first:
            out = fn()
        torch.cuda.synchronize()
        ms[label] = (time.perf_counter() - t0) * 1e3
        got = expect_launches(mods, want)
        launches[label] = got
        for k, v in got.items():
            counter[k] = counter.get(k, 0) + v
        return out

    serves = (ZOO_SERVES if "serve" in runs else ()) + \
        (ZOO_PHASE_SERVES if "phase-separated" in runs else ())
    record = shapes if cfg.resolved_head_dim == D120 else None
    for label, mode, extra, expect in serves:
        server = ForkServer(cfg, params, lora,
                            ServeConfig(mode=mode, **ZOO_SC, **extra))
        reset_counts(*mods)
        z = ZOO_SERVE
        if record is not None:
            record.__enter__()
        try:
            outs, m, seconds = serve(server, cfg.vocab_size, z["ctx"],
                                     z["forks"], z["adapters"], z["instr"],
                                     z["new"], seed=22,
                                     sampling_cls=SamplingParams)
        finally:
            if record is not None:
                record.__exit__(None, None, None)
        ran = check_counts(
            pra, ref, [pra.kernel_name(e, cfg.activation_dtype, False)
                       for e in expect], cfg.activation_dtype)
        launches[f"serve {label}"] = ran
        for k, v in ran.items():
            dense[k] = dense.get(k, 0) + v
        check_serving(outs, m, z["new"], mixed=server.engine.sc.mixed_batching)
        ms[f"serve {label}"] = seconds * 1e3
        rec[f"serve {label}"] = dict(
            tokens_per_s=sum(len(o.tokens) for o in outs) / seconds,
            ttft_p50_ms=m["ttft_p50_ms"], tpot_p50_ms=m["tpot_p50_ms"],
            steps=m["steps"], mixed_steps=m["mixed_steps"],
            peak_base_pages=m["peak_base_pages"],
            peak_res_pages=m["peak_res_pages"],
            peak_cache_bytes=m["peak_cache_bytes"],
            tokens=[o.tokens for o in outs[:2]])
        # the server holds the weights in reference cycles: collect them
        # now, or every model's weights outlive it
        del server, outs
        gc.collect()
        torch.cuda.empty_cache()
    if "dense" in runs:
        with DropShare(tfm) as drops:
            counted("forward", lambda: tfm.forward(
                params, tokens, cfg, disagg=True, **kw),
                {dense_prefill(cfg): n})
        if cfg.num_experts:
            rec["moe_dropped_share"] = drops.share()
            rec["moe_capacity_factor"] = cfg.moe_capacity_factor
        counted("forward_s1", lambda: tfm.forward(
            params, tokens[:, :1], cfg, disagg=True, **kw),
            {dense_decode(cfg): n})
    if "cache" in runs:
        steps = 8 if cfg.num_experts else 16
        out, times = prefill_decode(tfm, cfg, params, tokens, 600, steps,
                                    1024, kw)
        if not torch.isfinite(out.float()).all():
            raise AssertionError(f"{arch}: non-finite prefill/decode logits")
        ms.update(times)
        del out
    if "f32" in runs:
        f32 = lambda t: tree_map(lambda x: x.float(), t)  # noqa: E731
        cfg32 = dataclasses.replace(cfg, dtype="float32")

        def counted32(fn, want):
            label = "f32 forward" if dense_prefill(cfg32) in want else \
                "f32 forward_s1"
            return counted(label, fn, want, {}), ms[label]

        out, times = dense_api(tfm, cfg32, f32(params), f32(lora), tokens,
                               counted32, 600, 16)
        gaps = dense_gaps(out, 600, 16)
        del out
        torch.cuda.empty_cache()
        rec["f32"] = dict(gaps, tol=MODEL_TOL, **times)
        for what, g in gaps.items():
            if not g["within_model_tol"]:
                raise AssertionError(f"{arch} f32 {what}: {g} not within "
                                     f"{MODEL_TOL}")
    if "patches" in runs:
        b1 = dict(lora=lora, adapter_ids=torch.arange(1, device="cuda"))
        gen = torch.Generator(device="cuda")
        gen.manual_seed(23)
        patches = (torch.randn((1, cfg.num_patches, cfg.d_model),
                               generator=gen, device="cuda") * 0.02).to(
            cfg.activation_dtype)
        logits = counted("forward_patches", lambda: tfm.forward(
            params, tokens[:1, :120], cfg, extra_embeds=patches,
            disagg=True, **b1), {})
        if logits.shape != (1, cfg.num_patches + 120, cfg.vocab_size) or \
                not torch.isfinite(logits.float()).all():
            raise AssertionError(f"{arch}: forward with patches gave "
                                 f"{tuple(logits.shape)} / non-finite")
        del logits
        counted("forward_s1", lambda: tfm.forward(
            params, tokens[:, :1], cfg, disagg=True, **kw),
            {dense_decode(cfg): n})
        cache = tfm.init_cache(cfg, 1, cfg.num_patches + 256, disagg=True)
        t0 = time.perf_counter()
        lg, cache = tfm.prefill(params, tokens[:1, :120], cache, cfg,
                                extra_embeds=patches, disagg=True, **b1)
        torch.cuda.synchronize()
        ms["prefill_patches_ms"] = (time.perf_counter() - t0) * 1e3
        kv_len = torch.full((1,), cfg.num_patches + 120, dtype=torch.int32,
                            device="cuda")
        t0 = time.perf_counter()
        for t in range(16):
            lg, cache = tfm.decode_step(params, lg.argmax(-1).reshape(1),
                                        cache, kv_len, cfg, disagg=True,
                                        **b1)
            kv_len = kv_len + 1
        torch.cuda.synchronize()
        ms["decode_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / 16
        if not torch.isfinite(lg.float()).all():
            raise AssertionError(f"{arch}: non-finite decode logits")
        del cache, lg
    log("zoo", card=card, **rec, ms=ms, launches=launches,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30, ok=True)
    del params, lora, tokens
    gc.collect()
    torch.cuda.empty_cache()
    return dense


def zoo_family(arch, runs, configs, registry, mods, card):
    """One zoo model of the SSM or audio family at full width and depth,
    bf16, random weights from seed 0, through the model API
    (``registry.get_model``), each call with the launch counts zeroed just
    before it and checked just after (no kernel: neither family reaches a
    Pallas kernel in the reference, see ``small_families_card_vs_cpu``):

    * "ssm" (mamba2-130m, 24 layers): ``forward`` on 4 x 1000 tokens, then
      ``prefill`` of 600 tokens + 32 ``decode_step`` s;
    * "audio" (whisper-large-v3, 32 encoder and 32 decoder layers): 1500
      stub frame embeddings per row from the seed, 4 LoRA adapters of rank
      16, ``disagg=True``: ``forward`` on 4 x 448 tokens (the decoder's
      length), ``prefill`` of a 64-token prompt with the frames (the
      encoder and the cross cache) + 32 ``decode_step`` s.

    Logs one ``zoo`` line (init seconds, ms per call, peak memory,
    launches); returns its launches (none)."""
    cfg = configs.get_config(arch)
    api = registry.get_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(0)
    lora = api.init_lora_stacks(1, 4) if api.init_lora_stacks else None
    torch.cuda.synchronize()
    leaves = []
    tree_map(leaves.append, params)
    rec = dict(model=arch, family=cfg.family, layers=cfg.num_layers,
               encoder_layers=cfg.num_encoder_layers, d_model=cfg.d_model,
               init_seconds=time.perf_counter() - t0,
               param_gib=sum(t.numel() * t.element_size()
                             for t in leaves) / 2 ** 30)
    del leaves
    bsz = 4
    rng = np.random.default_rng(21)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (bsz, 1000))).cuda()
    kw = {} if lora is None else dict(
        lora=lora, adapter_ids=torch.arange(bsz, device="cuda"), disagg=True)
    pre = {}
    if "audio" in runs:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(23)
        pre["extra_embeds"] = (torch.randn(
            (bsz, cfg.encoder_seq, cfg.d_model), generator=gen,
            device="cuda") * 0.02).to(cfg.activation_dtype)
    fwd_len, prompt, steps = (448, 64, 32) if "audio" in runs else \
        (1000, 600, 32)
    ms, launches = {}, {}

    def counted(label, fn):
        reset_counts(*mods)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[label] = (time.perf_counter() - t0) * 1e3
        launches[label] = expect_launches(mods, {})
        return out

    logits = counted("forward", lambda: api.forward(
        params, tokens[:, :fwd_len], **pre, **kw))
    if logits.shape != (bsz, fwd_len, cfg.vocab_size) or \
            not torch.isfinite(logits.float()).all():
        raise AssertionError(f"{arch}: forward gave {tuple(logits.shape)} "
                             f"/ non-finite")
    del logits
    cache = api.init_cache(bsz, prompt + steps, disagg=lora is not None)
    lg, cache = counted("prefill", lambda: api.prefill(
        params, tokens[:, :prompt], cache, **pre, **kw))

    def decode():
        kv_len = torch.full((bsz,), prompt, dtype=torch.int32, device="cuda")
        out = None
        for t in range(prompt, prompt + steps):
            out, _ = api.decode_step(params, tokens[:, t], cache, kv_len,
                                     **kw)
            kv_len = kv_len + 1
        return out

    lg = counted("decode", decode)
    ms["decode_ms_per_step"] = ms["decode"] / steps
    if lg.shape != (bsz, cfg.vocab_size) or \
            not torch.isfinite(lg.float()).all():
        raise AssertionError(f"{arch}: decode gave {tuple(lg.shape)} / "
                             f"non-finite")
    log("zoo", card=card, **rec, forward_tokens=[bsz, fwd_len],
        prompt=prompt, decode_steps=steps, ms=ms, launches=launches,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30, ok=True)
    del params, lora, tokens, cache, lg, pre
    gc.collect()
    torch.cuda.empty_cache()
    return {}


def zoo(tfm, configs, registry, mods, pra, ref, ra, ForkServer, ServeConfig,
        SamplingParams, card):
    """Phase 5, zoo: every ``ZOO_MODELS`` entry in turn (``zoo_model``; the
    SSM and audio families ``zoo_family``).  Returns (the main path's
    launches per model, the first dense launches of the head_dim-120 model
    and the geometries of its serves' paged launches, as phase 6's
    cases)."""
    dense, d120 = {}, None
    shapes = LaunchShapes(pra)
    t0 = time.perf_counter()
    for arch, depth, runs in ZOO_MODELS:
        t1 = time.perf_counter()
        if configs.get_config(arch).family in ("ssm", "audio"):
            dense[arch] = zoo_family(arch, runs, configs, registry, mods,
                                     card)
        else:
            first = FirstLaunch(ra)
            dense[arch] = zoo_model(arch, depth, runs, tfm, configs, mods,
                                    pra, ref, first, ForkServer, ServeConfig,
                                    SamplingParams, card, shapes)
            if configs.get_config(arch).resolved_head_dim == D120:
                d120 = first.cases
        log("zoo_seconds", model=arch, seconds=time.perf_counter() - t1)
    log("zoo_done", models=[m[0] for m in ZOO_MODELS],
        seconds=time.perf_counter() - t0)
    return dense, d120, shapes.launches()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU "
              "machine", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no repro_torch package under {SRC}; run from "
              f"the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch import configs
    from repro_torch.configs.paper_models import (LLAMA3_8B,
                                                  tiny_serving_model)
    from repro_torch.configs.recurrentgemma_9b import CONFIG as RG9B
    from repro_torch.core.config import ServeConfig
    from repro_torch.kernels import _build
    from repro_torch.kernels import paged_residual_attention as pra
    from repro_torch.kernels import ref
    from repro_torch.kernels import residual_attention as ra
    from repro_torch.kernels import rg_lru as rg
    from repro_torch.configs.recurrentgemma_9b import tiny as rg_tiny
    from repro_torch.models import base as tbase
    from repro_torch.models import hybrid, registry
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import workflows
    from repro_torch.serving.api import ForkServer
    from repro_torch.serving.engine import Engine, Request
    from repro_torch.serving.executor import pool_bytes
    from repro_torch.serving.frontend import ForkClient, HttpError, \
        HttpFrontend
    from repro_torch.serving.sampling import SamplingParams
    from repro_torch.training import data as tdata
    from repro_torch.training import optimizer as toptim
    from repro_torch.training import train_loop
    from repro_torch.core.config import ShapeConfig
    from repro_torch.launch import analytic as tana
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import roofline as troof
    from repro_torch.launch import steps as tsteps

    t_start = time.perf_counter()
    # 1. environment
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("environment", card=card, torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
        python=sys.version.split()[0], allow_tf32=False)

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    sources = (pra, ra, rg)
    mods = sources + (ref,)          # every launch counter
    with ThreadPoolExecutor(len(sources)) as pool:
        for f in [pool.submit(m.build) for m in sources]:
            f.result()
    names = pra.SOURCES + (ra.SOURCE, rg.SOURCE)
    log("build", seconds=time.perf_counter() - t0,
        cached=[n for n in names if n not in _build.BUILD_LOGS])
    for name in names:
        for kernel, use in ptxas_kernels(
                _build.BUILD_LOGS.get(name, "")).items():
            log("ptxas", source=name, kernel=kernel, **use)
    # 3. kernels against their plain versions
    check_kernels(pra, ref, tfm.quantize_kv)
    check_edges(pra, ref, tfm.quantize_kv)
    time_decode_launches(pra, ref, tfm.quantize_kv)
    check_dense_kernels(ra, ref)
    check_scan_kernels(rg, ref)
    # (j) LoRA ranks 33-64 (the RP 64 instances), the bf16 cases at D 128
    # timed at ranks 32 and 64; the scan's backward; the grad guard
    log("rank64_times", card=card, kernels=[
        {k: r[k] for k in ("kernel", "ran", "case", "rank", "kernel_ms",
                           "plain_ms", "library_ms", "bound_ms", "bound_by",
                           "max_abs_err")}
        for r in check_rank64(pra, ref, ra, tfm.quantize_kv)])
    # LoRA ranks above 64 (the chunked instances), timed at ranks 64, 128
    # and 256
    log("rchunk_times", card=card, kernels=[
        {k: r[k] for k in ("kernel", "ran", "case", "rank", "kernel_ms",
                           "was_ms", "plain_ms", "library_ms", "x_sdpa",
                           "bound_ms", "bound_by", "max_abs_err")}
        for r in check_rank_chunks(pra, ref, ra, tfm.quantize_kv)])
    check_scan_bwd_kernels(rg, ref)
    check_grad_guard(ra)
    # (a) every kernel at head_dim 32, the bf16 ones timed
    log("d32_times", card=card, kernels=[
        {k: r[k] for k in ("kernel", "ran", "case", "kernel_ms", "plain_ms",
                           "library_ms", "bound_ms", "bound_by",
                           "max_abs_err")}
        for r in check_d32(pra, ref, tfm.quantize_kv) +
        check_dense_d32(ra, ref)])
    # (e) the dense kernels at head_dim 120 (h2o-danube-3-4b's), the bf16
    # ones timed, their bound counted at D 120
    log("d120_times", card=card, kernels=[
        {k: r[k] for k in ("kernel", "ran", "case", "kernel_ms", "plain_ms",
                           "library_ms", "bound_ms", "bound_by",
                           "max_abs_err")}
        for r in check_dense_d120(ra, ref) + check_d120(pra, ref,
                                                        tfm.quantize_kv)])
    # (g) pages of 64 tokens, run as sub-pages of 32
    check_page64(pra, ref, tfm.quantize_kv)
    # (h) the dense kernels without RoPE at whisper's decoder heads
    check_dense_identity(ra, ref)

    # 4. small models: card vs CPU
    small_model_card_vs_cpu(tiny_serving_model, tfm, ForkServer,
                            ServeConfig, SamplingParams, pra)
    # (b) tiny_serving_model() at its defaults, head_dim 32
    tiny_d32_card_vs_cpu(tiny_serving_model, tfm, ForkServer, ServeConfig,
                         SamplingParams, pra)
    # (j) tiny_serving_model() at rank 64: forkkv under both loops
    serves_card_vs_cpu(tiny_serving_model(rank=64), "tiny_rank64",
                       D32_SERVES[:2], tfm, ForkServer, ServeConfig,
                       SamplingParams, pra)
    # ... and at rank 128: the chunked instances of #1, #2 and #5
    serves_card_vs_cpu(tiny_serving_model(rank=128), "tiny_rank128",
                       D32_SERVES[:2], tfm, ForkServer, ServeConfig,
                       SamplingParams, pra)
    # (i) head_dim 120 served in every mode and loop; the SSM and audio
    # families' tiny models
    small_d120_card_vs_cpu(tiny_serving_model, tfm, ForkServer, ServeConfig,
                           SamplingParams, pra)
    small_families_card_vs_cpu(configs, registry, mods)
    small_dense_card_vs_cpu(tiny_serving_model, tfm, mods)
    small_hybrid_card_vs_cpu(hybrid, RG9B, mods)
    small_tiers_card_vs_cpu(tiny_serving_model, tfm, Engine, ServeConfig,
                            workflows, pra)
    page_round_trip(tiny_serving_model, tfm, Engine, ServeConfig)
    persist_restore(tiny_serving_model, tfm, Engine, Request, ServeConfig)
    # (d) the serve launcher's HTTP drain, as a process of its own
    log("cli_http_drain", **cli_http_drain(ForkClient, HttpError), ok=True)
    # (m) speculative decoding, the chaos fault schedules and fair-share
    # admission, card vs CPU; the launcher's drain and stats line with
    # both switched on
    for phase, fn in (("spec_card_vs_cpu", spec_card_vs_cpu),
                      ("chaos_card_vs_cpu", chaos_card_vs_cpu),
                      ("fairshare_card_vs_cpu", fairshare_card_vs_cpu)):
        t0 = time.perf_counter()
        fn(tiny_serving_model, tfm, ForkServer, ServeConfig, SamplingParams,
           pra)
        log("phase_seconds", name=phase, seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    rec = cli_http_drain(ForkClient, HttpError, extra=SPEC_FLAGS)
    if not rec["speculate"] or rec["admission"] != "fairshare":
        raise AssertionError(f"{SPEC_FLAGS}: the server runs {rec}")
    log("cli_http_drain", **rec, stats_line=cli_stats_line(SPEC_FLAGS),
        ok=True)
    log("phase_seconds", name="cli_http_drain speculative",
        seconds=time.perf_counter() - t0)

    # 5. Llama3-8B, full width and depth, bf16, random weights
    cfg = LLAMA3_8B
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, 0)
    lora = tfm.init_lora_stacks(cfg, 1, 4)
    torch.cuda.synchronize()
    log("init", model=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
        seconds=time.perf_counter() - t0,
        param_gib=sum(t.numel() * t.element_size()
                      for t in list(params["layers"].values()) +
                      [params["embed"], params["unembed"]]) / 2 ** 30)
    launches = dict.fromkeys(pra.LAUNCHES, 0)
    peaks = {}
    shapes = LaunchShapes(pra)
    cfg8 = dataclasses.replace(cfg, kv_quant="int8")

    def run(label, sc, drive, expect, model=cfg, record=True, stacks=None,
            recorder=None, count=True, note=None, instr=64):
        """One serve of ``model`` (with ``stacks``, else the phase's LoRA
        stacks) with the counts zeroed just before it and read just after
        (its launches recorded for phase 6, by ``recorder`` if given, unless
        not ``record``; added to the kernels line's counts if ``count``):
        each entry of ``expect`` must have launched the
        kernel it runs for ``model`` (``pra.kernel_name`` at its rank), and
        an int8 model int8 variants only.  The serve line carries the
        speculation counters of a speculative serve and ``note(outputs,
        metrics)``; ``instr`` is the drive's instruction length.  Returns
        its outputs and metrics."""
        server = ForkServer(model, params, lora if stacks is None else stacks,
                            sc)
        torch.cuda.reset_peak_memory_stats()
        reset_counts(*mods)
        if record:
            with recorder or shapes:
                outs, m, seconds = drive(server)
        else:
            outs, m, seconds = drive(server)
        int8 = model.kv_quant == "int8"
        ran = check_counts(pra, ref, [
            pra.kernel_name(e, model.activation_dtype, int8, model.lora.rank)
            for e in expect], model.activation_dtype)
        if int8 and not all("_int8" in k for k in ran):
            raise AssertionError(f"{label}: a full-precision kernel ran on "
                                 f"int8 pages: {ran}")
        for k, v in ran.items() if count else ():
            launches[k] = launches.get(k, 0) + v
        gen = sum(len(o.tokens) for o in outs)
        m["tokens_per_s"] = gen / seconds
        peaks[label] = (m["peak_base_pages"], m["peak_res_pages"],
                        m["peak_cache_bytes"])
        pb = pool_bytes(server.engine.executor.pools)
        log("serve", label=label, mode=sc.mode, model=model.name,
            kv_quant=model.kv_quant, lora_rank=model.lora.rank,
            max_pages=sc.max_pages,
            host_tier_bytes=sc.host_tier_bytes,
            mixed_batching=sc.mixed_batching,
            broadcast_fork=sc.broadcast_fork, forks=len(outs),
            context=2048, instr=instr, new_tokens=16, seconds=seconds,
            tokens_per_s=gen / seconds, ttft_p50_ms=m["ttft_p50_ms"],
            tpot_p50_ms=m["tpot_p50_ms"], steps=m["steps"],
            mixed_steps=m["mixed_steps"], decode_steps=m["decode_steps"],
            avg_decode_batch=m["avg_decode_batch"],
            prefill_ms=m["prefill_ms"], decode_ms=m["decode_ms"],
            sync_ms=m["sync_ms"], prefilled_tokens=m["prefilled_tokens"],
            peak_base_pages=m["peak_base_pages"],
            peak_res_pages=m["peak_res_pages"],
            peak_cache_bytes=m["peak_cache_bytes"],
            base_bytes_per_page=pb["base"] / sc.max_pages,
            res_bytes_per_page=pb["residual"] / max(
                1, server.engine.executor.num_res_pages),
            hit_kinds=m["hit_kinds"], launches=ran,
            **{k: m[k] for k in ("tier_hits", "demoted_pages",
                                 "promoted_pages", "evicted_pages",
                                 "preemptions")},
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            **({k: m[k] for k in SPEC_LINE_KEYS} if sc.speculate else {}),
            **(note(outs, m) if note else {}),
            tokens=[o.tokens for o in outs[:2]], ok=True)
        del server
        torch.cuda.empty_cache()
        return outs, m

    def staggered(server):
        return serve(server, cfg.vocab_size, 2048, 8, 4, 64, 16, seed=11,
                     sampling_cls=SamplingParams)

    def rerun(server):
        return serve_rerun(server, cfg.vocab_size, 2048, 4, RERUN_INSTR, 16,
                           seed=11, sampling_cls=SamplingParams)

    def fanout(server):
        return serve_fanout(server, cfg.vocab_size, 2048, FANOUT, 64, 16,
                            seed=12, sampling_cls=SamplingParams)

    big = dict(max_pages=2048, max_pages_per_req=256)
    serve_metrics = {}
    for label, mode, extra, expect in LLAMA_SERVES:
        sc = ServeConfig(mode=mode, **big, **extra)
        outs, m = run(label, sc, staggered, expect)
        check_serving(outs, m, 16, mixed=sc.mixed_batching)
        serve_metrics[label] = m

    # (k) the forkkv mixed-loop serve with 4 adapters of rank 128: #1 and
    # #2 run their chunked instances
    cfg128 = dataclasses.replace(cfg, lora=dataclasses.replace(cfg.lora,
                                                               rank=128))
    lora128 = tfm.init_lora_stacks(cfg128, 3, 4)
    shapes128 = LaunchShapes(pra)
    outs, m = run("forkkv rank 128", ServeConfig(mode="forkkv", **big),
                  staggered, LLAMA_SERVES[0][3], model=cfg128,
                  stacks=lora128, recorder=shapes128)
    check_serving(outs, m, 16)
    log("serve_rank128", card=card, launches={
        k: v for k, v in launches.items() if k.endswith("_rchunk") and v},
        serves={label: {k: mm[k] for k in (
            "tokens_per_s", "ttft_p50_ms", "tpot_p50_ms", "peak_cache_bytes",
            "peak_res_pages")}
            for label, mm in (("rank 16", serve_metrics["forkkv"]),
                              ("rank 128", m))}, ok=True)
    del lora128
    torch.cuda.empty_cache()
    log("memory_effect", forkkv_peak_base_pages=peaks["forkkv"][0],
        forkkv_peak_res_pages=peaks["forkkv"][1],
        prefix_peak_base_pages=peaks["prefix"][0])

    # the same serves over int8 bCache pages
    for label, mode, extra, expect in LLAMA_INT8_SERVES:
        sc = ServeConfig(mode=mode, **big, **extra)
        outs, m = run(label, sc, staggered, expect, model=cfg8)
        check_serving(outs, m, 16, mixed=sc.mixed_batching)
    log("memory_effect_int8", peaks={
        label: dict(zip(("base_pages", "res_pages", "cache_bytes"),
                        peaks[label]))
        for label in ("forkkv", "prefix", "forkkv int8", "prefix int8")})

    # memory pressure: bf16 pages, 640 device pages, the host tier on;
    # every fork must finish, and prefix (peak 937 pages) must demote
    for mode, expect in (("forkkv", LLAMA_SERVES[0][3]),
                         ("prefix", LLAMA_SERVES[1][3])):
        sc = ServeConfig(mode=mode, **PRESSURE)
        outs, m = run(f"{mode} pressure", sc, staggered, expect,
                      record=False)
        check_serving(outs, m, 16, mixed=False)
        if mode == "prefix" and m["demoted_pages"] < 1:
            raise AssertionError(f"prefix at {PRESSURE}: no page demoted")

    # the fan-out, without and with broadcast fork
    for broadcast in (False, True):
        label = "fan-out broadcast" if broadcast else "fan-out"
        sc = ServeConfig(mode="forkkv", broadcast_fork=broadcast, **big)
        outs, m = run(label, sc, fanout,
                      ("paged_attention_prefill_base",) if broadcast
                      else ("paged_residual_attention_mixed",))
        check_serving(outs, m, 16, mixed=False)
        exact = sorted(int(o.metrics["prefilled_tokens"]) for o in outs)
        if broadcast:
            check_broadcast(exact, pra.LAUNCHES[pra.kernel_name(
                "paged_attention_prefill_base", cfg.activation_dtype,
                False)], cfg.num_layers, 2048 + 64, sc.page_size)
        log("fanout_prefill", label=label, prefilled_tokens=exact,
            peak_base_pages=m["peak_base_pages"],
            peak_res_pages=m["peak_res_pages"], ok=True)

    # (c) the forkkv server over HTTP against its own in-process API
    server = ForkServer(cfg, params, lora, ServeConfig(mode="forkkv", **big))
    reset_counts(*mods)
    rec = http_vs_in_process(server, cfg.vocab_size, HttpFrontend,
                             ForkClient, SamplingParams)
    ran = check_counts(pra, ref, [
        pra.kernel_name(e, cfg.activation_dtype, False)
        for e in LLAMA_SERVES[0][3]], cfg.activation_dtype)
    for k, v in ran.items():
        launches[k] += v
    log("http_vs_in_process", card=card, model=cfg.name, launches=ran,
        **rec, ok=True)
    del server
    torch.cuda.empty_cache()

    # (m) speculative decoding on the re-run traffic (adaptive k; the
    # ngram cache drafts a re-run from its first run: the prompt-lookup
    # default finds nothing to draft in random weights' outputs, which do
    # not repeat), each mode beside its serve of the same traffic with
    # speculation off; the verify launches recorded apart, for phase 6
    t0 = time.perf_counter()
    spec_shapes = LaunchShapes(pra)
    spec_launches = {}
    for mode, expect in (("forkkv", LLAMA_SERVES[0][3]),
                         ("prefix", LLAMA_SERVES[1][3])):
        outs, m = run(f"{mode} re-run", ServeConfig(mode=mode, **big), rerun,
                      expect, record=False, count=False, instr=RERUN_INSTR)
        check_serving(outs, m, 16)
        plain = [o.tokens for o in outs]
        beside = {f"plain_{k}": m[k] for k in ("tokens_per_s", "ttft_p50_ms",
                                               "tpot_p50_ms")}

        def agree(outs, m, plain=plain, beside=beside):
            same = sum(a == b for o, p in zip(outs, plain)
                       for a, b in zip(o.tokens, p))
            return dict(beside, agree_share=same / sum(map(len, plain)))

        before = verify_launches(spec_shapes).get(MIXED_ENTRY[mode], 0)
        outs, m = run(f"{mode} speculative", ServeConfig(
            mode=mode, speculate=True, spec_k=SPEC_K,
            spec_proposer="ngram_cache", **big), rerun, (MIXED_ENTRY[mode],),
            recorder=spec_shapes, count=False, note=agree, instr=RERUN_INSTR)
        check_serving(outs, m, 16)
        n_verify = verify_launches(spec_shapes).get(MIXED_ENTRY[mode], 0) - \
            before
        if not (m["spec_steps"] >= 1 and n_verify >= 1):
            raise AssertionError(f"{mode} speculative: {m['spec_steps']} "
                                 f"verify steps, {n_verify} verify launches")
        spec_launches[MIXED_ENTRY[mode]] = n_verify
    log("phase_seconds", name="llama speculative",
        seconds=time.perf_counter() - t0)

    # (l) launch/steps.py's prefill and serve steps on the 1x1 mesh
    built = built_steps_llama(cfg, params, tfm, tsteps, tmesh, troof, tana,
                              ShapeConfig, mods, card)

    # the dense model API on the same weights
    torch.cuda.reset_peak_memory_stats()
    first = FirstLaunch(ra)
    launches.update(llama_dense(cfg, params, lora, tfm, mods, first))
    # training (1): the LoRA fine-tune on the same weights
    trained = {"llama3-8b lora": train_llama_lora(
        cfg, params, lora, registry, train_loop, tdata, tbase, mods, card)}
    del params, lora
    torch.cuda.empty_cache()

    # RecurrentGemma-9B, full width and depth, once Llama3-8B is freed
    rg_first, scans = FirstLaunch(ra), ScanLaunches(rg)
    rg_launches = rg_hybrid(RG9B, hybrid, mods, rg_first, scans)
    # training (3): its LoRA fine-tune through the scan's two kernels
    bwd_first = ScanBwdLaunches(rg)
    trained["recurrentgemma-9b lora"] = train_rg_lora(
        RG9B, hybrid, registry, rg, ref, train_loop, tdata, tbase, mods, card,
        bwd_first)

    # (f) the zoo: the transformer family's other archs at full width
    zoo_launches, d120_cases, d120_serves = zoo(
        tfm, configs, registry, mods, pra, ref, ra, ForkServer, ServeConfig,
        SamplingParams, card)

    # training (2): internlm2-1.8b through the launcher; (4) small f32
    # models trained on card and CPU
    trained["internlm2-1.8b launcher"] = train_launcher(card)
    # (l) launch/steps.py's train step on the 1x1 mesh
    built["train"] = built_step_train(configs, registry, toptim, tsteps,
                                      tmesh, troof, tana, ShapeConfig, mods,
                                      card)
    log("built_steps", card=card, steps={
        k: {f: r[f] for f in ("ms", "bound_ms", "bound_share", "dominant",
                              "counted_flops", "analytic_flops",
                              "launches")} | (
            {"dtensor_ms": r["dtensor"]["ms"]} if "dtensor" in r else {})
        for k, r in built.items()})
    small_training_card_vs_cpu(
        (("hybrid", dataclasses.replace(rg_tiny(), remat=True), 2),
         ("dense", tiny_serving_model(), 0)),
        registry, train_loop, tdata, tbase, mods)
    log("train_summary", card=card, runs={
        run: {k: r.get(k) for k in ("ms_per_step", "tokens_per_s",
                                    "peak_mem_gib",
                                    "held_out_loss_before",
                                    "held_out_loss_after", "losses")}
        for run, r in trained.items()})

    # 6. kernels at the main paths' launch geometries
    recorded = shapes.launches()
    log("serve_launches", geometries={
        n: sorted({k[:4] for k in v}) for n, v in recorded.items()})
    measured = check_serving_shapes(pra, ref, recorded, tfm.quantize_kv)
    log("serve_launches_d120", geometries={
        n: sorted({k[:4] for k in v}) for n, v in d120_serves.items()})
    measured.update({f"{n}_d120": rec for n, rec in check_serving_shapes(
        pra, ref, d120_serves, tfm.quantize_kv, geom=DANUBE_GEOM).items()})
    measured.update(check_dense_main_path(ra, ref, first.cases))
    measured.update({f"{n}_d256": rec for n, rec in check_dense_main_path(
        ra, ref, rg_first.cases).items()})
    measured.update({f"{n}_d120": rec for n, rec in check_dense_main_path(
        ra, ref, d120_cases).items()})
    measured.update({f"{n}_r128": rec for n, rec in check_serving_shapes(
        pra, ref, shapes128.launches(), tfm.quantize_kv,
        geom=dict(LLAMA_GEOM, r=128)).items()})
    # the speculative serves' verify launches of #1 and #3, the heaviest
    # timed ("_spec") beside a decode-only launch of its rows
    spec_recorded = {n: [k for k in v if k[1] <= VERIFY_TILE]
                     for n, v in spec_shapes.launches().items()
                     if n in DECODE_TWIN}
    log("serve_launches_spec", geometries={
        n: sorted({k[:4] for k in v}) for n, v in spec_recorded.items()})
    for n, rec in check_serving_shapes(pra, ref, spec_recorded,
                                       tfm.quantize_kv).items():
        rec.update(verify_as_decode(pra, ref, n, rec))
        log("spec_vs_decode", kernel=n, **{k: rec[k] for k in (
            "ran", "case", "start", "q_len", "kernel_ms", "bound_ms",
            "decode_kernel", "decode_ms", "verify_over_decode")}, ok=True)
        measured[f"{n}_spec"] = rec
    measured["rg_lru_scan"] = check_scan_main_path(rg, ref, scans.cases)
    measured["rg_lru_scan_bwd"] = check_scan_bwd_main_path(rg, ref,
                                                           bwd_first.case)

    # 7. kernels line, card line, result line: the paged kernels at their
    # heaviest serving launch, the dense kernels at Llama3-8B's (D 128), at
    # RecurrentGemma-9B's (D 256, "_d256") and at h2o-danube-3-4b's (D 120,
    # "_d120") first main-path launch, the scan at the hybrid forward's.
    # Each kernel is named by its launch counter on the bf16 main path: #1,
    # #3, #5, #6 and #7 by their tensor-core kernels ("_mma"), #2, #4 and #8
    # by their split-K decodes ("_splitk").
    kernels = []
    entries = []              # (name, measured, launches, replaces, ...)
    for n, (_, r) in ALL_KERNELS.items():
        name = pra.kernel_name(n.removesuffix("_int8"), torch.bfloat16,
                               n.endswith("_int8"))
        source = DISAGG_SOURCE if n.startswith("paged_residual") \
            else PAGED_SOURCE
        entries.append((name, n, launches[name], r, source, "llama3-8b"))
        if f"{n}_d120" in measured:       # h2o-danube-3-4b's serves (bf16)
            entries.append((f"{name}_d120", f"{n}_d120",
                            zoo_launches["h2o-danube-3-4b"][name], r, source,
                            "h2o-danube-3-4b"))
    for n in ("paged_residual_attention_mixed",
              "paged_residual_attention_decode"):     # the rank-128 serve
        name = pra.kernel_name(n, torch.bfloat16, False, 128)
        entries.append((name, f"{n}_r128", launches[name], KERNELS[n][1],
                        DISAGG_SOURCE, "llama3-8b, LoRA rank 128"))
    for n, launches_spec in spec_launches.items():  # speculative verify
        name = pra.kernel_name(n, torch.bfloat16, False)
        entries.append((f"{name}_spec", f"{n}_spec", launches_spec,
                        KERNELS[n][1], DISAGG_SOURCE if
                        n.startswith("paged_residual") else PAGED_SOURCE,
                        "llama3-8b, speculative verify"))
    for n, r in DENSE_KERNELS.items():
        name = ra.prefill_kernel(torch.bfloat16) \
            if n == "residual_attention_prefill" else \
            ra.decode_kernel(torch.bfloat16)
        entries.append((name, n, launches[name], r, DENSE_SOURCE,
                        "llama3-8b"))
        entries.append((f"{name}_d256", f"{n}_d256", rg_launches[name], r,
                        DENSE_SOURCE, RG9B.name))
        entries.append((f"{name}_d120", f"{n}_d120",
                        zoo_launches["h2o-danube-3-4b"][name], r,
                        DENSE_SOURCE, "h2o-danube-3-4b"))
    entries.append(("rg_lru_scan", "rg_lru_scan", rg_launches["rg_lru_scan"],
                    SCAN_REPLACES, SCAN_SOURCE, RG9B.name))
    entries.append(("rg_lru_scan_bwd", "rg_lru_scan_bwd",
                    trained["recurrentgemma-9b lora"]["launches"][
                        "rg_lru_scan_bwd"], SCAN_BWD_REPLACES,
                    SCAN_SOURCE, RG9B.name))
    for name, key, n_launches, replaces, source, model in entries:
        rec = measured[key]
        kernels.append(dict(
            name=name, status="ported", route="cuda", source=source,
            replaces=replaces, model=model, launches=n_launches,
            max_abs_err=rec["max_abs_err"], ms=rec["kernel_ms"],
            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=rec["library_ms"]))
    run_dryrun(card)
    log("done", seconds=time.perf_counter() - t_start)
    print(card_line())
    print(json.dumps({"kernels": kernels, "todo": []}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
