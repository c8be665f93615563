#!/usr/bin/env python3
"""Time the cluster sizes, stage counts and chunk widths of the chunked
prefill tile on one GPU, and profile its phases; with ``decode``, the
design steps of the chunked split-K decodes instead.

    python3 scripts/rank_chunk_variants.py            # the prefill tile
    python3 scripts/rank_chunk_variants.py decode     # the decodes

Run from the root of a checkout, on a machine with a CUDA device and the
CUDA toolkit.  The chunked prefill tile (``flash::ChunkPipe`` in
``src/repro_torch/kernels/csrc/rank_chunk.cuh``) serves #7's
``residual_attention_chunk_kernel`` and #5/#1's
``paged_prefill_res_chunk_kernel`` at LoRA ranks above 64.  This builds
variants of the two sources that hold them into
``build/rank_chunk_variants/``:

* ``built``: the sources as they are (clusters of ``kClusterCtas`` = 4
  CTAs, up to ``kChunkStages`` = 3 stages, 128-column rank chunks);
* ``2 CTAs``, ``1 CTA``: ``kClusterCtas`` 2 and 1 (D 256 keeps 4);
* ``2 stages``, ``4 stages``: ``kChunkStages`` 2 and 4 (each instance
  takes at most the stages that fit);
* ``64-column chunks``: ``kPipeChunk`` 64;
* two ablations, their outputs wrong by design: ``no rebuild MMAs`` (the
  rank chunks load but are not multiplied) and ``no attention`` (the key
  loop rebuilds and takes no scores);
* ``profile`` and ``profile 2 CTAs``: thread 0 of every CTA adds the
  clock64 cycles of each phase of the pipe (``PHASES``) to a device
  array, printed as shares per case, with the card's most active clusters
  of #7's D 128 instance (``cudaOccupancyMaxActiveClusters``).

Each is timed through the port's own wrappers (the variant's library
loaded in place of the built one), at ranks 128 and 256 in bf16 on the
rows chip_smoke's ``rchunk_times`` line times: #7 on 4 x 1000 causal rows
at Llama3-8B's heads (D 128, G 4) and #5 on the fixed prefill rows
(``chip_smoke.FIXED["prefill"]``).  Every output but the ablations' is
held to the plain version at chip_smoke's 1% of its max |value|.
Variants run in turns (all, then in reverse) on one card; one JSON line
per (case, variant) with both times, the card line before them.

``decode``: the rank route of #2's ``paged_decode_res_chunk_kernel`` and
#8's ``residual_attention_decode_chunk_kernel`` (``flash::DecodePipe``,
ranks 65 to ``kDecodeRankMax``), each variant with the Python plan's
matching constants (``residual_attention.DECODE_*``) so its split counts
follow its shared memory:

* ``built``: as they are (K by keys, O and acc_r by columns; #2 two CTAs
  per SM with 2 stages, B_k held where they still fit, else streamed; #8
  B_k held with 3 stages where a CTA fits, else streamed with 2);
* ``V rebuilt``: ``kDecodeRankMax`` 64, so every rank above 64 runs the
  rebuild instance (``chunk_block``: K and V rebuilt per key block, one
  stage, the f32 sums in shared memory), the route before this design;
* ``B_k streamed``: ``kDecodeHoldBk`` false (B_k's chunks through the
  ring for every block, 2 stages: the route's first form);
* ``1 stage``, ``2 stages``, ``3 stages``: ``kDecodeStages`` 1, 2 and 3
  in place of each family's (at most what fits);
* ``warps by keys``: each warp keeps the softmax and the products of its
  own 16 keys of every block, with all D columns of O and all rank
  columns of acc_r in registers (``BYKEYS_RUN``), merged over the warps
  at the end, in place of the split by columns with P through shared
  memory;
* ``no rebuild MMAs``: an ablation, wrong by design (K's chunks load but
  are not multiplied);
* ``profile``: thread 0 of every CTA adds the clock64 cycles of each phase
  of the walk (``DECODE_PHASES``) to a device array.

The cases: #2 on the fixed decode rows at Llama3-8B's heads and #8 on B 4
x Sk 4096 (D 128, G 4), ranks 128 and 256, bf16, as chip_smoke's
``rchunk_times`` line times them.  ptxas's registers and spills of each
variant's decode kernels are printed after the build.
"""
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "rank_chunk_variants"
HEADER = "rank_chunk.cuh"
CTAS = "constexpr int kClusterCtas = 4;"
STAGES = "constexpr int kChunkStages = 3;"
CHUNK = "constexpr int kPipeChunk = 128;"
OWN_RANGE = "    if (blk < own_lo || blk > own_hi) return;"
# The phase profile: thread 0 of every CTA adds the clock64 cycles between
# consecutive marks to g_prof[phase] (PHASES); chunk_prof reads or clears
# it, chunk_max_clusters gives cudaOccupancyMaxActiveClusters of #7's D 128
# instance
PHASES = ("wait + sync", "issue", "multiply", "finish", "sync", "push",
          "full wait", "scores", "empty wait")
PROF_DEF = """namespace flash {

__device__ unsigned long long g_prof[9];
__device__ __forceinline__ void prof(int i) {
  __shared__ long long stamp;
  if (threadIdx.x == 0) {
    const long long now = clock64();
    if (i >= 0) atomicAdd(&g_prof[i], (unsigned long long)(now - stamp));
    stamp = now;
  }
}
"""
PROF_READ = """
extern "C" int chunk_prof(void* dst, int reset) {
  if (reset) {
    const unsigned long long z[9] = {};
    return (int)cudaMemcpyToSymbol(flash::g_prof, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(dst, flash::g_prof, sizeof(z_dummy));
}
""".replace("sizeof(z_dummy)", "sizeof(flash::g_prof)")
MAX_CLUSTERS = """
extern "C" int chunk_max_clusters(int* out) {
  constexpr int NC = flash::cluster_ctas(128);
  using T = DenseChunk<128, 64, 128, NC>;
  auto k = residual_attention_chunk_kernel<128, 64, 128, NC>;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kBytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1024);
  cfg.blockDim = dim3(flash::kThreads);
  cfg.dynamicSmemBytes = T::kBytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = NC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(out, k, &cfg);
}
"""
FULL_WAIT = ("      if constexpr (NC > 1) mbar_wait(full(blk), "
             "(blk / NB) & 1);\n")
PROFILE = (
    (HEADER, "namespace flash {\n", PROF_DEF),
    (HEADER, "        __syncthreads();\n        if (t + S - 1 < steps)",
     "        __syncthreads();\n        prof(0);\n"
     "        if (t + S - 1 < steps)"),
    (HEADER, "        cp_async_commit();\n        multiply(t, acc);\n",
     "        cp_async_commit();\n        prof(1);\n"
     "        multiply(t, acc);\n        prof(2);\n"),
    (HEADER, "vkind, acc);\n    }\n    return t;",
     "vkind, acc);\n      prof(3);\n    }\n    return t;"),
    (HEADER, "      t = rebuild(blk, t);\n      __syncthreads();\n",
     "      t = rebuild(blk, t);\n      __syncthreads();\n"
     "      prof(4);\n"),
    (HEADER, "      return t;\n    };", "      prof(5);\n      return t;\n"
     "    };"),
    (HEADER, FULL_WAIT, FULL_WAIT + "      prof(6);\n"),
    (HEADER, "(blk / NB - 1) & 1);\n", "(blk / NB - 1) & 1);\n"
     "      prof(8);\n"),
    (HEADER, "      attend(blk, k, k + BK * D);\n",
     "      attend(blk, k, k + BK * D);\n      prof(7);\n"),
    (HEADER, "    int t = 0;\n    if constexpr (kAhead)",
     "    prof(-1);\n    int t = 0;\n    if constexpr (kAhead)"),
    ("*.cu$", "", PROF_READ),
    ("residual_attention.cu$", "", MAX_CLUSTERS),
)
# variant: (its output is checked, ((file, text as built, replacement),
# ...)); "*.cu": both sources
VARIANTS = {
    "built": (True, ()),
    "2 CTAs": (True, ((HEADER, CTAS, "constexpr int kClusterCtas = 2;"),)),
    "1 CTA": (True, ((HEADER, CTAS, "constexpr int kClusterCtas = 1;"),)),
    "2 stages": (True, ((HEADER, STAGES,
                         "constexpr int kChunkStages = 2;"),)),
    "4 stages": (True, ((HEADER, STAGES,
                         "constexpr int kChunkStages = 4;"),)),
    "64-column chunks": (True, ((HEADER, CHUNK,
                                 "constexpr int kPipeChunk = 64;"),)),
    "no rebuild MMAs": (False, (
        (HEADER, "        mma(acc[u][0], af, bf[0], bf[1]);\n", ""),
        (HEADER, "        mma(acc[u][1], af, bf[0], bf[1]);\n", ""))),
    "no attention": (False, (("*.cu", OWN_RANGE, "    if (true) return;"),)),
    "profile": (False, PROFILE),
    "profile 2 CTAs": (False, PROFILE + (
        (HEADER, CTAS, "constexpr int kClusterCtas = 2;"),)),
}
# The decodes' rank route (``DecodePipe``): its constants, the phase marks
# of the profile (between consecutive marks of thread 0) and its variants,
# each with the Python plan's constants to match
D_STAGES = "constexpr int kDecodeStages = 0;"
D_HOLD = "constexpr bool kDecodeHoldBk = true;"
D_RMAX = "constexpr int kDecodeRankMax = 256;"
DECODE_PHASES = ("wait + sync", "issue", "K MMAs", "scores", "exchange",
                 "V steps")
DECODE_PROFILE = (
    (HEADER, "namespace flash {\n", PROF_DEF),
    (HEADER, "      __syncthreads();\n      if (t + S - 1 < steps) "
     "issue(t + S - 1);\n      cp_async_commit();\n",
     "      __syncthreads();\n      prof(0);\n      if (t + S - 1 < steps) "
     "issue(t + S - 1);\n      cp_async_commit();\n      prof(1);\n"),
    (HEADER, "        multiply(t, c, x1, x2);\n",
     "        multiply(t, c, x1, x2);\n        prof(2);\n"),
    (HEADER, "        mask<16>(sc, k0, pos, hi, false, 0, lane);\n      }\n",
     "        mask<16>(sc, k0, pos, hi, false, 0, lane);\n      }\n"
     "      prof(3);\n"),
    (HEADER, "      rescale<2 * kNch>(accr, alpha);\n",
     "      rescale<2 * kNch>(accr, alpha);\n      prof(4);\n"),
    (HEADER, "        ++t;\n", "        prof(5);\n        ++t;\n"),
    (HEADER, "    int t = 0;\n    for (int blk = 0; blk < nblocks; ++blk) {\n",
     "    prof(-1);\n    int t = 0;\n"
     "    for (int blk = 0; blk < nblocks; ++blk) {\n"),
    ("*.cu$", "", PROF_READ),
)
# ``warps by keys``: DecodePipe::run with each warp on its own keys of a
# block for the softmax and the products too (as the rebuild instance's
# warps are): its own m and l, all D columns of O and all rank columns of
# acc_r in registers, merged over the warps at the end (scaled to the
# CTA's max, added warp by warp into f32 buffers over the ring) into the
# by-columns layout the epilogues take
BYKEYS_SPAN = ("  // The whole range: O (the warp's QD columns), acc_r "
               "(the warp's 16\n", "  // sum_w l_w of the thread's two rows")
BYKEYS_RUN = """  template <class QFrag>
  __device__ void run(float (&o)[QD / 8][4], float (&accr)[2 * kNch][4],
                      float (&m)[2], float (&l)[2], float scale_log2,
                      QFrag qfrag) const {
    float ow[D / 8][4], aw[8 * kNch][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      ow[n][0] = ow[n][1] = ow[n][2] = ow[n][3] = 0.f;
#pragma unroll
    for (int n = 0; n < 8 * kNch; ++n)
      aw[n][0] = aw[n][1] = aw[n][2] = aw[n][3] = 0.f;
    m[0] = m[1] = kNegInit;
    l[0] = l[1] = 0.f;
    int t = 0;
    for (int blk = 0; blk < nblocks; ++blk) {
      float x1[D / 16][4], x2[D / 16][4];
#pragma unroll
      for (int j = 0; j < D / 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) x1[j][e] = x2[j][e] = 0.f;
      for (int c = 0; c < nch; ++c, ++t) {
        advance(t);
        multiply(t, c, x1, x2);
      }
      float sc[2][4];
      scores(sc, x1, x2, qfrag);
      const int k0 = lo + blk * BK + 16 * warp;
      if (k0 + 16 > hi) {
        const int pos[2] = {0, 0};
        mask<16>(sc, k0, pos, hi, false, 0, lane);
      }
      float alpha[2];
      softmax_step<16>(sc, m, l, alpha, scale_log2);
      rescale<D / 8>(ow, alpha);
      rescale<8 * kNch>(aw, alpha);
#pragma unroll
      for (int c = 0; c < kNch; ++c) {
        if (c >= nch) break;
        advance(t);
        if (c == 0) {
          if constexpr (INT8) {
            dequantize_cols<D, DR>(
                sm + L::kVbuf,
                reinterpret_cast<const float*>(sm + L::kVbuf + BK * D),
                reinterpret_cast<bf16*>(sm + L::kVtile), DS, BK, tid,
                32 * L::NW);
            __syncthreads();
          }
          product<16, D>(ow, sc,
                         reinterpret_cast<const bf16*>(sm + L::kVtile) +
                             16 * warp * DS,
                         DS, lane);
        }
        float pr[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) pr[n][e] = aw[8 * c + n][e];
        product<16, 64>(pr, sc,
                        reinterpret_cast<const bf16*>(
                            sm + L::kRing + (t % S) * L::kStage) +
                            16 * warp * RS,
                        RS, lane);
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) aw[8 * c + n][e] = pr[n][e];
        ++t;
      }
    }
    cp_async_wait<0>();
    __syncthreads();
    float* mxs = reinterpret_cast<float*>(sm + L::kMx);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if ((lane & 3) == 0) mxs[warp * 16 + (lane >> 2) + 8 * h] = m[h];
    float* bo = reinterpret_cast<float*>(sm + L::kRing);
    float* ba = bo + 16 * D;
    constexpr int RW = kNch * kRankChunk;
    for (int e = tid; e < 16 * (D + RW); e += 32 * L::NW) bo[e] = 0.f;
    __syncthreads();
    float sw[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mm = kNegInit;
#pragma unroll
      for (int w = 0; w < L::NW; ++w)
        mm = fmaxf(mm, mxs[w * 16 + (lane >> 2) + 8 * h]);
      sw[h] = exp2f(m[h] - mm);
      l[h] *= sw[h];
      m[h] = mm;
    }
    rescale<D / 8>(ow, sw);
    rescale<8 * kNch>(aw, sw);
    for (int w = 0; w < L::NW; ++w) {
      if (warp == w) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (lane >> 2) + 8 * h, cc = 2 * (lane & 3);
#pragma unroll
          for (int n = 0; n < D / 8; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              bo[r * D + 8 * n + cc + e] += ow[n][2 * h + e];
#pragma unroll
          for (int n = 0; n < 8 * kNch; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              ba[r * RW + 8 * n + cc + e] += aw[n][2 * h + e];
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (lane >> 2) + 8 * h, cc = 2 * (lane & 3);
#pragma unroll
      for (int n = 0; n < QD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          o[n][2 * h + e] = bo[r * D + warp * QD + 8 * n + cc + e];
#pragma unroll
      for (int c = 0; c < kNch; ++c)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            accr[2 * c + n][2 * h + e] =
                ba[r * RW + c * kRankChunk + 16 * warp + 8 * n + cc + e];
    }
    __syncthreads();
  }

"""
# variant: (its output is checked, source changes, plan constants)
DECODE_VARIANTS = {
    "built": (True, (), {}),
    "V rebuilt": (True, ((HEADER, D_RMAX,
                          "constexpr int kDecodeRankMax = 64;"),),
                  {"DECODE_RANK_MAX": 64}),
    "B_k streamed": (True, ((HEADER, D_HOLD,
                             "constexpr bool kDecodeHoldBk = false;"),),
                     {"DECODE_HOLD_BK": False}),
    "1 stage": (True, ((HEADER, D_STAGES,
                        "constexpr int kDecodeStages = 1;"),),
                {"DECODE_STAGES": 1}),
    "2 stages": (True, ((HEADER, D_STAGES,
                         "constexpr int kDecodeStages = 2;"),),
                 {"DECODE_STAGES": 2}),
    "3 stages": (True, ((HEADER, D_STAGES,
                         "constexpr int kDecodeStages = 3;"),),
                 {"DECODE_STAGES": 3}),
    "warps by keys": (True, ((HEADER, BYKEYS_SPAN, BYKEYS_RUN),), {}),
    "no rebuild MMAs": (False, (
        (HEADER, "        mma(x1[2 * n2], af, b[0], b[1]);\n", ""),
        (HEADER, "        mma(x1[2 * n2 + 1], af, b[2], b[3]);\n", ""),
        (HEADER, "        mma(x2[2 * n2], af, b[0], b[1]);\n", ""),
        (HEADER, "        mma(x2[2 * n2 + 1], af, b[2], b[3]);\n", "")), {}),
    "profile": (False, DECODE_PROFILE, {}),
}
SOURCES = ("residual_attention", "paged_residual_disagg")
RANKS = (128, 256)


def build(label, changes, nvcc, flags):
    """The two sources with ``changes`` applied, in their own directory;
    returns {source: library path}."""
    d = OUT / label.replace(" ", "_").replace(",", "")
    d.mkdir(parents=True, exist_ok=True)
    for src in CSRC.iterdir():
        text = src.read_text()
        for where, old, new in changes:
            if where.endswith("$"):          # appended to the source
                if where[:-1] in (src.name, "*.cu") and src.stem in SOURCES:
                    text += new
                continue
            if where == src.name and isinstance(old, tuple):
                i, j = text.index(old[0]), text.index(old[1])
                text = text[:i] + new + text[j:]       # the span [old)
                continue
            if where == src.name or (where == "*.cu" and
                                     src.stem in SOURCES):
                if text.count(old) != 1:
                    raise RuntimeError(f"{src.name}: {old!r} found "
                                       f"{text.count(old)} times")
                text = text.replace(old, new, 1)
        (d / src.name).write_text(text)
    libs = {}
    for name in SOURCES:
        so = d / f"{name}.so"
        p = subprocess.run([nvcc, *flags, "-o", str(so),
                            str(d / f"{name}.cu")],
                           capture_output=True, text=True)
        if p.returncode:
            raise RuntimeError(f"nvcc {label} {name}:\n{p.stderr}")
        (d / f"{name}.log").write_text(p.stderr)        # ptxas -v
        libs[name] = so
    return libs


def decode_main(cs, _build, ref, pra, ra) -> int:
    """The decodes' variants (``DECODE_VARIANTS``) on their timed cases."""
    with ThreadPoolExecutor(len(DECODE_VARIANTS)) as pool:
        futures = {k: pool.submit(build, "decode " + k, v[1], _build._nvcc(),
                                  _build.NVCC_FLAGS)
                   for k, v in DECODE_VARIANTS.items()}
        libs = {k: f.result() for k, f in futures.items()}
    print(cs.card_line(), flush=True)
    for label, lib in libs.items():
        for name, so in lib.items():
            use_ = cs.ptxas_kernels(so.with_suffix(".log").read_text())
            for kernel, regs in use_.items():
                if "decode" in kernel and "_chunk_kernel" in kernel:
                    print(json.dumps({"variant": label, "kernel": kernel,
                                      **regs}), flush=True)
    pra.build()            # the other paged source, as built
    built_build = _build.build
    plan = {k: getattr(ra, k) for k in ("DECODE_RANK_MAX", "DECODE_STAGES",
                                         "DECODE_HOLD_BK")}

    def use(label):
        """Load ``label``'s libraries and plan constants."""
        _build.build = lambda name: libs[label].get(name) or \
            built_build(name)
        _build.load.cache_clear()
        pra._lib.cache_clear()
        ra._lib.cache_clear()
        for k, v in {**plan, **DECODE_VARIANTS[label][2]}.items():
            setattr(ra, k, v)

    cases = {}
    for r in RANKS:
        cases[f"#2 R {r} fixed rows"] = (
            "paged_residual_attention_decode", cs.make_case(
                "decode", torch.bfloat16, 0, seed=71,
                geom=dict(cs.LLAMA_GEOM, r=r), **cs.FIXED["decode"]))
        cases[f"#8 R {r} B 4 x Sk 4096"] = (
            "dense", cs.make_dense_case(
                f"R {r}", (32, 8, 128, r), 1, 4096, [4095] * 4, [4096] * 4,
                dtype=torch.bfloat16, window=0, seed=80))
    ok = True
    order = list(DECODE_VARIANTS) + list(DECODE_VARIANTS)[::-1]
    for kernel, (name, c) in cases.items():
        dense = name == "dense"
        want = cs.dense_plain_call(ref, c)() if dense else \
            cs.plain_call(ref, name, c)()
        call = (lambda: cs.dense_kernel_call(ra, c)) if dense else \
            (lambda: cs.kernel_call(pra, name, c))
        times = {}
        for label in order:
            use(label)
            fn = call()
            out = fn()
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs().max().item()
            limit = cs.BF16_RTOL * want.float().abs().max().item()
            ok = ok and (err <= limit or not DECODE_VARIANTS[label][0])
            times.setdefault(label, []).append(cs.time_ms(fn, reps=20))
            times[f"{label} err"] = [err, limit]
        use("profile")
        fn = call()
        lib = _build.load("residual_attention" if dense
                          else "paged_residual_disagg")
        fn()
        torch.cuda.synchronize()
        cycles = (ctypes.c_ulonglong * 9)()
        lib.chunk_prof(None, 1)
        fn()
        torch.cuda.synchronize()
        lib.chunk_prof(cycles, 0)
        total = sum(cycles[:len(DECODE_PHASES)]) or 1
        print(json.dumps({
            "kernel": kernel, "variant": "profile",
            "share": {p: cycles[i] / total
                      for i, p in enumerate(DECODE_PHASES)},
            "cycles": list(cycles)[:len(DECODE_PHASES)]}), flush=True)
        for label in DECODE_VARIANTS:
            if label == "profile":
                continue
            print(json.dumps({"kernel": kernel, "variant": label,
                              "checked": DECODE_VARIANTS[label][0],
                              "ms": times[label],
                              "max_abs_err": times[f"{label} err"][0],
                              "limit": times[f"{label} err"][1]}),
                  flush=True)
        del c, want
        torch.cuda.empty_cache()
    use("built")
    return 0 if ok else 1


def main() -> int:
    if not torch.cuda.is_available():
        print("rank_chunk_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import paged_residual_attention as pra
    from repro_torch.kernels import residual_attention as ra

    torch.backends.cuda.matmul.allow_tf32 = False
    if sys.argv[1:] == ["decode"]:
        return decode_main(cs, _build, ref, pra, ra)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        futures = {k: pool.submit(build, k, v[1], _build._nvcc(),
                                  _build.NVCC_FLAGS)
                   for k, v in VARIANTS.items()}
        libs = {k: f.result() for k, f in futures.items()}
    print(cs.card_line(), flush=True)
    pra.build()            # the other paged source, as built
    built_build = _build.build

    def use(label):
        """Load ``label``'s libraries in place of the built ones."""
        _build.build = lambda name: libs[label].get(name) or \
            built_build(name)
        _build.load.cache_clear()
        pra._lib.cache_clear()
        ra._lib.cache_clear()

    cases = {}
    for r in RANKS:
        cases[f"#7 R {r} 4 x 1000"] = (
            "dense", cs.make_dense_case(
                f"R {r}", (32, 8, 128, r), 1000, 1000, [0] * 4, None,
                dtype=torch.bfloat16, window=0, seed=80))
        cases[f"#5 R {r} fixed rows"] = (
            "paged_residual_attention_prefill", cs.make_case(
                "prefill", torch.bfloat16, 0, seed=71,
                geom=dict(cs.LLAMA_GEOM, r=r), **cs.FIXED["prefill"]))
    ok = True
    order = list(VARIANTS) + list(VARIANTS)[::-1]
    for kernel, (name, c) in cases.items():
        if name == "dense":
            want = cs.dense_plain_call(ref, c)()
            rows = None
        else:
            want = cs.plain_call(ref, name, c)()
            rows = torch.arange(c["q"].shape[1], device="cuda")[None] < \
                torch.tensor(c["qlen_l"], device="cuda")[:, None]
        times = {}
        for label in order:
            use(label)
            fn = cs.dense_kernel_call(ra, c) if name == "dense" else \
                cs.kernel_call(pra, name, c)
            out = fn()
            torch.cuda.synchronize()
            got, ref_out = (out, want) if rows is None else \
                (out[rows], want[rows])
            err = (got.float() - ref_out.float()).abs().max().item()
            limit = cs.BF16_RTOL * ref_out.float().abs().max().item()
            ok = ok and (err <= limit or not VARIANTS[label][0])
            times.setdefault(label, []).append(cs.time_ms(fn, reps=20))
            times[f"{label} err"] = [err, limit]
        for label in VARIANTS:
            if not label.startswith("profile"):
                continue
            use(label)
            fn = cs.dense_kernel_call(ra, c) if name == "dense" else \
                cs.kernel_call(pra, name, c)
            lib = _build.load("residual_attention" if name == "dense"
                              else "paged_residual_disagg")
            fn()
            torch.cuda.synchronize()
            cycles = (ctypes.c_ulonglong * len(PHASES))()
            lib.chunk_prof(None, 1)
            fn()
            torch.cuda.synchronize()
            lib.chunk_prof(cycles, 0)
            total = sum(cycles) or 1
            clusters = ctypes.c_int(0)
            err = _build.load("residual_attention").chunk_max_clusters(
                ctypes.byref(clusters))
            print(json.dumps({
                "kernel": kernel, "variant": label,
                "share": {p: cycles[i] / total
                          for i, p in enumerate(PHASES)},
                "cycles": list(cycles),
                "max_active_clusters_d128": clusters.value if err == 0
                else f"error {err}"}), flush=True)
        for label in VARIANTS:
            print(json.dumps({"kernel": kernel, "variant": label,
                              "checked": VARIANTS[label][0],
                              "ms": times[label],
                              "max_abs_err": times[f"{label} err"][0],
                              "limit": times[f"{label} err"][1]}),
                  flush=True)
        del c, want
        torch.cuda.empty_cache()
    use("built")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
