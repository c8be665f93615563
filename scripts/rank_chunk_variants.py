#!/usr/bin/env python3
"""Time the cluster sizes, stage counts and chunk widths of the chunked
prefill tile on one GPU, and profile its phases.

    python3 scripts/rank_chunk_variants.py

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
            if where == src.name or (where == "*.cu" and
                                     src.stem in SOURCES):
                if old not in text:
                    raise RuntimeError(f"{src.name}: {old!r} not found")
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
        libs[name] = so
    return libs


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
