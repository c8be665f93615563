#!/usr/bin/env python3
"""Time two layouts of the split-K decode with the residual stream (#2) on
one GPU.

    python3 scripts/res_decode_variants.py

Run from the root of a checkout, on a machine with a CUDA device and the
CUDA toolkit.  It builds ``src/repro_torch/kernels/csrc/
paged_residual_disagg.cu`` twice:

* ``built``: the source as it is (each warp's two stages hold its K, V,
  K_r, V_r and RoPE rows: one CTA of 4 warps per SM at D 128, R 16 with
  bf16 pages, two with int8 pages);
* ``one RoPE buffer``: the RoPE rows in one buffer per warp, refilled for
  the next step once this step's rebuild has read it (two CTAs per SM at
  D 128, R 16 with bf16 pages too);

and times #2 (``paged_residual_attention_decode``, bf16, bf16 and int8
pages, Llama3-8B's heads, R 16) through its wrapper, with the split count
each layout's occupancy gives, on two sets of 8 decode rows: chip_smoke's
fixed ragged rows (kv_len 64..2048, 256-page tables) and rows like the
serves' heaviest launch (kv_len 2051..2128, 133-page tables).  Each output
is held to the plain version at chip_smoke's 1% of its max |value|.
Layouts run in turns (built, the other, the other, built) on one card; one
JSON line per (rows, pages) with the four times, the card line before
them.
"""
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import paged_residual_attention as pra  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "variants"
SOURCE = "paged_residual_disagg.cu"
# (text as built, replacement) of the one-buffer layout
ONE_BUFFER = [
    ("""                       kVr = kKr + kKeys * RS * 2, kSin = kVr + kKeys * RS * 2,
                       kCos = kSin + kKeys * HS * 2,
                       kStage = kCos + kKeys * HS * 2;
  static constexpr int kVt = 2 * kStage;            // int8: the V tile""",
     """                       kVr = kKr + kKeys * RS * 2,
                       kStage = kVr + kKeys * RS * 2;
  static constexpr int kSin = 2 * kStage, kCos = kSin + kKeys * HS * 2,
                       kVt = kCos + kKeys * HS * 2;  // int8: the V tile"""),
    ("""      for (int e = lane; e < kKeys * (HALF / 8); e += 32) {
        const int t = e / (HALF / 8), c = e % (HALF / 8);
        const bool ok = k0 + t < k_hi;
        const long src = ok ? (long)(k0 + t) * HALF + c * 8 : 0;
        flash::cp_async16(s + L::kSin + (t * HS + c * 8) * 2, sin_tab + src,
                          ok);
        flash::cp_async16(s + L::kCos + (t * HS + c * 8) * 2, cos_tab + src,
                          ok);
      }
    }
    flash::cp_async_commit();
  };""",
     """    }
    flash::cp_async_commit();
  };
  auto issue_rope = [&](int it) {
    if (it < nsteps) {
      const int k0 = k_lo + it * kKeys;
      for (int e = lane; e < kKeys * (HALF / 8); e += 32) {
        const int t = e / (HALF / 8), c = e % (HALF / 8);
        const bool ok = k0 + t < k_hi;
        const long src = ok ? (long)(k0 + t) * HALF + c * 8 : 0;
        flash::cp_async16(mine + L::kSin + (t * HS + c * 8) * 2,
                          sin_tab + src, ok);
        flash::cp_async16(mine + L::kCos + (t * HS + c * 8) * 2,
                          cos_tab + src, ok);
      }
    }
    flash::cp_async_commit();
  };"""),
    ("""  issue(0);
  for (int it = 0; it < nsteps; ++it) {""",
     """  issue(0);
  issue_rope(0);
  for (int it = 0; it < nsteps; ++it) {"""),
    ("""    const bf16* Sn = reinterpret_cast<const bf16*>(s + L::kSin);
    const bf16* Cs = reinterpret_cast<const bf16*>(s + L::kCos);""",
     """    const bf16* Sn = reinterpret_cast<const bf16*>(mine + L::kSin);
    const bf16* Cs = reinterpret_cast<const bf16*>(mine + L::kCos);"""),
    ("""    // S = Q K^T: 16 heads x the 16 keys (two n-tiles of 8)""",
     """    __syncwarp();
    issue_rope(it + 1);

    // S = Q K^T: 16 heads x the 16 keys (two n-tiles of 8)"""),
]
# resident CTAs per SM of each layout at D 128, R 16, by int8 pages
CTAS = {"built": {False: 1, True: 2}, "one RoPE buffer": {False: 2, True: 2}}
# 8 decode rows: chip_smoke's fixed ragged rows, and rows like the serves'
ROWS = {
    "fixed, W 256": dict(cs.FIXED["decode"], width=256),
    "serve-like, W 133": dict(start=[2127, 2111, 2100, 2090, 2080, 2070,
                                     2060, 2050], qlen=[1] * 8, sq=1,
                              width=133),
}


def build_one_buffer():
    """The one-buffer layout in its own directory; its library."""
    d = OUT / "one_rope_buffer"
    d.mkdir(parents=True, exist_ok=True)
    for src in CSRC.iterdir():
        shutil.copy(src, d / src.name)
    text = (d / SOURCE).read_text()
    for old, new in ONE_BUFFER:
        if old not in text:
            raise RuntimeError(f"{SOURCE}: {old[:60]!r} not found")
        text = text.replace(old, new)
    (d / SOURCE).write_text(text)
    lib = d / "paged_residual_disagg.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(lib), str(d / SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr)
    out = ctypes.CDLL(str(lib))
    for name, source in pra._ENTRY_SOURCE.items():
        fn = getattr(out, name)
        fn.argtypes = pra._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("res_decode_variants: no CUDA device", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    pra.build()
    libs = {"built": pra._lib(pra.SOURCES[1]),
            "one RoPE buffer": build_one_buffer()}
    lib_of, ctas_of = pra._lib, pra.res_ctas_per_sm

    def use(label):
        pra._lib = lambda source: libs[label] \
            if source == pra.SOURCES[1] else lib_of(source)
        pra.res_ctas_per_sm = lambda d, r, int8: CTAS[label][int8]

    try:
        for rows_label, rows in ROWS.items():
            for quant in (False, True):
                name = "paged_residual_attention_decode" + (
                    "_int8" if quant else "")
                c = cs.make_case("decode", torch.bfloat16, 0, seed=3,
                                 quantize=tfm.quantize_kv if quant else None,
                                 **rows)
                times = {}
                for i, label in enumerate(("built", "one RoPE buffer",
                                           "one RoPE buffer", "built")):
                    use(label)
                    cs.compare(pra, ref, name, c, cs.BF16_RTOL, rows_label)
                    times[f"{label} {1 + i // 2}"] = cs.time_ms(
                        cs.kernel_call(pra, name, c), reps=20)
                print(json.dumps(dict(
                    kernel=name, rows=rows_label,
                    bound_ms=cs.work(name, c)[0], **times)), flush=True)
                del c
    finally:
        pra._lib, pra.res_ctas_per_sm = lib_of, ctas_of
    return 0


if __name__ == "__main__":
    sys.exit(main())
