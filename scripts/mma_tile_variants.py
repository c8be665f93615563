#!/usr/bin/env python3
"""Time the tile variants of the tensor-core prefill kernels on one GPU.

    python3 scripts/mma_tile_variants.py

Run from the root of a checkout, on a machine with a CUDA device and the
CUDA toolkit.  It builds three variants of the kernel sources under
``src/repro_torch/kernels/csrc/`` into ``build/variants/``:

* ``built``: the sources as they are (8 warps, 128 query rows per CTA;
  Q's fragments in registers at head_dim <= 128);
* ``4 warps``: ``flash::kWarps`` = 4 (64 query rows per CTA);
* ``Q in smem``: the dense prefill reading Q from shared memory per key
  block at every head_dim;

and times, for each, the dense prefill (#7) at B 4, Sq = Sk = 1000, causal,
at Llama3-8B's heads (D 128) and RecurrentGemma-9B's (D 256), and the
base-only chunked prefill (#6) with bf16 and with int8 pages at its
heaviest main-path launch (B 4, chunk 2048, 256 pages of 16), in bf16.
Each launch goes straight to the library's C entry with the tile's own
query positions; each output is held to the plain version at chip_smoke's
1% of its max |value|.  Variants run in turns (built, others, then the
reverse) on one card; one JSON line per (variant, kernel) with both
times, the card line before them.
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
OUT = ROOT / "build" / "variants"
# variant: (file, text as built, replacement); None: the sources as built
VARIANTS = {
    "built": None,
    "4 warps": ("flash_tile.cuh", "constexpr int kWarps = 8;",
                "constexpr int kWarps = 4;"),
    "Q in smem": ("residual_attention.cu",
                  "constexpr bool kQInRegisters = D <= 128;",
                  "constexpr bool kQInRegisters = false;"),
}
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def build(label, change, nvcc, flags):
    """Both attention sources with ``change`` applied, in their own
    directory; returns {source: CDLL, "warps": warps per CTA}."""
    d = OUT / label.replace(" ", "_")
    d.mkdir(parents=True, exist_ok=True)
    for src in CSRC.iterdir():
        text = src.read_text()
        if change and change[0] == src.name:
            if change[1] not in text:
                raise RuntimeError(f"{src.name}: {change[1]!r} not found")
            text = text.replace(change[1], change[2])
        (d / src.name).write_text(text)
    libs = {}
    for name in ("residual_attention", "paged_residual_attention"):
        so = d / f"{name}.so"
        p = subprocess.run([nvcc, *flags, "-o", str(so), str(d / f"{name}.cu")],
                           capture_output=True, text=True)
        if p.returncode:
            raise RuntimeError(f"nvcc {label} {name}:\n{p.stderr}")
        libs[name] = ctypes.CDLL(str(so))
    libs["warps"] = 4 if change and "kWarps" in change[1] else 8
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("mma_tile_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build, ref
    from repro_torch.models.transformer import quantize_kv

    torch.backends.cuda.matmul.allow_tf32 = False
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        futures = {k: pool.submit(build, k, v, _build._nvcc(),
                                  _build.NVCC_FLAGS)
                   for k, v in VARIANTS.items()}
        libs = {k: f.result() for k, f in futures.items()}
    print(cs.card_line())
    stream = torch.cuda.current_stream().cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731

    def dense(lib, warps, c):
        fn = lib["residual_attention"].residual_attention_prefill
        fn.argtypes = [I] + [P] * 12 + [I] * 8 + [F, I, I, P]
        fn.restype = I
        bsz, sq, hq, d = c["q"].shape
        sk, hkv = c["k_base"].shape[1], c["k_base"].shape[2]
        out = torch.empty_like(c["q"])
        args = [1] + [ptr(c[k]) for k in ("q",) + cs._CACHE_ARGS] + [
            ptr(c["qpos"]), None, ptr(out), bsz, sq, sk, hq, hkv, d,
            c["k_res"].shape[2], min(sq, 16 * warps // (hq // hkv)),
            c["scale"], 1, 0, stream]
        return out, lambda: fn(*args)

    def paged(lib, warps, c):
        fn = lib["paged_residual_attention"].paged_attention_prefill_base
        fn.argtypes = [I] + [P] * 9 + [I] * 8 + [F, I, P]
        fn.restype = I
        g = c["geom"]
        out = torch.empty_like(c["q"])
        bsz, sq = c["q"].shape[:2]
        args = [1, ptr(c["q"]), ptr(c["kb"]), ptr(c["vb"]), ptr(c["ks"]),
                ptr(c["vs"]), ptr(c["bt_b"]), ptr(c["start"]),
                ptr(c["kv_len"]), ptr(out), bsz, sq, g["hq"], g["hkv"],
                g["d"], g["page"], c["bt_b"].shape[1],
                16 * warps // (g["hq"] // g["hkv"]), c["scale"], 0, stream]
        return out, lambda: fn(*args)

    cases = {
        "#7 D 128": (dense, cs.make_dense_case(
            "main", "llama", 1000, 1000, [0] * 4, None, torch.bfloat16, 0,
            seed=1), None),
        "#7 D 256": (dense, cs.make_dense_case(
            "main", "rg mqa", 1000, 1000, [0] * 4, None, torch.bfloat16, 0,
            seed=1), None),
    }
    for quant in (False, True):
        name = "paged_attention_prefill_base" + ("_int8" if quant else "")
        cases[f"#6 {'int8' if quant else 'bf16'} pages"] = (
            paged, cs.make_case("prefill", torch.bfloat16, 0, seed=5,
                                start=[2048, 0, 0, 0],
                                qlen=[64, 2048, 2048, 2048], sq=2048,
                                width=256,
                                quantize=quantize_kv if quant else None),
            name)
    ok = True
    order = list(VARIANTS) + list(VARIANTS)[::-1]
    for kernel, (call, c, name) in cases.items():
        want = cs.dense_plain_call(ref, c)() if name is None else \
            cs.plain_call(ref, name, c)()
        rows = None if name is None else torch.arange(
            c["q"].shape[1], device="cuda")[None] < torch.tensor(
                c["qlen_l"], device="cuda")[:, None]
        times = {}
        for label in order:
            lib = libs[label]
            out, fn = call(lib, lib["warps"], c)
            if fn() != 0:
                raise RuntimeError(f"{label} {kernel}: launch failed")
            torch.cuda.synchronize()
            got, ref_out = (out, want) if rows is None else \
                (out[rows], want[rows])
            err = (got.float() - ref_out.float()).abs().max().item()
            limit = cs.BF16_RTOL * ref_out.float().abs().max().item()
            ok = ok and err <= limit
            times.setdefault(label, []).append(cs.time_ms(fn, reps=20))
            times[f"{label} err"] = [err, limit]
        for label in VARIANTS:
            print(json.dumps({"kernel": kernel, "variant": label,
                              "ms": times[label],
                              "max_abs_err": times[f"{label} err"][0],
                              "limit": times[f"{label} err"][1]}))
        del c, want
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
