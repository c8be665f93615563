#!/usr/bin/env python3
"""Time two main-path decodes with the checkout in the current directory,
for comparing two checkouts on one card.

    cd <checkout> && python3 <any checkout>/scripts/decode_ab.py

Run on a machine with a CUDA device and the CUDA toolkit.  The script
imports the ``chip_smoke.py`` and ``src/repro_torch`` of the current
directory (not of its own checkout), builds their kernels there and
times, with ``chip_smoke.time_ms`` (L2 flushed before each of 50
launches), three times each:

* #8's ``residual_attention_decode`` at Llama3-8B's ``forward`` at one
  token: B 4, Sk 1 (no kv_len), D 128, G 4, rank 16, bf16, the one-range
  split-K decode;
* #2's ``paged_residual_attention_decode`` at rank 16 on chip_smoke's
  fixed decode rows (8 rows, kv_len up to 2048), bf16.

It prints one JSON line: the directory's name, the card line, the times.
Compare two checkouts in turns in one call (A, B, B, A), never across
calls.
"""
import json
import os
import sys

import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_ab: no CUDA device", file=sys.stderr)
        return 2
    root = os.getcwd()
    sys.path.insert(0, os.path.join(root, "src"))
    sys.path.insert(0, root)
    import chip_smoke as cs
    from repro_torch.kernels import paged_residual_attention as pra
    from repro_torch.kernels import residual_attention as ra

    ra.build()
    pra.build()
    c = cs.make_dense_case("S 1", (32, 8, 128, 16), 1, 1, [0] * 4, None,
                           dtype=torch.bfloat16, window=0, seed=7)
    c["decode"] = True          # forward at one token passes no kv_len
    dense = cs.dense_kernel_call(ra, c)
    p = cs.make_case("decode", torch.bfloat16, 0, seed=71,
                     **cs.FIXED["decode"])
    paged = cs.kernel_call(pra, "paged_residual_attention_decode", p)
    dense()
    paged()
    torch.cuda.synchronize()
    print(json.dumps({
        "tree": os.path.basename(root), "card": cs.card_line(),
        "#8 S1 ms": [cs.time_ms(dense, reps=50) for _ in range(3)],
        "#2 r16 ms": [cs.time_ms(paged, reps=50) for _ in range(3)]}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
