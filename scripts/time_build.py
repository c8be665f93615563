"""Time a cold build of every kernel source of a checkout, one nvcc per
source, all started together (as chip_smoke.py builds them).

    python3 scripts/time_build.py <checkout root> <label>

Removes ``<root>/build/kernels`` first, builds, and prints one JSON line
``{"build_of": label, "seconds": s}``.  Run it on the machine with the
card, for a parent checkout and for the change in turns within one call
(parent, change, change, parent) to compare build times.
"""
import json, shutil, sys, time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
root = Path(sys.argv[1]).resolve()
shutil.rmtree(root / "build" / "kernels", ignore_errors=True)
sys.path.insert(0, str(root / "src"))
from repro_torch.kernels import paged_residual_attention as pra
from repro_torch.kernels import residual_attention as ra
from repro_torch.kernels import rg_lru as rg
t0 = time.perf_counter()
with ThreadPoolExecutor(3) as pool:
    for f in [pool.submit(m.build) for m in (pra, ra, rg)]:
        f.result()
print(json.dumps({"build_of": sys.argv[2], "seconds": time.perf_counter() - t0}), flush=True)
