"""The dry run: every (architecture x input shape x mesh) step built against
the production meshes, counted and priced, with no device (port of
``repro/launch/dryrun.py``).

The reference lowers and compiles each step against 512 placeholder TPU
devices and reads XLA's cost and memory analyses.  Here each pair's step
(:mod:`repro_torch.launch.steps`) is built on ``meta`` tensors, its
shardings on a ``DeviceMesh`` of 256 (16 x 16, ``--mesh single``) or 512
(2 x 16 x 16, ``--mesh multi``) ranks over torch's ``"fake"`` process-group
backend, all in this one process.  The step runs on meta arguments under
``FlopCounterMode`` (shapes only), which counts every product it
dispatches over the global batch, every loop pass included, unlike XLA's
``cost_analysis``.  A train step is counted as one pass of the whole
batch: the accumulation's microbatches run the products of one pass, and
counting them one by one costs the sweep five times the time.  A record
holds those FLOPs, the per-device bytes of the step's arguments and
outputs under their shardings, the analytic model's costs
(:mod:`repro_torch.launch.analytic`) with their roofline terms on the
H100's constants (the record's roofline, as the reference's), and the
useful share of each count.  A step's FLOPs do not
depend on the mesh, so they are counted once per (arch, shape, strategy)
and reused on the second mesh.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh both --strategy baseline --out dryrun.json

It exits 1 if any applicable pair fails; a pair whose shape does not
apply to its arch is ``skipped``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Dict, List, Optional, Sequence

from repro_torch import configs as cfg_lib
from repro_torch.core.config import INPUT_SHAPES, shape_by_name
from repro_torch.launch import analytic as ana_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import roofline as rf
from repro_torch.launch import steps as steps_lib


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE); D = tokens/step."""
    n = cfg.active_params
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch          # decode: 1 token/request


def run_pair(arch: str, shape_name: str, mesh, chips: int,
             verbose: bool = True, strategy: str = "baseline",
             counted: Optional[Dict] = None) -> dict:
    """One pair's record.  ``counted`` memoizes the FLOP count per
    (arch, shape, strategy) across meshes."""
    cfg = cfg_lib.get_config(arch)
    shape = shape_by_name(shape_name)
    rec = {"arch": arch, "shape": shape_name, "chips": chips,
           "mode": shape.mode}
    if not cfg_lib.shape_applicable(cfg, shape):
        rec["status"] = "skipped"
        rec["reason"] = "full-attention arch; long_500k requires " \
                        "sub-quadratic attention (DESIGN.md §5)"
        return rec
    if strategy == "optimized" and shape.mode == "decode" and \
            cfg.family in ("dense", "moe", "vlm"):
        # beyond-paper: int8 bCache halves the decode memory term
        cfg = dataclasses.replace(cfg, kv_quant="int8")
    t0 = time.time()
    try:
        built = steps_lib.build_step(cfg, mesh, shape, strategy=strategy)
        t_build = time.time() - t0
        key = (arch, shape_name, strategy)
        memo = counted if counted is not None else {}
        if key not in memo:
            # one pass of the whole batch (the accumulation's microbatches
            # run the same products)
            one = steps_lib.build_step(cfg, mesh, shape, strategy=strategy,
                                       accum=1)
            memo[key] = rf.step_flops(one.step_fn, *one.abstract_args)[0]
        t_count = time.time() - t0 - t_build
        mf = model_flops_for(cfg, shape)
        analysis = rf.analyze_step(built, mesh, chips, memo[key], mf)
        # analytic model: the primary roofline source, as the reference's
        ana = ana_lib.analytic_costs(cfg, shape, mesh, strategy=strategy)
        ana_terms = rf.roofline_terms(ana["flops_dev"], ana["bytes_dev"],
                                      ana["coll_bytes_dev"], chips)
        ana["useful_fraction"] = mf / ana["flops_global"] \
            if ana["flops_global"] else 0.0
        analysis["analytic"] = {**ana, "terms": ana_terms}
        if verbose:
            print(f"  memory: {analysis['memory']}")
            print(f"  flops: counted={analysis['flops']:.3e} "
                  f"analytic={ana['flops_global']:.3e}")
        rec.update(status="ok", description=built.description,
                   build_s=round(t_build, 2), count_s=round(t_count, 2),
                   **analysis)
    except Exception as e:  # noqa: BLE001 — record failures, keep sweeping
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--out", default="")
    ap.add_argument("--strategy", default="baseline",
                    choices=["baseline", "optimized"])
    args = ap.parse_args(argv)

    archs = list(cfg_lib.ARCH_IDS) if args.arch == "all" else \
        args.arch.split(",")
    shapes = [s.name for s in INPUT_SHAPES] if args.shape == "all" else \
        args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    t_start = time.time()
    results: List[dict] = []
    counted: Dict = {}
    for multi in meshes:
        chips = mesh_lib.production_config(multi).num_devices
        with mesh_lib.fake_world(chips):
            mesh = mesh_lib.make_production_mesh(multi_pod=multi)
            for arch in archs:
                for shape in shapes:
                    tag = f"[{'multi' if multi else 'single'}-pod] " \
                          f"{arch} × {shape}"
                    print(f"== {tag}", flush=True)
                    rec = run_pair(arch, shape, mesh, chips,
                                   strategy=args.strategy, counted=counted)
                    rec["mesh"] = "multi" if multi else "single"
                    rec["strategy"] = args.strategy
                    if rec["status"] == "ok":
                        t = rec["analytic"]["terms"]
                        print(f"  OK build={rec['build_s']}s "
                              f"count={rec['count_s']}s "
                              f"analytic: dominant={t['dominant']} "
                              f"compute={t['compute_s']:.2e}s "
                              f"memory={t['memory_s']:.2e}s "
                              f"collective={t['collective_s']:.2e}s",
                              flush=True)
                    elif rec["status"] == "skipped":
                        print(f"  SKIP: {rec['reason']}", flush=True)
                    else:
                        print(f"  FAIL: {rec['error']}", flush=True)
                    results.append(rec)

    ok = sum(r["status"] == "ok" for r in results)
    sk = sum(r["status"] == "skipped" for r in results)
    err = sum(r["status"] == "error" for r in results)
    print(f"\n== done: {ok} ok, {sk} skipped, {err} failed in "
          f"{time.time() - t_start:.1f}s")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        slim = [{k: v for k, v in r.items() if k != "traceback"}
                for r in results]
        with open(args.out, "w") as f:
            json.dump(slim, f, indent=1, default=str)
        print(f"wrote {args.out}")
    return 1 if err else 0


if __name__ == "__main__":
    sys.exit(main())
