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

Each record also holds ``collectives``, with the reference's keys: the
step run on meta DTensors on the mesh (``steps.run_sharded``) under
``roofline.collective_bytes``, which sums the per-device operand bytes of
each collective DTensor issues, by kind.  DTensor dispatch costs tens of
milliseconds per new operation on these meshes, so a step is not run
whole: it is counted at two cut depths (:func:`count_depths`) and solved
as a + b·L, and a train step's microbatch is counted once and scaled by
``accum_for``, beside its once-per-step part (``collectives_counted``
says which depths and microbatches).  Pairs run in worker processes
(one per core, at most 8), each (arch, shape) on both meshes in one
worker; a single applicable pair runs in this process.

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
import math
import multiprocessing as mp
import os
import sys
import time
import traceback
from typing import Dict, List, Optional, Sequence, Tuple

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


def count_depths(cfg, mode: str) -> Tuple[int, int]:
    """Two cut depths at which the collectives of ``cfg``'s step are
    counted, d and d + p layers, where the layers repeat with period p and
    d = p + (L mod p): every p layers past the first cut repeat what the
    second cut adds.  p is a multiple of the hybrid's block pattern, of an
    interleaved MoE stack's group and, in a train step under remat with the
    two-level scan, of ``scan_groups`` (so that the cut step keeps the full
    one's number of remat units), and it is even: DTensor's choices differ
    between odd and even depths (internlm2-1.8b's train step on the
    multi-pod mesh grows by alternating amounts from 2 layers on), and its
    first layer differs from the later ones, so d is at least 2 and shares
    L's parity.  A model of at most d + p layers is counted whole."""
    L = cfg.num_layers
    p = len(cfg.block_pattern) if cfg.family == "hybrid" else 1
    if cfg.num_experts:
        p = math.lcm(p, cfg.moe_interleave)
    g = cfg.scan_groups
    if mode == "train" and cfg.remat and cfg.scan_layers and g and g > 1 \
            and L % g == 0:
        p = math.lcm(p, g)
    p = math.lcm(p, 2)
    d1 = p + L % p
    return (L, L) if d1 + p >= L else (d1, d1 + p)


def _cut(cfg, depth: int):
    """``cfg`` at ``depth`` layers (an encoder-decoder's encoder too, which
    has as many layers as its decoder in every config here)."""
    kw = {"num_layers": depth}
    if cfg.is_encoder_decoder:
        assert cfg.num_encoder_layers == cfg.num_layers, cfg.name
        kw["num_encoder_layers"] = depth
    return dataclasses.replace(cfg, **kw)


def _count_step(cfg, shape, mesh, strategy: str,
                accum: Optional[int] = None) -> Dict[str, int]:
    """The collectives of one sharded step of ``cfg`` on meta DTensors.  A
    train step's microbatches all issue the same ones, so one is counted
    and scaled by their number (``accum``, by default ``accum_for``'s),
    beside the once-per-step part (the batch's split, and the gradients'
    mean, norm and optimizer update)."""
    accum = steps_lib.accum_for(cfg, strategy) if accum is None else accum
    built = steps_lib.build_step(cfg, mesh, shape, strategy=strategy,
                                 accum=accum)
    dargs = steps_lib.shard_args(built, mesh)
    if built.parts is None:
        return rf.collective_bytes(steps_lib.run_sharded, built, mesh, *dargs)
    params, opt_state, batch = dargs
    parts = built.parts
    state = {}

    def once_before():
        state["mbs"] = parts.split(batch)
        state["sums"] = parts.start(params)

    def one_micro():
        state["sums"] = parts.micro(params, state["sums"], state["mbs"][0])

    def once_after():
        steps_lib.shard_outputs(built, mesh, parts.finish(
            params, opt_state, state["sums"]))

    def sharded(fn):
        def run():
            with steps_lib.sharded():
                fn()
        return run

    counts = [rf.collective_bytes(sharded(f)) for f in
              (once_before, one_micro, once_after)]
    return {k: counts[0][k] + accum * counts[1][k] + counts[2][k]
            for k in counts[0]}


def count_collectives(cfg, shape, mesh, strategy: str = "baseline",
                      accum: Optional[int] = None
                      ) -> Tuple[Dict[str, int], Dict]:
    """(collectives, how they were counted) of the full-depth step of
    ``cfg`` (a train step's in ``accum`` microbatches, by default
    ``accum_for``'s): counted at the two depths of :func:`count_depths`,
    solved as a + b·L for each key and read at the model's L."""
    L = cfg.num_layers
    train = shape.mode == "train"
    if train and accum is None:
        accum = steps_lib.accum_for(cfg, strategy)
    d1, d2 = count_depths(cfg, shape.mode)
    c1 = _count_step(_cut(cfg, d1), shape, mesh, strategy, accum)
    c2 = c1 if d2 == d1 else _count_step(_cut(cfg, d2), shape, mesh,
                                         strategy, accum)
    n = 0 if d2 == d1 else (L - d1) // (d2 - d1)
    out = {k: c1[k] + n * (c2[k] - c1[k]) for k in c1}
    how = {"depths": [d1, d2], "layers": L,
           "microbatches": 1 if train else None,
           "accum": accum if train else None}
    return out, how


def run_pair(arch: str, shape_name: str, mesh, chips: int,
             strategy: str = "baseline",
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
        t1 = time.time()
        analysis["collectives"], how = count_collectives(cfg, shape, mesh,
                                                         strategy)
        analysis["collectives_counted"] = {
            **how, "seconds": round(time.time() - t1, 2)}
        rec.update(status="ok", description=built.description,
                   build_s=round(t_build, 2), count_s=round(t_count, 2),
                   **analysis)
    except Exception as e:  # noqa: BLE001 — record failures, keep sweeping
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def _mesh_name(multi: bool) -> str:
    return "multi" if multi else "single"


def run_task(arch: str, shape: str, meshes: Sequence[bool],
             strategy: str) -> List[dict]:
    """One (arch, shape)'s records on each of ``meshes`` (False: single
    pod, True: multi pod), each mesh over a fake group of its own size,
    brought up here and torn down; the FLOP count is made once and reused
    on the second mesh."""
    recs, counted = [], {}
    for multi in meshes:
        chips = mesh_lib.production_config(multi).num_devices
        with mesh_lib.fake_world(chips):
            mesh = mesh_lib.make_production_mesh(multi_pod=multi)
            rec = run_pair(arch, shape, mesh, chips, strategy=strategy,
                           counted=counted)
        rec["mesh"] = _mesh_name(multi)
        rec["strategy"] = strategy
        recs.append(rec)
    return recs


def _run_task(task) -> List[dict]:
    return run_task(*task)


def _report(rec: dict) -> None:
    print(f"== [{rec['mesh']}-pod] {rec['arch']} × {rec['shape']}",
          flush=True)
    if rec["status"] == "ok":
        t = rec["analytic"]["terms"]
        c = rec["collectives"]
        print(f"  OK build={rec['build_s']}s count={rec['count_s']}s "
              f"collectives={rec['collectives_counted']['seconds']}s "
              f"flops: counted={rec['flops']:.3e} "
              f"analytic={rec['analytic']['flops_global']:.3e}; "
              f"analytic: dominant={t['dominant']} "
              f"compute={t['compute_s']:.2e}s memory={t['memory_s']:.2e}s "
              f"collective={t['collective_s']:.2e}s; counted collectives "
              f"{c['count']}, {c['total']:.3e} B/device against analytic "
              f"{rec['analytic']['coll_bytes_dev']:.3e}", flush=True)
    elif rec["status"] == "skipped":
        print(f"  SKIP: {rec['reason']}", flush=True)
    else:
        print(f"  FAIL: {rec['error']}", flush=True)


# the train steps take the longest: start them first
_MODE_ORDER = {"train": 0, "prefill": 1, "decode": 2}


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
    tasks = sorted(((a, s, meshes, args.strategy) for a in archs
                    for s in shapes),
                   key=lambda t: _MODE_ORDER[shape_by_name(t[1]).mode])
    # one worker per core, at most 8, and none for a single pair
    applicable = sum(cfg_lib.shape_applicable(cfg_lib.get_config(a),
                                              shape_by_name(s))
                     for a, s, _, _ in tasks)
    jobs = min(8, os.cpu_count() or 1, applicable)

    t_start = time.time()
    results: List[dict] = []
    if jobs <= 1:
        done = map(_run_task, tasks)
    else:
        pool = mp.get_context("spawn").Pool(jobs)
        done = pool.imap_unordered(_run_task, tasks)
    try:
        for recs in done:
            for rec in recs:
                _report(rec)
            results.extend(recs)
    finally:
        if jobs > 1:
            pool.terminate()
    order = {(a, s, _mesh_name(m)): i for i, (a, s, m) in enumerate(
        (a, s, m) for m in meshes for a in archs for s in shapes)}
    results.sort(key=lambda r: order[(r["arch"], r["shape"], r["mesh"])])

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
