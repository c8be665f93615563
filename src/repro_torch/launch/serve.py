"""Serving launcher: run the ForkKV engine on a workload (port of
``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --mode forkkv \
      --workflow react --workflows 2 --agents 3

Runs entirely through the session/fork API (``repro_torch.serving.api``):
the launcher builds a :class:`ForkServer`, the workflow driver pins the
shared context in an :class:`AgentSession` and forks agents off it.  With
``--http`` it serves :class:`~repro_torch.serving.frontend.HttpFrontend`
instead, after one warm-up request, and drains on SIGTERM.

It serves on the CUDA device and raises when there is none;
``--device cpu`` serves on the CPU with the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional, Sequence

from repro_torch.configs.paper_models import tiny_serving_model
from repro_torch.core.config import ServeConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.serving.api import ForkServer
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.workflows import WorkflowConfig, WorkflowDriver


def build_server(mode: str, *, rank: int = 8, max_pages: int = 512,
                 max_batch: int = 8, n_adapters: int = 32,
                 max_pages_per_req: int = 24, seed: int = 0,
                 host_tier_bytes: int = 0, tier_promote_limit: int = 0,
                 broadcast_fork: bool = False,
                 adaptive_fallback: bool = False,
                 use_paged_kernel: bool = True,
                 mixed_batching: bool = True,
                 iteration_token_budget: int = 0,
                 admission: str = "fifo",
                 tenant_weights: tuple = (),
                 tenant_max_concurrent: int = 0,
                 max_queue_depth: int = 0,
                 max_queue_wait_s: float = 0.0,
                 speculate: bool = False,
                 spec_k: int = 4,
                 spec_proposer: str = "prompt_lookup",
                 preempt: bool = True,
                 preempt_after_steps: int = 4,
                 fault_plan: str = "",
                 fault_seed: int = 0,
                 watchdog_s: float = 10.0,
                 kv_quant: str = "none",
                 kv_codec: str = "identity",
                 disk_tier_bytes: int = 0,
                 persist_dir: str = "",
                 device=None, params=None, lora=None):
    """A :class:`ForkServer` over ``tiny_serving_model(rank=rank)`` at its
    defaults (head_dim 32) on ``device`` (None: the CUDA device, raising
    when there is none).  Its weights are drawn from ``seed`` (the LoRA
    stacks from ``seed + 1``) unless given as ``params``/``lora`` (e.g. the
    reference's, through :mod:`repro_torch.bridge`).  Returns (server,
    model config)."""
    dev = resolve_device(device)
    cfg = tiny_serving_model(rank=rank)
    if kv_quant != "none":
        cfg = dataclasses.replace(cfg, kv_quant=kv_quant)
    if params is None:
        params = tfm.init_params(cfg, seed, device=dev)
    if lora is None:
        lora = tfm.init_lora_stacks(cfg, seed + 1, n_adapters, device=dev)
    sc = ServeConfig(page_size=16, max_pages=max_pages, max_batch=max_batch,
                     max_prefill_tokens=128, mode=mode,
                     max_pages_per_req=max_pages_per_req,
                     host_tier_bytes=host_tier_bytes,
                     tier_promote_limit=tier_promote_limit,
                     broadcast_fork=broadcast_fork,
                     adaptive_fallback=adaptive_fallback,
                     use_paged_kernel=use_paged_kernel,
                     mixed_batching=mixed_batching,
                     iteration_token_budget=iteration_token_budget,
                     admission=admission,
                     tenant_weights=tuple(tenant_weights),
                     tenant_max_concurrent=tenant_max_concurrent,
                     max_queue_depth=max_queue_depth,
                     max_queue_wait_s=max_queue_wait_s,
                     speculate=speculate, spec_k=spec_k,
                     spec_proposer=spec_proposer,
                     preempt=preempt,
                     preempt_after_steps=preempt_after_steps,
                     fault_plan=fault_plan, fault_seed=fault_seed,
                     watchdog_s=watchdog_s,
                     kv_codec=kv_codec, disk_tier_bytes=disk_tier_bytes,
                     persist_dir=persist_dir)
    server = ForkServer(cfg, params, lora, sc, device=dev)
    # restart rehydration (DESIGN.md §18): a manifest left by a previous
    # run's persist() grafts its shared prefixes into the radix tree as
    # host-tier nodes — matched requests promote instead of re-prefilling
    if persist_dir and os.path.exists(os.path.join(persist_dir,
                                                   "manifest.json")):
        n = server.engine.restore(persist_dir)
        print(f"restore: rehydrated {n} page(s) from {persist_dir}",
              flush=True)
    return server, cfg


def build_engine(mode: str, **kw):
    """Back-compat shim: returns the wrapped Engine."""
    server, cfg = build_server(mode, **kw)
    return server.engine, cfg


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where to serve (default: the CUDA device, an "
                         "error when there is none; cpu runs the kernels' "
                         "plain versions)")
    ap.add_argument("--mode", default="forkkv",
                    choices=["forkkv", "prefix", "full_reuse"])
    ap.add_argument("--workflow", default="react",
                    choices=["react", "mapreduce"])
    ap.add_argument("--workflows", type=int, default=2)
    ap.add_argument("--agents", type=int, default=3)
    ap.add_argument("--context", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-pages", type=int, default=512)
    ap.add_argument("--broadcast-fork", action="store_true",
                    help="amortize identical simultaneous prefills into one "
                         "base-trajectory pass (DESIGN.md §9)")
    ap.add_argument("--adaptive-fallback", action="store_true",
                    help="enable the adaptive unified-cache fallback knob "
                         "(ServeConfig.adaptive_fallback)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy argmax)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k sampling cutoff (0 = disabled)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling cutoff (1.0 = disabled)")
    ap.add_argument("--seed", type=int, default=0,
                    help="sampling PRNG seed")
    ap.add_argument("--host-tier-mb", type=int, default=0,
                    help="host KV offload budget in MiB (0 = disabled, "
                         "DESIGN.md §10)")
    ap.add_argument("--tier-promote-limit", type=int, default=0,
                    help="max pages promoted host→device per match "
                         "(0 = unlimited)")
    ap.add_argument("--kv-quant", default="none", choices=["none", "int8"],
                    help="bCache page quantization inside the paged "
                         "kernels (DESIGN.md §18)")
    ap.add_argument("--kv-codec", default="identity",
                    choices=["identity", "int8", "zstd"],
                    help="blob codec applied on demote to host/disk and "
                         "reversed on promote (DESIGN.md §18)")
    ap.add_argument("--disk-tier-mb", type=int, default=0,
                    help="disk KV tier budget in MiB below the host tier "
                         "(0 = disabled, DESIGN.md §18)")
    ap.add_argument("--persist-dir", default="",
                    help="directory for the disk tier + persist manifest; "
                         "a restarted server rehydrates cached prefixes "
                         "from it instead of re-prefilling (DESIGN.md §18)")
    ap.add_argument("--phase-separated", action="store_true",
                    help="disable iteration-level continuous batching and "
                         "run the legacy phase-separated step loop "
                         "(ServeConfig.mixed_batching=False, DESIGN.md §14)")
    ap.add_argument("--token-budget", type=int, default=0,
                    help="iteration token budget for mixed batching "
                         "(0 = derive max_prefill_tokens + max_batch)")
    ap.add_argument("--gather-decode", action="store_true",
                    help="disable the page-native decode kernel and use "
                         "the legacy gather-to-contiguous path "
                         "(bit-parity testing, DESIGN.md §12)")
    ap.add_argument("--http", action="store_true",
                    help="serve HTTP instead of running a canned workflow: "
                         "SSE streaming completions, session/fork routes "
                         "and /v1/metrics (DESIGN.md §15)")
    ap.add_argument("--host", default="127.0.0.1",
                    help="HTTP bind address (with --http)")
    ap.add_argument("--port", type=int, default=8080,
                    help="HTTP port (with --http; 0 = ephemeral)")
    ap.add_argument("--admission", default="fifo",
                    choices=["fifo", "fairshare"],
                    help="admission policy: FIFO or weighted-fair-queue "
                         "multi-tenant scheduling (DESIGN.md §15)")
    ap.add_argument("--tenant-weight", action="append", default=[],
                    metavar="TENANT=W",
                    help="fair-share weight for a tenant (repeatable), "
                         "e.g. --tenant-weight interactive=4")
    ap.add_argument("--tenant-max-concurrent", type=int, default=0,
                    help="per-tenant cap on concurrently admitted "
                         "requests (0 = unlimited)")
    ap.add_argument("--max-queue-depth", type=int, default=0,
                    help="shed waiting requests beyond this queue depth "
                         "(0 = never shed on depth)")
    ap.add_argument("--max-queue-wait-s", type=float, default=0.0,
                    help="shed waiting requests older than this many "
                         "seconds (0 = never shed on wait)")
    ap.add_argument("--speculate", action="store_true",
                    help="enable draft-free speculative decoding for "
                         "greedy requests (DESIGN.md §16)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="max drafted tokens per verify row (with "
                         "--speculate; adaptive controller may lower it)")
    ap.add_argument("--proposer", default="prompt_lookup",
                    choices=["prompt_lookup", "ngram_cache"],
                    help="draft proposer: prompt self-match or the "
                         "completed-request n-gram cache")
    ap.add_argument("--no-preempt", action="store_true",
                    help="disable preempt-restore under pool pressure "
                         "(DESIGN.md §17); blocked admission then waits "
                         "for natural completions only")
    ap.add_argument("--fault-plan", default="",
                    help="deterministic fault-injection plan, e.g. "
                         "'pool_alloc:c3;nan_logits:p0.1' (DESIGN.md §17; "
                         "FORKKV_FAULT_PLAN env is the fallback)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed for probabilistic fault triggers")
    ap.add_argument("--watchdog-s", type=float, default=10.0,
                    help="stuck-pump watchdog threshold in seconds for "
                         "--http (0 = disabled)")
    ap.add_argument("--stats", action="store_true",
                    help="print step-phase wall-clock totals "
                         "(prefill/decode/sync ms), compiled decode "
                         "variant count and per-request latency "
                         "aggregates (TTFT/TPOT p50/p99)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    weights = []
    for spec in args.tenant_weight:
        name, _, w = spec.partition("=")
        weights.append((name, float(w or 1.0)))
    server, cfg = build_server(
        args.mode, max_pages=args.max_pages,
        host_tier_bytes=args.host_tier_mb << 20,
        tier_promote_limit=args.tier_promote_limit,
        kv_quant=args.kv_quant, kv_codec=args.kv_codec,
        disk_tier_bytes=args.disk_tier_mb << 20,
        persist_dir=args.persist_dir,
        broadcast_fork=args.broadcast_fork,
        adaptive_fallback=args.adaptive_fallback,
        use_paged_kernel=not args.gather_decode,
        mixed_batching=not args.phase_separated,
        iteration_token_budget=args.token_budget,
        admission=args.admission, tenant_weights=tuple(weights),
        tenant_max_concurrent=args.tenant_max_concurrent,
        max_queue_depth=args.max_queue_depth,
        max_queue_wait_s=args.max_queue_wait_s,
        speculate=args.speculate, spec_k=args.spec_k,
        spec_proposer=args.proposer,
        preempt=not args.no_preempt,
        fault_plan=args.fault_plan, fault_seed=args.fault_seed,
        watchdog_s=args.watchdog_s, device=args.device)
    if args.http:
        import signal

        from repro_torch.serving.frontend import HttpFrontend
        fe = HttpFrontend(server, host=args.host, port=args.port)
        # one request first, on this thread: a cold card builds its kernels
        # before the watchdog can count a client's request as stalled
        fe.warm_up()
        # start_background so the bound port (possibly ephemeral) can be
        # printed for callers that parse it (scripts/smoke_torch.sh)
        fe.start_background()
        print(f"serving mode={args.mode} admission={args.admission} "
              f"on http://{args.host}:{fe.port}", flush=True)

        # graceful drain (DESIGN.md §17): SIGTERM stops admission (new
        # requests get 503 + Retry-After), in-flight requests finish,
        # then the process exits 0.  begin_drain is signal-safe (flag
        # flip + queue.put); the wait happens back on the main thread.
        def _on_term(signum, frame):
            print("drain: signal received, finishing in-flight "
                  "requests", flush=True)
            fe.begin_drain()

        signal.signal(signal.SIGTERM, _on_term)
        try:
            while fe._thread.is_alive():
                fe._thread.join(timeout=0.2)
                if fe.drained:
                    print("drain: complete, exiting", flush=True)
                    break
        except KeyboardInterrupt:
            fe.begin_drain()
            while not fe.drained and fe._thread.is_alive():
                fe._thread.join(timeout=0.2)
        if args.persist_dir:
            n = server.engine.persist(args.persist_dir)
            print(f"persist: wrote {n} page(s) to {args.persist_dir}",
                  flush=True)
        fe.shutdown()
        return
    sampling = SamplingParams(temperature=args.temperature,
                              top_k=args.top_k, top_p=args.top_p,
                              seed=args.seed, max_new_tokens=args.max_new)
    wf = WorkflowConfig(n_workflows=args.workflows,
                        agents_per_workflow=args.agents,
                        shared_context_len=args.context,
                        max_new_tokens=args.max_new, vocab=cfg.vocab_size,
                        sampling=sampling)
    driver = WorkflowDriver(server, wf)
    rep = driver.run_react() if args.workflow == "react" \
        else driver.run_mapreduce()
    if args.persist_dir:
        n = server.engine.persist(args.persist_dir)
        print(f"persist: wrote {n} page(s) to {args.persist_dir}",
              flush=True)
    if args.json:
        print(json.dumps(rep, default=str, indent=1))
    else:
        print(f"mode={rep['mode']} workflow={rep['workflow']} "
              f"tasks={rep['tasks']} wall={rep['wall_s']:.1f}s "
              f"throughput={rep['throughput_tasks_per_s']:.3f} tasks/s")
        print(f"hit_rate={rep['hit_rate']:.2f} "
              f"peak_base_pages={rep['peak_base_pages']} "
              f"peak_res_pages={rep['peak_res_pages']} "
              f"avg_decode_batch={rep['avg_decode_batch']:.1f} "
              f"hit_kinds={rep['hit_kinds']}")
        if args.host_tier_mb:
            print(f"tier_hits={rep['tier_hits']} "
                  f"demoted_pages={rep['demoted_pages']} "
                  f"promoted_bytes={rep['promoted_bytes']} "
                  f"host_used_bytes={rep['host_used_bytes']} "
                  f"preemptions={rep['preemptions']}")
        if args.stats:
            per_step = rep["decode_ms"] / max(1, rep["decode_steps"])
            print(f"kernels={'paged' if rep['use_paged_kernel'] else 'gather'}"
                  f" prefill_ms={rep['prefill_ms']:.1f} "
                  f"decode_ms={rep['decode_ms']:.1f} "
                  f"sync_ms={rep['sync_ms']:.1f} "
                  f"decode_steps={rep['decode_steps']} "
                  f"decode_ms_per_step={per_step:.2f} "
                  f"decode_jit_variants={rep['decode_jit_variants']} "
                  f"fallback_gather_calls={rep['fallback_gather_calls']}")
            batching = ("mixed" if rep["mixed_batching"]
                        else "phase-separated")
            print(f"batching={batching} "
                  f"mixed_steps={rep['mixed_steps']} "
                  f"token_budget={rep['iteration_token_budget']} "
                  f"ttft_p50_ms={rep['ttft_p50_ms']:.1f} "
                  f"ttft_p99_ms={rep['ttft_p99_ms']:.1f} "
                  f"tpot_p50_ms={rep['tpot_p50_ms']:.1f} "
                  f"tpot_p99_ms={rep['tpot_p99_ms']:.1f}")
            em = server.metrics()
            if em["speculate"]:
                print(f"speculate=on proposer={em['spec_proposer']} "
                      f"spec_steps={em['spec_steps']} "
                      f"spec_step_share={em['spec_step_share']:.2f} "
                      f"proposed={em['spec_proposed_tokens']} "
                      f"accepted={em['spec_accepted_tokens']} "
                      f"acceptance={em['spec_acceptance_rate']:.2f}")
            print(f"admission={em['admission']} "
                  f"queue_depth={em['queue_depth']} "
                  f"admission_wait_p50_ms={em['admission_wait_p50_ms']:.2f} "
                  f"admission_wait_p99_ms={em['admission_wait_p99_ms']:.2f} "
                  f"timeouts={em['timeouts']} shed={em['shed']} "
                  f"tenants={em['tenants']}")
            print(f"preempted={em['preempted_requests']} "
                  f"restored={em['restored_requests']} "
                  f"recompute_tokens={em['recompute_tokens']} "
                  f"quarantined={em['quarantined']} "
                  f"exec_errors={em['exec_errors']} "
                  f"watchdog_trips={em['watchdog_trips']} "
                  f"draining={em['draining']} "
                  f"faults_fired={em['faults_fired']}")


if __name__ == "__main__":
    main()
