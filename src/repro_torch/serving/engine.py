"""ForkKV serving engine: scheduler + fork/CoW lifecycle + metrics (port of
``repro/serving/engine.py``).

Three cache-sharing policies (paper §7.1):
  * ``forkkv``     — DualRadixTree, shared bCache + per-agent rCache,
                     disaggregated attention (the paper's system)
  * ``prefix``     — per-adapter unified caches (lossless baseline; cache
                     shared only between requests with the SAME adapter)
  * ``full_reuse`` — one unified cache shared across adapters (lossy
                     baseline; first computer wins)

Iteration-level continuous batching (the default): each step asks
:class:`~repro_torch.serving.scheduler.IterationScheduler` for ONE
token-budget batch plan — every runnable decode row first (q=1 each), then
chunked-prefill rows filling the remaining budget — and runs the whole plan
as a single mixed executor call, reading its results back to the host once.
``ServeConfig.mixed_batching=False`` keeps the phase-separated loop
instead: one batched prefill call, then one decode call per step.  Under
either loop, ``broadcast_fork=True`` first runs ONE shared base-trajectory
prefill for forkkv agents standing at the same position of an identical
chunk.  Pools are refcounted; under pressure the decoupled LRU eviction
frees tree leaves; requests that cannot allocate are queued (admission
control) or preempted.

With ``ServeConfig.host_tier_bytes > 0`` (or a disk tier or a persist dir)
both device pools are wrapped in
:class:`~repro_torch.serving.tiers.TieredPagePool` (DESIGN.md §10):
eviction demotes unlocked leaves to a numpy-backed host tier instead of
destroying them, host pressure spills them to an optional disk tier, and
prefix matching during admission promotes tier-hit pages back into free
device pages.  :meth:`Engine.persist` writes every cached prefix to disk
and :meth:`Engine.restore` grafts a persisted manifest back as host-tier
nodes.  ``ModelConfig.kv_quant="int8"`` stores the bCache pages as int8
with f32 scales, which the tiers carry with them.

Clients should not drive this class directly: the session/fork API
(:mod:`repro_torch.serving.api`) wraps it with ``AgentSession`` context
pinning, streaming ``GenerationHandle`` s and the ``poll()`` pump.
"""
from __future__ import annotations

import collections
import json
import os
import tempfile
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.core.config import ModelConfig, ServeConfig
from repro_torch.serving import faults as faults_mod
from repro_torch.serving.executor import PagedExecutor, pool_bytes
from repro_torch.serving.fairshare import make_policy
from repro_torch.serving.pool import PagePool
from repro_torch.serving.radix import DualRadixTree, RadixTree, ResidualForest
from repro_torch.serving.sampling import GREEDY, SamplingParams
from repro_torch.serving.scheduler import BatchPlan, IterationScheduler
from repro_torch.serving.speculate import AdaptiveK, make_proposer
from repro_torch.serving.tiers import (DiskTier, HostTier, TieredPagePool,
                                       get_codec, read_blob_file,
                                       write_blob_file)


def percentile(vals: Sequence[float], q: float) -> float:
    """Linear-interpolated percentile over SORTED ``vals`` (numpy's
    default 'linear' method, asserted against ``np.percentile`` in
    tests).  The previous nearest-rank rounding returned the window MAX
    as "p99" for any window under ~50 samples — e.g. the bounded
    admission-wait window early in a run — overstating tail latency."""
    if not vals:
        return 0.0
    rank = q * (len(vals) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(vals) - 1)
    frac = rank - lo
    return vals[lo] + (vals[hi] - vals[lo]) * frac


@dataclasses.dataclass
class Request:
    rid: int
    adapter_id: int
    prompt: List[int]
    max_new_tokens: int
    arrival: float = 0.0
    # token-selection policy; None -> greedy argmax (the seed behaviour)
    sampling: Optional[SamplingParams] = None
    # multi-tenant admission (DESIGN.md §15): the tenant this request
    # bills against, and an optional queueing deadline — a request still
    # WAITING deadline_s after arrival finishes with
    # ``finish_reason="timeout"`` instead of queueing forever.
    tenant: str = "default"
    deadline_s: float = 0.0
    admitted_at: float = 0.0      # when admission moved it to running
    retry_after_s: float = 0.0    # backoff hint set when shed (HTTP 429)
    # context-only request (AgentSession prefill): generates nothing, its
    # product is the cache; excluded from tasks_done
    is_context: bool = False
    # runtime state
    state: str = "waiting"        # waiting | prefill | decode | done
    output: List[int] = dataclasses.field(default_factory=list)
    prefill_pos: int = 0          # next prompt position to compute
    kv_len: int = 0               # tokens with cache present
    base_pages: List[int] = dataclasses.field(default_factory=list)
    res_pages: List[int] = dataclasses.field(default_factory=list)
    owned_base: List[int] = dataclasses.field(default_factory=list)
    owned_res: List[int] = dataclasses.field(default_factory=list)
    coowned_base: List[int] = dataclasses.field(default_factory=list)
    fork: Optional[Any] = dataclasses.field(default=None)
    finished_at: float = 0.0
    # latency timestamps (satellite, DESIGN.md §14): the scheduler stamps
    # first_scheduled_at when a plan first includes the request; the
    # engine stamps first_token_at when the first output token lands —
    # TTFT = first_token_at - arrival, TPOT = the per-token mean after it
    first_scheduled_at: float = 0.0
    first_token_at: float = 0.0
    # per-token wall-clock stamps, one per output token (multi-token-safe
    # TPOT/streaming: a verify step committing k+1 tokens interpolates
    # their stamps across the step instead of piling them on one instant)
    token_times: List[float] = dataclasses.field(default_factory=list)
    # speculative decoding (DESIGN.md §16): per-request draft accounting
    spec_proposed: int = 0        # drafted tokens sent to verification
    spec_accepted: int = 0        # drafted tokens the target model kept
    prefilled_tokens: int = 0     # tokens this request actually computed
                                  # (exact int; broadcast attributes the
                                  # shared pass to its writer)
    prefill_share: float = 0.0    # amortized share of prefill compute —
                                  # broadcast splits the pass across the
                                  # group; feeds metrics()
    # stop | length | rejected | stalled | timeout | error | draining
    finish_reason: str = ""
    error: str = ""               # non-empty on any non-stop/length finish
    # preempt–restore (DESIGN.md §17): kv_len checkpointed at the last
    # preemption (recompute accounting) and the restore-pending flag the
    # next successful admission clears
    preempt_kv: int = 0
    needs_restore: bool = False
    # output length at the last successful admission: a victim must have
    # emitted at least one NEW token since (re)admission to be
    # preemptable, or two requests that cannot coexist would preempt
    # each other's restore prefills forever with zero token progress
    admit_output_len: int = 0

    @property
    def params(self) -> SamplingParams:
        return self.sampling if self.sampling is not None else GREEDY

    @property
    def ptoks(self) -> List[int]:
        """Tokens whose KV must exist before decode can proceed: the
        prompt plus — after a preempt–restore cycle — the already
        generated output, minus its last token (whose KV the decode step
        consuming it writes).  Admission matching and every prefill path
        iterate THIS, so a restored request re-prefills its generated
        suffix exactly like prompt tokens and resumes bit-identically."""
        if not self.output:
            return self.prompt
        return self.prompt + self.output[:-1]


class Engine:
    def __init__(self, cfg: ModelConfig, params, lora, sc: ServeConfig,
                 device=None):
        self.cfg = cfg
        self.sc = sc
        self.mode = sc.mode
        disagg = sc.mode == "forkkv"
        # a disk tier or a persist dir implies tiering even without an
        # explicit host budget — restore grafts into the host tier, so one
        # must exist (default 1 GiB when only the deeper tiers asked)
        tiered = (sc.host_tier_bytes > 0 or sc.disk_tier_bytes > 0
                  or bool(sc.persist_dir))
        host_bytes = sc.host_tier_bytes or (1 << 30)
        # ONE host budget shared by both pools: host DRAM is one resource.
        self.host_tier = HostTier(host_bytes) if tiered else None
        # ...and one disk budget below it (DESIGN.md §18).  Blob files live
        # under persist_dir when given (so they survive restarts alongside
        # the manifest), else in a throwaway temp dir.
        self.disk_tier = None
        self.kv_codec = get_codec(sc.kv_codec)
        if tiered and sc.disk_tier_bytes > 0:
            disk_root = (os.path.join(sc.persist_dir, "disk")
                         if sc.persist_dir
                         else tempfile.mkdtemp(prefix="forkkv-disk-"))
            self.disk_tier = DiskTier(
                disk_root, sc.disk_tier_bytes,
                io_hook=lambda: self.faults.io("disk_io"))
        self.base_pool = PagePool(sc.max_pages, sc.page_size, "base")
        if tiered:
            self.base_pool = TieredPagePool(
                self.base_pool, self.host_tier,
                promote_limit=sc.tier_promote_limit,
                codec=self.kv_codec, disk=self.disk_tier)
        # EQUAL BYTE BUDGETS, not equal page counts: an rCache page holds
        # the same tokens in r/kv_dim of the bytes (the paper's asymmetry),
        # so the residual pool gets kv_dim/r x more pages per byte.
        res_factor = max(1, cfg.kv_dim // max(cfg.lora.rank, 1)) \
            if disagg else 1
        n_res_pages = sc.max_pages * res_factor if disagg else sc.max_pages
        self.res_pool = PagePool(n_res_pages, sc.page_size, "residual")
        if tiered and disagg:
            self.res_pool = TieredPagePool(
                self.res_pool, self.host_tier,
                promote_limit=sc.tier_promote_limit,
                codec=self.kv_codec, disk=self.disk_tier)
        # reserve the dump page in both pools
        dump_b = self.base_pool.alloc(1)[0]
        dump_r = self.res_pool.alloc(1)[0]
        self.max_pages_per_req = min(sc.max_pages_per_req,
                                     sc.max_pages - 2)
        self.executor = PagedExecutor(cfg, params, lora, sc, disagg,
                                      self.max_pages_per_req, device=device)
        self.executor.dump_page = dump_b
        self.executor.dump_page_r = dump_r
        self.dump_b, self.dump_r = dump_b, dump_r
        if self.mode == "forkkv":
            self.dual = DualRadixTree(self.base_pool, self.res_pool)
        elif self.mode == "prefix":
            # unified cache, keyed per adapter: a forest over the base pool
            self.forest = ResidualForest(self.base_pool)
        else:                      # full_reuse
            self.tree = RadixTree(self.base_pool)
        if tiered:
            # device↔host byte movement + back-pressure (DESIGN.md §10);
            # bound late: the executor/trees must exist first.  The fault
            # sites model IO errors on the transfer path (§17): tiers.py
            # catches them, counts tier_io_errors, and falls back (failed
            # demote → true eviction; failed promote → stay host-tier).
            def _export(kind):
                def fn(p):
                    self.faults.io("tier_demote")
                    return self.executor.export_pages(kind, p)
                return fn

            def _import(kind):
                def fn(p, b):
                    self.faults.io("tier_promote")
                    self.executor.import_pages(kind, p, b)
                return fn

            self.base_pool.bind(
                export_fn=_export("base"), import_fn=_import("base"),
                pressure_fn=lambda n: self._evict(self.base_pool, n))
            if disagg:
                self.res_pool.bind(
                    export_fn=_export("res"), import_fn=_import("res"),
                    pressure_fn=lambda n: self._evict(self.res_pool, n))
        self.waiting: List[Request] = []
        self.running: List[Request] = []
        self.done: List[Request] = []
        # iteration-level planner (DESIGN.md §14)
        self.scheduler = IterationScheduler(sc)
        self.steps = 0
        self.mixed_steps = 0          # iterations with decode AND prefill
        # bounded window of recent decode batch sizes (diagnostics only);
        # the EXACT running aggregates live in _decode_batch_sum/_steps so
        # avg_decode_batch/decode_steps stay exact while a long-lived
        # server's memory stays O(1) instead of one int per step
        self.decode_batch_hist = collections.deque(maxlen=512)
        self._decode_batch_sum = 0
        self._decode_steps = 0
        self.preemptions = 0          # demote-under-pressure events
        self.rejected = 0             # requests refused at admission
        self.stalled = 0              # requests failed by stall detection
        self.timeouts = 0             # waiting requests past deadline_s
        self.shed = 0                 # requests rejected by overload bounds
        self.restored_pages = 0       # pages grafted from a persist
                                      # manifest at startup (§18)
        # fault tolerance (DESIGN.md §17): deterministic fault injection
        # (inert when no plan is configured), preempt–restore accounting,
        # quarantine/executor-isolation counters, drain + watchdog state
        self.faults = faults_mod.from_config(sc)
        self.preempted = 0            # requests checkpointed + requeued
        self.restored = 0             # preempted requests re-admitted
        self.recompute_tokens = 0     # checkpointed KV the restore had to
                                      # re-prefill (tier full / evicted)
        self.quarantined = 0          # rows failed by the isfinite guard
        self.exec_errors = 0          # executor/step exceptions isolated
        self.watchdog_trips = 0       # stuck-pump detections (frontend)
        self.draining = False         # True: admission stopped, in-flight
                                      # requests run to completion
        self.last_step_at = time.time()   # watchdog heartbeat
        self._no_admit = 0            # consecutive steps admission was
                                      # blocked on memory (preempt trigger)
        # pluggable admission (DESIGN.md §15): FIFO (seed behaviour) or
        # weighted fair share across tenants; the policy probes prefix-hit
        # probability through the radix tree and per-tenant pinned pages
        # through the session-pin accounting below
        self.tenant_pinned_pages: Dict[str, int] = {}
        self.policy = make_policy(
            sc, probe_hit=self.prefix_hit_fraction,
            pinned_pages=lambda t: self.tenant_pinned_pages.get(t, 0))
        # admission-wait distribution (ms): bounded window for p50/p99 —
        # same O(1)-memory pattern as decode_batch_hist
        self._admission_waits = collections.deque(maxlen=2048)
        self._no_progress = 0         # consecutive zero-progress steps
        # speculative decoding (DESIGN.md §16): the proposer is always
        # constructed (cheap, host-only) — per-request SamplingParams can
        # enable speculation even when the engine default is off — and
        # warmed by every completed request so later forks replay their
        # siblings' outputs.  Per-request AdaptiveK controllers back the
        # draft length off when acceptance drops.
        self.proposer = make_proposer(sc)
        self._spec_ctl: Dict[int, AdaptiveK] = {}
        self.spec_steps = 0           # iterations that ran >=1 verify row
        self.spec_proposed = 0        # drafted tokens sent to verification
        self.spec_accepted = 0        # drafted tokens kept
        self.spec_committed = 0       # tokens committed by verify rows
                                      # (accepted + one bonus per row)
        self.peak_base_pages = 0
        self.peak_res_pages = 0
        self.agent_ids_seen = set()
        # step-phase wall-clock totals (ms).  prefill/decode time the
        # executor calls (async dispatch + trace/compile); sync times the
        # blocking device→host reads — ONE per step, not one per chunk —
        # so benchmark deltas are attributable to a phase (DESIGN.md §12)
        self.prefill_ms = 0.0
        self.decode_ms = 0.0
        self.sync_ms = 0.0

    # ------------------------------------------------------------- submit
    def submit(self, req: Request) -> None:
        req.arrival = time.time() if req.arrival == 0.0 else req.arrival
        self.agent_ids_seen.add(req.adapter_id)
        self.waiting.append(req)

    # -------------------------------------------------------- fork/admit
    def _match(self, req: Request):
        """Prefix-match per policy. Returns (base_pages, res_pages, reuse).

        Matches ``req.ptoks`` (prompt + committed output), not just the
        prompt: a preempted request's checkpointed KV lives in the radix
        tree under exactly that sequence, so restore is an ordinary
        prefix hit — device pages shared directly, host-tier pages
        promoted, evicted spans re-prefilled (DESIGN.md §17)."""
        toks = req.ptoks
        if self.mode == "forkkv":
            fr = self.dual.fork(toks, req.adapter_id, lock=True)
            req.fork = fr
            return list(fr.base_pages), list(fr.res_pages), fr.reuse_len
        if self.mode == "prefix":
            tree = self.forest.tree(req.adapter_id)
            pages, matched, path = tree.match_prefix(toks, lock=True)
            tree.hits_tokens += matched
            tree.miss_tokens += len(toks) - matched
            req.fork = (path, req.adapter_id)
            return list(pages), [], matched
        pages, matched, path = self.tree.match_prefix(toks, lock=True)
        self.tree.hits_tokens += matched
        self.tree.miss_tokens += len(toks) - matched
        req.fork = (path, None)
        return list(pages), [], matched

    def _release_lock(self, req: Request):
        if req.fork is None:
            return
        if self.mode == "forkkv":
            self.dual.release(req.fork, req.adapter_id)
        elif self.mode == "prefix":
            path, aid = req.fork
            self.forest.tree(aid).unlock_path(path)
        else:
            path, _ = req.fork
            self.tree.unlock_path(path)
        req.fork = None

    # ------------------------------------------------------ admission probe
    def prefix_hit_fraction(self, req: Request) -> float:
        """Fraction of ``req.prompt`` the radix cache already covers —
        the admission policy's prefix-hit probability (a request landing
        on warm cache is cheaper; admit it sooner).  Read-only walk: no
        locks taken, no host→device promotion paid (``promote=False``),
        so probing a request never moves bytes."""
        if not req.prompt:
            return 0.0
        if self.mode == "forkkv":
            _, matched, _ = self.dual.base.match_prefix(
                req.prompt, promote=False)
        elif self.mode == "prefix":
            _, matched, _ = self.forest.tree(req.adapter_id).match_prefix(
                req.prompt, promote=False)
        else:
            _, matched, _ = self.tree.match_prefix(req.prompt,
                                                   promote=False)
        return matched / len(req.prompt)

    # ------------------------------------------------------- session pins
    def pin_prefix(self, tokens: Sequence[int], adapter_id: int = 0,
                   tenant: str = "default"):
        """Pin the cached prefix of ``tokens`` against eviction for a
        session's lifetime (DESIGN.md §11).  Distinct from the transient
        per-request locks taken during admission: a pin outlives any one
        request and is released only by :meth:`unpin`.  Returns an opaque
        handle.  ``tenant`` bills the pinned pages against that tenant's
        ``tenant_max_pinned_pages`` admission budget (DESIGN.md §15)."""
        if self.mode == "forkkv":
            inner = self.dual.pin(tokens, adapter_id)
            pages = (sum(len(n.pages) for n in inner[0]) +
                     sum(len(n.pages) for n in inner[1]))
        elif self.mode == "prefix":
            inner = self.forest.pin(adapter_id, tokens)
            pages = sum(len(n.pages) for n in inner[0])
        else:
            inner = self.tree.pin(tokens)
            pages = sum(len(n.pages) for n in inner[0])
        self.tenant_pinned_pages[tenant] = \
            self.tenant_pinned_pages.get(tenant, 0) + pages
        return (self.mode, adapter_id, inner, tenant, pages)

    def unpin(self, handle) -> None:
        mode, adapter_id, inner, tenant, pages = handle
        if mode == "forkkv":
            self.dual.unpin(inner, adapter_id)
        elif mode == "prefix":
            self.forest.unpin(adapter_id, inner[0])
        else:
            self.tree.unpin(inner[0])
        self.tenant_pinned_pages[tenant] = max(
            0, self.tenant_pinned_pages.get(tenant, 0) - pages)

    def _evict(self, pool: PagePool, n: int) -> int:
        tiered = getattr(pool, "is_tiered", False)
        before = pool.demoted_pages if tiered else 0
        if self.mode == "forkkv":
            if pool is self.base_pool:
                freed = self.dual.base.evict(n)
            else:
                freed = self.dual.residual.evict(n)
        elif self.mode == "prefix":
            freed = self.forest.evict(n)
        else:
            freed = self.tree.evict(n)
        if tiered and pool.demoted_pages > before:
            self.preemptions += 1     # cache state pushed out under pressure
        return freed

    def _alloc(self, pool: PagePool, n: int) -> Optional[List[int]]:
        if n == 0:
            return []
        if self.faults.fire("pool_alloc"):
            # injected allocation failure (DESIGN.md §17): indistinguishable
            # from real exhaustion downstream — admission retries, and the
            # preempt trigger fires if the "pressure" persists
            return None
        pages = pool.alloc(n)
        if pages is None:
            self._evict(pool, n - pool.free_pages)
            pages = pool.alloc(n)
        return pages

    def _try_admit(self, req: Request) -> Optional[bool]:
        """Returns True (admitted), False (no memory — retry later) or
        None (rejected outright: the request can never fit)."""
        page = self.sc.page_size
        total_len = len(req.prompt) + req.max_new_tokens
        n_pages = -(-total_len // page)
        if n_pages > self.max_pages_per_req:
            req.state = "done"
            req.finish_reason = "rejected"
            req.error = (f"rejected: request {req.rid} too long "
                         f"({total_len} tokens > "
                         f"{self.max_pages_per_req * page})")
            req.finished_at = time.time()
            return None
        base_pages, res_pages, reuse = self._match(req)
        need_base = n_pages - len(base_pages)
        new_base = self._alloc(self.base_pool, need_base)
        if new_base is None:
            self._release_lock(req)
            return False
        if self.mode == "forkkv":
            # CoW: rCache pages beyond the residual hit are private
            have_res = len(res_pages)
            new_res = self._alloc(self.res_pool, n_pages - have_res)
            if new_res is None:
                self.base_pool.decref(new_base)
                self._release_lock(req)
                return False
            req.owned_res = new_res
            req.res_pages = res_pages + new_res
        req.owned_base = new_base
        req.base_pages = base_pages + new_base
        # resume computing after the usable (both-cache) prefix; for a
        # restored request ptoks extends past the prompt into the
        # generated output, so the uncovered suffix — and ONLY it — is
        # re-prefilled (DESIGN.md §17)
        toks = req.ptoks
        req.prefill_pos = reuse
        # never resume inside a partial page of reused cache
        req.prefill_pos = (req.prefill_pos // page) * page
        req.kv_len = req.prefill_pos
        req.state = "prefill" if req.prefill_pos < len(toks) \
            else "decode"
        if req.state == "decode":
            req.kv_len = len(toks)
        if req.needs_restore:
            req.needs_restore = False
            self.restored += 1
            # checkpointed KV the match did NOT cover must be recomputed
            # (host tier full at preempt time, or evicted since)
            self.recompute_tokens += max(
                0, min(req.preempt_kv, len(toks)) - req.prefill_pos)
        req.admit_output_len = len(req.output)
        return True

    # ------------------------------------------------------------ prefill
    def _write_page_for(self, req: Request, pos: int, kind: str) -> int:
        """CoW: only pages this request owns may be written."""
        page_idx = pos // self.sc.page_size
        pages = req.base_pages if kind == "base" else req.res_pages
        owned = req.owned_base if kind == "base" else req.owned_res
        p = pages[page_idx]
        if p in owned:
            return p
        return self.dump_b if kind == "base" else self.dump_r

    def _prefill_batch(self) -> bool:
        """Batched multi-request prefill (the phase-separated loop): pack
        co-resident chunks from every request in the ``prefill`` state into
        ONE padded ``(B, chunk)`` executor call, splitting the
        ``max_prefill_tokens`` budget across the power-of-two-padded batch.
        One host read per step — and only when some row finished its prompt
        and needs its first token on the host."""
        group = [r for r in self.running if r.state == "prefill"]
        if not group:
            return False
        cap = self.sc.max_prefill_batch or len(group)
        group = group[:max(1, min(cap, self.sc.max_prefill_tokens))]
        # the executor owns the shape policy: one plan drives both the
        # prompt slicing here and the batch padding inside prefill_batch
        _, chunk = self.executor.prefill_plan(len(group))
        chunks, starts, aids, btsb, btsr, wbs, wrs, ends, plens = \
            [], [], [], [], [], [], [], [], []
        temps, tks, tps, seeds, spos = [], [], [], [], []
        for r in group:
            toks = r.ptoks
            plens.append(len(toks))
            start = r.prefill_pos
            end = min(len(toks), start + chunk)
            ends.append(end)
            chunks.append(toks[start:end])
            starts.append(start)
            aids.append(r.adapter_id)
            btsb.append(list(r.base_pages))
            btsr.append(list(r.res_pages) if self.mode == "forkkv" else [])
            wbs.append([self._write_page_for(r, p, "base")
                        for p in range(start, end)])
            wrs.append([self._write_page_for(r, p, "res")
                        for p in range(start, end)]
                       if self.mode == "forkkv"
                       else [self.dump_r] * (end - start))
            sp = r.params
            temps.append(sp.temperature)
            tks.append(sp.top_k)
            tps.append(sp.top_p)
            seeds.append(sp.seed)
            spos.append(len(r.output))
        poison = [1 if self.faults.fire("nan_logits", key=r.rid) else 0
                  for r in group] if self.faults.active else None
        t0 = time.perf_counter()
        next_toks, _, row_ok = self.executor.prefill_batch(
            chunks, starts, aids, btsb, btsr, wbs, wrs, chunk,
            temps=temps, top_ks=tks, top_ps=tps, seeds=seeds, spos=spos,
            poison=poison)
        self.prefill_ms += (time.perf_counter() - t0) * 1e3
        host_toks = host_ok = None
        for i, r in enumerate(group):
            r.prefill_pos = ends[i]
            r.kv_len = ends[i]
            n = len(chunks[i])
            r.prefilled_tokens += n
            r.prefill_share += n
            if ends[i] < plens[i]:
                continue
            if r.max_new_tokens == 0:
                # context-only request (session prefill): the cache is the
                # product — commit it and finish without generating
                self._finish(r, reason="length")
                continue
            if host_toks is None:       # single blocking D2H for the step
                t0 = time.perf_counter()
                host_toks = next_toks.cpu().numpy()
                host_ok = row_ok.cpu().numpy()
                self.sync_ms += (time.perf_counter() - t0) * 1e3
            if not bool(host_ok[i]):
                # quarantine (DESIGN.md §17): non-finite logits fail THIS
                # row; co-batched requests proceed untouched
                self._quarantine(r)
                continue
            r.state = "decode"
            if r.output:
                # restored request: its last pre-preemption token was
                # never consumed — the next decode step takes it as
                # input; no new token is emitted here (greedy parity)
                continue
            tok = int(host_toks[i])
            if r.first_token_at == 0.0:
                r.first_token_at = time.time()
            r.output.append(tok)
            r.token_times.append(time.time())
            # the sampled token's KV is not cached yet; it will be written
            # when the decode step consumes it
            if tok in r.params.stop_token_ids:
                self._finish(r, reason="stop")
        return True

    def _bt(self, pages: Sequence[int]) -> List[int]:
        """A block table padded with the dump page to
        ``max_pages_per_req`` entries."""
        bt = list(pages)[:self.max_pages_per_req]
        return bt + [self.dump_b] * (self.max_pages_per_req - len(bt))

    def _note_decode_batch(self, n: int) -> None:
        """Record one decode iteration's batch size: bounded window for
        diagnostics + exact running aggregates for the metrics."""
        self.decode_batch_hist.append(n)
        self._decode_batch_sum += n
        self._decode_steps += 1

    # ------------------------------------------- speculative proposals
    def _spec_enabled(self, req: Request) -> bool:
        """Speculate for this request?  Per-request SamplingParams
        override beats the engine default; greedy only (accepted tokens
        must be bit-identical to the sequential stream), and only under
        mixed batching (verify rows ride the unified grid)."""
        sp = req.params
        on = sp.speculate if sp.speculate is not None else self.sc.speculate
        return bool(on) and sp.greedy and self.sc.mixed_batching \
            and not req.is_context

    def _propose(self, req: Request) -> tuple:
        """The scheduler's speculation hook (DESIGN.md §16): up to k
        drafted continuations of the request's tokens, or () for a plain
        decode row.  k is capped by the adaptive controller, the
        remaining generation budget (a verify row commits at most k+1
        tokens) and the request's page allocation (drafted KV must land
        inside its owned pages — the CoW rollback invariant)."""
        if not self._spec_enabled(req):
            return ()
        sp = req.params
        k = sp.spec_k or self.sc.spec_k
        if self.sc.spec_adaptive:
            ctl = self._spec_ctl.get(req.rid)
            if ctl is None:
                ctl = self._spec_ctl[req.rid] = AdaptiveK(k)
            k = min(k, ctl.k)
        k = min(k,
                req.max_new_tokens - len(req.output),
                len(req.base_pages) * self.sc.page_size - req.kv_len - 1)
        if k <= 0:
            return ()
        draft = self.proposer.propose(req.prompt + req.output, k)
        return tuple(draft[:k])

    # ------------------------------------------------------------- decode
    def _decode_all(self) -> bool:
        """One decode call over every decoding request (the
        phase-separated loop), with one host read."""
        batch = [r for r in self.running if r.state == "decode"
                 and len(r.output) < r.max_new_tokens + 1]
        batch = batch[:self.sc.max_batch]
        if not batch:
            return False
        self._note_decode_batch(len(batch))
        page = self.sc.page_size
        toks, kvl, ids, btb, btr, wpb, wpr, woff = [], [], [], [], [], [], \
            [], []
        temps, tks, tps, seeds, spos = [], [], [], [], []
        for r in batch:
            last = r.output[-1] if r.output else r.prompt[-1]
            toks.append(last)
            kvl.append(r.kv_len)
            ids.append(r.adapter_id)
            # RAW page lists: the executor owns batch/width bucketing
            btb.append(list(r.base_pages))
            btr.append(list(r.res_pages) if self.mode == "forkkv" else [])
            wpb.append(self._write_page_for(r, r.kv_len, "base"))
            wpr.append(self._write_page_for(r, r.kv_len, "res")
                       if self.mode == "forkkv" else self.dump_r)
            woff.append(r.kv_len % page)
            sp = r.params
            temps.append(sp.temperature)
            tks.append(sp.top_k)
            tps.append(sp.top_p)
            seeds.append(sp.seed)
            spos.append(len(r.output))
        poison = [1 if self.faults.fire("nan_logits", key=r.rid) else 0
                  for r in batch] if self.faults.active else None
        t0 = time.perf_counter()
        next_toks, _, row_ok = self.executor.decode(
            toks, kvl, ids, btb, btr, wpb, wpr, woff, temps=temps,
            top_ks=tks, top_ps=tps, seeds=seeds, spos=spos, poison=poison)
        self.decode_ms += (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        host_toks = next_toks.cpu().numpy()   # ONE blocking D2H per step
        host_ok = row_ok.cpu().numpy()        # quarantine guard rides it
        self.sync_ms += (time.perf_counter() - t0) * 1e3
        for i, r in enumerate(batch):
            if not bool(host_ok[i]):
                # quarantine (DESIGN.md §17): this row's logits went
                # non-finite — fail it alone; its kv_len is NOT advanced,
                # so the poisoned write at position kv_len stays
                # uncommitted garbage
                self._quarantine(r)
                continue
            r.kv_len += 1
            tok = int(host_toks[i])
            if r.first_token_at == 0.0:   # fully-cached admission: the
                r.first_token_at = time.time()  # first token is a decode
            r.output.append(tok)
            r.token_times.append(time.time())
            if tok in r.params.stop_token_ids:
                self._finish(r, reason="stop")
            elif len(r.output) >= r.max_new_tokens + 1 or \
                    r.kv_len + 1 >= self.max_pages_per_req * page:
                self._finish(r, reason="length")
        return True

    # ------------------------------------------------------------- finish
    def _commit_cache(self, req: Request) -> None:
        """Insert the request's computed-KV prefix into the radix tree
        (the tree increfs the pages it adopts)."""
        full_seq = req.prompt + req.output[:-1]
        seq = full_seq[:req.kv_len]
        if self.mode == "forkkv":
            self.dual.commit(seq, req.adapter_id,
                             req.base_pages, req.res_pages)
        elif self.mode == "prefix":
            self.forest.insert(req.adapter_id, seq, req.base_pages)
        else:
            self.tree.insert(seq, req.base_pages)

    def _finish(self, req: Request, reason: str = "length",
                commit: bool = True) -> None:
        """``commit=False`` (quarantine / executor-error isolation,
        DESIGN.md §17) skips the tree insert and the proposer warm-up —
        a poisoned request's cache must never be adopted as shared state
        — while still reclaiming every page it owned."""
        req.state = "done"
        req.finish_reason = req.finish_reason or reason
        req.finished_at = time.time()
        if commit:
            self._commit_cache(req)
        # drop this request's ownership; tree holds its own refs now
        self.base_pool.decref(req.owned_base)
        self.base_pool.decref(req.coowned_base)
        if self.mode == "forkkv":
            self.res_pool.decref(req.owned_res)
        self._release_lock(req)
        self.running.remove(req)
        self.done.append(req)
        self._spec_ctl.pop(req.rid, None)
        if commit and req.output and not req.is_context:
            # warm the n-gram cache with the committed sequence so later
            # forks replaying this trajectory get high-acceptance drafts
            self.proposer.observe(req.prompt + req.output[:-1])
        self.policy.on_finish(req, req.finished_at)

    # -------------------------------------------------------- quarantine
    def _quarantine(self, req: Request, why: str = "") -> None:
        """Fail ONE poisoned running request (DESIGN.md §17): terminal
        ``finish_reason="error"``, pages reclaimed, cache NOT committed,
        co-batched requests untouched."""
        self.quarantined += 1
        req.error = why or (
            f"error: request {req.rid} quarantined — non-finite logits "
            f"at step {self.steps}")
        req.finish_reason = "error"
        self._finish(req, reason="error", commit=False)

    def _fail_batch(self, exc: Exception) -> bool:
        """Executor-level exception isolation (DESIGN.md §17): a raising
        step call cannot say which rows' device state survived, so every
        running request fails terminally (``finish_reason="error"``,
        pages reclaimed, nothing committed) and the PUMP SURVIVES —
        waiting requests admit and run on the next step."""
        self.exec_errors += 1
        victims = list(self.running)
        for r in victims:
            r.error = (f"error: request {r.rid} failed — executor error "
                       f"at step {self.steps}: {exc}")
            r.finish_reason = "error"
            self._finish(r, reason="error", commit=False)
        return bool(victims)

    # ---------------------------------------------------- preempt–restore
    def _preempt(self, req: Request) -> None:
        """Checkpoint a running request's computed KV into the radix tree
        and send it back to the waiting queue (DESIGN.md §17).

        The checkpoint IS an ordinary cache commit — the tree adopts the
        full pages covering ``(prompt + output[:-1])[:kv_len]`` — so all
        existing machinery applies unchanged: under continued pressure
        the tree LRU demotes the pages to the host tier (tiered config)
        or destroys them (restore re-prefills = recompute), and
        re-admission restores them via the normal ``_match`` walk.  The
        generated ``output`` is kept: streaming consumers' indices stay
        valid, and ``ptoks`` replays it as prefill on restore."""
        self.preempted += 1
        req.preempt_kv = req.kv_len
        req.needs_restore = True
        if req.kv_len > 0:
            self._commit_cache(req)
        self.base_pool.decref(req.owned_base)
        self.base_pool.decref(req.coowned_base)
        if self.mode == "forkkv":
            self.res_pool.decref(req.owned_res)
        self._release_lock(req)
        self.running.remove(req)
        req.state = "waiting"
        req.prefill_pos = 0
        req.kv_len = 0
        req.base_pages, req.res_pages = [], []
        req.owned_base, req.owned_res, req.coowned_base = [], [], []
        # back of the queue: the blocked request that triggered the
        # preemption gets first claim on the freed pages (front insertion
        # would re-admit the victim immediately — a preempt livelock)
        self.waiting.append(req)
        self.policy.on_preempt(req, time.time())

    def _preempt_for(self, now: float) -> bool:
        """Pick and preempt ONE victim so blocked admission can proceed.

        Candidates: running requests that are not context prefills
        (their session holds pins — evicting them thrashes), not
        broadcast-fork writers (an owned page with refcount > 1 is
        co-owned by the group; preempting the writer would orphan the
        shared pass), and that have emitted at least one NEW token since
        their last admission — without that progress guard, two requests
        that cannot coexist in the pool preempt each other straight out
        of their restore prefills forever (a zero-progress livelock
        ``preempt_after_steps`` only delays).  A protected victim is
        running, so it becomes eligible after its next decode step;
        admission stays blocked at most that long.  Order is the
        admission policy's ``preempt_order`` — worst fair-share score
        first, newest-arrival first under FIFO."""
        cands = [
            r for r in self.running
            if not r.is_context
            and len(r.output) > r.admit_output_len
            and not any(self.base_pool.refcount(p) > 1
                        for p in r.owned_base)]
        for victim in self.policy.preempt_order(cands, now):
            self._preempt(victim)
            return True
        return False

    # --------------------------------------------------------------- drain
    def drain(self) -> None:
        """Graceful drain (DESIGN.md §17): stop admitting, let in-flight
        requests run to completion.  Every queued (never-admitted)
        request is refused with ``finish_reason="draining"`` on the next
        step so callers get a terminal signal (HTTP 503) instead of a
        hang.  Idempotent."""
        self.draining = True

    @property
    def drained(self) -> bool:
        """True once a draining engine holds no in-flight work."""
        return self.draining and not self.running and not self.waiting

    # --------------------------------------------- persist / restore (§18)
    def _persist_trees(self):
        """(executor_kind, adapter, tree) triples covering every radix
        namespace of the current mode."""
        if self.mode == "forkkv":
            out = [("base", None, self.dual.base)]
            out += [("res", aid, t)
                    for aid, t in sorted(self.dual.residual.trees.items())]
            return out
        if self.mode == "prefix":
            return [("base", aid, t)
                    for aid, t in sorted(self.forest.trees.items())]
        return [("base", None, self.tree)]

    def _tree_for_record(self, rec):
        if self.mode == "forkkv":
            return (self.dual.base if rec["kind"] == "base"
                    else self.dual.residual.tree(rec["adapter"]))
        if self.mode == "prefix":
            return self.forest.tree(rec["adapter"])
        return self.tree

    def _node_blobs(self, kind: str, node, pool):
        """Logical (decoded) page blobs of one radix node, whatever tier
        it currently occupies.  Read-only: no refcounts move."""
        if node.tier == "device":
            return self.executor.export_pages(kind, list(node.pages))
        store = pool.disk if node.tier == "disk" else pool.host
        return [pool.codec.decode(store.get(h)) for h in node.pages]

    def persist(self, persist_dir: Optional[str] = None) -> int:
        """Write every cached prefix (all tiers) to ``persist_dir`` as
        blob files + a token-prefix manifest, so a restarted engine can
        :meth:`restore` the shared agent context instead of re-prefilling
        it.  Returns the number of pages persisted.  Blobs are stored
        LOGICAL (decoded), so the restarted server may use a different
        codec.  Best-effort: an unreadable node is skipped, not fatal."""
        d = persist_dir or self.sc.persist_dir
        if not d or self.host_tier is None:
            return 0
        os.makedirs(d, exist_ok=True)
        records = []
        pages_out = 0
        for kind, adapter, tree in self._persist_trees():
            stack = [((), tree.root)]
            while stack:
                prefix, node = stack.pop()
                full = prefix + node.key
                for child in sorted(node.children.values(),
                                    key=lambda c: c.key):
                    stack.append((full, child))
                if node is tree.root or not node.pages:
                    continue
                try:
                    blobs = self._node_blobs(kind, node, tree.pool)
                except Exception:
                    continue        # e.g. injected disk fault: skip node
                merged = {}
                for i, b in enumerate(blobs):
                    for k, v in b.items():
                        merged[f"{i}/{k}"] = v
                fname = f"node_{len(records):06d}.blob"
                write_blob_file(os.path.join(d, fname), merged)
                records.append({"kind": kind, "adapter": adapter,
                                "tokens": [int(t) for t in full],
                                "n_pages": len(blobs), "file": fname})
                pages_out += len(blobs)
        manifest = {"mode": self.mode, "page_size": self.sc.page_size,
                    "records": records}
        tmp = os.path.join(d, "manifest.json.tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, os.path.join(d, "manifest.json"))
        return pages_out

    def restore(self, persist_dir: Optional[str] = None) -> int:
        """Rehydrate a :meth:`persist` manifest into the radix trees as
        HOST-tier nodes: zero device pages move until a later match
        promotes them (the normal tier-hit path, so restored context
        shows up as ``tier_hits`` instead of re-prefill).  Records come
        parent-first; grafts are best-effort (a full host budget or a
        mode/page-size mismatch skips, never fails the restart).
        Returns the number of pages grafted."""
        d = persist_dir or self.sc.persist_dir
        if not d or self.host_tier is None:
            return 0
        mf = os.path.join(d, "manifest.json")
        if not os.path.exists(mf):
            return 0
        with open(mf) as f:
            doc = json.load(f)
        if doc.get("mode") != self.mode \
                or doc.get("page_size") != self.sc.page_size:
            return 0
        restored = 0
        for rec in doc["records"]:
            try:
                merged = read_blob_file(os.path.join(d, rec["file"]))
            except Exception:
                continue
            blobs = [dict() for _ in range(rec["n_pages"])]
            for k, v in merged.items():
                i, _, key = k.partition("/")
                blobs[int(i)][key] = v
            tree = self._tree_for_record(rec)
            restored += tree.graft_host(rec["tokens"], blobs)
        self.restored_pages += restored
        return restored

    # ------------------------------------------------- broadcast fork
    def _try_broadcast(self) -> bool:
        """Broadcast fork (DESIGN.md §9): when several forkkv agents are at
        the SAME position of an identical upcoming chunk (MapReduce-style
        parallel forks), run ONE base-trajectory prefill emitting all their
        rCaches, and share the writer's new bCache pages (CoW incref)."""
        if self.mode != "forkkv" or not self.sc.broadcast_fork:
            return False
        page = self.sc.page_size
        groups: Dict = {}
        for r in self.running:
            if r.state != "prefill":
                continue
            toks = r.ptoks
            end = min(len(toks),
                      r.prefill_pos + self.sc.max_prefill_tokens)
            end = (end // page) * page
            if end >= len(toks):
                # leave the final tokens to an ordinary per-request prefill:
                # the broadcast pass emits no logits, so the request's first
                # output token must come from a real chunk ending at the
                # prompt's last token — not from an empty follow-up chunk
                end -= page
            if end <= r.prefill_pos:
                continue
            key = (r.prefill_pos, tuple(toks[r.prefill_pos:end]))
            groups.setdefault(key, []).append(r)
        key, group = max(groups.items(), key=lambda kv: len(kv[1]),
                         default=(None, []))
        if len(group) < 2:
            return False
        start = key[0]
        chunk = list(key[1])
        end = start + len(chunk)
        writer = group[0]
        p0, p1 = start // page, end // page
        for r in group[1:]:
            for i in range(p0, p1):
                wp = writer.base_pages[i]
                old = r.base_pages[i]
                if old == wp:
                    continue
                if old in r.owned_base:
                    r.owned_base.remove(old)
                    self.base_pool.decref([old])
                r.base_pages[i] = wp
                self.base_pool.incref([wp])
                r.coowned_base.append(wp)
        wb = [self._write_page_for(writer, p, "base")
              for p in range(start, end)]
        wr_list = [[self._write_page_for(r, p, "res")
                    for p in range(start, end)] for r in group]
        self.executor.prefill_broadcast(
            chunk, start, [r.adapter_id for r in group],
            self._bt(writer.base_pages), wb, wr_list,
            self.sc.max_prefill_tokens)
        for r in group:
            r.prefill_pos = end
            r.kv_len = end
            # amortized share for metrics; the EXACT int counter attributes
            # the single shared pass to its writer
            r.prefill_share += len(chunk) / len(group)
        writer.prefilled_tokens += len(chunk)
        return True

    # -------------------------------------------------- mixed iteration
    def _run_mixed(self, plan: BatchPlan) -> bool:
        """Execute one iteration-level batch plan (DESIGN.md §14) as a
        SINGLE mixed executor call: decode rows carry their last sampled
        token (q=1), prefill rows their next prompt chunk.  Rows that
        will not emit a token this iteration (mid-prompt chunks,
        context-only requests) get neutral sampling params so an
        all-greedy emitting set still compiles the argmax-only body; the
        one host sync happens only when some row emits."""
        rows = plan.rows
        if not rows:
            return False
        page = self.sc.page_size
        chunks, starts, aids, btb, btr, wbs, wrs = [], [], [], [], [], \
            [], []
        temps, tks, tps, seeds, spos = [], [], [], [], []
        emit = []
        for rp in rows:
            r = rp.req
            if rp.kind == "decode":
                chunks.append([r.output[-1] if r.output else r.prompt[-1]])
                emit.append(True)
            elif rp.kind == "verify":
                # speculative row (§16): last sampled token + the drafts;
                # drafted KV lands at [kv_len, kv_len+k) — positions the
                # page-aligned radix invariants place in request-OWNED
                # pages, so a rejected draft is private garbage the next
                # step overwrites (rollback = nothing to do)
                last = r.output[-1] if r.output else r.prompt[-1]
                chunks.append([last] + list(rp.draft))
                emit.append(True)
            else:
                toks = r.ptoks
                chunks.append(toks[rp.start:rp.end])
                # a restored request emits nothing on prefill completion:
                # its last pre-preemption token is the next decode input
                emit.append(rp.end >= len(toks)
                            and r.max_new_tokens > 0 and not r.output)
            starts.append(rp.start)
            aids.append(r.adapter_id)
            btb.append(list(r.base_pages))
            btr.append(list(r.res_pages) if self.mode == "forkkv" else [])
            wbs.append([self._write_page_for(r, p, "base")
                        for p in range(rp.start, rp.end)])
            wrs.append([self._write_page_for(r, p, "res")
                        for p in range(rp.start, rp.end)]
                       if self.mode == "forkkv"
                       else [self.dump_r] * rp.q_len)
            sp = r.params
            if emit[-1]:
                temps.append(sp.temperature)
                tks.append(sp.top_k)
                tps.append(sp.top_p)
                seeds.append(sp.seed)
                spos.append(len(r.output))
            else:                   # non-emitting row: neutral params so
                temps.append(0.0)   # ``sampled`` tracks EMITTING rows only
                tks.append(0)
                tps.append(1.0)
                seeds.append(0)
                spos.append(0)
        verify_rows = plan.verify_rows
        n_decode = len(plan.decode_rows) + len(verify_rows)
        if plan.is_mixed:
            self.mixed_steps += 1
        poison = [1 if self.faults.fire("nan_logits", key=rp.req.rid)
                  else 0 for rp in rows] if self.faults.active else None
        t0 = time.perf_counter()
        if verify_rows:
            self.spec_steps += 1
            # verify-only plans pad the q tile to pow2(k+1), not the
            # 32-wide prefill tile — the verify call must stay close to a
            # decode call's cost for speculation to pay off
            qfloor = plan.q_max if not plan.prefill_rows else 0
            next_toks, _, greedy_all, n_acc, row_ok = \
                self.executor.mixed_step(
                    chunks, starts, aids, btb, btr, wbs, wrs, temps=temps,
                    top_ks=tks, top_ps=tps, seeds=seeds, spos=spos,
                    poison=poison, verify=True, qfloor=qfloor)
        else:
            greedy_all = n_acc = None
            next_toks, _, row_ok = self.executor.mixed_step(
                chunks, starts, aids, btb, btr, wbs, wrs, temps=temps,
                top_ks=tks, top_ps=tps, seeds=seeds, spos=spos,
                poison=poison)
        elapsed = (time.perf_counter() - t0) * 1e3
        # attribute wall clock by token share: a decode-only iteration is
        # pure decode_ms (bench_decode's deltas stay meaningful), a mixed
        # one splits proportionally (verify rows count as decode work)
        dec_toks = sum(rp.q_len for rp in rows if rp.kind != "prefill")
        dec_frac = dec_toks / max(1, plan.total_tokens)
        self.decode_ms += elapsed * dec_frac
        self.prefill_ms += elapsed * (1.0 - dec_frac)
        host_toks = greedy_host = nacc_host = host_ok = None
        if any(emit):               # ONE blocking D2H per iteration
            t0 = time.perf_counter()
            host_toks = next_toks.cpu().numpy()
            host_ok = row_ok.cpu().numpy()  # quarantine guard rides the
            if verify_rows:                 # step's one sync (§17)
                greedy_host = greedy_all.cpu().numpy()
                nacc_host = n_acc.cpu().numpy()
            self.sync_ms += (time.perf_counter() - t0) * 1e3
        if n_decode:
            self._note_decode_batch(n_decode)
        step_end = time.time()
        for i, rp in enumerate(rows):
            r = rp.req
            if emit[i] and host_ok is not None and not bool(host_ok[i]):
                # quarantine (DESIGN.md §17): this row went non-finite —
                # fail it alone (kv_len untouched, nothing committed);
                # every other row of the plan proceeds normally
                self._quarantine(r)
                continue
            if rp.kind == "verify":
                # commit the accepted prefix + the bonus correction token
                # (greedy_all[n_acc] is computed from a fully accepted
                # input prefix, so it is the true greedy continuation);
                # one token at a time, mirroring the decode commit so
                # stop/length semantics stay bit-identical
                k = rp.q_len - 1
                n_ok = int(nacc_host[i])
                committed = [int(t) for t in greedy_host[i, :n_ok + 1]]
                r.spec_proposed += k
                r.spec_accepted += n_ok
                self.spec_proposed += k
                self.spec_accepted += n_ok
                self.spec_committed += len(committed)
                ctl = self._spec_ctl.get(r.rid)
                if ctl is not None:
                    ctl.update(k, n_ok)
                # interpolate per-token stamps across the step's wall
                # clock (multi-token-safe TPOT/streaming)
                dt = (elapsed / 1e3) / len(committed)
                for j, tok in enumerate(committed):
                    r.kv_len += 1
                    ts = step_end - dt * (len(committed) - 1 - j)
                    if r.first_token_at == 0.0:
                        r.first_token_at = ts
                    r.output.append(tok)
                    r.token_times.append(ts)
                    if tok in r.params.stop_token_ids:
                        self._finish(r, reason="stop")
                        break
                    if len(r.output) >= r.max_new_tokens + 1 or \
                            r.kv_len + 1 >= self.max_pages_per_req * page:
                        self._finish(r, reason="length")
                        break
                continue
            if rp.kind == "decode":
                r.kv_len += 1
                tok = int(host_toks[i])
                if r.first_token_at == 0.0:
                    r.first_token_at = step_end
                r.output.append(tok)
                r.token_times.append(step_end)
                if tok in r.params.stop_token_ids:
                    self._finish(r, reason="stop")
                elif len(r.output) >= r.max_new_tokens + 1 or \
                        r.kv_len + 1 >= self.max_pages_per_req * page:
                    self._finish(r, reason="length")
                continue
            # prefill row
            r.prefill_pos = rp.end
            r.kv_len = rp.end
            r.prefilled_tokens += rp.q_len
            r.prefill_share += rp.q_len
            if rp.end < len(r.ptoks):
                continue
            if r.max_new_tokens == 0:
                # context-only request: the cache is the product
                self._finish(r, reason="length")
                continue
            r.state = "decode"
            if r.output:
                # restored request (emit was False): the next decode step
                # consumes its last pre-preemption token — nothing lands
                continue
            tok = int(host_toks[i])
            if r.first_token_at == 0.0:
                r.first_token_at = step_end
            r.output.append(tok)
            r.token_times.append(step_end)
            if tok in r.params.stop_token_ids:
                self._finish(r, reason="stop")
        return True

    # ----------------------------------------------------- refuse helpers
    def _refuse(self, req: Request, reason: str, error: str,
                retry_after: float = 0.0, timeout: bool = False) -> None:
        """Finish a never-admitted waiting request (reject/shed/timeout)."""
        req.state = "done"
        req.finish_reason = reason
        req.error = error
        req.retry_after_s = retry_after
        req.finished_at = time.time()
        self.done.append(req)
        self.policy.on_reject(req, req.finished_at, timeout=timeout)

    def _expire_and_shed(self, now: float) -> bool:
        """Deadline sweep + overload shedding over the waiting queue
        (DESIGN.md §15).  Deadlines apply under EVERY policy: a request
        still waiting ``deadline_s`` after arrival finishes with
        ``finish_reason="timeout"`` instead of queueing forever.  The
        policy then names overload victims (queue depth / wait bounds),
        finished as ``rejected`` with a retry-after hint."""
        progress = False
        for req in [r for r in self.waiting
                    if r.deadline_s > 0 and now - r.arrival > r.deadline_s]:
            self.waiting.remove(req)
            self._refuse(req, "timeout",
                         f"timeout: request {req.rid} waited "
                         f"{now - req.arrival:.3f}s > deadline "
                         f"{req.deadline_s:.3f}s", timeout=True)
            self.timeouts += 1
            progress = True
        for req, retry_after in self.policy.shed(self.waiting, now):
            self.waiting.remove(req)
            self._refuse(req, "rejected",
                         f"rejected: overloaded (queue depth "
                         f"{len(self.waiting) + 1}, tenant {req.tenant}); "
                         f"retry after {retry_after:.1f}s",
                         retry_after=retry_after)
            self.rejected += 1
            self.shed += 1
            progress = True
        return progress

    # --------------------------------------------------------------- step
    def step(self) -> None:
        self.steps += 1
        now = time.time()
        self.faults.maybe_stall()       # pump_stall site (watchdog food)
        progress = False
        if self.draining:
            # drain (§17): stop admission — every queued request gets a
            # terminal refusal (HTTP 503) while in-flight work proceeds
            for req in list(self.waiting):
                self.waiting.remove(req)
                self._refuse(req, "draining",
                             f"draining: request {req.rid} refused — "
                             f"server is shutting down")
                progress = True
        else:
            progress = self._expire_and_shed(now)
        # admit, in policy order (FIFO = the seed behaviour: strict
        # arrival order, stop at the first request that does not fit)
        blocked = False
        while self.waiting and len(self.running) < self.sc.max_batch:
            req = self.policy.select(self.waiting, now)
            if req is None:               # every waiting tenant over budget
                break
            try:
                admitted = self._try_admit(req)
            except Exception as e:        # per-request isolation (§17): a
                self.exec_errors += 1     # blown admission fails ONE
                self.waiting.remove(req)  # request, not the pump
                self._refuse(req, "error",
                             f"error: admission of request {req.rid} "
                             f"failed: {e}")
                progress = True
                continue
            if admitted is None:          # impossible request: reject, keep
                self.waiting.remove(req)  # the engine alive for the rest
                self.done.append(req)     # (_try_admit already finished it)
                self.policy.on_reject(req, now)
                self.rejected += 1
                progress = True
                continue
            if not admitted:
                blocked = True
                break
            self.waiting.remove(req)
            self.running.append(req)
            req.admitted_at = time.time()
            self._admission_waits.append(
                (req.admitted_at - req.arrival) * 1e3)
            self.policy.on_admit(req, req.admitted_at)
            progress = True
            if req.state == "decode" and req.max_new_tokens == 0:
                # fully-cached context-only request: nothing to compute
                self._finish(req, reason="length")
        # preempt–restore trigger (§17): admission blocked on pages for
        # preempt_after_steps consecutive steps → checkpoint one victim
        if blocked and self.sc.preempt:
            self._no_admit += 1
            if self._no_admit >= self.sc.preempt_after_steps and \
                    self._preempt_for(now):
                self._no_admit = 0
                progress = True
        elif not blocked:
            self._no_admit = 0
        try:
            self.faults.io("executor")    # injected step failure (§17)
            # broadcast-fork groups go first, under either loop: ONE
            # shared base-trajectory pass
            broadcast = self._try_broadcast()
            if broadcast:
                progress = True
            if self.sc.mixed_batching:
                # iteration-level continuous batching (§14): one
                # token-budget plan — all runnable decode rows + budget-
                # filling prefill chunks — runs as one call
                if self._run_mixed(self.scheduler.plan(
                        self.running, propose=self._propose)):
                    progress = True
            else:
                # phase-separated loop: one batched prefill call (unless a
                # broadcast pass ran), then one decode call
                if not broadcast and self._prefill_batch():
                    progress = True
                if self._decode_all():
                    progress = True
        except Exception as e:
            # executor isolation (§17): the step call died — fail the
            # affected requests terminally, keep the pump alive
            if self._fail_batch(e):
                progress = True
        # stall detection: waiting work + nothing admitted/prefilled/decoded
        # for stall_limit consecutive steps -> fail the head request loudly
        # instead of silently burning the caller's step budget
        if self.waiting and not progress:
            self._no_progress += 1
            if self._no_progress >= self.sc.stall_limit:
                head = self.waiting.pop(0)
                head.state = "done"
                head.finish_reason = "stalled"
                head.error = (
                    f"stalled: request {head.rid} made no progress for "
                    f"{self._no_progress} steps (pool too small or cache "
                    f"pinned beyond its needs: {self.base_pool.free_pages} "
                    f"base pages free)")
                head.finished_at = time.time()
                self.done.append(head)
                self.policy.on_reject(head, head.finished_at)
                self.stalled += 1
                self._no_progress = 0
        else:
            self._no_progress = 0
        self.peak_base_pages = max(self.peak_base_pages,
                                   self.base_pool.used_pages)
        self.peak_res_pages = max(self.peak_res_pages,
                                  self.res_pool.used_pages)
        self.last_step_at = time.time()   # watchdog heartbeat (§17)

    def run(self, max_steps: int = 100_000) -> None:
        for _ in range(max_steps):
            if not self.waiting and not self.running:
                break
            self.step()

    # ------------------------------------------------------------ metrics
    def metrics(self) -> Dict:
        pb = pool_bytes(self.executor.pools)
        page = self.sc.page_size
        base_bytes_page = pb["base"] / self.sc.max_pages
        res_bytes_page = (pb["residual"] / self.executor.num_res_pages
                          if pb["residual"] else 0)
        n_agents = max(1, len(self.agent_ids_seen))
        used_bytes = (self.peak_base_pages * base_bytes_page +
                      self.peak_res_pages * res_bytes_page)
        hit = miss = 0
        hit_kinds = {}
        evicted = 0
        if self.mode == "forkkv":
            hit = self.dual.base.hits_tokens
            miss = self.dual.base.miss_tokens
            hit_kinds = dict(self.dual.hit_kinds)
            evicted = (self.dual.base.evicted_pages +
                       self.dual.residual.evicted_pages)
        elif self.mode == "prefix":
            for t in self.forest.trees.values():
                hit += t.hits_tokens
                miss += t.miss_tokens
            evicted = self.forest.evicted_pages
        else:
            hit = self.tree.hits_tokens
            miss = self.tree.miss_tokens
            evicted = self.tree.evicted_pages
        # amortized shares (broadcast splits its one pass across the group);
        # the exact per-request int lives in Request.prefilled_tokens
        prefilled = sum(r.prefill_share for r in self.done)
        prompt_tokens = sum(len(r.prompt) for r in self.done
                            if not r.error)
        tier = {"tier_hits": 0, "disk_hits": 0, "demoted_pages": 0,
                "demoted_bytes": 0, "promoted_pages": 0,
                "promoted_bytes": 0, "spilled_pages": 0,
                "host_evicted_pages": 0, "disk_evicted_pages": 0,
                "dropped_device_pages": 0, "tier_io_errors": 0,
                "codec_logical_bytes": 0, "codec_stored_bytes": 0}
        for pool in (self.base_pool, self.res_pool):
            if getattr(pool, "is_tiered", False):
                for k, v in pool.stats().items():
                    if k in tier:
                        tier[k] += v
        # device cache destroyed by host-LRU cascades is real eviction too
        evicted += tier["dropped_device_pages"]
        tier["host_used_bytes"] = (self.host_tier.used_bytes
                                   if self.host_tier else 0)
        # stored (post-codec) host bytes and the achieved ratio (§18):
        # host_used_bytes IS compressed occupancy now that the budget
        # accounts stored sizes — mirrored under the explicit name too
        tier["host_compressed_bytes"] = tier["host_used_bytes"]
        tier["compression_ratio"] = (
            tier["codec_logical_bytes"] / tier["codec_stored_bytes"]
            if tier["codec_stored_bytes"] else 1.0)
        tier["disk_used_bytes"] = (self.disk_tier.used_bytes
                                   if self.disk_tier else 0)
        tier["kv_codec"] = self.kv_codec.name if self.host_tier else "none"
        tier["restored_pages"] = self.restored_pages
        # per-request latency aggregates (satellite, §14): TTFT from
        # arrival to first output token, TPOT the mean gap after it —
        # over finished generating requests only
        lat = [r for r in self.done
               if not r.is_context and r.first_token_at > 0.0]
        ttfts = sorted((r.first_token_at - r.arrival) * 1e3 for r in lat)

        def _tpot_ms(r):
            # per-token stamps (interpolated across multi-token verify
            # commits) give the honest inter-token gap; fall back to the
            # old span/(n-1) estimate for requests without stamps
            if len(r.token_times) >= 2:
                return ((r.token_times[-1] - r.token_times[0]) * 1e3 /
                        (len(r.token_times) - 1))
            return ((r.finished_at - r.first_token_at) * 1e3 /
                    max(1, len(r.output) - 1))

        tpots = sorted(_tpot_ms(r) for r in lat)

        _pct = percentile

        return {
            **tier,
            "mode": self.mode,
            "tasks_done": len([r for r in self.done if not r.is_context]),
            "context_prefills": len([r for r in self.done if r.is_context]),
            "steps": self.steps,
            "mixed_batching": self.sc.mixed_batching,
            "mixed_steps": self.mixed_steps,
            "iteration_token_budget": self.scheduler.budget,
            "ttft_mean_ms": sum(ttfts) / max(1, len(ttfts)),
            "ttft_p50_ms": _pct(ttfts, 0.50),
            "ttft_p99_ms": _pct(ttfts, 0.99),
            "tpot_mean_ms": sum(tpots) / max(1, len(tpots)),
            "tpot_p50_ms": _pct(tpots, 0.50),
            "tpot_p99_ms": _pct(tpots, 0.99),
            "avg_decode_batch": (self._decode_batch_sum /
                                 max(1, self._decode_steps)),
            "peak_base_pages": self.peak_base_pages,
            "peak_res_pages": self.peak_res_pages,
            "peak_cache_bytes": used_bytes,
            "bytes_per_agent": used_bytes / n_agents,
            "prefilled_tokens": prefilled,
            "prompt_tokens": prompt_tokens,
            "prefill_saved_frac": 1 - prefilled / max(1, prompt_tokens),
            "hit_tokens": hit,
            "miss_tokens": miss,
            "hit_rate": hit / max(1, hit + miss),
            "hit_kinds": hit_kinds,
            "evicted_pages": evicted,
            "preemptions": self.preemptions,
            "rejected": self.rejected,
            "stalled": self.stalled,
            # fault tolerance (DESIGN.md §17): preempt–restore accounting,
            # quarantine/isolation counters, drain + watchdog state, and
            # which injected fault sites actually fired (empty plan = {})
            "preempted_requests": self.preempted,
            "restored_requests": self.restored,
            "recompute_tokens": self.recompute_tokens,
            "quarantined": self.quarantined,
            "exec_errors": self.exec_errors,
            "watchdog_trips": self.watchdog_trips,
            "draining": self.draining,
            "drained": self.drained,
            "faults_fired": self.faults.stats(),
            # multi-tenant admission (DESIGN.md §15): live queue state,
            # admission-wait distribution over a bounded recent window,
            # and per-tenant accept/reject/budget accounting
            "admission": self.policy.name,
            "queue_depth": len(self.waiting),
            "admission_wait_p50_ms": _pct(sorted(self._admission_waits),
                                          0.50),
            "admission_wait_p99_ms": _pct(sorted(self._admission_waits),
                                          0.99),
            "timeouts": self.timeouts,
            "shed": self.shed,
            "tenants": self.policy.snapshot(),
            "tenant_pinned_pages": dict(self.tenant_pinned_pages),
            # step-phase wall clock + compiled-variant probe (DESIGN.md §12)
            "prefill_ms": self.prefill_ms,
            "decode_ms": self.decode_ms,
            "sync_ms": self.sync_ms,
            "decode_steps": self._decode_steps,
            "decode_jit_variants": self.executor.decode_cache_size(),
            "use_paged_kernel": self.sc.use_paged_kernel,
            # executor calls that took a legacy gather-to-contiguous path
            # (0 whenever use_paged_kernel=True — regression-gated by the
            # parity matrix, DESIGN.md §13)
            "fallback_gather_calls": self.executor.fallback_gather_calls,
            # speculative decoding (DESIGN.md §16): proposer throughput,
            # acceptance, and how many iterations carried verify rows
            "speculate": self.sc.speculate,
            "spec_proposer": self.proposer.name,
            "spec_steps": self.spec_steps,
            "spec_step_share": self.spec_steps / max(1, self.steps),
            "spec_proposed_tokens": self.spec_proposed,
            "spec_accepted_tokens": self.spec_accepted,
            "spec_committed_tokens": self.spec_committed,
            "spec_acceptance_rate": (self.spec_accepted /
                                     max(1, self.spec_proposed)),
        }
