"""Iteration-level token-budget scheduler (DESIGN.md §14).

The phase-separated step loop (one batched prefill call, then one decode
call, per step) lets a long prompt head-of-line-block every in-flight
token stream: decode rows wait for the whole prefill call's wall clock
each step.  This module replaces that with Sarathi-style iteration-level
scheduling: :class:`IterationScheduler` plans ONE :class:`BatchPlan` per
engine step, packing

  1. every runnable decode row first (q=1 each — decode is never starved
     by prefill; the rows are cheap and they are the latency-critical
     ones), then
  2. chunked-prefill rows, FCFS, each taking ``min(remaining prompt,
     remaining budget, max_prefill_tokens)`` tokens of the iteration's
     ``token budget``,

and the executor runs the whole plan as a single mixed call through the
unified kernel grid (each row carries its q-length as a scalar-prefetch
input — see ``kernels/paged_residual_attention.py``).  Broadcast-fork
groups still take precedence: the engine runs the broadcast pass first
and the scheduler simply sees the group's advanced ``prefill_pos``.

The scheduler also owns the per-request latency timestamps: a request's
``first_scheduled_at`` is stamped the first time any plan includes it,
feeding the queueing-delay component of TTFT (``Engine.metrics()``
aggregates p50/p99 over finished requests).

Pure planning, no device work: the module never touches pools or torch, so
its invariants (budget never exceeded, decode priority, chunk caps) are
unit-testable without a model — see ``tests/test_scheduler.py``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

from repro_torch.core.config import ServeConfig


@dataclasses.dataclass(frozen=True)
class RowPlan:
    """One row of an iteration: a request plus the q-slice it computes.

    ``kind == "decode"`` rows consume the request's last sampled token
    (q_len == 1, start == kv_len); ``kind == "prefill"`` rows compute the
    prompt slice ``[start, start + q_len)``; ``kind == "verify"`` rows
    are speculative decode rows (DESIGN.md §16) carrying the last sampled
    token plus ``draft`` guessed continuations (q_len == 1 + len(draft),
    start == kv_len) — the engine commits the accepted prefix and drops
    the rest via CoW.  All three are the same operation to the unified
    grid — write q_len tokens' KV at ``start`` and attend causally over
    ``start + q_len`` tokens — which is exactly why one kernel launch can
    serve the whole plan.
    """

    req: Any                    # serving.engine.Request (untyped: no cycle)
    q_len: int
    start: int
    kind: str                   # "decode" | "prefill" | "verify"
    draft: Tuple[int, ...] = ()  # speculated tokens (verify rows only)

    @property
    def end(self) -> int:
        return self.start + self.q_len


@dataclasses.dataclass
class BatchPlan:
    """The rows one engine iteration executes as a single mixed call."""

    rows: List[RowPlan]
    budget: int                 # the token budget this plan was packed under

    @property
    def decode_rows(self) -> List[RowPlan]:
        return [r for r in self.rows if r.kind == "decode"]

    @property
    def verify_rows(self) -> List[RowPlan]:
        return [r for r in self.rows if r.kind == "verify"]

    @property
    def prefill_rows(self) -> List[RowPlan]:
        return [r for r in self.rows if r.kind == "prefill"]

    @property
    def total_tokens(self) -> int:
        return sum(r.q_len for r in self.rows)

    @property
    def q_max(self) -> int:
        return max((r.q_len for r in self.rows), default=0)

    @property
    def is_mixed(self) -> bool:
        """True when decode(/verify) AND prefill rows share this
        iteration — the overlap case the unified grid exists for."""
        return bool(self.decode_rows or self.verify_rows) \
            and bool(self.prefill_rows)


class IterationScheduler:
    """Plans one token-budget iteration per engine step.

    Packing policy (DESIGN.md §14):

    * decode rows first, ALL runnable ones (capped at ``max_batch``) —
      the budget can bound prefill to zero but never drops a decode row,
      so token streams keep flowing no matter how much prompt is queued;
    * then prefill rows FCFS (capped at ``max_prefill_batch``), each
      chunk ``min(prompt remainder, budget remainder,
      max_prefill_tokens)`` — a long prompt streams in across iterations
      instead of monopolizing one.

    Consequently ``plan.total_tokens <= max(budget, len(decode_rows))``,
    the invariant ``tests/test_scheduler.py`` locks down.
    """

    def __init__(self, sc: ServeConfig):
        self.sc = sc
        self.plans = 0              # iterations planned (metrics)

    @property
    def budget(self) -> int:
        if self.sc.iteration_token_budget > 0:
            return self.sc.iteration_token_budget
        return self.sc.max_prefill_tokens + self.sc.max_batch

    def plan(self, running: Sequence[Any],
             now: Optional[float] = None,
             propose: Optional[Callable[[Any], Sequence[int]]] = None
             ) -> BatchPlan:
        """Pack one iteration from the ``running`` list.  Does not mutate
        request state beyond stamping ``first_scheduled_at``.

        ``propose`` (DESIGN.md §16) is the engine's speculation hook: per
        decode-ready request it returns up to k drafted tokens (empty =
        no speculation).  A non-empty draft turns the decode row into a
        ``verify`` row with q_len = 1 + len(draft); drafts are trimmed to
        the remaining token budget but the base decode token is never
        dropped — decode stays unstarvable under budget pressure.
        """
        budget = self.budget
        rows: List[RowPlan] = []
        used = 0
        # 1. decode rows — never starved, regardless of budget pressure
        for r in running:
            if len(rows) >= self.sc.max_batch:
                break
            if r.state == "decode" and \
                    len(r.output) < r.max_new_tokens + 1:
                draft: Tuple[int, ...] = ()
                if propose is not None:
                    draft = tuple(propose(r))[:max(0, budget - used - 1)]
                if draft:
                    rows.append(RowPlan(r, 1 + len(draft), r.kv_len,
                                        "verify", draft))
                else:
                    rows.append(RowPlan(r, 1, r.kv_len, "decode"))
                used += 1 + len(draft)
        # 2. chunked prefill fills what budget remains
        cap = self.sc.max_prefill_batch or len(running)
        n_prefill = 0
        for r in running:
            if r.state != "prefill" or n_prefill >= cap:
                continue
            if used >= budget:
                break
            # ptoks, not prompt: a restored request (DESIGN.md §17)
            # re-prefills its generated suffix like prompt tokens
            remainder = len(r.ptoks) - r.prefill_pos
            chunk = min(remainder, budget - used,
                        self.sc.max_prefill_tokens)
            if chunk <= 0:
                continue
            if chunk < remainder:
                # align mid-prompt chunks to a power of two: the executor
                # pads the batch's q tile to pow2(q_max), so a 48-token
                # chunk would compile and compute a 64-wide call at 33%
                # padding waste — clamping costs one extra iteration per
                # prompt at worst and keeps every mixed launch tight.
                # Final chunks keep their exact remainder (the tail pad
                # is unavoidable and paid once per prompt).
                chunk = 1 << (chunk.bit_length() - 1)
            rows.append(RowPlan(r, chunk, r.prefill_pos, "prefill"))
            used += chunk
            n_prefill += 1
        if rows:
            self.plans += 1
            stamp = now if now is not None else time.time()
            for rp in rows:
                if rp.req.first_scheduled_at == 0.0:
                    rp.req.first_scheduled_at = stamp
        return BatchPlan(rows, budget)
