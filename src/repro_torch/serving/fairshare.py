"""Multi-tenant admission control: fair-share scheduling + overload
shedding (DESIGN.md §15).

The engine's admission loop was FIFO: ``waiting[0]`` or nothing.  That is
fine for one cooperative caller, but the HTTP frontend
(:mod:`repro_torch.serving.frontend`) turns the engine into a shared service —
and with FIFO a single tenant flooding requests owns every batch slot
while everyone else queues behind its backlog.  This module makes
admission a pluggable policy object:

  * :class:`FIFOAdmission` — the seed behaviour, bit-compatible: strict
    arrival order, stop at the first request that does not fit.
  * :class:`FairShareAdmission` — weighted fair queuing across tenants
    with an SRPT bias, aging, per-tenant budgets and a prefix-hit
    discount.

Admission score (lower = admitted sooner)::

    vtime_t  = service_t / weight_t          # WFQ virtual service
    miss_r   = len(prompt) * (1 - hit_prob)  # expected prefill compute
    cost_r   = miss_r + max_new_tokens       # SRPT proxy (total compute)
    score_r  = vtime_t + srpt_weight * cost_r - aging_rate * wait_s

``vtime_t`` is the tenant's admitted compute divided by its weight — the
classic WFQ virtual clock, so a tenant that has consumed little service
wins ties regardless of arrival order.  ``cost_r`` biases toward short
requests (SRPT keeps mean latency low), and the prefix-hit probe
(``hit_prob`` from a radix ``match_prefix`` walk) recognises that a
request landing on warm cache is cheaper than its token count suggests —
admit it sooner.  ``aging_rate`` (cost-tokens of credit per waiting
second) bounds starvation: any request's score eventually goes negative,
so a long job cannot be SRPT-starved forever.

Budgets gate a tenant out of ``select()`` entirely (its requests keep
waiting, other tenants proceed): concurrent admitted requests
(``tenant_max_concurrent``), tokens in flight — prompt + max_new of
admitted, unfinished requests — (``tenant_max_tokens_in_flight``), and
pinned device pages held by the tenant's live sessions
(``tenant_max_pinned_pages``, probed via a callback so the policy stays
pool-agnostic).

Overload shedding is explicit, not emergent: once ``max_queue_depth`` or
``max_queue_wait_s`` is exceeded, ``shed()`` names victims — worst score
first for fair share, newest first for FIFO — and the engine finishes
them with ``finish_reason="rejected"`` and a retry-after hint the HTTP
layer surfaces as ``429`` + ``Retry-After``.  Shedding is deterministic:
same queue, same clock, same victims.

Pure control plane: no torch, no pools — unit-testable without a model
(``tests/test_fairshare.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.config import ServeConfig

__all__ = ["AdmissionPolicy", "FIFOAdmission", "FairShareAdmission",
           "TenantState", "make_policy"]


@dataclasses.dataclass
class TenantState:
    """Per-tenant accounting the fair-share score reads."""

    weight: float = 1.0
    service: float = 0.0          # admitted cost-tokens (WFQ service)
    concurrent: int = 0           # admitted, unfinished requests
    tokens_in_flight: int = 0     # prompt + max_new of those requests
    accepted: int = 0
    rejected: int = 0             # shed / impossible
    timeouts: int = 0             # deadline expiries while waiting

    @property
    def vtime(self) -> float:
        return self.service / max(self.weight, 1e-9)


class AdmissionPolicy:
    """Admission-order + overload-shedding interface (DESIGN.md §15).

    The engine calls, per step: :meth:`shed` (victims to reject),
    :meth:`select` repeatedly (next request to try admitting; ``None``
    ends the admission loop), then :meth:`on_admit` /
    :meth:`on_finish` / :meth:`on_reject` as lifecycle notifications.
    Policies never mutate the queue — the engine owns request state.
    """

    name = "base"

    def __init__(self, sc: ServeConfig,
                 probe_hit: Optional[Callable[[Any], float]] = None,
                 pinned_pages: Optional[Callable[[str], int]] = None):
        self.sc = sc
        self._probe_hit = probe_hit or (lambda req: 0.0)
        self._pinned_pages = pinned_pages or (lambda tenant: 0)
        self.tenants: Dict[str, TenantState] = {}
        self._weights = dict(sc.tenant_weights)
        self._hit_cache: Dict[int, float] = {}

    # ------------------------------------------------------------ helpers
    def tenant(self, name: str) -> TenantState:
        st = self.tenants.get(name)
        if st is None:
            st = TenantState(weight=float(self._weights.get(name, 1.0)))
            self.tenants[name] = st
        return st

    def hit_prob(self, req) -> float:
        """Prefix-hit probability for ``req``, probed once and cached —
        the radix walk is cheap but not free, and the fraction only
        changes while the request waits if OTHER traffic warms its
        prefix (a staleness we accept)."""
        p = self._hit_cache.get(req.rid)
        if p is None:
            p = min(1.0, max(0.0, float(self._probe_hit(req))))
            self._hit_cache[req.rid] = p
        return p

    def cost(self, req) -> float:
        """Expected compute in tokens: prefill the radix cache will not
        cover, plus the decode budget."""
        miss = len(req.prompt) * (1.0 - self.hit_prob(req))
        return miss + req.max_new_tokens

    def over_budget(self, tenant: str) -> bool:
        sc, st = self.sc, self.tenant(tenant)
        if sc.tenant_max_concurrent > 0 and \
                st.concurrent >= sc.tenant_max_concurrent:
            return True
        if sc.tenant_max_tokens_in_flight > 0 and \
                st.tokens_in_flight >= sc.tenant_max_tokens_in_flight:
            return True
        if sc.tenant_max_pinned_pages > 0 and \
                self._pinned_pages(tenant) > sc.tenant_max_pinned_pages:
            return True
        return False

    # ---------------------------------------------------------- interface
    def select(self, waiting: Sequence[Any], now: float) -> Optional[Any]:
        raise NotImplementedError

    def shed(self, waiting: Sequence[Any],
             now: float) -> List[Tuple[Any, float]]:
        """Victims to reject as ``(request, retry_after_s)``, computed
        against the configured queue-depth and wait-time bounds.  The
        base rule is shared; subclasses define victim ORDER via
        :meth:`_shed_order`."""
        sc = self.sc
        victims: List[Tuple[Any, float]] = []
        shed_set = set()
        if sc.max_queue_wait_s > 0:
            for req in waiting:
                if now - req.arrival > sc.max_queue_wait_s:
                    victims.append((req, self._retry_after(len(waiting))))
                    shed_set.add(req.rid)
        if sc.max_queue_depth > 0:
            depth = len(waiting) - len(shed_set)
            if depth > sc.max_queue_depth:
                for req in self._shed_order(waiting, now):
                    if req.rid in shed_set:
                        continue
                    victims.append((req, self._retry_after(depth)))
                    shed_set.add(req.rid)
                    depth -= 1
                    if depth <= sc.max_queue_depth:
                        break
        return victims

    def _shed_order(self, waiting: Sequence[Any],
                    now: float) -> List[Any]:
        """Depth-bound victim preference; FIFO sheds newest first."""
        return sorted(waiting, key=lambda r: r.arrival, reverse=True)

    def _retry_after(self, depth: int) -> float:
        """Deterministic backoff hint: half a second per queued request
        beyond the bound, floored at 1s."""
        excess = max(0, depth - max(self.sc.max_queue_depth, 0))
        return max(1.0, 0.5 * excess)

    # --------------------------------------------------------- lifecycle
    def on_admit(self, req, now: float) -> None:
        st = self.tenant(req.tenant)
        st.concurrent += 1
        st.tokens_in_flight += len(req.prompt) + req.max_new_tokens
        st.accepted += 1
        st.service += self.cost(req)
        self._hit_cache.pop(req.rid, None)

    def on_finish(self, req, now: float) -> None:
        """An ADMITTED request finished (any reason)."""
        st = self.tenant(req.tenant)
        st.concurrent = max(0, st.concurrent - 1)
        st.tokens_in_flight = max(
            0, st.tokens_in_flight - (len(req.prompt) + req.max_new_tokens))
        # settle decode billing against tokens ACTUALLY generated: admission
        # charged the full max_new budget up front; a stop-token finish (or
        # a speculative run whose rejected drafts were never committed)
        # generated fewer.  Proposed-but-rejected draft tokens are never
        # billed — only the committed stream counts as service.
        out = getattr(req, "output", None)
        if out is not None:
            gen = max(0, len(out) - 1)
            st.service += gen - req.max_new_tokens

    def on_reject(self, req, now: float, timeout: bool = False) -> None:
        """A WAITING request was refused (shed / impossible / deadline)."""
        st = self.tenant(req.tenant)
        if timeout:
            st.timeouts += 1
        else:
            st.rejected += 1
        self._hit_cache.pop(req.rid, None)

    # -------------------------------------------------------- preemption
    def preempt_order(self, running: Sequence[Any],
                      now: float) -> List[Any]:
        """Victim preference for preempt–restore (DESIGN.md §17): the
        engine preempts the FIRST feasible candidate in this order when
        the device pool stays exhausted.  The base (FIFO-compatible) rule
        is newest-admitted first — the request that has invested the
        least compute loses it.  Accounting is NOT touched here; the
        engine calls :meth:`on_preempt` once a victim is actually
        checkpointed."""
        return sorted(running, key=lambda r: r.arrival, reverse=True)

    def on_preempt(self, req, now: float) -> None:
        """An admitted request went back to the waiting queue.  Reverse
        the in-flight budgets (it no longer holds batch/page resources)
        but KEEP the service already billed: the tenant paid for compute
        that really ran, and keeping it billed makes the same tenant's
        requests the natural next victims under fair share instead of a
        preempt–readmit livelock."""
        st = self.tenant(req.tenant)
        st.concurrent = max(0, st.concurrent - 1)
        st.tokens_in_flight = max(
            0, st.tokens_in_flight - (len(req.prompt) + req.max_new_tokens))

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        return {name: {"weight": st.weight, "service": round(st.service, 2),
                       "vtime": round(st.vtime, 2),
                       "concurrent": st.concurrent,
                       "tokens_in_flight": st.tokens_in_flight,
                       "accepted": st.accepted, "rejected": st.rejected,
                       "timeouts": st.timeouts}
                for name, st in sorted(self.tenants.items())}


class FIFOAdmission(AdmissionPolicy):
    """The seed behaviour: strict arrival order, head-of-line blocking
    and all.  Budgets still apply (a head request from an over-budget
    tenant blocks the queue exactly as a too-big one does — FIFO is
    FIFO), which keeps the two policies comparable under one config."""

    name = "fifo"

    def select(self, waiting: Sequence[Any], now: float) -> Optional[Any]:
        if not waiting:
            return None
        head = waiting[0]
        if self.over_budget(head.tenant):
            return None
        return head


class FairShareAdmission(AdmissionPolicy):
    """Weighted fair queuing + SRPT bias + aging (module docstring has
    the score formula).  ``select`` returns the eligible waiting request
    with the LOWEST score; tenants over budget are skipped, not
    blocking."""

    name = "fairshare"

    def score(self, req, now: float) -> float:
        sc = self.sc
        wait_s = max(0.0, now - req.arrival)
        return (self.tenant(req.tenant).vtime
                + sc.fair_srpt_weight * self.cost(req)
                - sc.fair_aging_tokens_per_s * wait_s)

    def select(self, waiting: Sequence[Any], now: float) -> Optional[Any]:
        best, best_key = None, None
        for i, req in enumerate(waiting):
            if self.over_budget(req.tenant):
                continue
            key = (self.score(req, now), i)   # index: deterministic ties
            if best_key is None or key < best_key:
                best, best_key = req, key
        return best

    def _shed_order(self, waiting: Sequence[Any],
                    now: float) -> List[Any]:
        """Depth-bound victims: worst score first — the request fair
        share would have admitted LAST is the one shed first."""
        scored = sorted(((self.score(r, now), i, r)
                         for i, r in enumerate(waiting)), reverse=True)
        return [r for _, _, r in scored]

    def preempt_order(self, running: Sequence[Any],
                      now: float) -> List[Any]:
        """Preemption victims: worst fair-share score first — the same
        ordering shedding uses, so the request fair share values least
        is the one that loses its batch slot under pressure."""
        scored = sorted(((self.score(r, now), i, r)
                         for i, r in enumerate(running)), reverse=True)
        return [r for _, _, r in scored]


def make_policy(sc: ServeConfig,
                probe_hit: Optional[Callable[[Any], float]] = None,
                pinned_pages: Optional[Callable[[str], int]] = None
                ) -> AdmissionPolicy:
    """Build the policy named by ``ServeConfig.admission``."""
    if sc.admission == "fifo":
        return FIFOAdmission(sc, probe_hit, pinned_pages)
    if sc.admission == "fairshare":
        return FairShareAdmission(sc, probe_hit, pinned_pages)
    raise ValueError(f"unknown admission policy {sc.admission!r}")
