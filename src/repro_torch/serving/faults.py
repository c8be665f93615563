"""Deterministic fault injection for the serving stack (DESIGN.md §17).

Tests, smoke.sh and CI need to *replay* failure schedules — "the third
pool allocation fails", "request r7's logits go NaN", "the first tier
demotion hits an IO error" — so the harness is a tiny seeded rule engine
rather than a random monkeypatcher:

  * every instrumented code path names its **site** and asks
    ``injector.fire(site, key=...)`` whether this particular call faults;
  * a **plan** maps sites to trigger lists; with a fixed seed the same
    plan fires at exactly the same calls on every run, which is what the
    preempt–restore parity gate relies on.

Plan grammar (``ServeConfig.fault_plan`` or ``FORKKV_FAULT_PLAN``)::

    site:trig,trig;site2:trig

with triggers

    cN     the Nth call at this site (1-based, per-site counter)
    rKEY   any call whose ``key`` argument equals KEY (e.g. a request id)
    pX     each call fires with probability X (seeded — deterministic)
    *      every call

Example: ``pool_alloc:c3,c4;nan_logits:r7`` fails the 3rd and 4th pool
allocations and poisons request 7's logits.

Known sites (grep for ``faults.fire`` / ``faults.io``):

  pool_alloc     device page allocation (engine._alloc) — fail → OOM path
  tier_demote    device→host page export (tiers.demote_node IO)
  tier_promote   host→device page import (tiers.promote_node IO)
  disk_io        disk-tier file read/write (tiers.DiskTier io_hook) —
                 spill failure drops the node, promote failure truncates
                 the match; either way the server recomputes (§18)
  nan_logits     poison one batch row's logits on the device (engine step)
  pump_stall     sleep ``stall_s`` inside the step loop (watchdog food)
  executor       raise before the batched executor call (isolation test)
"""
from __future__ import annotations

import os
import random
import time
from typing import Dict, List, Optional

SITES = ("pool_alloc", "tier_demote", "tier_promote", "disk_io",
         "nan_logits", "pump_stall", "executor")


class FaultError(RuntimeError):
    """Raised by ``io()`` sites; carries the site name for assertions."""

    def __init__(self, site: str):
        super().__init__(f"injected fault at site '{site}'")
        self.site = site


class FaultInjector:
    """Seeded, deterministic fault plan evaluator.

    The default (empty plan) instance never fires and costs one dict
    lookup per instrumented call, so production paths keep it inline
    rather than branching on "faults enabled".
    """

    def __init__(self, plan: str = "", seed: int = 0, stall_s: float = 0.25):
        self.plan = plan or ""
        self.seed = int(seed)
        self.stall_s = float(stall_s)
        self._rng = random.Random(self.seed)
        self._rules: Dict[str, List[str]] = {}
        self._calls: Dict[str, int] = {}
        self.fired: Dict[str, int] = {}
        for part in filter(None, (p.strip() for p in self.plan.split(";"))):
            site, _, trigs = part.partition(":")
            site = site.strip()
            if site not in SITES:
                raise ValueError(
                    f"unknown fault site '{site}' (known: {', '.join(SITES)})")
            self._rules.setdefault(site, []).extend(
                t.strip() for t in trigs.split(",") if t.strip())

    @property
    def active(self) -> bool:
        return bool(self._rules)

    def fire(self, site: str, key=None) -> bool:
        """Should this call at ``site`` fault?  Increments the per-site
        call counter either way so cN triggers stay aligned."""
        rules = self._rules.get(site)
        if not rules:
            return False
        n = self._calls.get(site, 0) + 1
        self._calls[site] = n
        hit = False
        for trig in rules:
            if trig == "*":
                hit = True
            elif trig.startswith("c"):
                if n == int(trig[1:]):
                    hit = True
            elif trig.startswith("p"):
                if self._rng.random() < float(trig[1:]):
                    hit = True
            elif trig.startswith("r"):
                if key is not None and str(key) == trig[1:]:
                    hit = True
            else:
                raise ValueError(f"bad fault trigger '{trig}'")
            if hit:
                break
        if hit:
            self.fired[site] = self.fired.get(site, 0) + 1
        return hit

    def io(self, site: str, key=None) -> None:
        """Raise :class:`FaultError` when the plan fires — for sites that
        model IO failures (tier export/import, executor)."""
        if self.fire(site, key=key):
            raise FaultError(site)

    def maybe_stall(self, site: str = "pump_stall") -> None:
        """Sleep ``stall_s`` when the plan fires — feeds the watchdog."""
        if self.fire(site):
            time.sleep(self.stall_s)

    def stats(self) -> Dict[str, int]:
        return {f"fault_{s}": self.fired.get(s, 0) for s in self._rules}


def from_config(sc) -> FaultInjector:
    """Build the injector from ServeConfig, falling back to the
    FORKKV_FAULT_PLAN / FORKKV_FAULT_SEED environment (smoke/CI wiring)."""
    plan = getattr(sc, "fault_plan", "") or os.environ.get(
        "FORKKV_FAULT_PLAN", "")
    seed = getattr(sc, "fault_seed", 0) or int(os.environ.get(
        "FORKKV_FAULT_SEED", "0"))
    return FaultInjector(plan=plan, seed=seed)
