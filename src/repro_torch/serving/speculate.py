"""Speculative decoding on CoW forks (DESIGN.md §16).

ForkKV's fork/CoW machinery makes speculative decoding unusually cheap:

  * **Propose.** A draft-free :class:`Proposer` guesses the next k tokens
    from token statistics alone — no draft model, no extra forward pass.
    Two built-ins: :class:`PromptLookupProposer` (longest-suffix n-gram
    match against the request's OWN prompt+output — agent traces quote
    their context constantly) and :class:`NGramCacheProposer` (a bounded
    global n-gram → continuation cache warmed by COMPLETED requests, so a
    repeated fork replays its sibling's output at ~100% acceptance).
  * **Verify.** The scheduler turns the request's decode row into a
    ``verify`` row carrying ``[last_token, d_1..d_k]`` — q_len = k+1
    through the existing unified mixed grid (the per-row q-length
    scalar-prefetch from DESIGN.md §14 already handles it).  The executor
    computes the greedy argmax at EVERY row position on the device and reduces
    the longest accepted prefix per row — one host sync per step, never
    per token.
  * **Rollback.** Drafted tokens' KV lands at positions >= kv_len, which
    the page-aligned radix invariants guarantee live in request-OWNED
    (CoW-private) pages: ``match_prefix`` only matches whole pages and
    ``insert`` only adopts full pages, so shared prefixes end at a page
    boundary <= kv_len.  Rejected-draft KV is therefore private garbage —
    overwritten by the next step's writes at those same positions, or
    freed by the ordinary refcount decrement at finish.  ``_finish``
    commits only ``(prompt + output[:-1])[:kv_len]``, so garbage can never
    enter the radix tree.  Rollback is a refcount decrement, not a rewind.

Greedy only: under argmax sampling, accepted tokens are bit-identical to
the non-speculative stream (the verify pass computes the same logits the
sequential decode would), which is what the parity matrix locks down.
Sampled requests fall back to plain decode rows.

Pure host-side token statistics: no torch, no pools — unit-testable without
a model (``tests/test_speculate.py``).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import List, Sequence

from repro_torch.core.config import ServeConfig

__all__ = ["Proposer", "PromptLookupProposer", "NGramCacheProposer",
           "AdaptiveK", "longest_accepted_prefix", "make_proposer"]


def longest_accepted_prefix(draft: Sequence[int],
                            greedy: Sequence[int]) -> int:
    """Reference accept rule: the number of leading draft tokens that
    match the target model's greedy predictions.  ``greedy[j]`` is the
    argmax AFTER consuming ``[t0, d_1..d_j]``, so draft ``d_{j+1}`` is
    accepted iff it equals ``greedy[j]`` and every earlier draft was.
    The on-device equivalent (cumprod-sum over the match mask) runs
    inside the executor; this mirror exists for tests."""
    n = 0
    for d, g in zip(draft, greedy):
        if d != g:
            break
        n += 1
    return n


class Proposer:
    """Draft-free proposer interface.

    ``propose(tokens, k)`` returns up to ``k`` guessed continuations of
    ``tokens`` (the request's prompt + output so far); an empty list
    means "no guess" and the request runs a plain decode row this step.
    ``observe(tokens)`` feeds a COMPLETED request's definitive sequence
    back in so future requests can replay it (no-op by default).
    """

    name = "base"

    def propose(self, tokens: Sequence[int], k: int) -> List[int]:
        raise NotImplementedError

    def observe(self, tokens: Sequence[int]) -> None:
        pass

    def stats(self) -> dict:
        return {}


class PromptLookupProposer(Proposer):
    """Prompt-lookup decoding: match the current suffix n-gram against
    earlier occurrences in the request's OWN tokens and propose the
    continuation of the MOST RECENT match (longest n wins).

    Agent workloads re-quote their context constantly (tool schemas,
    instructions, prior turns), so self-matches are common and free —
    no state beyond the request's token list, nothing to evict.
    """

    name = "prompt_lookup"

    def __init__(self, max_ngram: int = 4, min_ngram: int = 2,
                 scan_window: int = 4096):
        assert 1 <= min_ngram <= max_ngram
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        # bound the per-proposal scan for very long sequences; recent
        # tokens are the likeliest match sites anyway
        self.scan_window = scan_window

    def propose(self, tokens: Sequence[int], k: int) -> List[int]:
        toks = list(tokens)
        L = len(toks)
        if k <= 0 or L < self.min_ngram + 1:
            return []
        lo = max(0, L - self.scan_window)
        for n in range(min(self.max_ngram, L - 1), self.min_ngram - 1, -1):
            suffix = toks[L - n:]
            # most recent earlier occurrence: scan right-to-left, the
            # match must END strictly before the sequence's end so a
            # continuation token exists
            for i in range(L - n - 1, lo - 1, -1):
                if toks[i:i + n] == suffix:
                    cont = toks[i + n:i + n + k]
                    if cont:
                        return cont
        return []


class NGramCacheProposer(Proposer):
    """Bounded global n-gram → continuation cache, warmed by completed
    requests (a flat radix over fixed-length keys — the bounded stand-in
    for a suffix automaton).

    :meth:`observe` indexes every n-gram of a finished request's
    definitive sequence to its following tokens; :meth:`propose` looks up
    the current suffix (longest n first) and returns the cached
    continuation.  LRU-bounded at ``max_entries`` keys, each holding at
    most ``cont_len`` continuation tokens, so memory is
    O(max_entries · cont_len) regardless of traffic.  On a cache miss it
    falls back to prompt-lookup over the request's own tokens, so cold
    requests still speculate.

    The payoff case is the agent tree: sibling forks sharing a context
    produce near-identical outputs, so the second fork's continuation is
    already cached when it decodes — acceptance approaches 100% and a
    verify step commits k+1 tokens at the cost of one.
    """

    name = "ngram_cache"

    def __init__(self, max_ngram: int = 4, min_ngram: int = 2,
                 max_entries: int = 8192, cont_len: int = 16):
        assert 1 <= min_ngram <= max_ngram
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self.max_entries = max_entries
        self.cont_len = cont_len
        self._cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._fallback = PromptLookupProposer(max_ngram, min_ngram)
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._cache)

    def observe(self, tokens: Sequence[int]) -> None:
        toks = list(tokens)
        L = len(toks)
        for n in range(self.min_ngram, self.max_ngram + 1):
            for i in range(0, L - n):
                key = tuple(toks[i:i + n])
                cont = tuple(toks[i + n:i + n + self.cont_len])
                # last writer wins + refreshes recency
                self._cache.pop(key, None)
                self._cache[key] = cont
        while len(self._cache) > self.max_entries:
            self._cache.popitem(last=False)       # LRU eviction

    def propose(self, tokens: Sequence[int], k: int) -> List[int]:
        toks = list(tokens)
        L = len(toks)
        if k <= 0 or L < self.min_ngram:
            return []
        for n in range(min(self.max_ngram, L), self.min_ngram - 1, -1):
            key = tuple(toks[L - n:])
            cont = self._cache.get(key)
            if cont:
                self._cache.move_to_end(key)      # refresh recency
                self.hits += 1
                return list(cont[:k])
        self.misses += 1
        return self._fallback.propose(toks, k)

    def stats(self) -> dict:
        return {"entries": len(self._cache), "hits": self.hits,
                "misses": self.misses}


class AdaptiveK:
    """Per-request draft-length controller: back off when acceptance
    drops, recover when it runs high.

    Keeps an EMA of the per-step acceptance rate; below ``low`` the draft
    length halves (floor ``k_min``), above ``high`` it grows by one
    (ceiling ``k_max``).  A proposer feeding garbage therefore converges
    to k_min within a few steps — the verify row stays nearly as cheap as
    a plain decode row — while a replayed trace climbs back to k_max.
    """

    def __init__(self, k_max: int, k_min: int = 1, alpha: float = 0.5,
                 low: float = 0.35, high: float = 0.8):
        self.k_max = max(1, k_max)
        self.k_min = max(1, min(k_min, self.k_max))
        self.alpha = alpha
        self.low = low
        self.high = high
        self.k = self.k_max           # optimistic start
        self.ema = 1.0

    def update(self, proposed: int, accepted: int) -> int:
        """Feed one verify step's outcome; returns the new draft cap."""
        if proposed > 0:
            rate = accepted / proposed
            self.ema = self.alpha * rate + (1.0 - self.alpha) * self.ema
            if self.ema < self.low:
                self.k = max(self.k_min, self.k // 2)
            elif self.ema > self.high:
                self.k = min(self.k_max, self.k + 1)
        return self.k


def make_proposer(sc: ServeConfig) -> Proposer:
    """Build the proposer named by ``ServeConfig.spec_proposer``."""
    if sc.spec_proposer == "prompt_lookup":
        return PromptLookupProposer(min_ngram=sc.spec_min_ngram)
    if sc.spec_proposer == "ngram_cache":
        return NGramCacheProposer(min_ngram=sc.spec_min_ngram,
                                  max_entries=sc.spec_cache_entries)
    raise ValueError(f"unknown spec_proposer {sc.spec_proposer!r}")
