"""Sampling parameters + token selection (port of
``repro/serving/sampling.py``).

:func:`sample_tokens` runs on the executor's device:

  * greedy rows (``temperature <= 0``) take ``argmax`` over the RAW logits
    (the first maximum, as in the reference), so greedy output is exact;
  * sampled rows apply temperature, then top-k, then top-p masking, and
    draw from a ``torch.Generator`` seeded from (seed, position) — fully
    deterministic given (seed, #tokens generated so far) and independent of
    batch composition.  It cannot reproduce JAX's threefry draws, so
    sampled streams match the reference only in distribution.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request token-selection policy (frozen: safe to share/hash).

    temperature  0.0 (default) = greedy argmax; > 0 = categorical sampling
    top_k        keep only the k highest logits (0 = disabled)
    top_p        nucleus sampling: keep the smallest prefix of the sorted
                 distribution with cumulative probability >= top_p
                 (1.0 = disabled)
    seed         PRNG seed for this request's stream (ignored when greedy)
    max_new_tokens  generation budget
    stop_token_ids  generation finishes (reason "stop") when one of these
                 is produced; the stop token itself is not returned
    speculate    per-request speculative-decoding override (DESIGN.md
                 §16): None defers to ``ServeConfig.speculate``; True/
                 False forces it on/off for this request.  Greedy
                 requests only — sampled rows always run plain decode.
    spec_k       per-request draft-length cap (0 = ``ServeConfig.spec_k``)
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    max_new_tokens: int = 16
    stop_token_ids: Tuple[int, ...] = ()
    speculate: Optional[bool] = None
    spec_k: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got "
                             f"{self.temperature}")
        if not 0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if self.max_new_tokens < 0:
            raise ValueError("max_new_tokens must be >= 0")
        if self.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {self.spec_k}")
        # tolerate lists from CLI / JSON callers
        object.__setattr__(self, "stop_token_ids",
                           tuple(self.stop_token_ids))

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


GREEDY = SamplingParams()


def _row_generator(seed: int, position: int,
                   device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + int(position)) & (2 ** 63 - 1))
    return gen


def sample_tokens(logits: torch.Tensor, temps: torch.Tensor,
                  top_ks: torch.Tensor, top_ps: torch.Tensor,
                  seeds: torch.Tensor, positions: torch.Tensor
                  ) -> torch.Tensor:
    """Select one token per row of ``logits``.

    logits: (B, V); temps/top_ps: (B,) float; top_ks/seeds/positions: (B,)
    int32.  ``positions`` is the number of tokens the row's request has
    generated so far, so successive steps draw fresh randomness
    deterministically.  Returns (B,) int32.
    """
    vocab = logits.shape[-1]
    greedy = temps <= 0.0
    scaled = logits.to(torch.float32) / \
        torch.where(greedy, torch.ones_like(temps), temps)[:, None]
    # top-k: threshold at the k-th largest logit (k per row)
    sort_desc = torch.sort(scaled, dim=-1, descending=True).values
    k = torch.clamp(torch.where(top_ks <= 0, torch.full_like(top_ks, vocab),
                                top_ks), 1, vocab)
    kth = torch.gather(sort_desc, 1, (k - 1)[:, None].long())
    neg_inf = torch.tensor(-float("inf"), device=logits.device)
    masked = torch.where(scaled < kth, neg_inf, scaled)
    # top-p over the top-k-masked distribution: keep the smallest prefix of
    # the sorted probs whose EXCLUSIVE cumsum is < top_p (the most probable
    # token is always kept)
    sort_m = torch.sort(masked, dim=-1, descending=True).values
    probs = torch.softmax(sort_m, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_ps[:, None]
    last = torch.clamp(keep.sum(dim=-1) - 1, min=0)
    pth = torch.gather(sort_m, 1, last[:, None].long())
    masked = torch.where(masked < pth, neg_inf, masked)
    out = torch.argmax(logits, dim=-1)
    # seeded rows draw on their own generators (host loop over the rows;
    # the sampled path is off the greedy hot path)
    probs = torch.softmax(masked, dim=-1)
    for i in torch.nonzero(~greedy).flatten().tolist():
        gen = _row_generator(int(seeds[i]), int(positions[i]), logits.device)
        out[i] = torch.multinomial(probs[i], 1, generator=gen)[0]
    return out.to(torch.int32)
