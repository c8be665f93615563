"""Uniform model API over the architecture families (port of
``repro/models/registry.py``).

``get_model(cfg)`` returns a :class:`ModelApi` with init_params / forward /
init_cache / prefill / decode_step / init_lora_stacks, dispatched on
``cfg.family``.  The dense, MoE and VLM families (all served by
:mod:`~repro_torch.models.transformer`) and the hybrid are ported; SSM and
audio raise, naming their ROADMAP item.  The logical-axis trees that the
reference's API also carries are for sharding, which goes with ROADMAP
Queue 1, item 13.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.core.config import ModelConfig
from repro_torch.models import hybrid
from repro_torch.models import transformer as tfm

# ported families: the module whose functions serve each (both take the
# same arguments), as in the reference's registry
_FAMILIES = {"dense": tfm, "moe": tfm, "vlm": tfm, "hybrid": hybrid}

# families of the reference's registry that are not ported yet, with the
# ROADMAP Queue 1 item that ports each
_UNPORTED = {
    "ssm": "item 11 (ssm.py)",
    "audio": "item 11 (encdec.py)",
}


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    init_params: Callable
    forward: Callable
    init_cache: Callable
    prefill: Callable
    decode_step: Callable
    init_lora_stacks: Optional[Callable]
    supports_forkkv: bool      # does the family have a LoRA'd KV cache?


def get_model(cfg: ModelConfig) -> ModelApi:
    fam = cfg.family
    if fam in _FAMILIES:
        mod = _FAMILIES[fam]
        return ModelApi(
            cfg=cfg,
            init_params=lambda seed=0, **kw: mod.init_params(cfg, seed, **kw),
            forward=lambda params, tokens, **kw: mod.forward(
                params, tokens, cfg, **kw),
            init_cache=lambda batch, max_len, **kw: mod.init_cache(
                cfg, batch, max_len, **kw),
            prefill=lambda params, tokens, cache, **kw: mod.prefill(
                params, tokens, cache, cfg, **kw),
            decode_step=lambda params, tokens, cache, kv_len, **kw:
                mod.decode_step(params, tokens, cache, kv_len, cfg, **kw),
            init_lora_stacks=lambda seed, n, **kw: mod.init_lora_stacks(
                cfg, seed, n, **kw),
            supports_forkkv=True)
    if fam in _UNPORTED:
        raise NotImplementedError(
            f"family {fam!r} is not ported yet (ROADMAP Queue 1, "
            f"{_UNPORTED[fam]})")
    raise ValueError(f"unknown family {fam!r}")
