"""Uniform model API over the architecture families (port of
``repro/models/registry.py``).

``get_model(cfg)`` returns a :class:`ModelApi` with init_params /
logical_axes / forward / init_cache / cache_logical_axes / prefill /
decode_step / init_lora_stacks / lora_logical_axes, dispatched on
``cfg.family``: the dense, MoE and VLM families (all served by
:mod:`~repro_torch.models.transformer`), the hybrid, the SSM (mamba2) and
the audio encoder-decoder (whisper).  The logical-axis trees name each
dimension of the parameters, caches and LoRA stacks for the sharding
layer (:mod:`repro_torch.launch.sharding`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.core.config import ModelConfig
from repro_torch.models import encdec, hybrid, ssm
from repro_torch.models import transformer as tfm

# the module whose functions serve each family (all take the same
# arguments), as in the reference's registry
_FAMILIES = {"dense": tfm, "moe": tfm, "vlm": tfm, "hybrid": hybrid,
             "ssm": ssm, "audio": encdec}
# the LoRA-stack init of a family where it is not its module's own: none
# for the attention-free SSM, the transformer's over the decoder's layers
# for the audio encoder-decoder
_LORA_INIT = {"ssm": None, "audio": tfm.init_lora_stacks}


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    init_params: Callable
    logical_axes: Callable
    forward: Callable
    init_cache: Callable
    cache_logical_axes: Callable
    prefill: Callable
    decode_step: Callable
    init_lora_stacks: Optional[Callable]
    lora_logical_axes: Optional[Callable]
    supports_forkkv: bool      # does the family have a LoRA'd KV cache?


def get_model(cfg: ModelConfig) -> ModelApi:
    fam = cfg.family
    if fam in _FAMILIES:
        mod = _FAMILIES[fam]
        init = _LORA_INIT[fam] if fam in _LORA_INIT else \
            mod.init_lora_stacks
        return ModelApi(
            cfg=cfg,
            init_params=lambda seed=0, **kw: mod.init_params(cfg, seed, **kw),
            logical_axes=lambda: mod.logical_axes(cfg),
            forward=lambda params, tokens, **kw: mod.forward(
                params, tokens, cfg, **kw),
            init_cache=lambda batch, max_len, **kw: mod.init_cache(
                cfg, batch, max_len, **kw),
            cache_logical_axes=lambda **kw: mod.cache_logical_axes(cfg, **kw),
            prefill=lambda params, tokens, cache, **kw: mod.prefill(
                params, tokens, cache, cfg, **kw),
            decode_step=lambda params, tokens, cache, kv_len, **kw:
                mod.decode_step(params, tokens, cache, kv_len, cfg, **kw),
            init_lora_stacks=None if init is None else (
                lambda seed, n, **kw: init(cfg, seed, n, **kw)),
            lora_logical_axes=None if init is None else
            tfm.lora_logical_axes,
            # attention-free: ForkKV does not apply to mamba2; whisper's
            # applies to its decoder self-attention
            supports_forkkv=fam != "ssm")
    raise ValueError(f"unknown family {fam!r}")
