"""Step builders for the dry run and for runs on a mesh (port of
``repro/launch/steps.py``).

For each (architecture x input shape) this constructs:
  * abstract state (params / optimizer / LoRA stacks / KV caches) as
    ``meta`` tensors, which have shapes and dtypes and hold no memory (the
    reference's ``jax.eval_shape``);
  * the shardings of every argument and output, from the model's logical
    axes and the rule table (:mod:`repro_torch.launch.sharding`);
  * the step itself, a plain function that runs on whatever device its
    arguments are on: on meta tensors it computes shapes only (the dry
    run counts its FLOPs, :mod:`repro_torch.launch.roofline`); on real
    tensors of a 1x1 mesh (``mesh.make_local_mesh``) it is the step, as
    the reference's jitted step runs on ``make_local_mesh()``.

train_4k   -> train_step   (loss + grads + optimizer update)
prefill_32k-> prefill_step (populate disaggregated cache, argmax logits)
decode_*   -> serve_step   (ONE token against a seq_len cache)
"""
from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch import configs as cfg_lib
from repro_torch.core.config import ModelConfig, ShapeConfig
from repro_torch.launch import sharding as shd
from repro_torch.models import base
from repro_torch.models.registry import get_model
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import train_loop

N_ADAPTERS = 8          # concurrent agents in the serving dry-run
# gradient-accumulation microbatches per train step: 16 keeps the local
# microbatch at 1 sequence per chip (256 global / 16 data shards / 16),
# bounding activation temps
DEFAULT_ACCUM = 16
ACCUM_STEPS = {}

META = torch.device("meta")


def accum_for(cfg, strategy: str = "baseline") -> int:
    # optimized strategy, small models: activations fit without microbatching
    # and every accumulation pass re-streams the (replicated) weights
    if strategy == "optimized" and cfg.num_params < 1e9:
        return 1
    return ACCUM_STEPS.get(cfg.name, DEFAULT_ACCUM)


class StepShardings(NamedTuple):
    """The sharding trees of a step's arguments and of its outputs (None:
    replicated), one per argument and output."""
    args: tuple
    outputs: tuple


class BuiltStep(NamedTuple):
    step_fn: Callable       # runs on meta or real tensors alike
    abstract_args: tuple    # meta trees to call it with
    shardings: StepShardings
    description: str
    abstract_outputs: tuple = ()   # meta trees of what it returns


def _opt_axes(cfg: ModelConfig, param_axes):
    inner = opt_lib.opt_state_logical_axes(cfg.optimizer, param_axes)
    return opt_lib.OptState(step=None, inner=inner)


def _device_of(tree) -> torch.device:
    return base.leaves(tree)[0].device


def build_train_step(cfg: ModelConfig, mesh, shape: ShapeConfig,
                     strategy: str = "baseline",
                     accum: Optional[int] = None) -> BuiltStep:
    """``train_loop.make_train_step`` with ``accum_for``'s microbatches
    (``accum`` given: that many)."""
    api = get_model(cfg)
    accum = accum_for(cfg, strategy) if accum is None else accum

    @functools.lru_cache(maxsize=None)
    def on(device: torch.device):
        return train_loop.make_train_step(cfg, accum_steps=accum,
                                          device=device)

    params_sds = api.init_params(0, device=META)
    opt_sds = on(META)[0](params_sds)
    batch_sds = cfg_lib.input_specs(cfg, shape)

    p_axes = api.logical_axes()
    params_sh = shd.tree_shardings(mesh, params_sds, p_axes, cfg, "train",
                                   strategy)
    opt_sh = shd.tree_shardings(mesh, opt_sds, _opt_axes(cfg, p_axes), cfg,
                                "train", strategy)
    batch_sh = shd.input_shardings(mesh, batch_sds, cfg, "train", strategy)

    def train_step(params, opt_state, batch):
        return on(_device_of(params))[1](params, opt_state, batch)

    scalar = torch.empty((), dtype=torch.float32, device=META)
    return BuiltStep(train_step, (params_sds, opt_sds, batch_sds),
                     StepShardings((params_sh, opt_sh, batch_sh),
                                   (params_sh, opt_sh, None)),
                     f"train_step accum={accum} opt={cfg.optimizer}",
                     (params_sds, opt_sds,
                      {"loss": scalar, "grad_norm": scalar}))


def _lora_state(cfg: ModelConfig, api, mesh, purpose: str,
                strategy: str = "baseline"):
    if api.init_lora_stacks is None:
        return None, None
    lora_sds = api.init_lora_stacks(0, N_ADAPTERS, device=META)
    lora_sh = shd.tree_shardings(mesh, lora_sds, api.lora_logical_axes(),
                                 cfg, purpose, strategy)
    return lora_sds, lora_sh


def build_prefill_step(cfg: ModelConfig, mesh, shape: ShapeConfig,
                       disagg: Optional[bool] = None,
                       strategy: str = "baseline") -> BuiltStep:
    """A fresh cache of Sq positions, the prompt prefilled into it; the
    argmax of the last position's logits and the cache."""
    api = get_model(cfg)
    disagg = api.supports_forkkv if disagg is None else disagg
    B, S = shape.global_batch, shape.seq_len

    params_sds = api.init_params(0, device=META)
    params_sh = shd.tree_shardings(mesh, params_sds, api.logical_axes(), cfg,
                                   "prefill", strategy)
    lora_sds, lora_sh = _lora_state(cfg, api, mesh, "prefill", strategy)
    batch_sds = cfg_lib.input_specs(cfg, shape)
    batch_sh = shd.input_shardings(mesh, batch_sds, cfg, "prefill", strategy)

    cache_sds = api.init_cache(B, S, disagg=disagg, device=META)
    cache_sh = shd.tree_shardings(mesh, cache_sds,
                                  api.cache_logical_axes(disagg=disagg), cfg,
                                  "prefill", strategy)
    ids_sds = torch.empty((B,), dtype=torch.int32, device=META)
    ids_sh = shd.vector_sharding(mesh, B, cfg, "prefill", strategy)

    def prefill_step(params, lora, batch, adapter_ids):
        cache = api.init_cache(B, S, disagg=disagg,
                               device=batch["tokens"].device)
        kwargs = {}
        if "extra_embeds" in batch:
            kwargs["extra_embeds"] = batch["extra_embeds"]
        if lora is not None:
            kwargs.update(lora=lora, adapter_ids=adapter_ids, disagg=disagg)
        with torch.no_grad():
            logits, cache = api.prefill(params, batch["tokens"], cache,
                                        **kwargs)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), cache

    return BuiltStep(prefill_step,
                     (params_sds, lora_sds, batch_sds, ids_sds),
                     StepShardings((params_sh, lora_sh, batch_sh, ids_sh),
                                   (ids_sh, cache_sh)),
                     f"prefill_step disagg={disagg}", (ids_sds, cache_sds))


def build_serve_step(cfg: ModelConfig, mesh, shape: ShapeConfig,
                     disagg: Optional[bool] = None,
                     strategy: str = "baseline") -> BuiltStep:
    """Decode: ONE new token with a KV cache of shape.seq_len."""
    api = get_model(cfg)
    disagg = api.supports_forkkv if disagg is None else disagg
    B, S = shape.global_batch, shape.seq_len

    params_sds = api.init_params(0, device=META)
    params_sh = shd.tree_shardings(mesh, params_sds, api.logical_axes(), cfg,
                                   "decode", strategy)
    lora_sds, lora_sh = _lora_state(cfg, api, mesh, "decode", strategy)

    cache_sds = api.init_cache(B, S, disagg=disagg, device=META)
    cache_sh = shd.tree_shardings(mesh, cache_sds,
                                  api.cache_logical_axes(disagg=disagg), cfg,
                                  "decode", strategy)
    tok_sds = torch.empty((B,), dtype=torch.int32, device=META)
    len_sds = torch.empty((B,), dtype=torch.int32, device=META)
    vec_sh = shd.vector_sharding(mesh, B, cfg, "decode", strategy)

    def serve_step(params, lora, cache, tokens, kv_len, adapter_ids):
        kwargs = {}
        if lora is not None:
            kwargs.update(lora=lora, adapter_ids=adapter_ids, disagg=disagg)
        with torch.no_grad():
            logits, cache = api.decode_step(params, tokens, cache, kv_len,
                                            **kwargs)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return BuiltStep(
        serve_step,
        (params_sds, lora_sds, cache_sds, tok_sds, len_sds, tok_sds),
        StepShardings((params_sh, lora_sh, cache_sh, vec_sh, vec_sh, vec_sh),
                      (vec_sh, cache_sh)),
        f"serve_step disagg={disagg} cache_len={S}", (tok_sds, cache_sds))


def build_step(cfg: ModelConfig, mesh, shape: ShapeConfig,
               **kw: Any) -> BuiltStep:
    if shape.mode == "train":
        kw.pop("disagg", None)
        return build_train_step(cfg, mesh, shape, **kw)
    kw.pop("accum", None)
    if shape.mode == "prefill":
        return build_prefill_step(cfg, mesh, shape, **kw)
    return build_serve_step(cfg, mesh, shape, **kw)
