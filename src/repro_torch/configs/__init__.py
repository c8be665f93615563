"""Config registry: arch id resolution + input specs per shape (port of
``repro/configs/__init__.py``).

``input_specs(cfg, shape)`` returns allocation-free stand-ins for every
per-step model input of one (architecture x input shape) pair: tensors on
the ``meta`` device, which carry a shape and a dtype and hold no memory
(the reference returns ``jax.ShapeDtypeStruct``).  ``concrete_inputs``
makes small real ones from an explicit, seeded ``torch.Generator``.
"""
from __future__ import annotations

import importlib
from typing import Dict, Optional, Union

import torch

from repro_torch.core.config import INPUT_SHAPES, ModelConfig, ShapeConfig
from repro_torch.core.device import resolve_device

ARCH_MODULES = {
    "recurrentgemma-9b": "recurrentgemma_9b",
    "dbrx-132b": "dbrx_132b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "starcoder2-3b": "starcoder2_3b",
    "mamba2-130m": "mamba2_130m",
    "internlm2-1.8b": "internlm2_1_8b",
    "llama3-405b": "llama3_405b",
    "whisper-large-v3": "whisper_large_v3",
}

ARCH_IDS = tuple(ARCH_MODULES)


def _module(arch_id: str):
    if arch_id not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{list(ARCH_MODULES)}")
    return importlib.import_module(
        f"repro_torch.configs.{ARCH_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_tiny_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).tiny()


# --------------------------------------------------------------------------
# Shape applicability: long_500k requires sub-quadratic attention — run only
# for SSM / hybrid / SWA archs.
# --------------------------------------------------------------------------
SUB_QUADRATIC = ("mamba2-130m", "recurrentgemma-9b", "h2o-danube-3-4b")


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k":
        return cfg.name in SUB_QUADRATIC or cfg.sliding_window > 0 or \
            cfg.family in ("ssm", "hybrid")
    return True


def applicable_pairs():
    """All (arch_id, shape) baseline pairs (33 of the 10x4=40)."""
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in INPUT_SHAPES:
            if shape_applicable(cfg, shape):
                out.append((arch, shape.name))
    return out


# --------------------------------------------------------------------------
# Input specs (meta tensors, no allocation)
# --------------------------------------------------------------------------
def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                n_adapters: int = 8) -> Dict[str, torch.Tensor]:
    """Model inputs for one (arch x shape): the per-step data inputs, as
    ``meta`` tensors.  Caches and params are built by the model API."""
    B, S = shape.global_batch, shape.seq_len
    f = cfg.activation_dtype
    d = cfg.d_model

    def sds(shp, dt=torch.int32):
        return torch.empty(shp, dtype=dt, device="meta")

    if shape.mode == "train":
        if cfg.frontend == "vision_stub":
            p = min(cfg.num_patches, S // 2)
            return {"tokens": sds((B, S - p)), "labels": sds((B, S - p)),
                    "extra_embeds": sds((B, p, d), f)}
        if cfg.frontend == "audio_stub":
            return {"tokens": sds((B, S)), "labels": sds((B, S)),
                    "extra_embeds": sds((B, cfg.encoder_seq, d), f)}
        return {"tokens": sds((B, S)), "labels": sds((B, S))}

    if shape.mode == "prefill":
        if cfg.frontend == "vision_stub":
            p = min(cfg.num_patches, S // 2)
            return {"tokens": sds((B, S - p)),
                    "extra_embeds": sds((B, p, d), f)}
        if cfg.frontend == "audio_stub":
            return {"tokens": sds((B, S)),
                    "extra_embeds": sds((B, cfg.encoder_seq, d), f)}
        return {"tokens": sds((B, S))}

    # decode: one token against a cache of length S
    return {"tokens": sds((B,)), "kv_len": sds((B,))}


def concrete_inputs(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0, *,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Dict[str, torch.Tensor]:
    """Small concrete analogue of ``input_specs`` for smoke tests, on
    ``device`` (None: the CUDA device), drawn from a ``torch.Generator``
    seeded with ``seed`` (JAX's draws cannot be reproduced; the shapes,
    dtypes and ranges are the reference's)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = {}
    for name, s in input_specs(cfg, shape).items():
        if not s.dtype.is_floating_point:
            if name == "kv_len":
                out[name] = torch.full(s.shape, max(1, shape.seq_len - 1),
                                       dtype=s.dtype, device=device)
            else:
                out[name] = torch.randint(0, cfg.vocab_size, s.shape,
                                          generator=gen, device=device
                                          ).to(s.dtype)
        else:
            out[name] = (torch.randn(s.shape, generator=gen,
                                     dtype=torch.float32, device=device)
                         * 0.02).to(s.dtype)
    return out
