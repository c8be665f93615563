"""Training steps: full-parameter pretraining and LoRA fine-tuning
(port of ``repro/training/train_loop.py``).

``make_train_step(cfg)`` returns ``(init_opt_state, step)`` with
``step(params, opt_state, batch) -> (params, opt_state, metrics)`` and
optional gradient accumulation; ``make_lora_train_step`` freezes the base
model and trains only the adapter stacks (how ForkKV's specialized agents
are produced).  Both run eagerly on ``device`` (None: the CUDA device,
raising without one; the tests pass ``"cpu"``), take a batch of numpy
arrays or tensors, and are functional as the reference's are: the
arguments are left as they are and new trees come back.

The loss runs the model with ``disagg=False``, as the reference's
``_loss_fn`` does, so the attention reaches no kernel (the attention
kernels have no backward; their wrappers refuse an input that requires
grad).  The hybrid's RG-LRU scan is differentiated through its forward and
backward kernels on the card (``kernels.rg_lru.RgLruScan``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Tuple

import torch

from repro_torch.core import shards
from repro_torch.core.config import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import base
from repro_torch.models.registry import get_model
from repro_torch.training import optimizer as opt_lib


def _to(batch, device: torch.device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _loss_fn(api, params, batch, lora=None, adapter_ids=None,
             disagg: bool = False) -> torch.Tensor:
    kwargs = {}
    if "extra_embeds" in batch:
        kwargs["extra_embeds"] = batch["extra_embeds"]
    if lora is not None:
        kwargs.update(lora=lora, adapter_ids=adapter_ids, disagg=disagg)
    logits = api.forward(params, batch["tokens"], **kwargs)
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:
        # VLM: logits cover [patches ‖ text]; loss only on the text tail
        logits = logits[:, -labels.shape[1]:]
    return base.cross_entropy(logits, labels)


def _value_and_grad(loss: Callable, tree, *args
                    ) -> Tuple[torch.Tensor, object]:
    """``jax.value_and_grad(loss)(tree, *args)``: the loss and the gradient
    of every floating leaf of ``tree`` (zeros where the loss does not reach
    a leaf), in the leaf's dtype.  The leaves are detached views that
    require grad, so the caller's tensors are untouched."""
    leaves: List[torch.Tensor] = []

    def track(t):
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            t = t.detach().requires_grad_(True)
            leaves.append(t)
        return t

    with torch.enable_grad():
        tracked = base.tree_map(track, tree)
        value = loss(tracked, *args)
        grads = torch.autograd.grad(value, leaves, allow_unused=True)
    it = iter(torch.zeros_like(t) if g is None else g
              for t, g in zip(leaves, grads))
    out = base.tree_map(lambda t: next(it) if isinstance(
        t, torch.Tensor) and t.is_floating_point() else t, tree)
    return value.detach(), out


def _grad_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in base.leaves(grads)))


class TrainParts(NamedTuple):
    """A train step in the pieces the dry run counts apart
    (:mod:`repro_torch.launch.dryrun`): the step is ``finish(params,
    opt_state, sums)`` after ``sums = micro(params, sums, mb)`` over the
    microbatches ``split(batch)``, from ``sums = start(params)``."""
    split: Callable
    start: Callable
    micro: Callable
    finish: Callable


def make_train_step(cfg: ModelConfig, lr: float = 3e-4,
                    accum_steps: int = 1, *, device=None
                    ) -> Tuple[Callable, Callable]:
    """Full-parameter training with ``cfg.optimizer``.  Returns
    (init_opt_state, step); the metrics are ``loss`` and ``grad_norm``.
    With ``accum_steps`` > 1 the batch is cut into that many micro-batches
    along its first axis and their f32 gradients summed, then averaged.
    ``step.parts`` holds the step's :class:`TrainParts`."""
    dev = resolve_device(device)
    api = get_model(cfg)
    init, update = opt_lib.get_optimizer(cfg.optimizer, lr)

    def loss(params, batch):
        return _loss_fn(api, params, batch)

    def split(batch):
        batch = _to(batch, dev)
        if accum_steps == 1:
            return [batch]
        return [{k: v.reshape((accum_steps, v.shape[0] // accum_steps)
                              + tuple(v.shape[1:]))[i]
                 for k, v in batch.items()}
                for i in range(accum_steps)]

    def start(params):
        if accum_steps == 1:
            return None
        return 0.0, base.tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)

    def micro(params, sums, mb):
        l_mb, g = _value_and_grad(loss, params, mb)
        if accum_steps == 1:
            return l_mb, g
        lsum, gsum = sums
        return lsum + l_mb, base.tree_map(
            lambda a, b: a + b.to(torch.float32), gsum, g)

    def finish(params, opt_state, sums):
        value, grads = sums
        grads = base.tree_map(shards.laid_out_as, grads, params)
        if accum_steps > 1:
            grads = base.tree_map(lambda g: g / accum_steps, grads)
            value = value / accum_steps
        gnorm = _grad_norm(grads)
        with torch.no_grad():
            params, opt_state = update(grads, opt_state, params)
        return params, opt_state, {"loss": value, "grad_norm": gnorm}

    def step(params, opt_state, batch):
        sums = start(params)
        for mb in split(batch):
            sums = micro(params, sums, mb)
        return finish(params, opt_state, sums)

    step.parts = TrainParts(split, start, micro, finish)
    return init, step


def make_lora_train_step(cfg: ModelConfig, lr: float = 1e-3,
                         adapter_id: int = 0, *, device=None
                         ) -> Tuple[Callable, Callable]:
    """LoRA fine-tuning: base parameters frozen (no gradient is taken for
    them: they stay ``requires_grad=False``), every leaf of the adapter
    stacks trained with AdamW, each batch row under ``adapter_id``.
    Returns (init_opt_state, step) with ``step(lora, opt_state, params,
    batch) -> (lora, opt_state, {"loss"})``."""
    dev = resolve_device(device)
    api = get_model(cfg)
    init, update = opt_lib.get_optimizer("adamw", lr)

    def loss(lora, params, batch):
        ids = torch.full((batch["tokens"].shape[0],), adapter_id,
                         dtype=torch.long, device=dev)
        return _loss_fn(api, params, batch, lora=lora, adapter_ids=ids)

    def step(lora, opt_state, params, batch):
        frozen = base.tree_map(lambda t: t.detach() if isinstance(
            t, torch.Tensor) else t, params)
        value, grads = _value_and_grad(loss, lora, frozen, _to(batch, dev))
        with torch.no_grad():
            lora, opt_state = update(grads, opt_state, lora)
        return lora, opt_state, {"loss": value}

    return init, step


def eval_loss(cfg: ModelConfig, params, batch, lora=None,
              adapter_ids=None, *, device=None) -> torch.Tensor:
    """The loss on ``batch`` without a gradient."""
    dev = resolve_device(device)
    with torch.no_grad():
        return _loss_fn(get_model(cfg), params, _to(batch, dev), lora=lora,
                        adapter_ids=adapter_ids)
