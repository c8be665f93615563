"""Optimizers: AdamW (f32 moments) and Adafactor (factored second moments),
port of ``repro/training/optimizer.py``.

Plain functions over trees (nested dicts and lists) of tensors, not
``torch.optim`` classes, so the update rule matches the reference value
for value: decoupled weight decay on ``p``, Adafactor's factored moments
and its ``decay`` schedule, every update in f32 and cast back to the
parameter's type.  ``update`` is functional, as the reference's: it
returns new parameters and state and leaves its arguments as they are.
``opt_state_logical_axes`` gives the state's logical axes to the sharding
layer (:mod:`repro_torch.launch.sharding`).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.models.base import leaves, tree_map


class OptState(NamedTuple):
    step: torch.Tensor     # () int32
    inner: Any


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def _step(state: OptState) -> Tuple[torch.Tensor, torch.Tensor]:
    step = state.step + 1
    return step, step.to(torch.float32)


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1
          ) -> Tuple[Callable, Callable]:
    def init(params) -> OptState:
        zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        return OptState(torch.zeros((), dtype=torch.int32,
                                    device=leaves(params)[0].device),
                        {"m": zeros, "v": tree_map(torch.zeros_like, zeros)})

    def update(grads, state: OptState, params):
        step, t = _step(state)
        c1 = 1 - torch.tensor(b1, dtype=torch.float32, device=t.device) ** t
        c2 = 1 - torch.tensor(b2, dtype=torch.float32, device=t.device) ** t

        def upd(g, m, v, p):
            g = _f32(g)
            m2 = b1 * m + (1 - b1) * g
            v2 = b2 * v + (1 - b2) * g * g
            delta = (m2 / c1) / (torch.sqrt(v2 / c2) + eps) + \
                weight_decay * _f32(p)
            return (_f32(p) - lr * delta).to(p.dtype), m2, v2

        out = tree_map(upd, grads, state.inner["m"], state.inner["v"],
                       params)
        return _pick(out, 0), OptState(step, {"m": _pick(out, 1),
                                              "v": _pick(out, 2)})

    return init, update


def _pick(tree, i: int):
    """Element ``i`` of every (new_p, new_m, new_v) leaf tuple of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]


def adafactor(lr: float = 1e-3, eps: float = 1e-30, decay: float = 0.8,
              clip_threshold: float = 1.0) -> Tuple[Callable, Callable]:
    """Factored Adafactor for >= 2-D params, full second moment for 1-D."""
    def init(params) -> OptState:
        def per_param(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if p.dim() >= 2:
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          **f32)}
            return {"v": torch.zeros(p.shape, **f32)}

        return OptState(torch.zeros((), dtype=torch.int32,
                                    device=leaves(params)[0].device),
                        tree_map(per_param, params))

    def update(grads, state: OptState, params):
        step, t = _step(state)
        beta = 1.0 - t ** (-decay)

        def upd(g, p, s):
            g = _f32(g)
            g2 = g * g + eps
            if p.dim() >= 2:
                vr = beta * s["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
                vc = beta * s["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
                denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                    min=eps)
                row_factor = torch.rsqrt(vr / denom)
                u = g * row_factor[..., None] * torch.rsqrt(vc[..., None, :])
                new_s = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(v)
                new_s = {"v": v}
            rms = torch.sqrt(torch.mean(u * u))
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            return (_f32(p) - lr * u).to(p.dtype), new_s

        # the walk follows the gradients' tree, so each leaf meets its
        # parameter and its own state dict
        out = tree_map(upd, grads, params, state.inner)
        return _pick(out, 0), OptState(step, _pick(out, 1))

    return init, update


def get_optimizer(name: str, lr: float = 3e-4) -> Tuple[Callable, Callable]:
    if name == "adamw":
        return adamw(lr=lr)
    if name == "adafactor":
        return adafactor(lr=lr)
    raise ValueError(name)


def _axes_map(fn: Callable, axes):
    """``fn`` over the leaves of a logical-axes tree: a tuple of axis names
    or None is a leaf; dicts and lists are nodes."""
    if isinstance(axes, dict):
        return {k: _axes_map(fn, v) for k, v in axes.items()}
    if isinstance(axes, list):
        return [_axes_map(fn, v) for v in axes]
    return fn(axes)


def opt_state_logical_axes(name: str, param_axes):
    """Logical axes of the optimizer state's ``inner`` tree, mirroring the
    parameters' (``param_axes``): AdamW's ``m`` and ``v`` take them as
    they are; Adafactor's factored ``vr`` drops a matrix's last axis and
    ``vc`` its second to last, and an unfactored ``v`` keeps them."""
    if name == "adamw":
        return {"m": param_axes, "v": param_axes}

    def per_param(ax):
        ax = tuple(ax) if ax is not None else None
        if ax is None:
            return {"v": None}
        if len(ax) >= 2:
            return {"vr": ax[:-1], "vc": ax[:-2] + ax[-1:]}
        return {"v": ax}

    return _axes_map(per_param, param_axes)
