"""Minimal optimizer library over parameter dicts: plain SGD.

Optimizers follow the (init, update) pair convention of ``repro.optim``:
``update(params, grads, state)`` returns ``(new_params, new_state)``.
Momentum, Adam and clipping follow with the slices that use them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

__all__ = ["Optimizer", "sgd"]

Params = dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], Any]
    update: Callable[[Params, Params, Any], tuple[Params, Any]]
    name: str = "optimizer"
    # the learning rate, when the optimizer has a single static one — lets
    # the fused update kernel (kernels/fused_sgd) take it as an argument
    lr: Optional[float] = None


def sgd(learning_rate: float) -> Optimizer:
    def init(params):
        return ()

    def update(params, grads, state):
        new = {
            # bf16 params take the gradient through f32 and back (the
            # reference's cast rule); f32 params update directly
            k: (p - learning_rate * grads[k].float().to(p.dtype)).to(p.dtype)
            if p.dtype == torch.bfloat16
            else p - learning_rate * grads[k]
            for k, p in params.items()
        }
        return new, state

    return Optimizer(init, update, "sgd", lr=learning_rate)
