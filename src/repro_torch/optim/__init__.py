"""Minimal optimizer library over parameter dicts: SGD, momentum, Adam.

Optimizers follow the (init, update) pair convention of ``repro.optim``:
``update(params, grads, state)`` returns ``(new_params, new_state)``, with
the reference's arithmetic.  ``state_dtype`` keeps momentum's buffer or
Adam's moments in another dtype (bf16 halves the optimizer's memory);
updates are computed in f32 and cast back to each parameter's dtype.

Every tensor of a state is built from a parameter (``zeros_like``), so
``torch.func.vmap(opt.init)(stacked)`` gives each client of a stacked
``(C, ...)`` tree its own state in memory of its own (Adam's step a
``(C,)`` tensor), the port's form of the reference's ``jax.vmap(opt.init)``.
``opt.init(stacked)`` instead gives one state over the stack: momentum's
buffers are then ``(C, ...)`` as well, while Adam's step is a scalar that
a per-client update refuses, as the reference's ``vmap`` does
(``core.local_update.per_client_update``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

__all__ = ["Optimizer", "sgd", "momentum", "adam", "AdamState", "clip_by_global_norm"]

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


def momentum(learning_rate: float, beta: float = 0.9,
             state_dtype: torch.dtype = torch.float32) -> Optimizer:
    # the reference's ``beta * m`` takes the weakly typed scalar in m's dtype
    beta_s = float(torch.tensor(beta, dtype=state_dtype))

    def init(params):
        return {k: torch.zeros_like(p, dtype=state_dtype) for k, p in params.items()}

    def update(params, grads, state):
        # beta * m rounds to the state's dtype, the sum does not: the
        # parameters step on the f32 sum and the state keeps it cast, as the
        # reference's fused update computes (it drops the cast-back pair)
        new_m = {k: (beta_s * m).float() + grads[k].to(state_dtype).float()
                 for k, m in state.items()}
        new_p = {k: (p.float() - learning_rate * new_m[k]).to(p.dtype)
                 for k, p in params.items()}
        return new_p, {k: m.to(state_dtype) for k, m in new_m.items()}

    return Optimizer(init, update, "momentum")


class AdamState(NamedTuple):
    step: torch.Tensor
    m: Params
    v: Params


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0, state_dtype: torch.dtype = torch.float32) -> Optimizer:
    def init(params):
        first = next(iter(params.values()))
        return AdamState(
            # a 0-d view of a leaf's first entry: under vmap each client's own
            step=torch.zeros_like(first.reshape(-1)[0], dtype=torch.int32),
            m={k: torch.zeros_like(p, dtype=state_dtype) for k, p in params.items()},
            v={k: torch.zeros_like(p, dtype=state_dtype) for k, p in params.items()},
        )

    def update(params, grads, state):
        step = state.step + 1
        b1t = 1 - b1 ** step.float()
        b2t = 1 - b2 ** step.float()
        new_p, new_m, new_v = {}, {}, {}
        for k, p in params.items():
            # the reference's expressions, op for op; each op writes into a
            # temporary of this leaf where it can, so that a wide leaf's f32
            # temporaries stay few
            g32 = grads[k].float()
            m = state.m[k].float() * b1
            m += (1 - b1) * g32
            v = state.v[k].float() * b2
            v += (1 - b2) * g32 * g32
            del g32
            delta = (m / b1t).div_((v / b2t).sqrt_().add_(eps))
            if weight_decay:
                delta += weight_decay * p.float()
            new_p[k] = (p.float() - delta.mul_(learning_rate)).to(p.dtype)
            new_m[k], new_v[k] = m.to(state_dtype), v.to(state_dtype)
        return new_p, AdamState(step=step, m=new_m, v=new_v)

    return Optimizer(init, update, "adam")


def clip_by_global_norm(grads: Params, max_norm: float) -> Params:
    """``grads`` scaled so that their one norm over every leaf, in f32, is at
    most ``max_norm``."""
    total = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads.values()))
    scale = torch.clamp(max_norm / (total + 1e-12), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}
