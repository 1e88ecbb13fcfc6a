"""Batched local-update stage: one fleet-wide SGD micro-step per call.

The client models are stacked along a leading ``(C, ...)`` axis of every
parameter tensor, and ``torch.func.vmap(torch.func.grad_and_value(loss))``
computes every client's gradient in one batched pass.  The update that
follows is elementwise over the stacked tensors, so it needs no vmap.

``build_sequential_local_update`` is the per-client loop reference the
batched stage is tested against.

Fused-kernel path: when the optimizer is plain SGD with a static learning
rate and the aggregation backend is ``cuda``, the update runs through the
``sgd_update`` kernel (``kernels/fused_sgd``) over every stacked leaf, in
place, one launch per tree.  Unlike the reference there is no dense
fallback for leaves that do not tile: the kernel masks its own tail, so
every leaf goes through it.
"""
from __future__ import annotations

import torch

__all__ = [
    "build_local_update",
    "build_sequential_local_update",
    "fused_sgd_applicable",
]


def fused_sgd_applicable(opt, backend) -> bool:
    """True when the (optimizer, backend) pair routes through ``sgd_update``.

    The kernel implements ``w - lr * g`` with f32 arithmetic, so it only
    substitutes for stateless SGD; the backend gate keeps dense runs on the
    plain expression and lets ``backend="cuda"`` opt in to the kernel.
    """
    return (
        getattr(opt, "name", "") == "sgd"
        and getattr(opt, "lr", None) is not None
        and getattr(backend, "name", "") == "cuda"
    )


def build_local_update(model, opt, *, backend=None):
    """Returns ``local_update(params, opt_state, batch) -> (params,
    opt_state, losses)`` over stacked ``(C, ...)`` client dicts.

    ``batch`` values are ``(C, b, ...)``; ``losses`` is the ``(C,)``
    per-client loss.  On the fused path the leaves of ``params`` are
    overwritten in place and returned.
    """
    use_fused = fused_sgd_applicable(opt, backend)
    grads_and_losses = torch.func.vmap(torch.func.grad_and_value(model.loss))

    def local_update(params, opt_state, batch):
        grads, losses = grads_and_losses(params, batch)
        if use_fused:
            from ..kernels import sgd_update_tree

            # conv-kernel gradients come back as permuted (OIHW-ordered)
            # views of the HWIO shape; the kernel streams contiguous memory
            grads = {k: g.contiguous() for k, g in grads.items()}
            params = sgd_update_tree(params, grads, opt.lr, inplace=True)
        else:
            params, opt_state = opt.update(params, grads, opt_state)
        return params, opt_state, losses

    return local_update


def build_sequential_local_update(model, opt):
    """Per-client loop reference: ``C`` gradient passes per micro-step.

    Same signature and stacked operands as ``build_local_update``, for
    stateless optimizers (``opt_state`` is passed through unchanged).
    """
    grad_and_loss = torch.func.grad_and_value(model.loss)

    def sequential_update(params, opt_state, batch):
        num_clients = next(iter(params.values())).shape[0]
        new, losses = [], []
        for i in range(num_clients):
            p = {k: v[i] for k, v in params.items()}
            g, loss = grad_and_loss(p, {k: v[i] for k, v in batch.items()})
            p, _ = opt.update(p, g, opt_state)
            new.append(p)
            losses.append(loss)
        params = {k: torch.stack([p[k] for p in new]) for k in params}
        return params, opt_state, torch.stack(losses)

    return sequential_update
