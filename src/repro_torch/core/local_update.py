"""Batched local-update stage: one fleet-wide SGD micro-step per call.

The client models are stacked along a leading ``(C, ...)`` axis of every
parameter tensor, and ``torch.func.vmap(torch.func.grad_and_value(loss))``
computes every client's gradient in one batched pass.  The optimizer's
update follows, mapped over the client axis as the reference's
``vmap(opt.update)`` maps it (``per_client_update``): each client keeps its
own state.  A stateless update (SGD's ``()``) is elementwise over the
stacked tensors and runs on them as they are.

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
from torch.utils._pytree import tree_leaves, tree_map

__all__ = [
    "build_local_update",
    "build_sequential_local_update",
    "fused_sgd_applicable",
    "per_client_update",
]


def fused_sgd_applicable(opt, backend) -> bool:
    """True when the (optimizer, backend) pair routes through ``sgd_update``.

    The kernel implements ``w - lr * g`` with f32 arithmetic, so it only
    substitutes for stateless SGD; the backend gate (a backend or its name)
    keeps dense runs on the plain expression and lets ``"cuda"`` opt in to
    the kernel.
    """
    route = backend if isinstance(backend, str) else getattr(backend, "name", "")
    return (
        getattr(opt, "name", "") == "sgd"
        and getattr(opt, "lr", None) is not None
        and route == "cuda"
    )


def per_client_update(opt):
    """``opt.update`` over stacked ``(C, ...)`` trees, each client with its own
    state: the reference's ``vmap(opt.update)``.  Every state leaf carries
    the client axis: a stateful ``opt.init`` of the stack (momentum), or
    ``torch.func.vmap(opt.init)`` (Adam, whose step is then ``(C,)``); a
    0-d leaf, as ``adam().init`` of the stack gives, raises ``ValueError``,
    as in the reference.  A state with no tensors needs no map."""
    mapped = torch.func.vmap(opt.update)

    def update(params, grads, state):
        if not tree_leaves(state):
            return opt.update(params, grads, state)
        return mapped(params, grads, state)

    return update


def build_local_update(model, opt, *, backend=None):
    """Returns ``local_update(params, opt_state, batch) -> (params,
    opt_state, losses)`` over stacked ``(C, ...)`` client dicts.

    ``batch`` values are ``(C, b, ...)``; ``losses`` is the ``(C,)``
    per-client loss.  On the fused path the leaves of ``params`` are
    overwritten in place and returned.
    """
    use_fused = fused_sgd_applicable(opt, backend)
    grads_and_losses = torch.func.vmap(torch.func.grad_and_value(model.loss))
    update = per_client_update(opt)

    def local_update(params, opt_state, batch):
        grads, losses = grads_and_losses(params, batch)
        if use_fused:
            from ..kernels import sgd_update_tree

            # conv-kernel gradients come back as permuted (OIHW-ordered)
            # views of the HWIO shape; the kernel streams contiguous memory
            grads = {k: g.contiguous() for k, g in grads.items()}
            params = sgd_update_tree(params, grads, opt.lr, inplace=True)
        else:
            params, opt_state = update(params, grads, opt_state)
        return params, opt_state, losses

    return local_update


def build_sequential_local_update(model, opt):
    """Per-client loop reference: ``C`` gradient passes per micro-step.

    Same signature and stacked operands as ``build_local_update``: client
    ``i`` steps on row ``i`` of every state leaf, and the clients' states
    are stacked back, as the reference indexes and restacks them.
    """
    grad_and_loss = torch.func.grad_and_value(model.loss)

    def sequential_update(params, opt_state, batch):
        num_clients = next(iter(params.values())).shape[0]
        new, states, losses = [], [], []
        for i in range(num_clients):
            p = {k: v[i] for k, v in params.items()}
            g, loss = grad_and_loss(p, {k: v[i] for k, v in batch.items()})
            p, s = opt.update(p, g, tree_map(lambda x: x[i], opt_state))
            new.append(p)
            states.append(s)
            losses.append(loss)
        params = {k: torch.stack([p[k] for p in new]) for k in params}
        opt_state = tree_map(lambda *xs: torch.stack(xs), *states)
        return params, opt_state, torch.stack(losses)

    return sequential_update
