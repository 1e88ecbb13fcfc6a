"""Whole-round engine: one call = ``R`` full SD-FEEL protocol rounds.

The port's ``repro.core.round_engine.build_fl_round_step``, for the
resident, full-participation path (``round_step`` and ``superstep``).  The
reference's nested ``lax.scan`` is a Python loop here::

    for r in 1..R:
        for j in 1..tau2:
            for i in 1..tau1:      # local SGD micro-steps, vmapped over clients
                W <- W - eta * G
            W <- W @ (V B)         # intra-cluster aggregation
        W <- W @ (V P^alpha B)     # inter-cluster gossip (round boundary)

Batch entries carry the leading iteration axis: ``(R * tau1 * tau2, C, b,
...)``.  On the ``cuda`` backend the SGD step (``sgd_update``) and the
transitions (``fused_transition``) overwrite the stacked parameters in
place, one launch per tree each, the counterpart of the reference's
donated buffers; on ``dense``
every stage returns new tensors.  Losses stay one device tensor of shape
``(R * tau1 * tau2,)``: nothing is read back per iteration.

The ``participation`` and ``mixing`` operand variants come with 'Fleet
axes'; a CUDA graph of the round is later work.
"""
from __future__ import annotations

import torch

from .sdfeel import FLSpec

__all__ = ["build_fl_round_step"]


def build_fl_round_step(model, opt, fl: FLSpec, backend=None, rounds_per_step: int = 1,
                        participation: bool = False, mixing: bool = False, device=None):
    """Returns ``round_step(params, opt_state, batches) -> (params, opt_state,
    losses)``; ``losses`` is the ``(rounds_per_step * tau1 * tau2,)`` mean
    loss per iteration.  ``backend`` defaults to the dense Lemma-1 backend
    on ``device``."""
    from .backends import resolve_backend
    from .local_update import build_local_update

    if rounds_per_step < 1:
        raise ValueError(f"rounds_per_step must be >= 1, got {rounds_per_step}")
    if participation or mixing:
        raise NotImplementedError(
            "the round engine's participation/mixing operands are not ported yet "
            "(ROADMAP.md queue 1, 'Fleet axes')"
        )
    proto = fl.protocol()
    if backend is None:
        backend = resolve_backend("dense", proto.clusters, proto.P(), fl.alpha, device=device)
    tau1, tau2 = fl.tau1, fl.tau2
    ipr = tau1 * tau2
    local_update = build_local_update(model, opt, backend=backend)

    def round_step(params, opt_state, batches):
        n = next(iter(batches.values())).shape[0]
        if n != rounds_per_step * ipr:
            raise ValueError(f"batches hold {n} iterations, expected "
                             f"{rounds_per_step} x {tau1} x {tau2}")
        losses = []
        it = 0
        for _ in range(rounds_per_step):
            for _ in range(tau2):
                for _ in range(tau1):
                    params, opt_state, client_losses = local_update(
                        params, opt_state, {k: v[it] for k, v in batches.items()})
                    losses.append(client_losses.mean())
                    it += 1
                params = backend.transition(params, "intra")
            # T_intra @ T_inter = T_inter (B V = I_D), as in the reference
            params = backend.transition(params, "inter")
        return params, opt_state, torch.stack(losses)

    return round_step
