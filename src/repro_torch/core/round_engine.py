"""Whole-round engine: one call = ``R`` full SD-FEEL protocol rounds.

The port's ``repro.core.round_engine.build_fl_round_step`` on resident
client state, with the reference's ``participation`` and ``mixing``
operands.  The reference's nested ``lax.scan`` is a Python loop here::

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

The function built here is the eager reference path and, unchanged, the
body that ``RoundScheduler`` captures as one CUDA graph per (super)step
(``core/cuda_graph.py``), the counterpart of the reference's jitted
``lax.scan``.

With ``participation=True`` the step takes a fourth operand, ``weights``
of shape ``(R, C)``: round ``r``'s masked and renormalized intra-cluster
weights, threaded into every transition of that round.  With
``mixing=True`` (which requires ``participation=True``) a fifth,
``mixing`` of shape ``(R, D, D)``: round ``r``'s faulted mixing matrix,
threaded into its inter transition.  Both are device tensors read where
they lie, so a captured step reads them from its static input buffers and
a new round's values never change the graph.

On a client mesh (a collective backend bound to a ``launch.mesh.ClientMesh``)
``params`` and ``opt_state`` are this rank's ``(1, ...)`` row, the step
takes the rank's row of the fleet's batches (every rank draws the same
stream) and the fleet's ``(R, C)`` weights and ``(R, D, D)`` matrices, of
which the backend reads the rank's entries, and all-gathers the losses, so
every rank returns what one process returns.
"""
from __future__ import annotations

import torch

from .sdfeel import FLSpec

__all__ = ["build_fl_round_step"]


def build_fl_round_step(model, opt, fl: FLSpec, backend=None, rounds_per_step: int = 1,
                        participation: bool = False, mixing: bool = False, device=None):
    """Returns ``round_step(params, opt_state, batches[, weights[, mixing]])
    -> (params, opt_state, losses)``; ``losses`` is the ``(rounds_per_step *
    tau1 * tau2,)`` mean loss per iteration.  ``weights`` (``(R, C)``) is
    taken with ``participation=True``, ``mixing`` (``(R, D, D)``) with
    ``mixing=True`` too.  ``backend`` defaults to the dense Lemma-1 backend
    on ``device``."""
    from .aggregation import fleet_mean_losses, mesh_rows
    from .backends import resolve_backend
    from .local_update import build_local_update

    if rounds_per_step < 1:
        raise ValueError(f"rounds_per_step must be >= 1, got {rounds_per_step}")
    if mixing and not participation:
        # the fault path always renormalizes per-round weights, as the reference
        raise ValueError("mixing=True requires participation=True")
    proto = fl.protocol()
    if backend is None:
        backend = resolve_backend("dense", proto.clusters, proto.P(), fl.alpha, device=device)
    tau1, tau2 = fl.tau1, fl.tau2
    ipr = tau1 * tau2
    mixing_on = mixing
    local_update = build_local_update(model, opt, backend=backend)
    mesh = getattr(backend, "mesh", None)

    def round_step(params, opt_state, batches, weights=None, mixing=None):
        n = next(iter(batches.values())).shape[0]
        if n != rounds_per_step * ipr:
            raise ValueError(f"batches hold {n} iterations, expected "
                             f"{rounds_per_step} x {tau1} x {tau2}")
        if (weights is not None) != participation or (mixing is not None) != mixing_on:
            raise TypeError(f"this round step takes weights: {participation}, "
                            f"mixing: {mixing_on}")
        if mesh is not None:
            batches = mesh_rows(batches, mesh, dim=1)
        losses = []
        it = 0
        for r in range(rounds_per_step):
            # round r's operands (None: the backend's bound m^ and P)
            w = None if weights is None else weights[r]
            p = None if mixing is None else mixing[r]
            for _ in range(tau2):
                for _ in range(tau1):
                    params, opt_state, client_losses = local_update(
                        params, opt_state, {k: v[it] for k, v in batches.items()})
                    losses.append(client_losses if mesh is not None else client_losses.mean())
                    it += 1
                params = backend.transition(params, "intra", weights=w)
            # T_intra @ T_inter = T_inter (B V = I_D), as in the reference; under
            # participation both factors use the round's weights
            params = backend.transition(params, "inter", weights=w, p=p)
        if mesh is not None:
            return params, opt_state, fleet_mean_losses(torch.cat(losses), mesh)
        return params, opt_state, torch.stack(losses)

    return round_step
