"""Dense aggregation operators: the Lemma-1 transition as a matrix product.

``apply_transition_dense`` is the paper-faithful form of ``W <- W @ T_k``
on a dict of client-stacked ``(C, ...)`` tensors, and
``dense_gossip_reference`` the eq. 4 oracle on ``(D, ...)`` cluster models.
The structured collective operators of ``repro.core.aggregation`` wait for
the multi-device slice.
"""
from __future__ import annotations

import torch

__all__ = ["apply_transition_dense", "dense_gossip_reference"]


def apply_transition_dense(stacked: dict, t_matrix: torch.Tensor) -> dict:
    """W <- W @ T_k on a (C, ...) stacked dict (paper Lemma 1).

    ``t_matrix[j, d]`` is the weight of client j's model in client d's new
    model; the parameters' dtype is preserved (mixing in f32)."""
    t = t_matrix.float()
    return {
        k: torch.tensordot(t, w.float(), dims=([0], [0])).to(w.dtype)
        for k, w in stacked.items()
    }


def dense_gossip_reference(cluster_models: dict, p_matrix: torch.Tensor, alpha: int) -> dict:
    """Y <- Y @ P^alpha on (D, ...) cluster-stacked models (eq. 4 oracle)."""
    p_a = torch.linalg.matrix_power(p_matrix.float(), alpha)
    return apply_transition_dense(cluster_models, p_a)
