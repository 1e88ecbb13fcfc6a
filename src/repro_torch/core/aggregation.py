"""Aggregation operators: the Lemma-1 transition, dense and structured.

Two forms of ``W <- W @ T_k`` on a dict of client-stacked ``(C, ...)``
tensors:

* ``dense``: ``apply_transition_dense``, one product against the ``C x C``
  transition matrix (``V B`` or ``V P^alpha B``), and
  ``dense_gossip_reference``, the eq. 4 oracle on ``(D, ...)`` cluster
  models.
* ``gossip``: the reference's collective form, written for one device that
  holds the whole stacked client axis:

  - intra-cluster aggregation is the weighted hypercube all-reduce
    (``hypercube_cluster_allreduce``), log2(g) exchanges with the partner
    ``i ^ step`` inside each contiguous group of ``g`` clients;
  - inter-cluster aggregation is ``alpha`` rounds of ring gossip
    (``ring_gossip``), each an exchange with the neighbours ``cluster_size``
    clients to the left and to the right.

  The reference runs each exchange as a ``lax.ppermute`` over a mesh axis,
  or, without a mesh, under ``vmap(axis_name=...)``, which lowers it to a
  gather along the client axis.  Here each exchange is that gather: a fixed
  permutation of dim 0 (``index_select`` for the hypercube, ``roll`` for the
  ring), with the reference's arithmetic: ``x * weight`` promotes a bf16
  leaf to f32, each gossip round is ``wl * left + ws * y + wr * right`` in
  f32, and the caller casts back to the leaf's dtype once.

``backends.CollectiveBackend`` is the scheduler-facing interface over the
gossip form, ``DenseBackend`` over the dense one.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "apply_transition_dense",
    "dense_gossip_reference",
    "stack_clients",
    "unstack_clients",
    "hypercube_cluster_allreduce",
    "ring_gossip",
    "ring_mixing_weights",
]


def stack_clients(trees: list[dict]) -> dict:
    """[tree_0 .. tree_{C-1}] -> dict of tensors with a leading client axis."""
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def unstack_clients(stacked: dict, num_clients: int) -> list[dict]:
    return [{k: v[i] for k, v in stacked.items()} for i in range(num_clients)]


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


# --------------------------------------------------------------------------
# Structured collective form, on the stacked client axis
# --------------------------------------------------------------------------

def _rows(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A ``(C,)`` vector shaped to broadcast over ``like``'s rows."""
    return v.view((v.shape[0],) + (1,) * (like.dim() - 1))


def hypercube_cluster_allreduce(x: torch.Tensor, cluster_size: int,
                                weight: torch.Tensor) -> torch.Tensor:
    """Weighted all-reduce within contiguous groups of ``cluster_size`` rows.

    Intra-cluster aggregation (eq. 2-3): every row of a cluster ends up with
    ``sum_{i in cluster} weight_i * x_i`` (``weight_i = m^_i``, a ``(C,)``
    f32 tensor), in f32.  ``cluster_size`` must be a power of two and divide
    the row count; row ``i`` belongs to cluster ``i // cluster_size``, so the
    XOR partners never cross a cluster.  Each of the log2(g) steps adds the
    partner's partial sum, ``acc + acc[i ^ step]``, as the reference's
    ``acc + ppermute(acc)``.
    """
    axis_size = x.shape[0]
    if cluster_size < 1 or (cluster_size & (cluster_size - 1)):
        raise ValueError(
            f"cluster_size={cluster_size} must be a power of two for the "
            f"hypercube all-reduce (XOR partners); use the dense backend for "
            f"other cluster sizes (backend='auto' falls back automatically)"
        )
    if axis_size % cluster_size:
        raise ValueError(
            f"cluster_size={cluster_size} must divide axis_size={axis_size}"
        )
    acc = x * _rows(weight, x)
    idx = torch.arange(axis_size, device=x.device)
    step = 1
    while step < cluster_size:
        acc = acc.add_(torch.index_select(acc, 0, idx ^ step))
        step <<= 1
    return acc


def _scaled_roll(y: torch.Tensor, shift: int, w: torch.Tensor) -> torch.Tensor:
    """``roll(y, shift, 0) * w``, in the roll's own memory where the product
    keeps its dtype (the same rounding, one leaf-sized copy fewer)."""
    r = torch.roll(y, shift, 0)
    return r.mul_(w) if torch.promote_types(r.dtype, w.dtype) == r.dtype else r * w


def ring_gossip(y: torch.Tensor, cluster_size: int, w_left: torch.Tensor,
                w_self: torch.Tensor, w_right: torch.Tensor, alpha: int) -> torch.Tensor:
    """``alpha`` rounds of ring gossip (eq. 4 with a ring topology).

    Each row holds its cluster's aggregated model ``y`` (identical within a
    cluster after ``hypercube_cluster_allreduce``).  One round::

        y_d <- w_left[d] * y_{d-1} + w_self[d] * y_d + w_right[d] * y_{d+1}

    with the neighbours ``cluster_size`` rows away on either side.  ``w_*``
    are the per-cluster ``(D,)`` columns of the eq-(5) mixing matrix, f32
    tensors on ``y``'s device.  Every round is computed in f32 and rounded to
    ``y``'s dtype (f32 after the all-reduce); the caller casts to the leaf's
    dtype.
    """
    axis_size = y.shape[0]
    if axis_size // cluster_size < 2:
        raise ValueError("ring gossip needs >= 2 clusters")
    cluster = torch.arange(axis_size, device=y.device) // cluster_size
    wl, ws, wr = (_rows(w[cluster], y) for w in (w_left, w_self, w_right))
    for _ in range(alpha):
        # receive from the left: row i gets row i - cluster_size (a roll by
        # +cluster_size); from the right: row i + cluster_size.  The f32
        # weights promote each product, so a bf16 y is rounded once a round
        out = _scaled_roll(y, cluster_size, wl)
        out.add_(ws * y)
        y = out.add_(_scaled_roll(y, -cluster_size, wr)).to(y.dtype)
    return y


def ring_mixing_weights(p_matrix: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Extract (w_left, w_self, w_right) columns from a ring mixing matrix.

    For cluster d the eq-(4) update uses column d of P: contributions from
    d-1 (left), d (self) and d+1 (right).  Raises if P has support off the
    ring stencil.
    """
    d = p_matrix.shape[0]
    w_left = np.zeros(d)
    w_self = np.zeros(d)
    w_right = np.zeros(d)
    stencil = np.zeros_like(p_matrix, dtype=bool)
    for col in range(d):
        left, right = (col - 1) % d, (col + 1) % d
        w_left[col] = p_matrix[left, col]
        w_self[col] = p_matrix[col, col]
        w_right[col] = p_matrix[right, col]
        stencil[[left, col, right], col] = True
    if np.any(np.abs(np.where(stencil, 0.0, p_matrix)) > 1e-12):
        raise ValueError("mixing matrix has support outside the ring stencil")
    return w_left, w_self, w_right
