"""Staleness-aware mixing for asynchronous SD-FEEL (Section IV, eq. (22)).

A numpy copy of ``repro.core.staleness`` so the port never imports the JAX
package.  When edge cluster ``d`` triggers an inter-cluster aggregation at
global iteration ``t``, each neighbor ``j`` holds a model from an earlier
iteration ``t'(j) < t`` with *iteration gap* ``delta_t^(j) = t - t'(j)``.
The neighbors' models are weighted by a non-increasing function ``psi`` of
their gap, normalized over the closed neighborhood (eq. 22):

    p_t[i, d]  = psi(delta_t^(i)) / Psi_t^(d),  i in N_d u {d}   (column d)
    p_t[d, j]  = p_t[j, d]                                       (symmetric pair)
    p_t[j, j]  = 1 - p_t[d, j],                 j in N_d
    p_t[i, i]  = 1 otherwise,  rest 0.

The resulting P_t is doubly stochastic, so the uniform average is preserved.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from .topology import Topology

__all__ = ["psi_inverse", "psi_constant", "psi_exponential", "staleness_mixing_matrix"]


def psi_inverse(delta: np.ndarray | float) -> np.ndarray | float:
    """The paper's simulation choice: psi(x) = 1 / (2 (x + 1))."""
    return 1.0 / (2.0 * (np.asarray(delta, dtype=np.float64) + 1.0))


def psi_constant(delta: np.ndarray | float) -> np.ndarray | float:
    """Vanilla async: constant psi (staleness-oblivious baseline, Fig. 10a)."""
    return 0.5 * np.ones_like(np.asarray(delta, dtype=np.float64))


def psi_exponential(rate: float = 0.5) -> Callable:
    def _psi(delta):
        return np.exp(-rate * np.asarray(delta, dtype=np.float64))
    return _psi


def staleness_mixing_matrix(
    topo: Topology | np.ndarray,
    trigger: int,
    gaps: Sequence[float],
    psi: Callable = psi_inverse,
) -> np.ndarray:
    """The eq-(22) mixing matrix P_t (float64) for one triggering cluster.

    ``topo`` is a ``Topology`` or a raw symmetric (D, D) adjacency array (a
    surviving graph under faults may be disconnected, which ``Topology``
    rejects; the trigger then blends only with the neighbors it can reach).
    ``gaps`` holds one iteration gap per cluster (the trigger's own is 0).
    Column convention: ``P_t[j, d]`` is the weight of cluster j's model in
    cluster d's new model, as ``Y @ P_t`` on stacked models.
    """
    if isinstance(topo, Topology):
        d_count = topo.num_servers
        nbrs = [int(v) for v in topo.neighbors(trigger)]
    else:
        adj = np.asarray(topo)
        d_count = adj.shape[0]
        nbrs = [int(v) for v in np.nonzero(adj[trigger])[0]]
    gaps = np.asarray(gaps, dtype=np.float64)
    if gaps.shape != (d_count,):
        raise ValueError("one gap per cluster required")
    closed = nbrs + [trigger]
    w = {i: float(psi(gaps[i])) for i in closed}
    big_psi = sum(w.values())

    p = np.eye(d_count)
    # column `trigger`: the triggering cluster absorbs the psi-normalized blend
    for i in closed:
        p[i, trigger] = w[i] / big_psi
    # neighbors j: symmetric give/keep split
    for j in nbrs:
        p[trigger, j] = p[j, trigger]
        p[j, j] = 1.0 - p[trigger, j]
    return p
