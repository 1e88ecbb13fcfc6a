"""Edge-server topologies, Laplacians, and the eq-(5) mixing matrix.

The inter-cluster gossip of SD-FEEL is driven by a doubly-stochastic-like
mixing matrix ``P`` built from the Laplacian of the edge-server graph and the
per-cluster data ratios (eq. (5) of the paper):

    P = I_D - 2 / (lambda_1(L~) + lambda_{D-1}(L~)) * L~ ,   L~ = L @ Omega^{-1}

with ``Omega = diag(m~_1, ..., m~_D)`` the cluster data ratios.  The magnitude
of the second-largest eigenvalue, ``zeta = |lambda_2(P)|``, governs consensus
speed (Remark 2, Fig. 3).

A numpy copy of ``repro.core.topology`` (which cannot be imported without
JAX); the fault path's ``from_edges``/``connected_components`` wait for the
fleet-axes slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "Topology",
    "ring",
    "star",
    "fully_connected",
    "partially_connected",
    "chain",
    "torus_2d",
    "laplacian",
    "mixing_matrix",
    "zeta",
    "TOPOLOGIES",
]


@dataclasses.dataclass(frozen=True)
class Topology:
    """An undirected connected graph over ``num_servers`` edge servers."""

    name: str
    num_servers: int
    adjacency: np.ndarray  # (D, D) symmetric 0/1, zero diagonal

    def __post_init__(self):
        a = np.asarray(self.adjacency)
        if a.shape != (self.num_servers, self.num_servers):
            raise ValueError(f"adjacency shape {a.shape} != D={self.num_servers}")
        if not np.array_equal(a, a.T):
            raise ValueError("adjacency must be symmetric (undirected graph)")
        if np.any(np.diag(a) != 0):
            raise ValueError("adjacency must have a zero diagonal")
        if not self.is_connected():
            raise ValueError(f"topology {self.name!r} is not connected")

    # -- graph utilities ---------------------------------------------------
    def neighbors(self, d: int) -> np.ndarray:
        return np.nonzero(self.adjacency[d])[0]

    def degree(self) -> np.ndarray:
        return self.adjacency.sum(axis=1)

    def is_connected(self) -> bool:
        d = self.num_servers
        reach = np.zeros(d, dtype=bool)
        stack = [0]
        reach[0] = True
        while stack:
            u = stack.pop()
            for v in np.nonzero(self.adjacency[u])[0]:
                if not reach[v]:
                    reach[v] = True
                    stack.append(int(v))
        return bool(reach.all())

    def max_degree(self) -> int:
        return int(self.degree().max())


# -- constructors ----------------------------------------------------------

def ring(d: int) -> Topology:
    a = np.zeros((d, d), dtype=np.int64)
    for i in range(d):
        a[i, (i + 1) % d] = 1
        a[(i + 1) % d, i] = 1
    if d == 2:  # avoid double edge
        a = np.array([[0, 1], [1, 0]])
    return Topology("ring", d, a)


def star(d: int) -> Topology:
    a = np.zeros((d, d), dtype=np.int64)
    a[0, 1:] = 1
    a[1:, 0] = 1
    return Topology("star", d, a)


def fully_connected(d: int) -> Topology:
    a = np.ones((d, d), dtype=np.int64) - np.eye(d, dtype=np.int64)
    return Topology("fully_connected", d, a)


def chain(d: int) -> Topology:
    a = np.zeros((d, d), dtype=np.int64)
    for i in range(d - 1):
        a[i, i + 1] = a[i + 1, i] = 1
    return Topology("chain", d, a)


def partially_connected(d: int, extra_edges: int | None = None, seed: int = 0) -> Topology:
    """Ring plus ``extra_edges`` random chords (paper Fig. 3 'partially')."""
    base = ring(d).adjacency.copy()
    rng = np.random.default_rng(seed)
    if extra_edges is None:
        extra_edges = d // 2
    candidates = [
        (i, j)
        for i in range(d)
        for j in range(i + 1, d)
        if base[i, j] == 0
    ]
    rng.shuffle(candidates)
    for i, j in candidates[:extra_edges]:
        base[i, j] = base[j, i] = 1
    return Topology("partially_connected", d, base)


def torus_2d(rows: int, cols: int) -> Topology:
    """2-D torus — matches TPU ICI topology; used for the beyond-paper mapping."""
    d = rows * cols
    a = np.zeros((d, d), dtype=np.int64)

    def idx(r, c):
        return (r % rows) * cols + (c % cols)

    for r in range(rows):
        for c in range(cols):
            u = idx(r, c)
            for v in (idx(r + 1, c), idx(r, c + 1)):
                if u != v:
                    a[u, v] = a[v, u] = 1
    return Topology("torus_2d", d, a)


def torus(d: int) -> Topology:
    """Near-square 2-D torus over ``d`` servers (name-addressable torus_2d)."""
    rows = int(np.floor(np.sqrt(d)))
    while rows > 1 and d % rows:
        rows -= 1
    if rows <= 1:
        raise ValueError(f"torus requires a composite server count, got {d}")
    return torus_2d(rows, d // rows)


TOPOLOGIES = {
    "ring": ring,
    "star": star,
    "fully_connected": fully_connected,
    "chain": chain,
    "partially_connected": partially_connected,
    "torus": torus,
}


# -- spectral machinery ------------------------------------------------------

def laplacian(topo: Topology) -> np.ndarray:
    a = topo.adjacency.astype(np.float64)
    return np.diag(a.sum(axis=1)) - a


def mixing_matrix(topo: Topology, cluster_ratios: np.ndarray | None = None) -> np.ndarray:
    """Eq. (5): P = I - 2/(l1(L~) + l_{D-1}(L~)) L~ with L~ = L Omega^{-1}.

    ``cluster_ratios`` are the data ratios ``m~_d`` (default: uniform).  The
    resulting ``P`` satisfies ``1^T P = 1^T`` (column sums = 1, mass
    preservation of the weighted average) and ``P @ m~ = m~`` (the weighted
    mean is its fixed point), so repeated gossip converges to the global
    data-weighted model average.
    """
    d = topo.num_servers
    if cluster_ratios is None:
        cluster_ratios = np.full(d, 1.0 / d)
    m = np.asarray(cluster_ratios, dtype=np.float64)
    if m.shape != (d,) or np.any(m <= 0):
        raise ValueError("cluster_ratios must be positive with one entry per server")
    m = m / m.sum()
    lap = laplacian(topo)
    l_tilde = lap @ np.diag(1.0 / m)
    # L~ is similar to the symmetric Omega^{-1/2} L Omega^{-1/2}: real spectrum.
    sym = np.diag(m ** -0.5) @ lap @ np.diag(m ** -0.5)
    eig = np.sort(np.linalg.eigvalsh(sym))[::-1]  # descending
    lam1, lam_dm1 = eig[0], eig[d - 2] if d >= 2 else eig[0]
    denom = lam1 + lam_dm1
    if denom <= 0:
        raise ValueError("graph must be connected (positive spectral gap)")
    p = np.eye(d) - (2.0 / denom) * l_tilde
    return p


def zeta(p: np.ndarray, cluster_ratios: np.ndarray | None = None) -> float:
    """zeta = |lambda_2(P)| — second-largest eigenvalue magnitude of P."""
    d = p.shape[0]
    if cluster_ratios is None:
        cluster_ratios = np.full(d, 1.0 / d)
    m = np.asarray(cluster_ratios, dtype=np.float64)
    m = m / m.sum()
    # P = I - c L Omega^{-1} is similar to a symmetric matrix; use eigvals and
    # sort by magnitude, dropping the Perron eigenvalue 1.
    vals = np.linalg.eigvals(p)
    mags = np.sort(np.abs(vals))[::-1]
    # Largest magnitude should be 1 (consensus eigenvalue).
    return float(mags[1]) if d >= 2 else 0.0
