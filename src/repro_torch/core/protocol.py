"""SD-FEEL protocol: cluster structure, Lemma-1 transition matrices, schedule.

The paper's Lemma 1 collapses the whole protocol into

    W_{k+1} = (W_k - eta * G_k) @ T_k,
    T_k in { I_C               (plain local step),
             V @ B             (intra-cluster aggregation, eq. 2-3),
             V @ P^alpha @ B   (intra + inter-cluster aggregation, eq. 4) }

where ``V[i, d] = m^_i * 1{i in C_d}`` (client-to-server weighted upload) and
``B[d, i] = 1{i in C_d}`` (server-to-client broadcast).  Pure numpy, float64;
a copy of ``repro.core.protocol`` so the port never imports the JAX package.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Literal

import numpy as np

from .topology import Topology, mixing_matrix, zeta as _zeta

__all__ = ["ClusterSpec", "SDFEELConfig", "transition_matrix", "AggregationEvent",
           "schedule_event"]


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Assignment of C clients onto D edge clusters + per-client data sizes."""

    num_clients: int
    assignments: tuple[int, ...]  # client i -> cluster d
    data_sizes: tuple[float, ...]  # |S_i| per client (relative sizes fine)

    def __post_init__(self):
        if len(self.assignments) != self.num_clients:
            raise ValueError("one cluster assignment per client required")
        if len(self.data_sizes) != self.num_clients:
            raise ValueError("one data size per client required")
        if any(s <= 0 for s in self.data_sizes):
            raise ValueError("data sizes must be positive")
        d = self.num_clusters
        present = set(self.assignments)
        if present != set(range(d)):
            raise ValueError("every cluster in [0, D) must have >= 1 client")

    @functools.cached_property
    def assignment_array(self) -> np.ndarray:
        """``assignments`` as an int64 array, built once (a fleet of 10^6
        clients reads it every round)."""
        return np.asarray(self.assignments, dtype=np.int64)

    @functools.cached_property
    def num_clusters(self) -> int:
        return int(self.assignment_array.max()) + 1

    @staticmethod
    def uniform(num_clients: int, num_clusters: int) -> "ClusterSpec":
        """Evenly-sized clusters, equal data per client (paper default: 50/10)."""
        if num_clients % num_clusters:
            raise ValueError("uniform() requires C % D == 0")
        per = num_clients // num_clusters
        assign = tuple(i // per for i in range(num_clients))
        return ClusterSpec(num_clients, assign, tuple(1.0 for _ in range(num_clients)))

    @staticmethod
    def imbalanced(num_clusters: int, base: int, gamma: int) -> "ClusterSpec":
        """Paper §V-C.5 cluster imbalance: with D=10, four clusters have
        ``base`` clients, three have ``base - gamma`` and three have
        ``base + gamma`` clients."""
        if num_clusters < 10 and gamma > 0:
            raise ValueError("imbalanced() follows the paper's 10-cluster setup")
        sizes = [base] * 4 + [base - gamma] * 3 + [base + gamma] * 3
        sizes = sizes[:num_clusters]
        if any(s <= 0 for s in sizes):
            raise ValueError("gamma too large: empty cluster")
        assign: list[int] = []
        for d, s in enumerate(sizes):
            assign += [d] * s
        c = len(assign)
        return ClusterSpec(c, tuple(assign), tuple(1.0 for _ in range(c)))

    # -- data-ratio vectors (paper notation) --------------------------------
    def m(self) -> np.ndarray:
        """m_i = |S_i| / |S| — global client data ratios."""
        s = np.asarray(self.data_sizes, dtype=np.float64)
        return s / s.sum()

    # The per-cluster sums are np.bincount's, which adds in client order, as
    # the reference's loop does: the same float64 values, bit for bit.
    def m_tilde(self) -> np.ndarray:
        """m~_d = |S~_d| / |S| — cluster data ratios."""
        s = np.asarray(self.data_sizes, dtype=np.float64)
        out = np.bincount(self.assignment_array, weights=s, minlength=self.num_clusters)
        return out / s.sum()

    def m_hat(self) -> np.ndarray:
        """m^_i = |S_i| / |S~_{d(i)}| — within-cluster client data ratios."""
        s = np.asarray(self.data_sizes, dtype=np.float64)
        totals = np.bincount(self.assignment_array, weights=s, minlength=self.num_clusters)
        return s / totals[self.assignment_array]

    # -- Lemma-1 matrices ----------------------------------------------------
    def V(self) -> np.ndarray:
        """V[i, d] = m^_i 1{i in C_d}  (C x D)."""
        v = np.zeros((self.num_clients, self.num_clusters))
        v[np.arange(self.num_clients), self.assignment_array] = self.m_hat()
        return v

    def B(self) -> np.ndarray:
        """B[d, i] = 1{i in C_d}  (D x C)."""
        b = np.zeros((self.num_clusters, self.num_clients))
        b[self.assignment_array, np.arange(self.num_clients)] = 1.0
        return b

    def clients_of(self, d: int) -> list[int]:
        return np.flatnonzero(self.assignment_array == d).tolist()


AggregationEvent = Literal["local", "intra", "inter"]


@dataclasses.dataclass(frozen=True)
class SDFEELConfig:
    """Hyper-parameters of Algorithm 1 (+ the structured/dense switch).

    ``aggregation_impl`` is the reference's legacy backend field: a
    scheduler built with ``backend=None`` maps ``"gossip"`` to the
    collective backend where the scenario allows it (dense otherwise) and
    ``"pallas"`` to the CUDA kernels; the default ``"dense"`` leaves the
    choice to ``"auto"``."""

    clusters: ClusterSpec
    topology: Topology
    tau1: int = 5          # intra-cluster aggregation period
    tau2: int = 1          # inter-cluster period (in units of tau1)
    alpha: int = 1         # gossip rounds per inter-cluster aggregation
    learning_rate: float = 0.01
    aggregation_impl: Literal["dense", "gossip", "pallas"] = "dense"

    def __post_init__(self):
        if self.tau1 < 1 or self.tau2 < 1 or self.alpha < 1:
            raise ValueError("tau1, tau2, alpha must be >= 1")
        if self.topology.num_servers != self.clusters.num_clusters:
            raise ValueError("topology size must equal number of clusters")

    # -- derived matrices ----------------------------------------------------
    def P(self) -> np.ndarray:
        return mixing_matrix(self.topology, self.clusters.m_tilde())

    def zeta(self) -> float:
        return _zeta(self.P(), self.clusters.m_tilde())

    def event_at(self, k: int) -> AggregationEvent:
        """Which aggregation fires after local step k (1-indexed, Algorithm 1).

        With ``tau2 == 1`` every ``tau1``-th step is ``inter`` and ``intra``
        never fires.
        """
        return schedule_event(k, self.tau1, self.tau2)


def transition_matrix(cfg: SDFEELConfig, event: AggregationEvent) -> np.ndarray:
    """Lemma-1 T_k for the given event (C x C, applied on the client axis)."""
    c = cfg.clusters.num_clients
    if event == "local":
        return np.eye(c)
    v, b = cfg.clusters.V(), cfg.clusters.B()
    if event == "intra":
        return v @ b
    p = np.linalg.matrix_power(cfg.P(), cfg.alpha)
    return v @ p @ b


def schedule_event(k: int, tau1: int, tau2: int) -> AggregationEvent:
    """Which aggregation fires after local step ``k`` (``SDFEELConfig.event_at``)."""
    if k % (tau1 * tau2) == 0:
        return "inter"
    if k % tau1 == 0:
        return "intra"
    return "local"
