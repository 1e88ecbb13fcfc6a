"""Asynchronous SD-FEEL (Section IV): configuration.

The port's copy of ``repro.core.async_engine`` (numpy only).  The event loop
lives in ``runtime.AsyncScheduler``; the removed ``AsyncSDFEEL`` name raises
``ImportError`` pointing at ``make_run``.

Each edge cluster is an event in a priority queue keyed by wall-clock finish
time.  When cluster ``d`` fires at global iteration ``t``:

  1. every client ``i in C_d`` runs ``theta_i = clip(h_i * beta)`` local SGD
     epochs within the deadline ``T_comp^(d)`` and normalizes its update by
     ``theta_i``                                          (eq. 18-19);
  2. the edge server applies the weighted update with gain
     ``theta_bar_d = sum m^_i theta_i``                     (eq. 20);
  3. the staleness-aware mixing matrix ``P_t`` built from the iteration gaps
     ``delta_t^(j) = t - t'(j)`` re-mixes the closed neighborhood (eq. 21-22);
  4. ``t <- t + 1``; the next event for ``d`` is scheduled after its
     iteration latency.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Callable, Optional

import numpy as np

from .latency import LatencyModel
from .protocol import ClusterSpec
from .staleness import psi_inverse
from .topology import Topology

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (hetero -> core)
    from ..hetero import DeviceProfile

__all__ = ["AsyncConfig", "make_speeds"]


def __getattr__(name: str):
    if name == "AsyncSDFEEL":
        raise ImportError(
            "AsyncSDFEEL was removed; use repro_torch.core.runtime.make_run("
            "{'scheduler': 'async', ...}) instead"
        )
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def make_speeds(num_clients: int, heterogeneity: float, seed: int = 0) -> np.ndarray:
    """Client speeds h_i with heterogeneity gap H = max h / min h."""
    rng = np.random.default_rng(seed)
    if heterogeneity <= 1.0 or num_clients < 2:
        return np.ones(num_clients)
    h = rng.uniform(1.0, heterogeneity, size=num_clients)
    # pin slowest/fastest at distinct indices so the gap is exactly H
    lo, hi = rng.choice(num_clients, size=2, replace=False)
    h[lo] = 1.0
    h[hi] = heterogeneity
    return h


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    clusters: ClusterSpec
    topology: Topology
    speeds: Optional[np.ndarray] = None  # h_i per client (or take them from profile)
    learning_rate: float = 0.01
    theta_min: int = 1
    theta_max: int = 20
    min_batches: int = 4                # deadline: slowest client fits this many
    psi: Callable = psi_inverse
    alpha_latency: Optional[LatencyModel] = None
    profile: Optional["DeviceProfile"] = None   # per-client compute/link/availability

    def __post_init__(self):
        if self.profile is not None:
            if self.speeds is not None:
                # iter_times() prices the queue from the profile while theta()
                # reads speeds; two sources could silently disagree
                raise ValueError("pass either speeds or profile, not both")
            if self.profile.num_clients != self.clusters.num_clients:
                raise ValueError("profile size must match the number of clients")
            object.__setattr__(self, "speeds", self.profile.speeds)
        elif self.speeds is None:
            object.__setattr__(self, "speeds", np.ones(self.clusters.num_clients))
        if len(self.speeds) != self.clusters.num_clients:
            raise ValueError("one speed per client required")

    def theta(self) -> np.ndarray:
        """theta_i: local epochs within each cluster's deadline (eq. 18)."""
        h = np.asarray(self.speeds, dtype=np.float64)
        out = np.zeros(len(h), dtype=np.int64)
        for d in range(self.clusters.num_clusters):
            idx = self.clusters.clients_of(d)
            slowest = h[idx].min()
            # deadline T_d = min_batches * batch_time(slowest in cluster)
            out[idx] = np.clip(
                np.floor(self.min_batches * h[idx] / slowest),
                self.theta_min,
                self.theta_max,
            ).astype(np.int64)
        return out

    def iter_times(self) -> np.ndarray:
        """Per-cluster iteration latency T_iter^(d) (compute + comms).

        With a ``DeviceProfile`` attached, each cluster is priced by its own
        slowest member *and* its narrowest uplink (``FleetTiming``); without
        one, only the compute leg differentiates clusters.
        """
        if self.profile is not None:
            from ..hetero import FleetTiming

            return FleetTiming(self.profile, self.alpha_latency).cluster_service_times(
                self.clusters, self.min_batches
            )
        lat = self.alpha_latency
        h = np.asarray(self.speeds, dtype=np.float64)
        times = np.zeros(self.clusters.num_clusters)
        for d in range(self.clusters.num_clusters):
            idx = self.clusters.clients_of(d)
            slowest = h[idx].min()
            if lat is None:
                comp = self.min_batches / slowest
                comm = 0.5
            else:
                comp = self.min_batches * lat.t_comp(slowest)
                comm = lat.t_comm_client_server() + lat.t_comm_server_server()
            times[d] = comp + comm
        return times
