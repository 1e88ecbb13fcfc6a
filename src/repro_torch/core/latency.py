"""Latency model of Section V-B — converts protocol iterations to wall-clock.

    T_tot = K * ( T_comp^ct + (1/tau1) T_comm^{ct-sr} + (alpha/(tau1 tau2)) T_comm^{sr-sr} )

with computation time ``T_comp = N_MAC / C_CPU`` and communication time
``T_comm = M_bit / R``.  The same primitives price the FedAvg / HierFAVG /
FEEL baselines so Figs. 4-6 can be reproduced.  All rates in the paper's
units: FLOPs, bits, bit/s.
"""
from __future__ import annotations

import dataclasses

__all__ = ["LatencyModel", "MNIST_LATENCY", "CIFAR_LATENCY"]


@dataclasses.dataclass(frozen=True)
class LatencyModel:
    n_mac_flops: float            # FLOPs per local iteration
    model_bits: float = 32e6      # M_bit = 32 Mbits (paper)
    cpu_flops: float = 10e9       # C_CPU = 10 GFLOPS (slowest device)
    rate_client_server: float = 5e6     # R^{ct-sr} = 5 Mbps
    rate_server_server: float = 50e6    # R^{sr-sr} = 50 Mbps
    rate_server_cloud: float = 5e6      # edge <-> cloud
    rate_client_cloud: float = 2.5e6    # R^{ct-cd} = 2.5 Mbps

    # -- primitive latencies -------------------------------------------------
    # ``speed_scale`` / ``bandwidth_scale`` default to 1.0 == the paper's
    # slowest-device / nominal-link constants; a ``DeviceProfile`` threads
    # per-client values through the same primitives (see repro.hetero).
    def t_comp(self, speed_scale: float = 1.0) -> float:
        """Per-local-iteration compute time; speed_scale=h_i/h_slowest >= 1."""
        return self.n_mac_flops / (self.cpu_flops * speed_scale)

    def t_comm_client_server(self, bandwidth_scale: float = 1.0) -> float:
        return self.model_bits / (self.rate_client_server * bandwidth_scale)

    def t_comm_server_server(self) -> float:
        return self.model_bits / self.rate_server_server

    def t_comm_server_cloud(self) -> float:
        return self.model_bits / self.rate_server_cloud

    def t_comm_client_cloud(self, bandwidth_scale: float = 1.0) -> float:
        return self.model_bits / (self.rate_client_cloud * bandwidth_scale)

    # -- per-K totals for each FL system (Table I rows) -----------------------
    def sdfeel_total(self, k: int, tau1: int, tau2: int, alpha: int) -> float:
        per_iter = (
            self.t_comp()
            + self.t_comm_client_server() / tau1
            + alpha * self.t_comm_server_server() / (tau1 * tau2)
        )
        return k * per_iter

    def hierfavg_total(self, k: int, tau1: int, tau2: int) -> float:
        """HierFAVG: edge aggregation every tau1, cloud aggregation every tau1*tau2."""
        per_iter = (
            self.t_comp()
            + self.t_comm_client_server() / tau1
            + self.t_comm_server_cloud() / (tau1 * tau2)
        )
        return k * per_iter

    def fedavg_total(self, k: int, tau: int) -> float:
        """FedAvg: clients talk straight to the cloud every tau iterations."""
        per_iter = self.t_comp() + self.t_comm_client_cloud() / tau
        return k * per_iter

    def feel_total(self, k: int, tau: int) -> float:
        """Single-edge-server FEEL: client <-> edge every tau iterations."""
        per_iter = self.t_comp() + self.t_comm_client_server() / tau
        return k * per_iter


# Paper §V-B constants (OpCounter measurements).
MNIST_LATENCY = LatencyModel(n_mac_flops=487.54e3)
CIFAR_LATENCY = LatencyModel(n_mac_flops=138.4e6)
