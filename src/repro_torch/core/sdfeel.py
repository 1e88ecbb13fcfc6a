"""Federated layout spec of the round engine: the port's ``repro.core.sdfeel``.

``FLSpec`` (uniform contiguous clusters, the topology by name) and
``init_stacked``.  The single-iteration SPMD step ``build_fl_train_step``
comes with 'Multi-device and launch'.
"""
from __future__ import annotations

import dataclasses

from .protocol import SDFEELConfig

__all__ = ["FLSpec", "init_stacked"]


@dataclasses.dataclass(frozen=True)
class FLSpec:
    """Federated layout: C clients in D uniform clusters, protocol periods."""

    num_clients: int
    num_clusters: int
    tau1: int = 2
    tau2: int = 1
    alpha: int = 2
    learning_rate: float = 0.01
    impl: str = "dense"       # dense | pallas (the kernel backend) | gossip
    topology: str = "ring"

    @property
    def cluster_size(self) -> int:
        if self.num_clients % self.num_clusters:
            raise ValueError("clients must divide evenly into clusters")
        return self.num_clients // self.num_clusters

    def protocol(self) -> SDFEELConfig:
        from .protocol import ClusterSpec
        from .topology import TOPOLOGIES

        return SDFEELConfig(
            clusters=ClusterSpec.uniform(self.num_clients, self.num_clusters),
            topology=TOPOLOGIES[self.topology](self.num_clusters),
            tau1=self.tau1,
            tau2=self.tau2,
            alpha=self.alpha,
            learning_rate=self.learning_rate,
        )


def init_stacked(model, num_clients: int, seed, device) -> dict:
    """Identical initial model replicated on the client axis."""
    from .runtime import stacked_init

    return stacked_init(model, num_clients, seed, device)
