"""Serving: the port's ``repro.serving``.

Static-drain (``BatchServer``) and slot-pool (``ContinuousServer``, its
decode chunk on a CUDA graph) engines over ``CausalLM``'s caches, their
per-cluster federated variants with hot swap (``FederatedServer``,
``ContinuousFederatedServer``, ``ReplicaBuffer``), and synthetic Zipf
request traces (``synthetic_trace``)."""
from .engine import BatchServer, ContinuousServer, Request, ServeStats
from .federated import ContinuousFederatedServer, FederatedServer, ReplicaBuffer
from .traffic import heavy_tail_ints, synthetic_trace, zipf_cluster_ids

__all__ = [
    "Request", "BatchServer", "ContinuousServer", "ServeStats",
    "FederatedServer", "ContinuousFederatedServer", "ReplicaBuffer",
    "synthetic_trace", "zipf_cluster_ids", "heavy_tail_ints",
]
