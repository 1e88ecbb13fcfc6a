"""SD-FEEL core in PyTorch: protocol math, aggregation backends, runtime."""
from .topology import (
    Topology, ring, star, fully_connected, chain, partially_connected, torus_2d, mixing_matrix,
    zeta, TOPOLOGIES, connected_components, from_edges,
)
from .protocol import ClusterSpec, SDFEELConfig, transition_matrix
from .aggregation import (
    apply_transition_dense, dense_gossip_reference, stack_clients, unstack_clients,
)
from .backends import (
    AggregationBackend, DenseBackend, CudaBackend, CollectiveBackend,
    BACKEND_REGISTRY, register_backend, resolve_backend, select_auto_backend,
    collective_supported,
)
from .config import DataSpec, ExecSpec, FleetSpec, ModelSpec, RunConfig
from .device import resolve_device
from .latency import LatencyModel, MNIST_LATENCY, CIFAR_LATENCY
from .local_update import (
    build_local_update, build_sequential_local_update, fused_sgd_applicable,
)
from .pipeline import BatchPipeline, device_batch, gather_client_batches, stack_window
from .runtime import (
    AsyncScheduler, FederationRuntime, RoundScheduler, Scheduler, StepEvent, SyncScheduler,
    TrainHistory, make_run, register_scheduler, stacked_init, SCHEDULER_REGISTRY,
)
from .sdfeel import FLSpec, build_fl_train_step, init_stacked
from .round_engine import build_fl_round_step
from .staleness import psi_constant, psi_exponential, psi_inverse, staleness_mixing_matrix
from .async_engine import AsyncConfig, make_speeds
from .baselines import FedAvgTrainer, HierFAVGTrainer, FEELTrainer
from . import theory

__all__ = [
    "Topology", "ring", "star", "fully_connected", "chain", "partially_connected",
    "torus_2d", "mixing_matrix", "zeta", "TOPOLOGIES", "connected_components", "from_edges",
    "ClusterSpec", "SDFEELConfig", "transition_matrix",
    "apply_transition_dense", "dense_gossip_reference", "stack_clients", "unstack_clients",
    "AggregationBackend", "DenseBackend", "CudaBackend", "CollectiveBackend",
    "BACKEND_REGISTRY", "register_backend", "resolve_backend", "select_auto_backend",
    "collective_supported",
    "DataSpec", "ExecSpec", "FleetSpec", "ModelSpec", "RunConfig",
    "resolve_device",
    "LatencyModel", "MNIST_LATENCY", "CIFAR_LATENCY",
    "build_local_update", "build_sequential_local_update", "fused_sgd_applicable",
    "BatchPipeline", "device_batch", "gather_client_batches", "stack_window",
    "FLSpec", "build_fl_train_step", "init_stacked", "build_fl_round_step",
    "AsyncScheduler", "FederationRuntime", "RoundScheduler", "Scheduler", "StepEvent",
    "SyncScheduler",
    "TrainHistory", "make_run", "register_scheduler", "stacked_init", "SCHEDULER_REGISTRY",
    "psi_constant", "psi_exponential", "psi_inverse", "staleness_mixing_matrix",
    "AsyncConfig", "make_speeds",
    "FedAvgTrainer", "HierFAVGTrainer", "FEELTrainer",
    "theory",
]
