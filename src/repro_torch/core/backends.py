"""Pluggable aggregation backends: one Lemma-1 transition, two implementations.

Every schedule applies the same linear operator — ``W <- W @ T_k`` with
``T_k in {I, V B, V P^alpha B}`` — to a dict of client-stacked ``(C, ...)``
tensors.  ``AggregationBackend`` is the interface (``C`` clients, ``D``
clusters)::

    intra_cluster(stacked, weights)  (C, ...) -> (D, ...)   eq. 2-3 reduce
    inter_cluster(y, p, alpha)       (D, ...) -> (D, ...)   eq. 4 mixing
    transition(stacked, event,       (C, ...) -> (C, ...)   full Lemma-1 T_k
               weights=None, p=None)

``weights`` is a per-call ``(C,)`` tensor of intra-cluster client weights
(the participation axis) and ``p`` a per-call ``(D, D)`` mixing matrix (the
fault axis, used by the ``inter`` event only).  Both are runtime tensors:
changing them changes values, never a kernel or a cached program.

Registered implementations:

=================  ==========================================================
``DenseBackend``   Matrix products against the precomputed ``T_k``; works for
                   any ``ClusterSpec``/topology and is the reference of the
                   equivalence tests.  Returns new tensors.
``CudaBackend``    The hand-written CUDA kernels, the counterpart of the
                   reference's ``PallasBackend``: ``transition`` is the fused
                   ``V P^alpha B`` kernel (``kernels/fused_transition``, one
                   launch per tree and one pass over each leaf, the (D, M)
                   cluster intermediate kept in registers),
                   ``intra_cluster`` the ``cluster_agg`` kernel
                   and ``inter_cluster`` the ``gossip_mix`` kernel.  Requires
                   contiguous uniform clusters.  ``transition`` and
                   ``inter_cluster`` **overwrite** the leaves they are given
                   and return them.
=================  ==========================================================

Every backend and ``resolve_backend`` take ``device=None``, which means
``"cuda"`` and raises without a GPU (``core.device.resolve_device``).

``resolve_backend("auto", ...)`` picks ``cuda`` when the run's device is
CUDA and the clusters are contiguous and uniform, ``dense`` otherwise.
"""
from __future__ import annotations

from typing import Callable, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from .aggregation import apply_transition_dense, dense_gossip_reference
from .device import resolve_device
from .protocol import AggregationEvent, ClusterSpec

__all__ = [
    "AggregationBackend",
    "DenseBackend",
    "CudaBackend",
    "BACKEND_REGISTRY",
    "register_backend",
    "resolve_backend",
    "select_auto_backend",
]


@runtime_checkable
class AggregationBackend(Protocol):
    """One implementation of the Lemma-1 transition and its two factors."""

    name: str

    def intra_cluster(self, stacked: dict, weights: torch.Tensor) -> dict: ...

    def inter_cluster(self, y: dict, p: torch.Tensor, alpha: int) -> dict: ...

    def transition(
        self, stacked: dict, event: AggregationEvent,
        weights: Optional[torch.Tensor] = None,
        p: Optional[torch.Tensor] = None,
    ) -> dict: ...


def _uniform_contiguous(clusters: ClusterSpec) -> bool:
    """Clusters are contiguous, equally-sized blocks (the kernel layout)."""
    c, d = clusters.num_clients, clusters.num_clusters
    if c % d:
        return False
    g = c // d
    return clusters.assignments == tuple(i // g for i in range(c))


def _t_matrix(clusters: ClusterSpec, p: np.ndarray, alpha: int,
              event: AggregationEvent) -> np.ndarray:
    """Lemma-1 T_k from raw factors, float64 on the host."""
    v, b = clusters.V(), clusters.B()
    if event == "intra":
        return v @ b
    return v @ np.linalg.matrix_power(np.asarray(p, np.float64), alpha) @ b


def _f32(x, device) -> torch.Tensor:
    """``x`` as f32 on ``device``.  A per-call operand (``weights``, ``p``)
    that is already an f32 tensor there is used as it is (inside a captured
    graph, the graph's static buffer); anything else is copied once, and a
    tensor never goes through numpy."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Dense (paper-faithful) backend
# ---------------------------------------------------------------------------

class DenseBackend:
    """Lemma-1 matrix products — correct for every cluster layout."""

    name = "dense"

    def __init__(self, clusters: ClusterSpec, p: np.ndarray, alpha: int, device=None):
        self.clusters = clusters
        self.alpha = alpha
        dev = resolve_device(device)
        self.device = dev
        # static path: P^alpha and T_k in float64 on the host, then f32
        self._t = {e: _f32(_t_matrix(clusters, p, alpha, e), dev) for e in ("intra", "inter")}
        # B indicator (C, D) for the weight-parametrized transition
        self._b_ind = _f32(clusters.B().T, dev)
        # right factors of T(w) = V(w) @ M_event: M_intra = B, M_inter = P^alpha B
        b = clusters.B()
        p_a = np.linalg.matrix_power(np.asarray(p, np.float64), alpha)
        self._m_event = {"intra": _f32(b, dev), "inter": _f32(p_a @ b, dev)}
        self._m_hat_full = _f32(clusters.m_hat(), dev)

    def _v(self, weights: torch.Tensor) -> torch.Tensor:
        # V(w): (C, D) one-hot rows of B^T scaled by the per-client weight
        return self._b_ind * _f32(weights, self.device)[:, None]

    def intra_cluster(self, stacked: dict, weights: torch.Tensor) -> dict:
        return apply_transition_dense(stacked, self._v(weights))

    def inter_cluster(self, y: dict, p: torch.Tensor, alpha: int = 1) -> dict:
        return dense_gossip_reference(y, torch.as_tensor(p, device=self.device), alpha)

    def transition(self, stacked: dict, event: AggregationEvent,
                   weights: Optional[torch.Tensor] = None,
                   p: Optional[torch.Tensor] = None) -> dict:
        if event == "local":
            return stacked
        if p is not None and event == "inter":
            # per-call mixing matrix: P^alpha in f32 on the device (the
            # static path's P^alpha is float64 on the host)
            w = self._m_hat_full if weights is None else weights
            p_a = torch.linalg.matrix_power(_f32(p, self.device), self.alpha)
            return apply_transition_dense(stacked, self._v(w) @ (p_a @ self._m_event["intra"]))
        if weights is None:
            return apply_transition_dense(stacked, self._t[event])
        return apply_transition_dense(stacked, self._v(weights) @ self._m_event[event])


# ---------------------------------------------------------------------------
# CUDA kernel backend
# ---------------------------------------------------------------------------

class CudaBackend:
    """The hand-written CUDA kernels for the transition and its two factors.

    The counterpart of the reference's ``PallasBackend``.  ``transition``
    (``fused_transition``) overwrites the ``(C, ...)`` leaves it is given
    and ``inter_cluster`` (``gossip_mix``) the ``(D, ...)`` leaves: each
    column of a leaf belongs to one kernel thread, which reads it whole
    before writing it.  ``intra_cluster`` (``cluster_agg``) returns new
    ``(D, ...)`` leaves.  On CPU tensors the kernel wrappers take their
    plain PyTorch versions.
    """

    name = "cuda"

    def __init__(self, clusters: ClusterSpec, p: np.ndarray, alpha: int, device=None):
        if not _uniform_contiguous(clusters):
            raise ValueError(
                f"cuda backend requires contiguous uniform clusters (C % D == 0, "
                f"client i in cluster i // (C/D)); got assignments={clusters.assignments}"
            )
        self.clusters = clusters
        self.alpha = alpha
        dev = resolve_device(device)
        self.device = dev
        # the factors bound contiguous once: the kernel reads them as dense
        # row-major matrices, so a strided one would cost a copy every call
        self._vt = _f32(np.ascontiguousarray(clusters.V().T), dev)   # (D, C)
        self._bt = _f32(np.ascontiguousarray(clusters.B().T), dev)   # (C, D)
        self._b = _f32(clusters.B(), dev)                            # (D, C) = bt.T
        self._p = _f32(p, dev)

    def intra_cluster(self, stacked: dict, weights: torch.Tensor) -> dict:
        from ..kernels import cluster_agg_tree

        w = torch.as_tensor(weights, dtype=torch.float32).to(self.device).contiguous()
        return cluster_agg_tree(stacked, w, self.clusters.num_clusters)

    def inter_cluster(self, y: dict, p: torch.Tensor, alpha: int = 1) -> dict:
        from ..kernels import gossip_mix_tree

        # the kernel reads P from device memory: a P built on the host goes
        # there in one non-blocking copy from pinned memory (a captured step
        # passes its static device buffer, which is used as it is)
        p = torch.as_tensor(p, dtype=torch.float32)
        if p.device.type == "cpu" and self.device.type == "cuda":
            p = p.contiguous().pin_memory().to(self.device, non_blocking=True)
        return gossip_mix_tree(y, p, alpha=alpha, inplace=True)

    def transition(self, stacked: dict, event: AggregationEvent,
                   weights: Optional[torch.Tensor] = None,
                   p: Optional[torch.Tensor] = None) -> dict:
        from ..kernels import fused_transition_tree

        if event == "local":
            return stacked
        # alpha=0 skips the mixing stage: V B
        alpha = self.alpha if event == "inter" else 0
        if weights is None:
            vt = self._vt
        else:
            # V(w)^T: B is the exact 0/1 indicator, so vt rows carry w verbatim
            # (and come out contiguous, as B is)
            vt = self._b * _f32(weights, self.device)[None, :]
        p_call = self._p if p is None or event != "inter" else _f32(p, self.device)
        return fused_transition_tree(stacked, vt, p_call, self._bt, alpha=alpha, inplace=True)


# ---------------------------------------------------------------------------
# Registry + auto selection
# ---------------------------------------------------------------------------

BACKEND_REGISTRY: dict[str, Callable[..., AggregationBackend]] = {}


def register_backend(name: str):
    """Register a backend factory ``(clusters, p, alpha, device=) -> backend``."""

    def deco(factory: Callable[..., AggregationBackend]):
        BACKEND_REGISTRY[name] = factory
        return factory

    return deco


register_backend("dense")(DenseBackend)
register_backend("cuda")(CudaBackend)


def select_auto_backend(clusters: ClusterSpec, device) -> str:
    """``cuda`` on a CUDA device with contiguous uniform clusters, else ``dense``."""
    if torch.device(device).type == "cuda" and _uniform_contiguous(clusters):
        return "cuda"
    return "dense"


def resolve_backend(spec, clusters: ClusterSpec, p: np.ndarray, alpha: int,
                    device=None) -> AggregationBackend:
    """Turn a backend spec into a bound instance.

    ``spec`` is a registered name, ``"auto"``, ``None`` (== auto), or an
    already-constructed backend (returned as-is).  ``device=None`` means
    ``"cuda"`` and raises without a GPU.
    """
    if spec is None:
        spec = "auto"
    if not isinstance(spec, str):
        return spec
    device = resolve_device(device)
    name = select_auto_backend(clusters, device) if spec == "auto" else spec
    if name not in BACKEND_REGISTRY:
        raise KeyError(
            f"unknown aggregation backend {name!r}; registered: {sorted(BACKEND_REGISTRY)}"
        )
    return BACKEND_REGISTRY[name](clusters, np.asarray(p, np.float64), alpha, device=device)
