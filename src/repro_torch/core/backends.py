"""Pluggable aggregation backends: one Lemma-1 transition, three implementations.

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
``CollectiveBackend``  The reference's structured path: weighted hypercube
                   all-reduce (log2(g) exchanges) and ``alpha`` rounds of
                   ring gossip.  Without a mesh on the stacked client axis
                   of one device (``aggregation.hypercube_cluster_allreduce``,
                   ``ring_gossip``), the computation the reference runs
                   under ``vmap``; on a client mesh (``launch.mesh``, one
                   client a rank) as point-to-point messages between the
                   ranks (``aggregation.hypercube_allreduce_on_mesh``,
                   ``ring_gossip_on_mesh``), as the reference runs it under
                   ``shard_map``.  Plain PyTorch and ``torch.distributed``:
                   the reference runs it as ``lax.ppermute`` and elementwise
                   ops, in no Pallas kernel.  Requires a ring mixing
                   stencil, contiguous uniform clusters of power-of-two size
                   and D >= 3.  Returns new tensors.
=================  ==========================================================

Every backend and ``resolve_backend`` take ``device=None``, which means
``"cuda"`` and raises without a GPU (``core.device.resolve_device``).

``resolve_backend("auto", ...)`` picks ``collective`` when a client mesh is
given and the scenario satisfies the collective constraints, else ``cuda``
when the run's device is CUDA and the clusters are contiguous and uniform,
``dense`` otherwise.  ``launch.mesh.resolve_client_mesh`` gives a client
mesh only over an initialized process group of one rank a client, so in one
process ``"auto"`` is ``cuda`` on the card and ``dense`` on the CPU.
"""
from __future__ import annotations

from typing import Callable, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from .aggregation import (
    apply_transition_dense,
    dense_gossip_reference,
    hypercube_allreduce_on_mesh,
    hypercube_cluster_allreduce,
    ring_gossip,
    ring_gossip_on_mesh,
    ring_mixing_weights,
)
from .device import resolve_device
from .protocol import AggregationEvent, ClusterSpec

__all__ = [
    "AggregationBackend",
    "DenseBackend",
    "CudaBackend",
    "CollectiveBackend",
    "BACKEND_REGISTRY",
    "register_backend",
    "resolve_backend",
    "select_auto_backend",
    "collective_supported",
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
# Structured collective backend (the stacked client axis of one device)
# ---------------------------------------------------------------------------

class CollectiveBackend:
    """Hypercube all-reduce + ring gossip over the client axis.

    Without a mesh, the reference's ``CollectiveBackend`` under ``vmap``: the
    per-client collective code with every ``lax.ppermute`` a fixed
    permutation of the stacked client axis
    (``aggregation.hypercube_cluster_allreduce``, ``ring_gossip``).
    ``transition`` and ``intra_cluster`` accumulate each leaf in f32 (``x *
    m^`` promotes a bf16 leaf) and cast back once; ``inter_cluster`` mixes
    ``(D, ...)`` cluster models in their own dtype.

    With ``mesh`` (a ``launch.mesh.ClientMesh`` of C ranks), the reference's
    ``shard_map`` path: ``transition`` takes this rank's ``(1, ...)`` row,
    reads its own entry of the weights and its cluster's of the stencil,
    and exchanges with the other ranks (``hypercube_allreduce_on_mesh``,
    ``ring_gossip_on_mesh``) leaf by leaf, so a leaf's f32 copies are the
    most it holds beside the row.  ``intra_cluster`` and ``inter_cluster``
    keep the stacked path, as in the reference.

    The per-call ``weights`` substitute for the bound ``m^`` in the
    all-reduce, and a per-call ``p`` becomes three ``(D,)`` stencil vectors
    gathered on the device (``_ring_stencil``), so neither syncs with the
    host and a captured graph reads both from its static buffers.  Support
    off the ring stencil cannot be checked on device values: the schedulers
    check every faulted matrix on the host before it is staged
    (``FaultSchedule.mixing_stack(require_ring_stencil=True)``, and each
    async ``P_t`` as it is built), and ``inter_cluster`` checks a ``p`` that
    lies on the host.
    """

    name = "collective"

    def __init__(self, clusters: ClusterSpec, p: np.ndarray, alpha: int, device=None,
                 mesh=None):
        from ..launch.mesh import ClientMesh

        if mesh is not None and not isinstance(mesh, ClientMesh):
            raise ValueError(f"mesh must be None or a launch.mesh.ClientMesh, got {mesh!r}")
        if mesh is not None and mesh.size != clusters.num_clients:
            raise ValueError(f"mesh axis {mesh.axis_name!r} has size {mesh.size}, need one "
                             f"rank a client ({clusters.num_clients})")
        if not _uniform_contiguous(clusters):
            raise ValueError(
                f"collective backend requires contiguous uniform clusters "
                f"(C % D == 0, client i in cluster i // (C/D)); got "
                f"assignments={clusters.assignments}"
            )
        g = clusters.num_clients // clusters.num_clusters
        if g & (g - 1):
            raise ValueError(
                f"collective backend requires power-of-two cluster sizes for the "
                f"hypercube all-reduce; got cluster_size={g}"
            )
        d = clusters.num_clusters
        if d < 3:
            raise ValueError("collective ring gossip needs >= 3 clusters")
        self.clusters = clusters
        self.cluster_size = g
        self.alpha = alpha
        self.mesh = mesh
        dev = mesh.device if mesh is not None else resolve_device(device)
        self.device = dev
        # raises if P has support off the ring stencil (non-ring topology)
        self._ring_w = tuple(_f32(w, dev) for w in ring_mixing_weights(np.asarray(p, np.float64)))
        self._m_hat = _f32(clusters.m_hat(), dev)
        idx = torch.arange(d, device=dev)
        self._stencil_idx = ((idx - 1) % d, idx, (idx + 1) % d)

    def _ring_stencil(self, p: torch.Tensor) -> tuple:
        """Per-cluster ``(w_left, w_self, w_right)`` gathered from ``p`` on the
        device: column ``d`` of a ring-stencil matrix holds the three weights
        cluster ``d``'s gossip uses (the device twin of
        ``ring_mixing_weights``, without its host-side check)."""
        left, idx, right = self._stencil_idx
        p = _f32(p, self.device)
        return p[left, idx], p[idx, idx], p[right, idx]

    def _apply(self, stacked: dict, event: AggregationEvent, m_hat: torch.Tensor,
               ring_w: tuple) -> dict:
        g, out = self.cluster_size, {}
        for k, x in stacked.items():
            y = hypercube_cluster_allreduce(x, g, m_hat)
            # one round a call: the round's input is freed as the next begins,
            # so a leaf holds at most three f32 copies at once
            for _ in range(self.alpha if event == "inter" else 0):
                y = ring_gossip(y, g, *ring_w, 1)
            out[k] = y.to(x.dtype)
        return out

    def _apply_on_mesh(self, row: dict, event: AggregationEvent, m_hat: torch.Tensor,
                       ring_w: tuple) -> dict:
        """This rank's ``(1, ...)`` row through the exchanges, leaf by leaf as
        the reference's ``per_leaf``, so one leaf bounds the f32 scratch."""
        mesh, g, out = self.mesh, self.cluster_size, {}
        alpha = self.alpha if event == "inter" else 0
        for k, x in row.items():
            y = hypercube_allreduce_on_mesh(x, mesh, g, m_hat[mesh.index])
            out[k] = ring_gossip_on_mesh(y, mesh, g, *ring_w, alpha).to(x.dtype)
        return out

    # -- full Lemma-1 transition, (C, ...) -> (C, ...) -----------------------
    def transition(self, stacked: dict, event: AggregationEvent,
                   weights: Optional[torch.Tensor] = None,
                   p: Optional[torch.Tensor] = None) -> dict:
        """The Lemma-1 transition; on a mesh ``stacked`` is this rank's
        ``(1, ...)`` row, and ``weights`` (``(C,)``) and ``p`` (``(D, D)``)
        are the fleet's, of which the rank reads its own entries."""
        if event == "local":
            return stacked
        ring_w = self._ring_w if p is None or event != "inter" else self._ring_stencil(p)
        m_hat = self._m_hat if weights is None else _f32(weights, self.device)
        if self.mesh is not None:
            return self._apply_on_mesh(stacked, event, m_hat, ring_w)
        return self._apply(stacked, event, m_hat, ring_w)

    # -- factors -------------------------------------------------------------
    def intra_cluster(self, stacked: dict, weights: torch.Tensor) -> dict:
        reduced = self._apply(stacked, "intra", _f32(weights, self.device), self._ring_w)
        # every member of a cluster holds the reduced model; take the leads
        return {k: v[::self.cluster_size].contiguous() for k, v in reduced.items()}

    def inter_cluster(self, y: dict, p: torch.Tensor, alpha: int = 1) -> dict:
        if not (isinstance(p, torch.Tensor) and p.device.type == "cuda"):
            # values on the host: check the stencil, as the reference does
            # for every P it re-derives (raises off the ring)
            ring_mixing_weights(np.asarray(torch.as_tensor(p).cpu(), np.float64))
        ring_w = self._ring_stencil(p)
        return {k: ring_gossip(v, 1, *ring_w, alpha).to(v.dtype) for k, v in y.items()}


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
register_backend("collective")(CollectiveBackend)


def collective_supported(clusters: ClusterSpec, p: np.ndarray) -> bool:
    """Can ``CollectiveBackend`` represent this scenario?  (See its docstring.)"""
    if not _uniform_contiguous(clusters) or clusters.num_clusters < 3:
        return False
    g = clusters.num_clients // clusters.num_clusters
    if g & (g - 1):  # the hypercube needs power-of-two cluster sizes
        return False
    try:
        ring_mixing_weights(np.asarray(p, np.float64))
    except ValueError:
        return False
    return True


def select_auto_backend(clusters: ClusterSpec, device, p: Optional[np.ndarray] = None,
                        mesh=None) -> str:
    """Pick a backend name by client mesh, device and cluster layout.

    * ``collective`` when a client mesh is given (``mesh`` as
      ``launch.mesh.resolve_client_mesh`` returns it) and the scenario
      satisfies the collective constraints (ring stencil of ``p``,
      power-of-two uniform clusters, D >= 3), as the reference;
    * ``cuda`` on a CUDA device with contiguous uniform clusters;
    * ``dense`` everywhere else.
    """
    if mesh is not None and p is not None and collective_supported(clusters, p):
        return "collective"
    if torch.device(device).type == "cuda" and _uniform_contiguous(clusters):
        return "cuda"
    return "dense"


def resolve_backend(spec, clusters: ClusterSpec, p: np.ndarray, alpha: int,
                    device=None, mesh=None) -> AggregationBackend:
    """Turn a backend spec into a bound instance.

    ``spec`` is a registered name, ``"auto"``, ``None`` (== auto), or an
    already-constructed backend (returned as-is).  ``device=None`` means
    ``"cuda"`` and raises without a GPU.  ``mesh`` (a resolved client mesh,
    None on one device) goes to the collective backend; the other backends
    take none.
    """
    if spec is None:
        spec = "auto"
    if not isinstance(spec, str):
        return spec
    device = resolve_device(device)
    name = select_auto_backend(clusters, device, p, mesh) if spec == "auto" else spec
    if name not in BACKEND_REGISTRY:
        raise KeyError(
            f"unknown aggregation backend {name!r}; registered: {sorted(BACKEND_REGISTRY)}"
        )
    if mesh is None:
        return BACKEND_REGISTRY[name](clusters, np.asarray(p, np.float64), alpha, device=device)
    if name != "collective":
        # a rank holds one client's row; the reference's dense product over a
        # sharded axis is a gather the port does not make
        raise ValueError(
            f"backend {name!r} on a client mesh: a rank holds one client, so only the "
            f"collective backend runs there (a ring stencil, D >= 3, uniform contiguous "
            f"power-of-two clusters); run without a mesh for {name!r}")
    return BACKEND_REGISTRY[name](clusters, np.asarray(p, np.float64), alpha, device=device,
                                  mesh=mesh)
