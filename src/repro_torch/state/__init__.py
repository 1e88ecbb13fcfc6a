"""Sparse resident client state: device buffers sized by participation, not N.

The port's ``repro.state``.  A dense ``(N, params)`` stack on the device
bounds the fleet by device memory, though only the round's sampled clients
ever touch the weight path.  Residency is a policy behind one interface:

``DenseResidentStore``
    The dense layout.  The scheduler keeps owning its stacked tensors; the
    store *attaches* to the scheduler's attribute and reads through it.

``HostOffloadStore``
    One fixed ``(k_max, ...)`` device buffer per parameter leaf, allocated
    once at ``bind``.  Each round (superstep) the participants are
    *gathered* into per-cluster slots, the step runs on the buffer, and the
    results are *scattered* back; the cold majority never reaches the
    device.  ``gather`` writes into the buffer and never returns new
    tensors, so a CUDA graph captured over it (``core/cuda_graph.py`` keys
    a graph by its state's addresses) is captured once and replayed for
    every residency.  Two residency models:

    * ``mode="cluster"`` (default): SD-FEEL broadcasts every aggregate back
      to the whole cluster, so at round boundaries each client's model is
      its cluster model ``y_d``.  Only the ``(D, ...)`` cluster stack
      persists on the device; gather and scatter are device-side takes on
      the constant slot->cluster and cluster->first-slot maps, with no host
      synchronization.
    * ``mode="client"``: every participant also keeps its own state in a
      host-side :class:`HostArrayStore` (the checkpoint layer's leaf naming
      and encoding, in RAM or spilled to disk).  Cold clients start from
      their cluster model (``cold_init="cluster"``) or from the initial
      model (``cold_init="initial"``).  The rows that cannot change under
      the step in flight are read ahead (``stage``) and, in the round
      scheduler, reach the device beside the next superstep's batches.

Residency is planned per round from the participation mask
(:func:`plan_residency`): participants pack cluster-major into ``k_max //
D`` slots per cluster, and a short cluster pads by repeating a participant
at weight exactly 0.  The slot->cluster map is a constant, so changing who
is resident changes values only.

``live_device_bytes(store)`` is ``torch.cuda.memory_allocated`` on a CUDA
device and the store's own tensor bytes on the CPU.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from ..checkpoint import host_leaf
from ..core.protocol import ClusterSpec

__all__ = [
    "ClientStateStore",
    "DenseResidentStore",
    "HostOffloadStore",
    "HostArrayStore",
    "Residency",
    "plan_residency",
    "identity_residency",
    "sub_weights",
    "STORE_REGISTRY",
    "register_store",
    "resolve_store",
    "live_device_bytes",
    "ROWS",
    "STAGED",
]

# the batch entries that carry a client-mode store's staged rows to the
# device beside a superstep's batches: ROWS + leaf name, each (k_max, ...),
# and STAGED, the (k_max,) mask of the slots they fill
ROWS = "store.rows."
STAGED = "store.staged"


def _tree_bytes(tree: Optional[dict]) -> int:
    return 0 if tree is None else sum(t.numel() * t.element_size() for t in tree.values())


def live_device_bytes(store) -> int:
    """Device bytes in use: ``torch.cuda.memory_allocated`` on the store's
    CUDA device, else the store's own device tensors."""
    device = getattr(store, "device", None)
    if device is not None and torch.device(device).type == "cuda":
        return int(torch.cuda.memory_allocated(device))
    return store.device_bytes()


# ---------------------------------------------------------------------------
# Residency planning (numpy, as the reference)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Residency:
    """Which client occupies each of the ``k_max`` device slots this round.

    ``clients[s]`` is the fleet index resident in slot ``s``; ``valid[s]`` is
    False for padding slots (a short cluster repeats one of its participants,
    at aggregation weight exactly 0, never scattered back).  ``slot_cluster``
    is the constant slot->cluster map.
    """

    clients: np.ndarray       # (k_max,) int64
    valid: np.ndarray         # (k_max,) bool
    slot_cluster: np.ndarray  # (k_max,) int64
    identity: bool = False    # True when slots == the full fleet, in order

    @property
    def k_max(self) -> int:
        return int(self.clients.shape[0])

    def participant_mask(self, num_clients: int) -> np.ndarray:
        """Fleet-sized boolean mask of the clients actually resident."""
        m = np.zeros(num_clients, dtype=bool)
        m[self.clients[self.valid]] = True
        return m


def identity_residency(clusters: ClusterSpec) -> Residency:
    """Every client resident, in fleet order (the ``k_max == N`` case)."""
    c = clusters.num_clients
    return Residency(
        clients=np.arange(c, dtype=np.int64),
        valid=np.ones(c, dtype=bool),
        slot_cluster=clusters.assignment_array.copy(),
        identity=True,
    )


def plan_residency(clusters: ClusterSpec, mask: np.ndarray,
                   slots_per_cluster: int) -> Residency:
    """Pack a round's participants into fixed per-cluster device slots.

    Cluster ``d`` owns slots ``[d * g, (d + 1) * g)`` for ``g =
    slots_per_cluster``; its participants fill them in client order and a
    short cluster pads by repeating its first participant (weight 0, see
    :func:`sub_weights`).  Raises when a cluster's participants exceed its
    slots, and when a cluster has none: an offloaded fleet cannot back-fill
    to full membership, so the plan must cover every cluster (``uniform-k``
    does).
    """
    mask = np.asarray(mask, dtype=bool)
    if mask.shape != (clusters.num_clients,):
        raise ValueError(f"mask has shape {mask.shape}, expected ({clusters.num_clients},)")
    g = int(slots_per_cluster)
    d_num = clusters.num_clusters
    assign = clusters.assignment_array
    participants = np.flatnonzero(mask)
    part_clusters = assign[participants]
    counts = np.bincount(part_clusters, minlength=d_num)
    if (counts == 0).any():
        empty = int(np.flatnonzero(counts == 0)[0])
        raise ValueError(
            f"residency: cluster {empty} has no participants this round; an "
            f"offloaded fleet cannot back-fill to full membership — use a "
            f"participation plan with per-cluster coverage (e.g. uniform-k)"
        )
    if (counts > g).any():
        full = int(np.flatnonzero(counts > g)[0])
        raise ValueError(
            f"residency: cluster {full} has {int(counts[full])} participants "
            f"but only {g} device slots (k_max = D * {g}); raise k_max or "
            f"sample fewer clients per cluster"
        )
    clients = np.empty(d_num * g, dtype=np.int64)
    valid = np.zeros(d_num * g, dtype=bool)
    order = np.argsort(part_clusters, kind="stable")  # cluster-major, client order
    sorted_participants = participants[order]
    offsets = np.concatenate([[0], np.cumsum(counts)])
    for d in range(d_num):
        p = sorted_participants[offsets[d]:offsets[d + 1]]
        clients[d * g:d * g + len(p)] = p
        clients[d * g + len(p):(d + 1) * g] = p[0]  # pad: repeat, weight 0
        valid[d * g:d * g + len(p)] = True
    slot_cluster = np.repeat(np.arange(d_num, dtype=np.int64), g)
    return Residency(clients=clients, valid=valid, slot_cluster=slot_cluster)


def sub_weights(full_weights: np.ndarray, res: Residency) -> np.ndarray:
    """A fleet-sized weight vector on the resident slots: padding slots get
    exactly 0, so a repeated participant counts once and each cluster's slot
    weights still sum to 1."""
    w = np.asarray(full_weights, dtype=np.float64)[res.clients]
    return np.where(res.valid, w, 0.0)


# ---------------------------------------------------------------------------
# Host-side array store (checkpoint-encoded leaves)
# ---------------------------------------------------------------------------

class HostArrayStore:
    """Per-entry host storage of a tree's leaves, checkpoint-encoded.

    Leaf naming and the on-disk encoding are the checkpoint layer's
    (``repro_torch.checkpoint``), so a spilled entry is a record of the
    format full checkpoints use.  ``spill_dir=None`` keeps entries in RAM; a
    directory holds one ``client_<8 digits>.npz`` per entry.
    """

    def __init__(self, template: dict, spill_dir: Optional[str] = None):
        from ..checkpoint import flatten_with_names

        self.names = [n for n, _ in flatten_with_names(template)]
        self.spill_dir = spill_dir
        self._ram: dict[int, list[np.ndarray]] = {}
        if spill_dir is not None:
            os.makedirs(spill_dir, exist_ok=True)

    def _path(self, idx: int) -> str:
        return os.path.join(self.spill_dir, f"client_{idx:08d}.npz")

    def __contains__(self, idx: int) -> bool:
        if self.spill_dir is None:
            return idx in self._ram
        return idx in self._ram or os.path.exists(self._path(idx))

    def __len__(self) -> int:
        if self.spill_dir is None:
            return len(self._ram)
        return sum(f.endswith(".npz") for f in os.listdir(self.spill_dir))

    def put(self, idx: int, leaves: list[np.ndarray]) -> None:
        leaves = [np.ascontiguousarray(x) for x in leaves]
        if self.spill_dir is None:
            self._ram[int(idx)] = leaves
        else:
            from ..checkpoint import save_leaves

            save_leaves(self._path(idx), list(zip(self.names, leaves)))

    def get(self, idx: int) -> Optional[list[np.ndarray]]:
        if self.spill_dir is None:
            return self._ram.get(int(idx))
        if not os.path.exists(self._path(idx)):
            return None
        from ..checkpoint import load_leaves

        return load_leaves(self._path(idx))

    def keys(self) -> list[int]:
        if self.spill_dir is None:
            return sorted(self._ram)
        return sorted(int(f[len("client_"):-len(".npz")]) for f in os.listdir(self.spill_dir)
                      if f.startswith("client_") and f.endswith(".npz"))

    def nbytes(self) -> int:
        """Host bytes of RAM-resident entries (spilled entries cost disk)."""
        return sum(x.nbytes for ls in self._ram.values() for x in ls)


# ---------------------------------------------------------------------------
# The store interface and its implementations
# ---------------------------------------------------------------------------

@runtime_checkable
class ClientStateStore(Protocol):
    """Where per-client federation state lives between steps.

    ``resident`` stores keep the full stack on the device and attach to the
    scheduler's own attribute; offloaded stores are bound once (``bind``)
    and then cycle ``residency -> gather -> step -> scatter``.
    """

    kind: str
    resident: bool
    num_clients: int

    def device_bytes(self) -> int: ...


class DenseResidentStore:
    """The dense ``(N, ...)`` device layout behind the store interface: the
    scheduler owns its stacked tensors, ``attach`` points the store at them."""

    kind = "dense"
    resident = True

    def __init__(self, num_clients: int):
        self.num_clients = int(num_clients)
        self._owner = None
        self._attr = "params"
        self._state: Optional[dict] = None

    def attach(self, owner, attr: str = "params") -> "DenseResidentStore":
        self._owner, self._attr = owner, attr
        return self

    @property
    def state(self) -> Optional[dict]:
        if self._owner is not None:
            return getattr(self._owner, self._attr)
        return self._state

    @state.setter
    def state(self, value: dict) -> None:
        if self._owner is not None:
            setattr(self._owner, self._attr, value)
        else:
            self._state = value

    @property
    def device(self):
        state = self.state
        return None if not state else next(iter(state.values())).device

    @property
    def k_max(self) -> int:
        return self.num_clients

    def device_bytes(self) -> int:
        return _tree_bytes(self.state)


class HostOffloadStore:
    """Fixed ``(k_max, ...)`` device residency over an N-client fleet.

    Lifecycle (see the module docstring)::

        store.bind(clusters, model, seed, device)   # once, from Scheduler.bind
        res = store.residency(mask)                 # per round / superstep
        store.gather(res)                           # writes store.buffer
        ... step on store.buffer, in place ...
        store.scatter(res, store.buffer)

    ``k_max=None`` (or ``k_max == N``) is identity residency: every client
    has a slot and ``residency()`` ignores the mask.
    """

    kind = "host-offload"
    resident = False

    def __init__(self, num_clients: int, k_max: Optional[int] = None, mode: str = "cluster",
                 cold_init: str = "cluster", spill_dir: Optional[str] = None):
        if mode not in ("cluster", "client"):
            raise ValueError(f"mode must be 'cluster' or 'client', got {mode!r}")
        if cold_init not in ("cluster", "initial"):
            raise ValueError(f"cold_init must be 'cluster' or 'initial', got {cold_init!r}")
        self.num_clients = int(num_clients)
        self.k_max = None if k_max is None else int(k_max)
        if self.k_max is not None and not (1 <= self.k_max <= self.num_clients):
            raise ValueError(f"k_max must lie in [1, num_clients={num_clients}], got {k_max}")
        self.mode = mode
        self.cold_init = cold_init
        self.spill_dir = spill_dir
        self.clusters: Optional[ClusterSpec] = None
        self.device: Optional[torch.device] = None
        self.buffer: Optional[dict] = None
        self.cluster_models: Optional[dict] = None

    # -- binding -------------------------------------------------------------
    def bind(self, clusters: ClusterSpec, model, seed: int, device) -> None:
        """Initialize every cluster model to the run's ``w0`` (Alg. 1 line 1,
        drawn as ``runtime.stacked_init`` draws it) and allocate the buffer."""
        if clusters.num_clients != self.num_clients:
            raise ValueError(f"store covers {self.num_clients} clients, fleet has "
                             f"{clusters.num_clients}")
        self.clusters = clusters
        self.device = device = torch.device(device)
        d = clusters.num_clusters
        if self.k_max is None:
            self.k_max = self.num_clients
        assign = clusters.assignment_array
        if self.k_max == self.num_clients:
            self.slots_per_cluster = None  # identity: the real membership
            self.sub_clusters = clusters
            self._identity = identity_residency(clusters)
            slot_cluster = assign
            first_slot = np.array([int(np.flatnonzero(assign == j)[0]) for j in range(d)])
        else:
            if self.k_max % d:
                raise ValueError(f"k_max={self.k_max} must be a multiple of the {d} clusters "
                                 f"(fixed per-cluster slot counts)")
            self.slots_per_cluster = g = self.k_max // d
            self.sub_clusters = ClusterSpec.uniform(self.k_max, d)
            self._identity = None
            slot_cluster = np.repeat(np.arange(d, dtype=np.int64), g)
            first_slot = np.arange(d, dtype=np.int64) * g
        w0 = model.init(torch.Generator().manual_seed(int(seed)))
        self.cluster_models = {k: v.to(device)[None].expand((d,) + tuple(v.shape)).contiguous()
                               for k, v in w0.items()}
        self.buffer = {k: torch.empty((self.k_max,) + tuple(v.shape[1:]), dtype=v.dtype,
                                      device=device)
                       for k, v in self.cluster_models.items()}
        # host rows list leaves in the checkpoint layer's order (JAX's: sorted
        # by path), so a spilled row is a record of the checkpoint format
        self._names = sorted(w0, key=lambda n: n.split("."))
        self._w0_host = ([host_leaf(w0[k]) for k in self._names]
                         if self.cold_init == "initial" else None)
        self._host = HostArrayStore(w0, self.spill_dir) if self.mode == "client" else None
        # the constant maps: a new residency never changes them
        self._slot_cluster = torch.as_tensor(slot_cluster, dtype=torch.int64, device=device)
        self._first_slot = torch.as_tensor(first_slot, dtype=torch.int64, device=device)
        self._m = clusters.m()
        self._m_tilde = torch.as_tensor(clusters.m_tilde(), dtype=torch.float32, device=device)

    # -- per-round interface -------------------------------------------------
    def residency(self, mask: Optional[np.ndarray] = None) -> Residency:
        """Slot assignment for one round's participation mask: the full fleet
        for an identity store; a sparse store needs a mask covering every
        cluster."""
        if self._identity is not None:
            return self._identity
        if mask is None:
            raise ValueError(
                f"a sparse HostOffloadStore (k_max={self.k_max} < N={self.num_clients}) "
                f"needs a participation mask; configure a participation plan (e.g. uniform-k)"
            )
        return plan_residency(self.clusters, mask, self.slots_per_cluster)

    def stage(self, res: Residency, in_flight: tuple = ()) -> Optional[dict]:
        """Client mode: the host rows of residency ``res`` that no step in
        flight can change, as batch entries (``ROWS`` + leaf name, ``(k_max,
        ...)``, and ``STAGED``, the slots they fill), so they travel to the
        device with the batches.  ``in_flight`` lists the residencies of the
        steps that run before ``res``'s and may not have scattered yet.  A
        warm client changes only when it is scattered, so only their
        residents wait for ``gather``; so do cold clients under
        ``cold_init="cluster"``, whose cluster model is read on the device.
        None in cluster mode."""
        if self.mode != "client":
            return None
        busy = {c for r in in_flight for c in r.clients[r.valid].tolist()}
        staged = np.zeros(res.k_max, dtype=bool)
        rows = [np.zeros((res.k_max,) + tuple(self.buffer[k].shape[1:]), dtype=np.float32)
                for k in self._names]
        for s, c in enumerate(res.clients.tolist()):
            if c in busy:
                continue
            leaves = self._cold_or_stored(c)
            if leaves is not None:
                staged[s] = True
                for r, x in zip(rows, leaves):
                    r[s] = x
        out = {ROWS + k: r for k, r in zip(self._names, rows)}
        out[STAGED] = staged
        return out

    def _cold_or_stored(self, c: int) -> Optional[list[np.ndarray]]:
        leaves = self._host.get(c)
        if leaves is None and self.cold_init == "initial":
            leaves = self._w0_host
        return leaves

    def gather(self, res: Residency, staged: Optional[dict] = None) -> dict:
        """Write the resident clients' states into ``self.buffer`` (and return it).

        Cluster mode: every client's state is its cluster model (Lemma 1
        broadcasts each aggregate to the whole cluster), so gather is a
        device-side take on the constant slot->cluster map.  Client mode:
        the same take (the cold clients' source under ``cold_init="cluster"``),
        then the staged rows (device tensors, from ``stage``), then any other
        stored rows, copied from the host in one transfer."""
        for k, buf in self.buffer.items():
            torch.index_select(self.cluster_models[k], 0, self._slot_cluster, out=buf)
        if self.mode == "cluster":
            return self.buffer
        done = np.zeros(res.k_max, dtype=bool)
        if staged is not None:
            mask = staged[STAGED].to(self.device)
            for k, buf in self.buffer.items():
                m = mask.view((-1,) + (1,) * (buf.dim() - 1))
                buf.copy_(torch.where(m, staged[ROWS + k].to(self.device), buf))
            done = staged[STAGED].cpu().numpy().astype(bool)
        slots, rows = [], []
        for s, c in enumerate(res.clients.tolist()):
            if not done[s]:
                leaves = self._cold_or_stored(c)
                if leaves is not None:
                    slots.append(s)
                    rows.append(leaves)
        if slots:
            idx = torch.as_tensor(slots, dtype=torch.int64, device=self.device)
            for i, k in enumerate(self._names):
                host = torch.from_numpy(np.stack([r[i] for r in rows]))
                self.buffer[k].index_copy_(0, idx, host.to(self.device, self.buffer[k].dtype))
        return self.buffer

    def scatter(self, res: Residency, buffer: dict) -> None:
        """Write a round's results back; pads are never written.

        The cluster stack always updates, from one slot per cluster (after the
        inter-cluster gossip every slot of a cluster holds the same
        post-mixing model), by a device-side take; client mode also persists
        each valid participant's row on the host."""
        for k, y in self.cluster_models.items():
            torch.index_select(buffer[k], 0, self._first_slot, out=y)
        if self.mode == "client":
            host = [host_leaf(buffer[k]) for k in self._names]
            for s in np.flatnonzero(res.valid):
                self._host.put(int(res.clients[s]), [x[int(s)] for x in host])

    # -- consensus and introspection -----------------------------------------
    def _cluster_host(self) -> list[np.ndarray]:
        return [host_leaf(self.cluster_models[k]).astype(np.float64) for k in self._names]

    def state_of(self, client: int) -> list[np.ndarray]:
        """Host leaves of one client's current state."""
        if self.mode == "client":
            leaves = self._cold_or_stored(int(client))
            if leaves is not None:
                return leaves
        d = int(self.clusters.assignments[int(client)])
        return [host_leaf(self.cluster_models[k][d]) for k in self._names]

    def _host_consensus(self, include: np.ndarray) -> list[np.ndarray]:
        """``sum_i m_i w_i`` over the included clients on the host (client
        mode): warm clients add their stored state, cold ones their
        ``cold_init`` source."""
        assign = self.clusters.assignment_array
        warm = [c for c in self._host.keys() if include[c]]
        cold_mass = np.zeros(self.clusters.num_clusters, dtype=np.float64)
        np.add.at(cold_mass, assign[include], self._m[include])
        for c in warm:
            cold_mass[assign[c]] -= self._m[c]
        if self.cold_init == "initial":
            total = float(cold_mass.sum())
            acc = [total * np.asarray(x, dtype=np.float64) for x in self._w0_host]
        else:
            acc = [np.einsum("d...,d->...", x, cold_mass) for x in self._cluster_host()]
        for c in warm:
            for i, leaf in enumerate(self._host.get(c)):
                acc[i] = acc[i] + self._m[c] * np.asarray(leaf, dtype=np.float64)
        return acc

    def global_params(self, resident: Optional[Residency] = None,
                      buffer: Optional[dict] = None) -> dict:
        """The consensus model ``sum_i m_i w_i`` over the whole fleet, f32.

        Cluster mode: ``sum_d m~_d y_d`` on the device.  Client mode: the
        warm/cold accumulation on the host.  Mid-round (``resident`` and
        ``buffer`` given: a round in flight, not scattered yet) a resident's
        state is its buffer row and everyone else keeps the stored state."""
        names = self._names
        if buffer is None:
            if self.mode == "cluster":
                return {k: torch.tensordot(self._m_tilde, y.float(), dims=([0], [0]))
                        for k, y in self.cluster_models.items()}
            acc = self._host_consensus(np.ones(self.num_clients, dtype=bool))
        else:
            include = ~resident.participant_mask(self.num_clients)
            if self.mode == "cluster":
                assign = self.clusters.assignment_array
                mass = np.zeros(self.clusters.num_clusters, dtype=np.float64)
                np.add.at(mass, assign[include], self._m[include])
                acc = [np.einsum("d...,d->...", x, mass) for x in self._cluster_host()]
            else:
                acc = self._host_consensus(include)
            buf = [host_leaf(buffer[k]).astype(np.float64) for k in names]
            for s in np.flatnonzero(resident.valid):
                c = int(resident.clients[s])
                for i, x in enumerate(buf):
                    acc[i] = acc[i] + self._m[c] * x[int(s)]
        return {k: torch.as_tensor(a, dtype=torch.float32, device=self.device)
                for k, a in zip(names, acc)}

    def device_bytes(self) -> int:
        """Persistent device footprint: the cluster stack and the slot buffer."""
        return _tree_bytes(self.cluster_models) + _tree_bytes(self.buffer)

    def host_bytes(self) -> int:
        return 0 if self._host is None else self._host.nbytes()


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

STORE_REGISTRY: dict[str, Callable[..., ClientStateStore]] = {}


def register_store(name: str):
    """Register a store factory ``(num_clients, **params) -> ClientStateStore``."""

    def deco(factory):
        STORE_REGISTRY[name] = factory
        return factory

    return deco


register_store("dense")(DenseResidentStore)
register_store("host-offload")(HostOffloadStore)


def resolve_store(spec, num_clients: int) -> ClientStateStore:
    """A ``FleetSpec.store`` spec as a store: ``None`` (dense), a registered
    kind, a ``{"kind": name, **params}`` dict, or a ready store (checked for
    the fleet's size)."""
    if spec is None:
        return DenseResidentStore(num_clients)
    if not isinstance(spec, (str, dict)) and hasattr(spec, "resident"):
        if getattr(spec, "num_clients", num_clients) != num_clients:
            raise ValueError(f"store covers {spec.num_clients} clients, fleet has {num_clients}")
        return spec
    if isinstance(spec, str):
        kind, params = spec, {}
    else:
        params = dict(spec)
        kind = params.pop("kind")
    if kind not in STORE_REGISTRY:
        raise KeyError(f"unknown state store {kind!r}; registered: {sorted(STORE_REGISTRY)}")
    return STORE_REGISTRY[kind](num_clients, **params)
