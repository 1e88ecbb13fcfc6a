"""Federation runtime: one trainer, pluggable schedulers.

The port's ``repro.core.runtime``.  ``FederationRuntime`` owns what every
regime shares — stacked-parameter init (Algorithm 1 line 1), evaluation of
the consensus model, the Section V-B wall-clock accounting, eval cadence
and ``TrainHistory`` — and delegates *how a step advances the federation*
to a scheduler.  Ported: ``SyncScheduler`` (Algorithm 1 / Lemma 1) and
``RoundScheduler`` (whole Algorithm-1 rounds per step) on the default
fleet, and ``AsyncScheduler`` (Section IV, Algorithm 2).  Every scheduler
takes the fleet axes of a ``FleetSpec``: a device profile that prices its
wall-clock, a participation plan (``repro_torch.participation``), a fault
schedule (``repro_torch.faults``) and a client-state store
(``repro_torch.state``).  With a ``host-offload`` store the sync and round
schedulers step a fixed ``(k_max, ...)`` buffer of the round's
participants, which the store gathers before the round and scatters after
it; the buffer's tensors never change, so a captured step is captured once
for every residency.

The aggregation backend is ``dense``, ``cuda`` (the kernels) or
``collective`` (the reference's hypercube all-reduce and ring gossip), by
name or ``"auto"``.  The sync and round schedulers also take the
reference's ``mesh`` (``None``, ``"auto"`` or a ``launch.mesh.ClientMesh``,
resolved by ``launch.mesh.resolve_client_mesh`` over the clients the
aggregation spans, an offload store's slots included) and its legacy
backend fields: with ``backend=None``, ``aggregation_impl``/``FLSpec.impl``
``"gossip"`` maps to ``collective`` where the scenario allows it and to
``dense`` otherwise (``_legacy_impl_backend``).

On a client mesh, one client a rank of a ``torch.distributed`` process
group, each rank's ``params`` are its client's ``(1, ...)`` row and the
collective backend exchanges rows between the ranks.  Every rank draws the
same batch stream and takes its row; participation weights and fault
matrices stay the fleet's runtime tensors, of which each rank reads its own
entries.  ``global_params`` (and so evaluation) all-reduces each rank's
``m_i w^(i)`` and ``cluster_params`` reduces within each cluster, one model
a rank, so every rank reports what one process reports; an offload
store's scatter gathers into the store's buffer, which every rank holds.  On a
mesh ``graph`` resolves as off it, by the rank's device: a CUDA rank replays
its steps from CUDA graphs with their process-group exchanges captured inside
(``core/cuda_graph.py``), and an offloaded rank copies each round's row into
the row tensors ``bind`` allocated, so one graph a key serves every round.

Per-round participation weights and faulted mixing matrices are runtime
operands of fixed shape: the sync and round schedulers stage them with
each step's batches, as the batch entries ``WEIGHTS`` (``(C,)``, a
superstep's ``(R, C)``) and ``MIXING`` (``(D, D)``, ``(R, D, D)``), so a
captured step reads them from its static input buffers and a new round
changes values, never a graph.  ``"full"`` participation and an empty
fault schedule take the static path, as in the reference.

Everything runs on an explicit ``device``.  Entry points take
``device=None``, which means ``"cuda"``, and raise when there is no GPU and
the caller did not pass ``device="cpu"``.  On a CUDA device the sync, round
and async schedulers replay their steps from CUDA graphs (``graph=None``,
see ``core/cuda_graph.py``); ``graph=False`` runs the eager loop, the
reference path::

    runtime = make_run({"scenario": "mnist-noniid-ring", "tau2": 2})
    history = runtime.run(200, batch_fn, eval_batch, eval_every=20)
"""
from __future__ import annotations

import dataclasses
import functools
import heapq
import warnings
from typing import Callable, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from .aggregation import (
    cluster_sums_on_mesh, fleet_weighted_sum, gather_rows, mesh_rows, own_rows,
)
from .backends import collective_supported, resolve_backend
from .config import FleetSpec, RunConfig
from .cuda_graph import GraphedStep, copy_into, resolve_graph
from .device import resolve_device
from .latency import LatencyModel
from .pipeline import BatchFeed, OperandStage
from .protocol import ClusterSpec, SDFEELConfig
from .staleness import staleness_mixing_matrix
from .topology import TOPOLOGIES, Topology

__all__ = [
    "TrainHistory",
    "StepEvent",
    "Scheduler",
    "SyncScheduler",
    "RoundScheduler",
    "AsyncScheduler",
    "FederationRuntime",
    "SCHEDULER_REGISTRY",
    "register_scheduler",
    "make_run",
    "stacked_init",
    "FleetAxes",
    "WEIGHTS",
    "MIXING",
    "CLUSTER",
    "INV_THETA",
    "THETA",
    "M_HAT",
    "STEP_MASK",
]

# the batch entries that carry a step's fleet operands to the device: the
# round's (C,) client weights and its (D, D) mixing matrix (a superstep's
# (R, C) and (R, D, D) stacks)
WEIGHTS = "fleet.weights"
MIXING = "fleet.mixing"
_OPERANDS = (WEIGHTS, MIXING)
# the async event's operands, staged with its client batches: the fired
# cluster's index ((1,) int64), its members' eq. 19 factors 1 / theta_i and
# theta_i, the event's eq. 20 weights m^ (each (g,)), the (theta_max, g) step
# mask and the eq. 21-22 mixing matrix P_t (MIXING, (D, D)), all f32
CLUSTER = "async.cluster"
INV_THETA = "async.inv_theta"
THETA = "async.theta"
M_HAT = "async.m_hat"
STEP_MASK = "async.step_mask"
_EVENT_OPERANDS = (CLUSTER, INV_THETA, THETA, M_HAT, STEP_MASK, MIXING)

_UNSET = object()


def _fleet_from_legacy(fleet: Optional[FleetSpec], owner: str, **legacy) -> FleetSpec:
    """Fold the deprecated ``profile=``/``participation=`` keywords into a
    ``FleetSpec``, with a ``DeprecationWarning``, as the reference does; the
    factories pass ``fleet=`` and never take this path."""
    used = {k: v for k, v in legacy.items() if v is not _UNSET}
    if used:
        warnings.warn(f"{owner}({'/'.join(sorted(used))}=...) keywords are deprecated; "
                      f"pass fleet=FleetSpec(...) instead", DeprecationWarning, stacklevel=3)
        fleet = dataclasses.replace(fleet or FleetSpec(), **used)
    return fleet if fleet is not None else FleetSpec()


class FleetAxes:
    """A run's participation plan, fault schedule and device pricing,
    resolved once at ``bind``: who aggregates in each round, what they
    weigh, how the edge servers mix and what the round's wall-clock pays.
    Every scheduler reads its fleet axes through one of these.

    ``sampling`` is False for ``"full"`` participation (the static-weight
    path, as in the reference), an empty fault schedule resolves to
    ``faults=None`` (the fault-free path), and ``active`` says whether the
    rounds carry runtime weights at all.
    """

    def __init__(self, fleet: FleetSpec, clusters: ClusterSpec, topology: Topology,
                 profile=None, latency: Optional[LatencyModel] = None, seed: int = 0):
        from ..faults import resolve_faults
        from ..participation import resolve_plan

        self.clusters = clusters
        self.plan = resolve_plan(fleet.participation, clusters, profile=profile, seed=seed)
        self.faults = resolve_faults(fleet.faults, topology, clusters)
        self.sampling = self.plan is not None and not self.plan.is_full
        self.active = self.sampling or self.faults is not None
        self.timing = None
        if profile is not None:
            from ..hetero import FleetTiming

            self.timing = FleetTiming(profile, latency)
        # a trace-scheduled fleet is priced by each round's own speeds
        self.traced = profile is not None and profile.schedule is not None

    def mask(self, r: int, fault_round: Optional[int] = None) -> np.ndarray:
        """Round ``r``'s aggregating clients: the plan's mask (everyone
        without sampling), under faults ANDed with the clients the schedule
        lets aggregate in ``fault_round`` (default ``r``)."""
        m = self.plan.mask(r) if self.sampling else np.ones(self.clusters.num_clients, dtype=bool)
        if self.faults is not None:
            m = m & self.faults.client_mask(r if fault_round is None else fault_round)
        return m

    def weights(self, r: int) -> np.ndarray:
        """Round ``r``'s renormalized ``(C,)`` intra-cluster weights: a crashed or
        sampled-out client weighs exactly 0, and a cluster left with nobody falls
        back to its full ``m^`` column, so the transition stays column-stochastic."""
        if self.faults is None:
            return self.plan.weights(r)
        from ..participation import renormalize_weights

        return renormalize_weights(self.clusters.m_hat(), self.clusters.assignments,
                                   self.mask(r))

    def operands(self, r: int) -> dict:
        """Round ``r``'s batch entries, f32: the ``(C,)`` weights and, under
        faults, the ``(D, D)`` mixing matrix over the surviving edges."""
        ops = {WEIGHTS: self.weights(r).astype(np.float32)}
        if self.faults is not None:
            ops[MIXING] = self.faults.mixing_at(r).astype(np.float32)
        return ops

    def uplink_penalty(self, r: int, members=None) -> float:
        """Capped-backoff retries of round ``r``'s failed uplinks (only
        ``members``' when given); 0 without faults or a profile."""
        if self.faults is None or self.timing is None:
            return 0.0
        failed = self.faults.uplink_failed(r)
        if members is not None:
            only = np.zeros_like(failed)
            only[members] = failed[members]
            failed = only
        return self.timing.uplink_retry_penalty(failed)

    def round_pricing(self, r: int) -> tuple[Optional[np.ndarray], float, Optional[int]]:
        """``(pacing mask, uplink penalty, trace round)`` of round ``r``: the
        surviving mask under faults, else the plan's effective mask (None:
        the full fleet), and ``r`` when the fleet is trace-scheduled."""
        if self.faults is not None:
            mask = self.mask(r)
        else:
            mask = self.plan.effective_mask(r) if self.sampling else None
        return mask, self.uplink_penalty(r), (r if self.traced else None)


def _participant_batches(batch_source, k: int, res) -> dict:
    """Iteration ``k``'s host batches for the resident slots only.

    A source with ``supports_clients`` (``data.ProceduralFederated``) draws
    just the requested rows, O(``k_max``) a step, the batching that scales to
    a million clients; any other source draws the full ``(N, ...)`` stack,
    which is sliced."""
    if getattr(batch_source, "supports_clients", False):
        return batch_source(k, clients=res.clients)
    return {key: np.asarray(x)[res.clients] for key, x in batch_source(k).items()}


def _split_store_rows(batch: dict) -> tuple[dict, Optional[dict]]:
    """``(batch, staged rows or None)``: a client-mode store's rows
    (``state.ROWS``/``state.STAGED`` entries) taken out of a staged batch."""
    from ..state import ROWS, STAGED

    if STAGED not in batch:
        return batch, None
    rows = {k: v for k, v in batch.items() if k == STAGED or k.startswith(ROWS)}
    return {k: v for k, v in batch.items() if k not in rows}, rows


class _ResidencyCache:
    """A scheduler's residencies by round (or superstep), each a pure function
    of its index, kept for the few indices the feed stages ahead."""

    def __init__(self, draw: Callable, keep: int = 8):
        self._draw = draw
        self._keep = keep
        self._by_index: dict = {}

    def __call__(self, i: int):
        res = self._by_index.get(i)
        if res is None:
            res = self._by_index[i] = self._draw(i)
            while len(self._by_index) > self._keep:
                del self._by_index[min(self._by_index)]
        return res


_OFFLOAD_FAULTS = ("fault injection requires a resident client-state store; "
                   "host-offload runs cannot thread per-round fault operands")
_OFFLOAD_CLUSTERS = ("cluster_params requires a resident client-state store; "
                     "serve host-offload runs from checkpoints instead")


def _split_operands(batch: dict) -> tuple[dict, list]:
    """``(model batch, [weights[, mixing]])`` of a staged step batch."""
    ops = [batch[k] for k in _OPERANDS if k in batch]
    if not ops:
        return batch, ops
    return {k: v for k, v in batch.items() if k not in _OPERANDS}, ops


# ---------------------------------------------------------------------------
# Shared state containers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainHistory:
    iterations: list
    wallclock: list
    loss: list
    accuracy: list

    def as_dict(self):
        return dataclasses.asdict(self)


@dataclasses.dataclass
class StepEvent:
    """What one scheduler step did to the federation.

    ``kind`` is the aggregation event ("local"/"intra"/"inter", "round" for
    a round step, "cluster" for an async cluster event, "skipped" for one
    none of whose clients participated, "outage" for one whose edge server
    is down), ``iteration`` the
    protocol-iteration count after the step, ``dt`` the Section V-B
    wall-clock the step consumed, ``cluster`` the cluster an async event
    fired.  ``losses`` (round steps: "round") is the ``(R * tau1 * tau2,)``
    per-iteration mean loss, left on the device so a step never waits for
    it; read it with ``float``/``.tolist()`` at logging boundaries.
    """

    kind: str
    iteration: int
    dt: float = 0.0
    cluster: Optional[int] = None
    losses: Optional[torch.Tensor] = None


def stacked_init(model, num_copies: int, seed, device) -> dict:
    """Identical initial model replicated on a leading axis (Alg. 1 line 1).

    Drawn from a CPU ``torch.Generator`` seeded with ``seed`` (not JAX's
    stream: tests that compare packages carry JAX's weights across with
    ``repro_torch.convert``), then copied to ``device``.
    """
    gen = torch.Generator().manual_seed(int(seed))
    w0 = model.init(gen)
    return {
        k: v.to(device)[None].expand((num_copies,) + tuple(v.shape)).contiguous()
        for k, v in w0.items()
    }


def _event_time(latency: Optional[LatencyModel], alpha: int, event: str, profile=None,
                participants=None, clusters=None, t=None) -> float:
    """Per-iteration wall-clock of Section V-B for one sync protocol event.

    With a ``DeviceProfile`` the event is paced by the slowest effective
    client and the narrowest uplink (``FleetTiming.sync_event_time``):
    ``participants`` (a round's mask) restricts pacing to the round's
    clients, ``clusters`` prices each cluster's own critical path, and ``t``
    (the round) prices a trace-scheduled fleet by that round's speeds.
    """
    if profile is not None:
        from ..hetero import FleetTiming

        return FleetTiming(profile, latency).sync_event_time(
            event, alpha, participants=participants, clusters=clusters, t=t
        )
    if latency is None:
        return 0.0
    t = latency.t_comp()
    if event in ("intra", "inter"):
        t += latency.t_comm_client_server()
    if event == "inter":
        t += alpha * latency.t_comm_server_server()
    return t


@runtime_checkable
class Scheduler(Protocol):
    """Pluggable federation schedule: ``bind`` once, then ``step``."""

    name: str

    def bind(self, model, seed: int, device: torch.device) -> None: ...

    def step(self, k: int, batch_source) -> StepEvent: ...

    def global_params(self) -> dict: ...


# ---------------------------------------------------------------------------
# Synchronous per-iteration scheduler (Algorithm 1)
# ---------------------------------------------------------------------------

def _legacy_impl_backend(impl: str, clusters: ClusterSpec, p: np.ndarray) -> str:
    """The backend the reference's legacy ``aggregation_impl``/``FLSpec.impl``
    field names, as the port calls it.

    ``"gossip"`` maps to the collective backend only where the scenario
    satisfies its constraints and degrades to dense otherwise, as in the
    reference; ``"pallas"`` (the reference's TPU kernels) is ``cuda``."""
    if impl == "gossip":
        return "collective" if collective_supported(clusters, p) else "dense"
    return {"dense": "dense", "pallas": "cuda"}[impl]


def _resolve_mesh(sched, num_clients: int) -> None:
    """``sched.mesh`` over the ``num_clients`` clients the aggregation spans
    (a store's slots under offload), and on a mesh the rank's device."""
    from ..launch.mesh import resolve_client_mesh

    sched.mesh = resolve_client_mesh(sched._mesh_spec, num_clients, device=sched.device)
    if sched.mesh is not None:
        sched.device = sched.mesh.device


def _load_rows(sched, stack: dict) -> None:
    """An offload store's gathered ``(k_max, ...)`` stack as ``sched.params``:
    off a mesh the stack itself (the store's fixed buffer), on a mesh the
    rank's row copied into the ``params`` tensors, which on graphs keep the
    addresses ``bind`` gave them, so a graph keyed by them serves every
    round."""
    if sched.mesh is None:
        sched.params = stack
    else:
        copy_into(sched.params, mesh_rows(stack, sched.mesh))


def _stacked(sched, tree: dict) -> dict:
    """An offload store's ``(k_max, ...)`` buffer stack: the tree, or on a
    mesh the ranks' rows all-gathered into the store's buffer, which every
    rank holds."""
    return tree if sched.mesh is None else gather_rows(tree, sched.mesh, out=sched.store.buffer)


def _consensus(sched) -> dict:
    """``sum_i m_i w^(i)`` in f32: one tensordot over the stack, or on a mesh
    the all-reduce of each rank's ``m_i w^(i)``."""
    if sched.mesh is not None:
        return fleet_weighted_sum(sched.params, sched.mesh, sched._m)
    return {k: torch.tensordot(sched._m, w.float(), dims=([0], [0]))
            for k, w in sched.params.items()}


def _cluster_models(sched, clusters: ClusterSpec) -> dict:
    """The ``(D, ...)`` models ``y^(d) = sum_{i in d} m^_i w^(i)`` in f32: one
    tensordot over the stack, or on a mesh the hypercube all-reduce within
    each cluster and a broadcast from each."""
    if sched.mesh is not None:
        m_hat = torch.as_tensor(clusters.m_hat(), dtype=torch.float32, device=sched.device)
        return cluster_sums_on_mesh(sched.params, sched.mesh, sched.backend.cluster_size,
                                    m_hat)
    v = torch.as_tensor(clusters.V(), dtype=torch.float32, device=sched.device)
    return {k: torch.tensordot(v, w.float(), dims=([0], [0])) for k, w in sched.params.items()}


def _bind_backend(sched, spec, clusters: ClusterSpec, p: np.ndarray, alpha: int) -> None:
    """``sched.backend`` of a sync or round scheduler, and on the collective
    backend the fault trace's ring-stencil check over its whole horizon (the
    device cannot check the values it is given)."""
    sched.backend = resolve_backend(spec, clusters, p, alpha, device=sched.device,
                                    mesh=sched.mesh)
    faults = sched.axes.faults
    if faults is not None and sched.backend.name == "collective":
        faults.mixing_stack(0, faults.horizon() + 1, require_ring_stencil=True)


class SyncScheduler:
    """Algorithm 1 over stacked client models.

    ``batch_source`` contract: callable ``k -> stacked batch`` with entries
    of shape ``(C, per_client_batch, ...)``.  ``backend`` is an
    ``AggregationBackend`` name/instance or ``"auto"`` (``cuda`` on a CUDA
    device with uniform contiguous clusters, ``dense`` otherwise).

    Each protocol iteration is one vmapped local SGD step followed by the
    scheduled transition.  With the ``cuda`` backend both stages overwrite
    ``self.params`` in place — the ``sgd_update`` kernel is elementwise and
    each column of the transition belongs to one kernel thread.  ``graph``
    (``None``: on for a CUDA device, off on the CPU; ``True`` on the CPU
    raises) replays each iteration from a CUDA graph, one ``GraphedStep``
    per event kind as the reference jits one step per kind; the ``dense``
    backend's new tensors are then copied into ``self.params``, which keeps
    its tensors across steps.  ``graph=False`` is the eager loop.  Batches
    are staged through a :class:`~repro_torch.core.pipeline.BatchFeed`.

    ``fleet`` (a ``FleetSpec``) carries the device profile, the
    participation plan and the fault schedule.  A plan samples who
    aggregates each round (``tau1 * tau2`` iterations); faults AND the
    round's surviving clients into its mask and give the round a mixing
    matrix.  The round's renormalized ``(C,)`` weights (and under faults its
    ``(D, D)`` matrix) are drawn for iteration ``i`` from ``i``'s round
    alone, so the batch feed can stage them ahead with the batches
    (``WEIGHTS``, ``MIXING``), and every transition of the round takes
    them.  With a profile the round's wall-clock is paced by the clients it
    aggregates, along each cluster's critical path, and under faults the
    inter event pays the round's uplink retries.  ``"full"`` participation
    runs the static-weight step.

    With a ``host-offload`` store (``fleet.store``) ``self.params`` is the
    store's fixed ``(k_max, ...)`` buffer (on a mesh, row tensors bound once,
    into which each round's row is copied): the round's residents are gathered
    into it at the round's first iteration, stepped by the same steps (and
    graphs), bound over the store's sub-fleet, and scattered back at the
    round's inter event.  Each iteration draws its batches for the resident
    slots only, and a sampled round's weights are those of the slots
    (``state.sub_weights``: a padding slot weighs exactly 0).  Faults need
    resident state and raise ``ValueError``, as in the reference.

    ``backend=None`` is ``"auto"`` unless ``cfg.aggregation_impl`` names
    ``"gossip"`` or ``"pallas"``, which map as in the reference
    (``_legacy_impl_backend``).  On the collective backend a fault trace is
    checked on the host over its whole horizon at ``bind``: every round's
    mixing matrix must stay on the ring stencil.
    """

    name = "sync"

    def __init__(self, cfg: SDFEELConfig, latency: Optional[LatencyModel] = None,
                 backend=None, prefetch: bool = True, graph: Optional[bool] = None,
                 fleet: Optional[FleetSpec] = None, mesh=None, *, profile=_UNSET,
                 participation=_UNSET):
        self.cfg = cfg
        self.latency = latency
        self.prefetch = prefetch
        self.params: Optional[dict] = None
        self._backend_spec = backend
        self._graph_spec = graph
        self._mesh_spec = mesh
        self.fleet = _fleet_from_legacy(fleet, "SyncScheduler", profile=profile,
                                        participation=participation)
        self.profile = self.fleet.resolve_profile(cfg.clusters.num_clients)
        self.axes: Optional[FleetAxes] = None
        self._round_cache = None    # (round, pacing mask, uplink penalty, trace round, {event: dt})
        self._operand_cache = None  # (round, {entry: f32 array}), the feed's side
        # §V-B per-event wall-clock of the full fleet, priced once
        self._event_times = {
            e: _event_time(latency, cfg.alpha, e, self.profile, clusters=cfg.clusters)
            for e in ("local", "intra", "inter")
        }

    def bind(self, model, seed: int, device: torch.device) -> None:
        from .. import optim
        from .local_update import build_local_update

        cfg = self.cfg
        self.model = model
        self.device = device
        self.axes = FleetAxes(self.fleet, cfg.clusters, cfg.topology, self.profile,
                              self.latency, seed)
        self.store = self.fleet.resolve_store(cfg.clusters.num_clients)
        if self.store.resident:
            _resolve_mesh(self, cfg.clusters.num_clients)
            # on a mesh the rank's client only: every copy is the same init
            self.params = stacked_init(
                model, 1 if self.mesh else cfg.clusters.num_clients, seed, self.device)
            self.store.attach(self)
            agg_clusters = cfg.clusters
        else:
            if self.axes.faults is not None:
                raise ValueError(_OFFLOAD_FAULTS)
            # the aggregation runs over the store's sub-fleet (same clusters,
            # slot-sized), on its fixed buffer (on a mesh, row tensors of the
            # rank's slot, allocated here once; each round is copied into them)
            self.store.bind(cfg.clusters, model, seed, self.device)
            _resolve_mesh(self, self.store.sub_clusters.num_clients)
            self.params = own_rows(self.store.buffer, self.mesh)
            self._res = None        # residency of the round the buffer holds, or None
            self._buf_round = None
            # round r's residency, a pure function of r (the feed stages ahead)
            self._residency_for_round = _ResidencyCache(lambda r: self.store.residency(
                self.axes.plan.mask(r) if self.axes.sampling else None))
            agg_clusters = self.store.sub_clusters
        spec = self._backend_spec
        if spec is None and cfg.aggregation_impl != "dense":
            spec = _legacy_impl_backend(cfg.aggregation_impl, agg_clusters, cfg.P())
        _bind_backend(self, spec, agg_clusters, cfg.P(), cfg.alpha)
        self._local = build_local_update(
            model, optim.sgd(cfg.learning_rate), backend=self.backend
        )
        # the consensus weights, (N,) on the device: resident state only (an
        # offloaded run's consensus is the store's, and keeps N off the device)
        self._m = (torch.as_tensor(cfg.clusters.m(), dtype=torch.float32, device=self.device)
                   if self.store.resident else None)
        self._feed = BatchFeed(self.device, self.prefetch)
        graph = resolve_graph(self._graph_spec, self.device)
        self._graphs = self._build_graphs() if graph else None

    def _build_graphs(self) -> dict:
        """One ``GraphedStep`` per event kind over ``_body``, in one memory pool."""
        pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None
        return {e: GraphedStep(functools.partial(self._body, e), lambda: self.params,
                               self.device, pool) for e in ("local", "intra", "inter")}

    def _update(self, event: str, batch: dict) -> dict:
        """One protocol iteration: the local SGD step, then the transition
        with the round's weights and mixing matrix where the batch has them."""
        batch, ops = _split_operands(batch)
        if self.mesh is not None:
            batch = mesh_rows(batch, self.mesh)
        params, _, _ = self._local(self.params, (), batch)
        if event != "local":
            params = self.backend.transition(params, event, *ops)
        return params

    def _body(self, event: str, batch: dict) -> None:
        """The captured step: ``_update`` written into ``self.params``."""
        copy_into(self.params, self._update(event, batch))

    # -- fleet operands --------------------------------------------------------
    def _round_of(self, k: int) -> int:
        return (k - 1) // (self.cfg.tau1 * self.cfg.tau2)

    def _operands(self, r: int) -> dict:
        """Round ``r``'s staged batch entries, f32: the renormalized ``(C,)``
        weights and, under faults, the ``(D, D)`` mixing matrix.  A pure
        function of ``r``, cached for the round: the feed stages iterations
        ahead of the one that runs."""
        if self._operand_cache is None or self._operand_cache[0] != r:
            if self.store.resident:
                ops = self.axes.operands(r)
            else:
                from ..state import sub_weights

                w = sub_weights(self.axes.plan.weights(r), self._residency_for_round(r))
                ops = {WEIGHTS: w.astype(np.float32)}
            self._operand_cache = (r, ops)
        return self._operand_cache[1]

    def _event_dt(self, k: int, event: str) -> float:
        """Iteration ``k``'s §V-B wall-clock.  With a profile the round is
        paced by the clients it aggregates (the plan's effective mask, or
        under faults the surviving mask, and its inter event pays the
        round's uplink retries), a trace-scheduled fleet by the round's
        speeds; each event kind is priced once per round."""
        if self.profile is None:
            return self._event_times[event]
        r = self._round_of(k)
        if self._round_cache is None or self._round_cache[0] != r:
            mask, penalty, t = self.axes.round_pricing(r)
            if not self.store.resident and self.axes.sampling:
                # an offloaded round is paced by its residents, as the reference
                mask = self._residency_for_round(r).participant_mask(self.cfg.clusters.num_clients)
            self._round_cache = (r, mask, penalty, t, {})
        _, mask, penalty, t, times = self._round_cache
        if mask is None and t is None:
            return self._event_times[event]
        if event not in times:
            times[event] = _event_time(
                self.latency, self.cfg.alpha, event, self.profile, participants=mask,
                clusters=self.cfg.clusters, t=t)
        return times[event] + penalty if event == "inter" else times[event]

    # -- one protocol iteration --------------------------------------------------
    def _apply(self, k: int, batch: dict) -> tuple[str, float]:
        event = self.cfg.event_at(k)
        offload = not self.store.resident
        if offload and self._buf_round != self._round_of(k):
            # the round's first iteration: its residents into the buffer
            self._buf_round = self._round_of(k)
            self._res = self._residency_for_round(self._buf_round)
            _load_rows(self, self.store.gather(self._res))
        if self._graphs is None:
            self.params = self._update(event, batch)
        else:
            self._graphs[event](batch)
        if offload and event == "inter":
            # the round's boundary: every resident holds its cluster's
            # post-gossip aggregate, which the store keeps
            self.store.scatter(self._res, _stacked(self, self.params))
            self._buf_round = None
        return event, self._event_dt(k, event)

    def _producer(self, batch_source) -> Optional[Callable[[int], dict]]:
        """Iteration ``i``'s host batch (the resident slots' rows under
        offload) with its round's operands, or None (the batch source alone)
        on the static path."""
        if not self.store.resident:
            return lambda i: {
                **_participant_batches(batch_source, i, self._residency_for_round(self._round_of(i))),
                **(self._operands(self._round_of(i)) if self.axes.active else {})}
        if not self.axes.active:
            return None
        return lambda i: {**batch_source(i), **self._operands(self._round_of(i))}

    def step(self, k: int, batch_source) -> StepEvent:
        batch = self._feed.get(k, batch_source, self._producer(batch_source))
        event, dt = self._apply(k, batch)
        return StepEvent(kind=event, iteration=k, dt=dt)

    def advance(self, k: int, stacked_batch: dict) -> str:
        """Iteration ``k`` on a given full-fleet host batch (no prefetch):
        under offload its resident slots' rows; returns the event."""
        from .pipeline import device_batch

        producer = self._producer(lambda i: stacked_batch) or (lambda i: stacked_batch)
        return self._apply(k, device_batch(producer(k), self.device))[0]

    def iteration_time(self, event: str) -> float:
        """Full-fleet §V-B pacing (participation-masked rounds may be cheaper)."""
        return self._event_times[event]

    def global_params(self) -> dict:
        """Consensus-phase output: sum_d m~_d y_K^(d) == sum_i m_i w_K^(i).
        Under offload the store's, mid-round with the buffer's residents."""
        if not self.store.resident:
            if self._buf_round is None:
                return self.store.global_params()
            return self.store.global_params(resident=self._res,
                                            buffer=_stacked(self, self.params))
        return {k: v.to(self.params[k].dtype) for k, v in _consensus(self).items()}

    def cluster_params(self) -> dict:
        """Stacked ``(D, ...)`` per-cluster models y^(d) = sum_{i in d} m^_i w^(i)."""
        if not self.store.resident:
            raise NotImplementedError(_OFFLOAD_CLUSTERS)
        return {k: v.to(self.params[k].dtype)
                for k, v in _cluster_models(self, self.cfg.clusters).items()}

# ---------------------------------------------------------------------------
# Whole-round scheduler (the reference's compiled round engine)
# ---------------------------------------------------------------------------

class RoundScheduler:
    """One step == ``rounds_per_step`` full Algorithm-1 rounds of tau1*tau2 iterations.

    ``batch_source`` contract: callable ``k -> stacked batch`` indexed by the
    protocol iteration; step ``r`` consumes iterations ``(r-1)*R*tau1*tau2 +
    1 .. r*R*tau1*tau2`` for ``R = rounds_per_step``, stacked by
    ``pipeline.stack_window`` and staged by a ``BatchPipeline`` one step
    ahead.  Each step runs ``round_engine.build_fl_round_step``: on the
    ``cuda`` backend the stacked parameters are updated in place by the
    ``sgd_update`` and ``fused_transition`` kernels.  ``graph`` (``None``: on
    for a CUDA device, off on the CPU; ``True`` on the CPU raises) replays
    the whole (super)step from one CUDA graph, the counterpart of the
    reference's jitted ``lax.scan``; the ``dense`` backend's new tensors are
    then copied into ``self.params``.  ``graph=False`` is the eager loop.
    ``StepEvent.losses`` stays on the device.

    ``fleet`` carries the device profile, participation plan and fault
    schedule, as for ``SyncScheduler``.  Sampling or faults run the round
    engine's operand variant: the superstep's ``(R, C)`` weights and, under
    faults, its ``(R, D, D)`` mixing stack are staged with its batches
    (``WEIGHTS``, ``MIXING``), one row per round.  With a profile each round
    is paced by the clients it aggregates, and under faults it pays its
    uplink retries.

    ``backend=None`` takes the one ``FLSpec.impl`` names (``dense`` by
    default, as the reference's round engine; ``"gossip"`` the collective
    backend where the scenario allows it, ``_legacy_impl_backend``);
    scenarios pass ``"auto"``.  On the collective backend a fault trace is
    checked on the host over its whole horizon at ``bind``.

    With a ``host-offload`` store the round engine is built over the store's
    ``k_max`` slots, always in its participation variant (a padding slot
    weighs exactly 0), and ``self.params`` is the store's fixed buffer (on a
    mesh, row tensors bound once, into which each superstep's row is
    copied).  One
    participation draw a superstep picks the residents
    (``_residency_for_step``); their batches, their slots' weights tiled
    over the R rounds (``WEIGHTS``) and, in client mode, the host rows no
    step in flight can change (``store.stage``) are staged together ahead
    of the step.  A step gathers, resets the optimizer state, runs the
    superstep (replayed from one graph for every residency) and scatters, so
    device memory is bounded by ``k_max`` whatever the fleet's size.

    ``optimizer`` (default ``optim.sgd(fl.learning_rate)``) may keep state:
    ``self.opt_state`` is ``optimizer.init(self.params)``, allocated once at
    ``bind`` (on a mesh the rank's ``(1, ...)`` row), each client's rows
    of it stepped by that client's updates (``local_update.per_client_update``)
    and, on a graph, captured and written back into at fixed addresses.
    Under offload it restarts every superstep, as in the reference.  Adam's
    scalar step over the stack raises at the first step, as the reference's
    ``vmap`` does.  The deprecated ``profile=``/``participation=`` keywords
    (also on the sync and async schedulers) warn and fold into ``fleet``.
    """

    name = "round"

    def __init__(self, fl, optimizer=None, latency: Optional[LatencyModel] = None,
                 backend=None, rounds_per_step: int = 1, prefetch: bool = True,
                 graph: Optional[bool] = None, fleet: Optional[FleetSpec] = None, mesh=None,
                 *, profile=_UNSET, participation=_UNSET):
        if rounds_per_step < 1:
            raise ValueError(f"rounds_per_step must be >= 1, got {rounds_per_step}")
        self.fl = fl
        self.optimizer = optimizer
        self.latency = latency
        self.rounds_per_step = rounds_per_step
        self.prefetch = prefetch
        self.params: Optional[dict] = None
        self.opt_state = None
        self._backend_spec = backend
        self._graph_spec = graph
        self._mesh_spec = mesh
        self.fleet = _fleet_from_legacy(fleet, "RoundScheduler", profile=profile,
                                        participation=participation)
        self.profile = self.fleet.resolve_profile(fl.num_clients)
        self.axes: Optional[FleetAxes] = None
        self._proto = fl.protocol()
        # §V-B wall-clock of one full round of the full fleet, priced once
        self._round_time = sum(
            _event_time(latency, fl.alpha, self._proto.event_at(i), self.profile,
                        clusters=self._proto.clusters)
            for i in range(1, self.iterations_per_round + 1)
        )

    @property
    def iterations_per_round(self) -> int:
        return self.fl.tau1 * self.fl.tau2

    @property
    def iterations_per_step(self) -> int:
        """Protocol iterations consumed by one (super)step."""
        return self.iterations_per_round * self.rounds_per_step

    def rounds_for(self, iterations: int) -> int:
        """Whole compiled rounds covering ``iterations`` protocol iterations."""
        return max(1, -(-iterations // self.iterations_per_round))

    def steps_for(self, iterations: int) -> int:
        """Scheduler steps (superstep dispatches) covering ``iterations``."""
        return -(-self.rounds_for(iterations) // self.rounds_per_step)

    def round_time(self) -> float:
        """Section V-B wall-clock of one full round (priced once at init)."""
        return self._round_time

    def bind(self, model, seed: int, device: torch.device) -> None:
        from .. import optim
        from .round_engine import build_fl_round_step

        fl = self.fl
        self.model = model
        self.device = device
        opt = self.optimizer or optim.sgd(fl.learning_rate)
        self.optimizer = opt
        clusters = self._proto.clusters
        self.axes = FleetAxes(self.fleet, clusters, self._proto.topology, self.profile,
                              self.latency, seed)
        self.store = self.fleet.resolve_store(fl.num_clients)
        if self.store.resident:
            _resolve_mesh(self, fl.num_clients)
            self.params = stacked_init(model, 1 if self.mesh else fl.num_clients, seed,
                                       self.device)
            self.store.attach(self)
            engine_fl, agg_clusters = fl, clusters
        else:
            if self.axes.faults is not None:
                raise ValueError(_OFFLOAD_FAULTS)
            self.store.bind(clusters, model, seed, self.device)
            _resolve_mesh(self, self.store.sub_clusters.num_clients)
            # the buffer, or on a mesh the rank's row tensors, allocated once
            self.params = own_rows(self.store.buffer, self.mesh)
            engine_fl = dataclasses.replace(fl, num_clients=self.store.k_max)
            agg_clusters = self.store.sub_clusters
            self._full_w = clusters.m_hat()
            # superstep k's residency, a pure function of k (staged ahead)
            self._residency_for_step = _ResidencyCache(self._draw_residency)
        self.opt_state = opt.init(self.params)
        spec = self._backend_spec
        if spec is None:
            spec = _legacy_impl_backend(fl.impl, agg_clusters, self._proto.P())
        _bind_backend(self, spec, agg_clusters, self._proto.P(), fl.alpha)
        self._round_step = build_fl_round_step(
            model, opt, engine_fl, backend=self.backend, rounds_per_step=self.rounds_per_step,
            participation=self.axes.active or not self.store.resident,
            mixing=self.axes.faults is not None,
        )
        self._m = (torch.as_tensor(clusters.m(), dtype=torch.float32, device=self.device)
                   if self.store.resident else None)  # as SyncScheduler's
        self._feed = BatchFeed(self.device, self.prefetch)
        graph = resolve_graph(self._graph_spec, self.device)
        self._graph = self._build_graph() if graph else None

    def _build_graph(self) -> GraphedStep:
        return GraphedStep(self._body, lambda: (self.params, self.opt_state), self.device)

    def _round_step_on(self, batches: dict):
        """The round step on a staged batch, its fleet operands passed on."""
        batches, ops = _split_operands(batches)
        return self._round_step(self.params, self.opt_state, batches, *ops)

    def _body(self, batches: dict) -> torch.Tensor:
        """The captured step: one round step written into the state."""
        params, opt_state, losses = self._round_step_on(batches)
        copy_into((self.params, self.opt_state), (params, opt_state))
        return losses

    # -- fleet operands ----------------------------------------------------------
    def _operands(self, k: int) -> dict:
        """Superstep ``k``'s staged batch entries, f32, one row per round: the
        ``(R, C)`` weights and, under faults, the ``(R, D, D)`` mixing stack
        (a pure function of ``k``: the feed stages the next superstep ahead)."""
        if not self.axes.active:
            return {}
        r0 = (k - 1) * self.rounds_per_step
        rounds = [self.axes.operands(r) for r in range(r0, r0 + self.rounds_per_step)]
        return {key: np.stack([ops[key] for ops in rounds]) for key in rounds[0]}

    # -- wall-clock --------------------------------------------------------------
    def _mask_round_time(self, mask, t: Optional[int] = None) -> float:
        """One round's schedule priced by ``mask``'s members (None: the full
        fleet) — three ``FleetTiming`` reductions, not ``tau1 * tau2``.  ``t``
        prices a trace-scheduled fleet by round ``t``'s speeds."""
        times = {
            e: _event_time(self.latency, self.fl.alpha, e, self.profile,
                           participants=mask, clusters=self._proto.clusters, t=t)
            for e in ("local", "intra", "inter")
        }
        return sum(times[self._proto.event_at(i)]
                   for i in range(1, self.iterations_per_round + 1))

    def _step_dt(self, k: int) -> float:
        """§V-B wall-clock of superstep ``k``.  With a profile each round is
        paced by the clients it aggregates (the plan's effective mask, or
        under faults the surviving mask plus the round's uplink retries), a
        trace-scheduled fleet by the round's speeds."""
        rps = self.rounds_per_step
        if self.profile is None or not (self.axes.active or self.axes.traced):
            return rps * self._round_time
        r0 = (k - 1) * rps
        dt = 0.0
        for r in range(r0, r0 + rps):
            mask, penalty, t = self.axes.round_pricing(r)
            dt += penalty
            dt += self._mask_round_time(mask, t)
        return dt

    def _run(self, stacked: dict) -> torch.Tensor:
        """The round step on a staged batch, replayed or eager; the losses."""
        if self._graph is None:
            self.params, self.opt_state, losses = self._round_step_on(stacked)
            return losses
        return self._graph(stacked)

    def step(self, k: int, batch_source) -> StepEvent:
        from .pipeline import stack_window

        if not self.store.resident:
            return self._offload_step(k, batch_source)
        ips = self.iterations_per_step
        stacked = self._feed.get(
            k, batch_source,
            lambda step: {**stack_window(batch_source, (step - 1) * ips + 1, ips),
                          **self._operands(step)})
        return StepEvent(kind="round", iteration=k * self.iterations_per_step,
                         dt=self._step_dt(k), losses=self._run(stacked))

    # -- host-offload stores -------------------------------------------------------
    def _draw_residency(self, k: int):
        """Superstep ``k``'s slots: one participation draw a superstep (round
        ``(k-1)*R``'s mask covers all R rounds), a pure function of ``k``."""
        if not self.axes.sampling:
            return self.store.residency()
        return self.store.residency(self.axes.plan.mask((k - 1) * self.rounds_per_step))

    def _offload_batch(self, batch_source, step: int) -> dict:
        """Superstep ``step``'s host entries: the residents' batches, their
        slots' weights tiled over the R rounds and, in client mode, the host
        rows that no superstep still in flight can change."""
        from ..state import sub_weights
        from .pipeline import stack_window

        ips, rps = self.iterations_per_step, self.rounds_per_step
        res = self._residency_for_step(step)
        window = stack_window(lambda i: _participant_batches(batch_source, i, res),
                              (step - 1) * ips + 1, ips)
        w_full = self.axes.plan.weights((step - 1) * rps) if self.axes.sampling else self._full_w
        window[WEIGHTS] = np.tile(sub_weights(w_full, res), (rps, 1)).astype(np.float32)
        # the feed stages up to two supersteps ahead of the one that runs, so
        # the two before ``step`` may not have scattered yet
        in_flight = [self._residency_for_step(j) for j in range(max(1, step - 2), step)]
        return {**window, **(self.store.stage(res, in_flight=in_flight) or {})}

    def _offload_step(self, k: int, batch_source) -> StepEvent:
        stacked, staged = _split_store_rows(
            self._feed.get(k, batch_source, functools.partial(self._offload_batch, batch_source)))
        res = self._residency_for_step(k)
        _load_rows(self, self.store.gather(res, staged))
        # sgd's state is (); a stateful optimizer restarts every superstep
        # under offload, as in the reference
        copy_into(self.opt_state, self.optimizer.init(self.params))
        losses = self._run(stacked)
        self.store.scatter(res, _stacked(self, self.params))
        rps = self.rounds_per_step
        if self.profile is None:
            dt = rps * self._round_time
        else:  # paced by the residents, as the reference
            mask = res.participant_mask(self.fl.num_clients)
            if self.axes.traced:
                dt = sum(self._mask_round_time(mask, t=(k - 1) * rps + i) for i in range(rps))
            else:
                dt = rps * self._mask_round_time(mask)
        return StepEvent(kind="round", iteration=k * self.iterations_per_step, dt=dt,
                         losses=losses)

    def global_params(self) -> dict:
        """``sum_i m_i w^(i)`` in f32 (the reference's einsum promotes to f32);
        under offload the store's (every superstep scatters before it ends)."""
        if not self.store.resident:
            return self.store.global_params()
        return _consensus(self)

    def cluster_params(self) -> dict:
        """Stacked ``(D, ...)`` per-cluster models at the last round boundary
        (steps end on the inter-cluster gossip), in f32."""
        if not self.store.resident:
            raise NotImplementedError(_OFFLOAD_CLUSTERS)
        return _cluster_models(self, self._proto.clusters)

# ---------------------------------------------------------------------------
# Asynchronous event-driven scheduler (Section IV)
# ---------------------------------------------------------------------------

class AsyncScheduler:
    """Priority-queue cluster events with staleness-aware mixing (Algorithm 2).

    ``batch_source`` contract: an object with ``next_batch(client)`` and,
    optionally, the bulk ``next_batches(clients, count)`` (a
    ``repro_torch.data.ClientBatcher``); see ``pipeline.gather_client_batches``.

    The state is the ``(D, ...)`` stack ``y`` of cluster models, whose
    tensors never change: every event writes into them.  When cluster ``d``
    fires, its ``g`` clients take ``theta_max`` masked SGD steps from
    ``y[d]`` (``torch.func.vmap(grad)`` over the clients, a Python loop over
    the steps), then

    * eq. 19: ``delta_i = (w_final - w_start) / theta_i``;
    * eq. 20: ``y[d] <- y[d] + theta_bar * sum_i m^_i delta_i``;
    * eq. 21-22: ``y <- y @ P_t`` through ``backend.inter_cluster``, with
      ``P_t`` built on the host in float64 from the iteration gaps.

    One event is the body ``_event(batch)``, the counterpart of the
    reference's donated ``jax.jit(cluster_update)`` and its mixing: it reads
    every per-event value from its batch, the client batches and the
    operands ``CLUSTER``, ``INV_THETA``, ``THETA``, ``M_HAT``, ``STEP_MASK``
    and ``MIXING`` (``P_t`` in f32), which the host stages in one
    non-blocking copy out of pinned memory (``pipeline.OperandStage``).  It
    takes ``w_start`` with ``index_select(y, 0, d)``, forms ``theta_bar =
    sum(m^ * theta)`` on the device and writes ``y[d]`` with ``index_copy_``
    on one index.  ``graph`` (``None``: on for a CUDA device, off on the
    CPU; ``True`` on the CPU raises) replays the body from a CUDA graph, one
    ``GraphedStep`` whose key is the batch shapes: one graph per cluster size
    ``g``, whichever cluster fires, as the reference's traced ``d_idx``
    serves every cluster of a size.  ``graph=False`` calls the same body
    eagerly.

    On the ``cuda`` backend eq. 19 runs through ``normalized_update_tree``
    (one factor ``1 / theta_i`` per client row), eq. 20's reduction through
    ``cluster_agg_tree`` (the fired cluster's ``(g, ...)`` stacks to ``(1,
    ...)``) and eq. 21-22 through ``gossip_mix_tree``, which reads ``P_t``
    from device memory, one launch each for the tree; on ``dense`` all
    three are the plain expressions the reference writes, the mixed stack
    copied into ``y``; on ``collective`` eq. 19-20 are those expressions and
    eq. 21-22 the ring gossip, with each ``P_t`` checked on the host to stay
    on the ring stencil.  The queue already names the next event when a step
    finishes, so its batches are gathered and copied (non-blocking) right
    after the current event's launches; ``prefetch=False`` draws the same
    streams.

    A device profile prices the queue (``hetero.FleetTiming``) and, with
    availability below 1, stretches it with dropout retries.  ``fleet``
    carries the participation plan and the fault schedule: the fired
    cluster's eq. 20 weights ``m^`` are masked to the event's participants
    (the plan's mask of event ``k``, ANDed under faults with the clients
    the schedule lets aggregate at iteration ``t``) and renormalized, so a
    non-participant weighs exactly 0 in ``cluster_agg``.  An event none of
    whose members participate is ``"skipped"``, and a downed edge server's
    event is an ``"outage"``: nothing is replayed, ``t`` is unchanged, while
    the wall-clock moves on (the batches are still drawn, so the streams
    stay the reference's).  Under faults eq. 21-22 mixes over the
    iteration's surviving edge set, and the next firing pays the cluster's
    failed uplinks' retries.

    The async state is already cluster-sized, so a ``host-offload`` store
    holds ``y`` as one pseudo-client per cluster (mass ``m~_d``) in identity
    residency: ``y`` is its buffer, and every event that updates ``y``
    scatters it into the store's cluster stack, after the event.  A store
    over fewer slots than clusters raises ``ValueError``, as in the
    reference.
    """

    name = "async"

    def __init__(self, cfg, backend=None, prefetch: bool = True,
                 graph: Optional[bool] = None, fleet: Optional[FleetSpec] = None, *,
                 participation=_UNSET):
        self.cfg = cfg
        self.prefetch = prefetch
        self._backend_spec = backend
        self._graph_spec = graph
        self.fleet = _fleet_from_legacy(fleet, "AsyncScheduler", participation=participation)
        self.axes: Optional[FleetAxes] = None
        self._prefetched = None

    def bind(self, model, seed: int, device: torch.device) -> None:
        from .topology import mixing_matrix

        cfg = self.cfg
        clusters = cfg.clusters
        d_count = clusters.num_clusters
        self.model = model
        self.device = device
        self.theta = cfg.theta()
        self.iter_times = cfg.iter_times()
        # the async fault axis is indexed by the global iteration count t
        self.axes = FleetAxes(self.fleet, clusters, cfg.topology, cfg.profile,
                              cfg.alpha_latency, seed)
        self._dropout = None
        if cfg.profile is not None and np.any(cfg.profile.availability < 1.0):
            self._dropout = self.axes.timing.dropout_process(clusters, seed=seed)
        self.store = self.fleet.resolve_store(d_count)
        self.y = stacked_init(model, d_count, seed, device)
        self._store_res = None
        if self.store.resident:
            self.store.attach(self, "y")
        else:
            if self.store.k_max not in (None, d_count):
                raise ValueError(
                    f"async state is per-cluster: a host-offload store must cover all "
                    f"{d_count} clusters (k_max in (None, {d_count})), got "
                    f"k_max={self.store.k_max}")
            sizes = np.bincount(clusters.assignment_array,
                                weights=np.asarray(clusters.data_sizes, dtype=np.float64),
                                minlength=d_count)
            pseudo = ClusterSpec(d_count, tuple(range(d_count)), tuple(sizes.tolist()))
            self.store.bind(pseudo, model, seed, device)
            self._store_res = self.store.residency()
            self.y = self.store.gather(self._store_res)
        self.t = 0
        self.last_update = np.zeros(d_count, dtype=np.int64)  # t'(d)
        self.clock = 0.0
        self._queue = [(self.iter_times[j], j) for j in range(d_count)]
        heapq.heapify(self._queue)
        self._theta_max = int(self.theta.max())
        self.backend = resolve_backend(
            self._backend_spec, clusters, mixing_matrix(cfg.topology, clusters.m_tilde()), 1,
            device=device,
        )
        self._use_kernels = self.backend.name == "cuda"
        # the collective ring gossip reads P_t's stencil on the device: each
        # P_t is checked on the host as it is built, where the reference's
        # inter_cluster re-derives it (raises off the ring)
        self._ring_only = self.backend.name == "collective"
        self._m_tilde = torch.as_tensor(clusters.m_tilde(), dtype=torch.float32, device=device)
        # per-cluster host operands, f32, staged with each event
        self._m_hat_np = clusters.m_hat()
        self._members = [clusters.clients_of(j) for j in range(d_count)]
        steps = np.arange(self._theta_max)
        self._host_ops = []
        for idx in self._members:
            theta = self.theta[idx].astype(np.float32)
            self._host_ops.append({
                INV_THETA: np.float32(1.0) / theta,  # eq. 19 factors
                THETA: theta,
                M_HAT: self._m_hat_np[idx].astype(np.float32),
                # client i steps while s < theta_i
                STEP_MASK: (steps[:, None] < theta[None, :]).astype(np.float32),
            })
        self._vgrad = torch.func.vmap(torch.func.grad(model.loss))
        self._stage = OperandStage(device)
        self._graph = self._build_graph() if resolve_graph(self._graph_spec, device) else None

    def _build_graph(self) -> GraphedStep:
        """One ``GraphedStep`` over ``_event``, in a memory pool of its own."""
        return GraphedStep(self._event, lambda: self.y, self.device)

    def _gather(self, batch_source, d: int, non_blocking: bool = False) -> dict:
        """``theta_max`` batches per member of cluster ``d``, staged on the device."""
        from .pipeline import device_batch, gather_client_batches

        host = gather_client_batches(batch_source, self._members[d], self._theta_max)
        return device_batch(host, self.device, non_blocking=non_blocking)

    def _event_weights(self, k: int, d: int) -> tuple[Optional[torch.Tensor], bool]:
        """``(m^ of the event, participated)`` for event ``k`` on cluster ``d``,
        the weights a host f32 tensor.

        The plan's mask of event ``k`` (ones without sampling), under faults
        ANDed with the clients that survive iteration ``t``; the fired
        cluster's ``m^`` is masked to them and renormalized.  A cluster with
        nobody left reports ``participated=False``.
        """
        idx = self._members[d]
        mask = self.axes.mask(k - 1, fault_round=self.t)[idx]
        if not mask.any():
            return None, False
        w = np.where(mask, self._m_hat_np[idx], 0.0)
        return torch.from_numpy((w / w.sum()).astype(np.float32)), True

    def _operands(self, d: int, m_hat: Optional[torch.Tensor], p_t: np.ndarray) -> dict:
        """The event's operands on the device, in one non-blocking copy."""
        ops = dict(self._host_ops[d])
        if m_hat is not None:
            ops[M_HAT] = m_hat.numpy()
        ops[CLUSTER] = np.array([d], dtype=np.int64)
        ops[MIXING] = p_t.astype(np.float32)
        return self._stage.stage(ops)

    def _event(self, batch: dict) -> None:
        """One cluster event (eq. 19-22) on the batch's client batches and
        operands, written into ``self.y``: the captured step."""
        data = {k: v for k, v in batch.items() if k not in _EVENT_OPERANDS}
        d, inv, theta, m_hat, mask = (batch[k] for k in _EVENT_OPERANDS[:5])
        g = theta.shape[0]
        lr = self.cfg.learning_rate
        y_d = {k: torch.index_select(y, 0, d) for k, y in self.y.items()}  # (1, ...)
        # w_start: y[d] for every member; contiguous, as the kernels stream rows
        w0 = {k: v.expand((g,) + tuple(v.shape[1:])).contiguous() for k, v in y_d.items()}
        w = w0
        for s in range(self._theta_max):
            grads = self._vgrad(w, {k: v[:, s] for k, v in data.items()})
            lm = lr * mask[s]  # (g,): lr on the steps a client still takes, else 0
            w = {k: v - lm.view((g,) + (1,) * (v.dim() - 1)) * grads[k] for k, v in w.items()}
        theta_bar = torch.sum(m_hat * theta)
        if self._use_kernels:
            from ..kernels import cluster_agg_tree, normalized_update_tree

            # vmap(grad) returns conv-kernel gradients as permuted views, and
            # w_final can inherit that layout from them: the kernels stream
            # contiguous rows (a no-op on a contiguous leaf, one copy launch
            # on a strided one)
            wf = {k: v.contiguous() for k, v in w.items()}
            deltas = normalized_update_tree(wf, w0, inv)  # one launch
            rs = cluster_agg_tree(deltas, m_hat, 1)  # one launch
            sums = {k: rs[k].view(y_d[k].shape) for k in self.y}
        else:
            sums = {}
            for k, y in self.y.items():
                delta = (w[k] - w0[k]) / theta.view((g,) + (1,) * (y.dim() - 1))
                sums[k] = torch.einsum("c...,c->...", delta, m_hat)[None]
        for k, y in self.y.items():  # eq. 20, one index: each element written once
            y.index_copy_(0, d, y_d[k] + theta_bar * sums[k])
        # staleness-aware inter-cluster mixing (eq. 21-22) via the backend
        copy_into(self.y, self.backend.inter_cluster(self.y, batch[MIXING], 1))

    def step(self, k: int, batch_source) -> StepEvent:
        cfg = self.cfg
        prev_clock = self.clock
        self.clock, d = heapq.heappop(self._queue)
        if (self._prefetched is not None and self._prefetched[0] is batch_source
                and self._prefetched[1] == d):
            batches = self._prefetched[2]
        else:
            batches = self._gather(batch_source, d)
        self._prefetched = None

        faults = self.axes.faults
        r_fault = self.t  # the fault round this event runs in
        # a dead edge server fires nothing: its gap grows through the outage
        outage = faults is not None and not bool(faults.server_alive(r_fault)[d])
        m_hat, participated = self._event_weights(k, d) if self.axes.active else (None, True)
        if outage:
            participated = False
        if participated:
            # staleness-aware mixing (eq. 21-22) over the surviving edge set
            # under faults, P_t built on the host in float64
            gaps = (self.t - self.last_update).astype(np.float64)
            gaps[d] = 0.0
            graph = cfg.topology if faults is None else faults.adjacency_at(r_fault)
            p_t = staleness_mixing_matrix(graph, d, gaps, cfg.psi)
            if self._ring_only:
                from .aggregation import ring_mixing_weights

                ring_mixing_weights(p_t)
            batch = {**batches, **self._operands(d, m_hat, p_t)}
            if self._graph is None:
                self._event(batch)
            else:
                self._graph(batch)
            self.t += 1
            self.last_update[d] = self.t
            if self._store_res is not None:
                # a device-side take on the identity map: the store's cluster
                # stack follows the live y
                self.store.scatter(self._store_res, self.y)

        # next firing: service time, stretched by dropout retries when the
        # profile says some of the cluster's devices are flaky, plus the
        # capped-backoff retries of this iteration's failed uplinks
        service = self.iter_times[d]
        if self._dropout is not None:
            service *= self._dropout.attempts(d)
        if faults is not None and self.axes.timing is not None and not outage:
            service += self.axes.uplink_penalty(r_fault, self._members[d])
        heapq.heappush(self._queue, (self.clock + service, d))
        if self.prefetch:
            # the queue top is the next event: gather its batches while the
            # device still runs this event's launches
            nxt = self._queue[0][1]
            self._prefetched = (batch_source, nxt,
                                self._gather(batch_source, nxt, non_blocking=True))
        kind = "outage" if outage else "cluster" if participated else "skipped"
        return StepEvent(kind=kind, iteration=self.t, dt=self.clock - prev_clock, cluster=d)

    def global_params(self) -> dict:
        """``sum_d m~_d y^(d)``: the consensus model (the store's under offload)."""
        if self._store_res is not None:
            return self.store.global_params()
        return {
            k: torch.tensordot(self._m_tilde, y.float(), dims=([0], [0])).to(y.dtype)
            for k, y in self.y.items()
        }

    def cluster_params(self) -> dict:
        """Stacked ``(D, ...)`` per-cluster models: the async state itself,
        overwritten by the next event (copy what must outlive it)."""
        return self.y


# ---------------------------------------------------------------------------
# The runtime
# ---------------------------------------------------------------------------

class FederationRuntime:
    """Federated trainer parameterized by a scheduler, on one device."""

    def __init__(self, model, scheduler: Scheduler, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.scheduler = scheduler
        self.clock = 0.0
        self.iteration = 0
        self._k = 0
        scheduler.bind(model, seed, self.device)
        self._eval_batch_cache: Optional[tuple] = None

    def step(self, batch_source) -> StepEvent:
        """Advance the federation by one schedule unit."""
        self._k += 1
        ev = self.scheduler.step(self._k, batch_source)
        self.clock += ev.dt
        self.iteration = ev.iteration
        return ev

    def global_params(self) -> dict:
        return self.scheduler.global_params()

    def cluster_params(self) -> dict:
        """Stacked ``(D, ...)`` per-cluster personalized models."""
        return self.scheduler.cluster_params()

    def evaluate(self, eval_batch) -> tuple[float, Optional[float]]:
        """Loss and accuracy of the ``m``-weighted consensus model."""
        g = self.global_params()
        # upload the eval batch once; the key includes every entry's identity
        key = (id(eval_batch), tuple(id(v) for v in eval_batch.values()))
        cache = self._eval_batch_cache
        if cache is None or cache[0] != key:
            from .pipeline import device_batch

            cache = (key, eval_batch, device_batch(eval_batch, self.device))
            self._eval_batch_cache = cache
        with torch.no_grad():
            loss = self.model.loss(g, cache[2])
            acc = self.model.accuracy(g, cache[2]) if hasattr(self.model, "accuracy") else None
        return float(loss), (None if acc is None else float(acc))

    def run(self, num_steps: int, batch_source, eval_batch=None,
            eval_every: int = 50) -> TrainHistory:
        """Run ``num_steps`` schedule units, evaluating every ``eval_every``."""
        hist = TrainHistory([], [], [], [])
        self._k = 0
        self.clock = 0.0
        for e in range(1, num_steps + 1):
            self.step(batch_source)
            if eval_batch is not None and (e % eval_every == 0 or e == num_steps):
                loss, acc = self.evaluate(eval_batch)
                hist.iterations.append(self.iteration)
                # the async event queue keeps absolute finish times
                hist.wallclock.append(getattr(self.scheduler, "clock", self.clock))
                hist.loss.append(loss)
                if acc is not None:
                    hist.accuracy.append(acc)
        return hist


# ---------------------------------------------------------------------------
# Config-driven scenario registry
# ---------------------------------------------------------------------------

SCHEDULER_REGISTRY: dict[str, Callable[[dict], Scheduler]] = {}


def register_scheduler(name: str):
    """Register a scenario factory: ``dict -> Scheduler`` (pops what it uses)."""

    def deco(factory: Callable[[dict], Scheduler]):
        SCHEDULER_REGISTRY[name] = factory
        return factory

    return deco


def _as_topology(topo, num_clusters: int) -> Topology:
    if isinstance(topo, Topology):
        return topo
    return TOPOLOGIES[topo](num_clusters)


def _as_clusters(s: dict) -> ClusterSpec:
    clusters = s.pop("clusters", None)
    if clusters is not None:
        return clusters
    return ClusterSpec.uniform(s.pop("num_clients"), s.pop("num_clusters"))


def _as_fleet(s: dict) -> FleetSpec:
    """Pop the who-axis keys into one ``FleetSpec``.

    Accepts either a ready ``"fleet"`` entry (``FleetSpec`` or kwargs dict)
    or the flat ``profile``/``profile_seed``/``participation``/``store``/
    ``faults`` keys that ``RunConfig.to_dict`` emits.
    """
    fleet = s.pop("fleet", None)
    if fleet is not None:
        if not isinstance(fleet, FleetSpec):
            fleet = FleetSpec(**dict(fleet))
        return fleet
    return FleetSpec(
        profile=s.pop("profile", None),
        profile_seed=s.pop("profile_seed", None),
        participation=s.pop("participation", None),
        store=s.pop("store", None),
        faults=s.pop("faults", None),
    )


@register_scheduler("sync")
def _make_sync(s: dict) -> SyncScheduler:
    clusters = _as_clusters(s)
    topology = _as_topology(s.pop("topology", "ring"), clusters.num_clusters)
    fleet = _as_fleet(s)
    cfg = SDFEELConfig(
        clusters=clusters,
        topology=topology,
        tau1=s.pop("tau1", 5),
        tau2=s.pop("tau2", 1),
        alpha=s.pop("alpha", 1),
        learning_rate=s.pop("learning_rate", 0.01),
        aggregation_impl=s.pop("aggregation_impl", "dense"),
    )
    return SyncScheduler(
        cfg, latency=s.pop("latency", None), backend=s.pop("backend", None),
        prefetch=s.pop("prefetch", True), graph=s.pop("graph", None), fleet=fleet,
        mesh=s.pop("mesh", None),
    )


@register_scheduler("round")
def _make_round(s: dict) -> RoundScheduler:
    from .sdfeel import FLSpec

    fleet = _as_fleet(s)
    fl = s.pop("fl", None)
    if fl is None:
        fl = FLSpec(
            num_clients=s.pop("num_clients"),
            num_clusters=s.pop("num_clusters"),
            tau1=s.pop("tau1", 2),
            tau2=s.pop("tau2", 1),
            alpha=s.pop("alpha", 2),
            learning_rate=s.pop("learning_rate", 0.01),
            impl=s.pop("impl", "dense"),
            topology=s.pop("topology", "ring"),
        )
    return RoundScheduler(
        fl, optimizer=s.pop("optimizer", None), latency=s.pop("latency", None),
        backend=s.pop("backend", None), rounds_per_step=s.pop("rounds_per_step", 1),
        prefetch=s.pop("prefetch", True), graph=s.pop("graph", None), fleet=fleet,
        mesh=s.pop("mesh", None),
    )


@register_scheduler("async")
def _make_async(s: dict) -> AsyncScheduler:
    from .async_engine import AsyncConfig, make_speeds
    from .staleness import psi_constant, psi_exponential, psi_inverse

    clusters = _as_clusters(s)
    topology = _as_topology(s.pop("topology", "ring"), clusters.num_clusters)
    fleet = _as_fleet(s)
    profile = fleet.resolve_profile(clusters.num_clients)
    speeds = s.pop("speeds", None)
    if speeds is None and profile is None:
        speeds = make_speeds(
            clusters.num_clients, s.pop("heterogeneity", 1.0), seed=s.pop("speed_seed", 0),
        )
    psi = s.pop("psi", psi_inverse)
    if isinstance(psi, str):
        psi = {
            "staleness": psi_inverse,
            "constant": psi_constant,
            "exponential": psi_exponential(),
        }[psi]
    cfg = AsyncConfig(
        clusters=clusters,
        topology=topology,
        speeds=None if speeds is None else np.asarray(speeds),
        learning_rate=s.pop("learning_rate", 0.01),
        theta_min=s.pop("theta_min", 1),
        theta_max=s.pop("theta_max", 20),
        min_batches=s.pop("min_batches", 4),
        psi=psi,
        alpha_latency=s.pop("latency", None),
        profile=profile,
    )
    return AsyncScheduler(cfg, backend=s.pop("backend", None), prefetch=s.pop("prefetch", True),
                          graph=s.pop("graph", None), fleet=fleet)


def make_run(scenario, device=None) -> FederationRuntime:
    """Build a ``FederationRuntime`` from a run configuration.

    ``scenario`` is a :class:`~repro_torch.core.config.RunConfig`, a
    registered scenario name, a dict with a ``"scenario"`` key whose other
    entries override the registered config, or a flat config dict.
    ``device=None`` means ``"cuda"`` and raises without a GPU.  Unconsumed
    keys raise, so typos fail fast.
    """
    device = resolve_device(device)
    if isinstance(scenario, RunConfig):
        rc = scenario
    else:
        if isinstance(scenario, str):
            scenario = {"scenario": scenario}
        s = dict(scenario)
        named = s.pop("scenario", None)
        if named is not None:
            from ..scenarios import get_scenario

            s = get_scenario(named).config(**s)
        rc = RunConfig.from_dict(s)
    rc.validate()
    s = rc.scheduler_config()
    name = s.pop("scheduler", "sync")
    s.pop("model", None)
    model = rc.model.build()
    seed = s.pop("seed", 0)
    sched = SCHEDULER_REGISTRY[name](s)
    if s:
        raise TypeError(f"unused scenario keys for {name!r}: {sorted(s)}")
    return FederationRuntime(model, sched, seed=seed, device=device)
