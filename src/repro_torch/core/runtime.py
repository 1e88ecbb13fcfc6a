"""Federation runtime: one trainer, pluggable schedulers.

The port's ``repro.core.runtime``.  ``FederationRuntime`` owns what every
regime shares — stacked-parameter init (Algorithm 1 line 1), evaluation of
the consensus model, the Section V-B wall-clock accounting, eval cadence
and ``TrainHistory`` — and delegates *how a step advances the federation*
to a scheduler.  Ported: ``SyncScheduler`` (Algorithm 1 / Lemma 1) and
``RoundScheduler`` (whole Algorithm-1 rounds per step) on the default
fleet, and ``AsyncScheduler`` (Section IV, Algorithm 2) with an optional
device profile.

Everything runs eagerly on an explicit ``device``.  Entry points take
``device=None``, which means ``"cuda"``, and raise when there is no GPU and
the caller did not pass ``device="cpu"``::

    runtime = make_run({"scenario": "mnist-noniid-ring", "tau2": 2})
    history = runtime.run(200, batch_fn, eval_batch, eval_every=20)
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from .backends import resolve_backend
from .config import RunConfig
from .device import resolve_device
from .latency import LatencyModel
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
]


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

    ``kind`` is the aggregation event ("local"/"intra"/"inter", or
    "cluster" for an async cluster event), ``iteration`` the
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


def _event_time(latency: Optional[LatencyModel], alpha: int, event: str) -> float:
    """Per-iteration wall-clock of Section V-B for one sync protocol event."""
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

class SyncScheduler:
    """Algorithm 1 over stacked client models.

    ``batch_source`` contract: callable ``k -> stacked batch`` with entries
    of shape ``(C, per_client_batch, ...)``.  ``backend`` is an
    ``AggregationBackend`` name/instance or ``"auto"`` (``cuda`` on a CUDA
    device with uniform contiguous clusters, ``dense`` otherwise).

    Each protocol iteration is one vmapped local SGD step followed by the
    scheduled transition.  With the ``cuda`` backend both stages overwrite
    ``self.params`` in place — the ``sgd_update`` kernel is elementwise and
    each column of the transition belongs to one kernel thread — which is
    the port's counterpart of the reference's donated jit step.  Batches are
    staged through a :class:`~repro_torch.core.pipeline.BatchPipeline`.

    Only the default fleet is ported (resident state, full participation,
    no profile, no faults, no mesh); ``RunConfig.validate`` rejects the rest.
    """

    name = "sync"

    def __init__(self, cfg: SDFEELConfig, latency: Optional[LatencyModel] = None,
                 backend=None, prefetch: bool = True):
        self.cfg = cfg
        self.latency = latency
        self.prefetch = prefetch
        self.params: Optional[dict] = None
        self._backend_spec = backend
        self._pipeline = None
        self._pipeline_src = None
        # §V-B per-event wall-clock depends only on construction args
        self._event_times = {
            e: _event_time(latency, cfg.alpha, e) for e in ("local", "intra", "inter")
        }

    def bind(self, model, seed: int, device: torch.device) -> None:
        from .. import optim
        from .local_update import build_local_update

        cfg = self.cfg
        self.model = model
        self.device = device
        self.params = stacked_init(model, cfg.clusters.num_clients, seed, device)
        self.backend = resolve_backend(
            self._backend_spec, cfg.clusters, cfg.P(), cfg.alpha, device=device
        )
        self._local = build_local_update(
            model, optim.sgd(cfg.learning_rate), backend=self.backend
        )
        self._m = torch.as_tensor(cfg.clusters.m(), dtype=torch.float32, device=device)
        self._v = torch.as_tensor(cfg.clusters.V(), dtype=torch.float32, device=device)

    def _apply(self, k: int, batch: dict) -> tuple[str, float]:
        event = self.cfg.event_at(k)
        self.params, _, _ = self._local(self.params, (), batch)
        if event != "local":
            self.params = self.backend.transition(self.params, event)
        return event, self._event_times[event]

    def _next_batch(self, k: int, batch_source) -> dict:
        from .pipeline import BatchPipeline, device_batch

        def transfer(batch):
            return device_batch(batch, self.device)

        if not self.prefetch:
            return transfer(batch_source(k))
        if (self._pipeline is None or self._pipeline_src is not batch_source
                or self._pipeline.next_index != k):
            self._pipeline = BatchPipeline(batch_source, transfer, start=k)
            self._pipeline_src = batch_source
        return self._pipeline.get(k)

    def step(self, k: int, batch_source) -> StepEvent:
        event, dt = self._apply(k, self._next_batch(k, batch_source))
        return StepEvent(kind=event, iteration=k, dt=dt)

    def global_params(self) -> dict:
        """Consensus-phase output: sum_d m~_d y_K^(d) == sum_i m_i w_K^(i)."""
        return {
            k: torch.tensordot(self._m, w.float(), dims=([0], [0])).to(w.dtype)
            for k, w in self.params.items()
        }

    def cluster_params(self) -> dict:
        """Stacked ``(D, ...)`` per-cluster models y^(d) = sum_{i in d} m^_i w^(i)."""
        return {
            k: torch.tensordot(self._v, w.float(), dims=([0], [0])).to(w.dtype)
            for k, w in self.params.items()
        }


# ---------------------------------------------------------------------------
# Whole-round scheduler (the reference's compiled round engine)
# ---------------------------------------------------------------------------

def _impl_backend(impl: str) -> str:
    """The backend the reference's ``FLSpec.impl`` names, as the port calls it."""
    if impl == "gossip":
        raise NotImplementedError(
            "impl='gossip' (CollectiveBackend) is not ported yet "
            "(ROADMAP.md queue 1, 'Multi-device and launch')"
        )
    return {"dense": "dense", "pallas": "cuda"}[impl]


class RoundScheduler:
    """One step == ``rounds_per_step`` full Algorithm-1 rounds of tau1*tau2 iterations.

    ``batch_source`` contract: callable ``k -> stacked batch`` indexed by the
    protocol iteration; step ``r`` consumes iterations ``(r-1)*R*tau1*tau2 +
    1 .. r*R*tau1*tau2`` for ``R = rounds_per_step``, stacked by
    ``pipeline.stack_window`` and staged by a ``BatchPipeline`` one step
    ahead.  Each step runs ``round_engine.build_fl_round_step``: on the
    ``cuda`` backend the stacked parameters are updated in place by the
    ``sgd_update`` and ``fused_transition`` kernels.  ``StepEvent.losses``
    stays on the device.

    ``backend=None`` takes the one ``FLSpec.impl`` names (``dense`` by
    default, as the reference's round engine); scenarios pass ``"auto"``.
    Ported for resident state and full participation, without a profile,
    faults or a mesh; ``RunConfig.validate`` rejects the rest.
    """

    name = "round"

    def __init__(self, fl, optimizer=None, latency: Optional[LatencyModel] = None,
                 backend=None, rounds_per_step: int = 1, prefetch: bool = True):
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
        self._pipeline = None
        self._pipeline_src = None
        self._proto = fl.protocol()
        # §V-B wall-clock of one full round, priced once
        self._round_time = sum(
            _event_time(latency, fl.alpha, self._proto.event_at(i))
            for i in range(1, self.iterations_per_round + 1)
        )

    @property
    def iterations_per_round(self) -> int:
        return self.fl.tau1 * self.fl.tau2

    @property
    def iterations_per_step(self) -> int:
        """Protocol iterations consumed by one (super)step."""
        return self.iterations_per_round * self.rounds_per_step

    def bind(self, model, seed: int, device: torch.device) -> None:
        from .. import optim
        from .round_engine import build_fl_round_step

        fl = self.fl
        self.model = model
        self.device = device
        opt = self.optimizer or optim.sgd(fl.learning_rate)
        self.optimizer = opt
        self.params = stacked_init(model, fl.num_clients, seed, device)
        self.opt_state = opt.init(self.params)
        clusters = self._proto.clusters
        spec = self._backend_spec
        self.backend = resolve_backend(
            _impl_backend(fl.impl) if spec is None else spec, clusters, self._proto.P(),
            fl.alpha, device=device,
        )
        self._round_step = build_fl_round_step(
            model, opt, fl, backend=self.backend, rounds_per_step=self.rounds_per_step
        )
        self._m = torch.as_tensor(clusters.m(), dtype=torch.float32, device=device)
        self._v = torch.as_tensor(clusters.V(), dtype=torch.float32, device=device)

    def _superstep_batches(self, k: int, batch_source) -> dict:
        from .pipeline import BatchPipeline, device_batch, stack_window

        ips = self.iterations_per_step

        def producer(step: int) -> dict:
            return stack_window(batch_source, (step - 1) * ips + 1, ips)

        def transfer(window: dict) -> dict:
            return device_batch(window, self.device)

        if not self.prefetch:
            return transfer(producer(k))
        if (self._pipeline is None or self._pipeline_src is not batch_source
                or self._pipeline.next_index != k):
            self._pipeline = BatchPipeline(producer, transfer, start=k)
            self._pipeline_src = batch_source
        return self._pipeline.get(k)

    def step(self, k: int, batch_source) -> StepEvent:
        stacked = self._superstep_batches(k, batch_source)
        self.params, self.opt_state, losses = self._round_step(
            self.params, self.opt_state, stacked
        )
        return StepEvent(kind="round", iteration=k * self.iterations_per_step,
                         dt=self.rounds_per_step * self._round_time, losses=losses)

    def global_params(self) -> dict:
        """``sum_i m_i w^(i)`` in f32 (the reference's einsum promotes to f32)."""
        return {k: torch.tensordot(self._m, w.float(), dims=([0], [0]))
                for k, w in self.params.items()}

    def cluster_params(self) -> dict:
        """Stacked ``(D, ...)`` per-cluster models at the last round boundary
        (steps end on the inter-cluster gossip), in f32."""
        return {k: torch.tensordot(self._v, w.float(), dims=([0], [0]))
                for k, w in self.params.items()}


# ---------------------------------------------------------------------------
# Asynchronous event-driven scheduler (Section IV)
# ---------------------------------------------------------------------------

class AsyncScheduler:
    """Priority-queue cluster events with staleness-aware mixing (Algorithm 2).

    ``batch_source`` contract: an object with ``next_batch(client)`` and,
    optionally, the bulk ``next_batches(clients, count)`` (a
    ``repro_torch.data.ClientBatcher``); see ``pipeline.gather_client_batches``.

    The state is the ``(D, ...)`` stack ``y`` of cluster models, updated in
    place.  When cluster ``d`` fires, its ``g`` clients take ``theta_max``
    masked SGD steps from ``y[d]`` (``torch.func.vmap(grad)`` over the
    clients, a Python loop over the steps), then

    * eq. 19: ``delta_i = (w_final - w_start) / theta_i``;
    * eq. 20: ``y[d] <- y[d] + theta_bar * sum_i m^_i delta_i``;
    * eq. 21-22: ``y <- y @ P_t`` through ``backend.inter_cluster``, with
      ``P_t`` built on the host in float64 from the iteration gaps.

    On the ``cuda`` backend eq. 19 runs through the ``normalized_update``
    kernel (one factor ``1 / theta_i`` per client row) and eq. 20's reduction
    through ``cluster_agg`` (the fired cluster's ``(g, M)`` stack to
    ``(1, M)``); on ``dense`` both are the plain expressions the reference
    writes.  The queue already names the next event when a step finishes,
    so its batches are gathered and copied (non-blocking) right after the
    current event's launches; ``prefetch=False`` draws the same streams.

    Ported for resident state, full participation and no faults; a device
    profile prices the queue (``hetero.FleetTiming``) and, with availability
    below 1, stretches it with dropout retries.
    """

    name = "async"

    def __init__(self, cfg, backend=None, prefetch: bool = True):
        self.cfg = cfg
        self.prefetch = prefetch
        self._backend_spec = backend
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
        self._dropout = None
        if cfg.profile is not None and np.any(cfg.profile.availability < 1.0):
            from ..hetero import FleetTiming

            self._dropout = FleetTiming(cfg.profile, cfg.alpha_latency).dropout_process(
                clusters, seed=seed
            )
        self.y = stacked_init(model, d_count, seed, device)
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
        f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)
        self._m_tilde = f32(clusters.m_tilde())
        m_hat = clusters.m_hat()
        # per-cluster constants staged once instead of per event
        self._members = [clusters.clients_of(j) for j in range(d_count)]
        self._thetas = [f32(self.theta[idx]) for idx in self._members]
        self._inv_thetas = [1.0 / t for t in self._thetas]  # eq. 19 factors, f32
        self._m_hats = [f32(m_hat[idx]) for idx in self._members]
        self._theta_bars = [torch.sum(m * t) for m, t in zip(self._m_hats, self._thetas)]
        steps = torch.arange(self._theta_max, device=device)
        # (theta_max, g) step masks: client i steps while s < theta_i
        self._masks = [(steps[:, None] < t[None, :]).float() for t in self._thetas]
        self._vgrad = torch.func.vmap(torch.func.grad(model.loss))

    def _gather(self, batch_source, d: int, non_blocking: bool = False) -> dict:
        """``theta_max`` batches per member of cluster ``d``, staged on the device."""
        from .pipeline import device_batch, gather_client_batches

        host = gather_client_batches(batch_source, self._members[d], self._theta_max)
        return device_batch(host, self.device, non_blocking=non_blocking)

    def _local_steps(self, d: int, batches: dict) -> tuple[dict, dict]:
        """``(w_start, w_final)`` of cluster ``d``'s members, each ``(g, ...)``:
        ``theta_max`` vmapped SGD steps, masked beyond each client's theta_i."""
        lr = self.cfg.learning_rate
        g = len(self._members[d])
        mask = self._masks[d]
        # w_start: y[d] for every member; contiguous, as the kernels stream rows
        w0 = {k: y[d].expand((g,) + tuple(y.shape[1:])).contiguous() for k, y in self.y.items()}
        w = w0
        for s in range(self._theta_max):
            grads = self._vgrad(w, {k: v[:, s] for k, v in batches.items()})
            lm = lr * mask[s]  # (g,): lr on the steps a client still takes, else 0
            w = {k: v - lm.view((g,) + (1,) * (v.dim() - 1)) * grads[k] for k, v in w.items()}
        return w0, w

    def _cluster_update(self, d: int, batches: dict) -> None:
        """Eq. 19-20 for cluster ``d``: ``y[d]`` is overwritten in place."""
        g = len(self._members[d])
        w0, w = self._local_steps(d, batches)
        theta_bar = self._theta_bars[d]
        if self._use_kernels:
            from ..kernels import cluster_agg, normalized_update

            for k, y in self.y.items():
                # vmap(grad) returns conv-kernel gradients as permuted views,
                # and w_final inherits that layout from them: the kernels
                # stream contiguous rows
                wf = w[k].reshape(g, -1).contiguous()
                delta = normalized_update(wf, w0[k].view(g, -1), self._inv_thetas[d])
                r = cluster_agg(delta, self._m_hats[d], 1)
                y[d].add_(theta_bar * r.view(y.shape[1:]))
        else:
            for k, y in self.y.items():
                theta = self._thetas[d].view((g,) + (1,) * (y.dim() - 1))
                delta = (w[k] - w0[k]) / theta
                r = torch.einsum("c...,c->...", delta, self._m_hats[d])
                y[d].add_(theta_bar * r)

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

        self._cluster_update(d, batches)
        # staleness-aware inter-cluster mixing (eq. 21-22) via the backend
        gaps = (self.t - self.last_update).astype(np.float64)
        gaps[d] = 0.0
        p_t = staleness_mixing_matrix(cfg.topology, d, gaps, cfg.psi)
        self.y = self.backend.inter_cluster(
            self.y, torch.as_tensor(p_t, dtype=torch.float32), 1
        )
        self.t += 1
        self.last_update[d] = self.t

        # next firing: service time, stretched by dropout retries when the
        # profile says some of the cluster's devices are flaky
        service = self.iter_times[d]
        if self._dropout is not None:
            service *= self._dropout.attempts(d)
        heapq.heappush(self._queue, (self.clock + service, d))
        if self.prefetch:
            # the queue top is the next event: gather its batches while the
            # device still runs this event's launches
            nxt = self._queue[0][1]
            self._prefetched = (batch_source, nxt,
                                self._gather(batch_source, nxt, non_blocking=True))
        return StepEvent(kind="cluster", iteration=self.t, dt=self.clock - prev_clock,
                         cluster=d)

    def global_params(self) -> dict:
        """``sum_d m~_d y^(d)``: the consensus model."""
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


@register_scheduler("sync")
def _make_sync(s: dict) -> SyncScheduler:
    clusters = _as_clusters(s)
    topology = _as_topology(s.pop("topology", "ring"), clusters.num_clusters)
    cfg = SDFEELConfig(
        clusters=clusters,
        topology=topology,
        tau1=s.pop("tau1", 5),
        tau2=s.pop("tau2", 1),
        alpha=s.pop("alpha", 1),
        learning_rate=s.pop("learning_rate", 0.01),
    )
    return SyncScheduler(
        cfg, latency=s.pop("latency", None), backend=s.pop("backend", None),
        prefetch=s.pop("prefetch", True),
    )


@register_scheduler("round")
def _make_round(s: dict) -> RoundScheduler:
    from .sdfeel import FLSpec

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
        prefetch=s.pop("prefetch", True),
    )


@register_scheduler("async")
def _make_async(s: dict) -> AsyncScheduler:
    from .async_engine import AsyncConfig, make_speeds
    from .config import FleetSpec
    from .staleness import psi_constant, psi_exponential, psi_inverse

    clusters = _as_clusters(s)
    topology = _as_topology(s.pop("topology", "ring"), clusters.num_clusters)
    fleet = FleetSpec(profile=s.pop("profile", None), profile_seed=s.pop("profile_seed", None))
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
    return AsyncScheduler(cfg, backend=s.pop("backend", None), prefetch=s.pop("prefetch", True))


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
