"""Federation runtime: one trainer, pluggable schedulers.

The port's ``repro.core.runtime``.  ``FederationRuntime`` owns what every
regime shares — stacked-parameter init (Algorithm 1 line 1), evaluation of
the consensus model, the Section V-B wall-clock accounting, eval cadence
and ``TrainHistory`` — and delegates *how a step advances the federation*
to a scheduler.  This slice ports ``SyncScheduler`` (Algorithm 1 / Lemma 1)
on the default fleet; the round and async schedulers follow.

Everything runs eagerly on an explicit ``device``.  Entry points take
``device=None``, which means ``"cuda"``, and raise when there is no GPU and
the caller did not pass ``device="cpu"``::

    runtime = make_run({"scenario": "mnist-noniid-ring", "tau2": 2})
    history = runtime.run(200, batch_fn, eval_batch, eval_every=20)
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Protocol, runtime_checkable

import torch

from .backends import resolve_backend
from .config import RunConfig
from .device import resolve_device
from .latency import LatencyModel
from .protocol import ClusterSpec, SDFEELConfig
from .topology import TOPOLOGIES, Topology

__all__ = [
    "TrainHistory",
    "StepEvent",
    "Scheduler",
    "SyncScheduler",
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

    ``kind`` is the aggregation event ("local"/"intra"/"inter"),
    ``iteration`` the protocol-iteration count after the step, ``dt`` the
    Section V-B wall-clock the step consumed.
    """

    kind: str
    iteration: int
    dt: float = 0.0


def stacked_init(model, num_copies: int, seed, device) -> dict:
    """Identical initial model replicated on a leading axis (Alg. 1 line 1).

    Drawn from a CPU ``torch.Generator`` seeded with ``seed`` (not JAX's
    stream: tests that compare packages carry JAX's weights across with
    ``repro_torch.convert``), then copied to ``device``.
    """
    gen = torch.Generator().manual_seed(int(seed))
    w0 = model.init(gen)
    return {
        k: v[None].expand((num_copies,) + tuple(v.shape)).contiguous().to(device)
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
                hist.wallclock.append(self.clock)
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
