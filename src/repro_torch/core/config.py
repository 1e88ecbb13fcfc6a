"""Typed run configuration: one validated schema behind ``make_run``.

The port's copy of ``repro.core.config``::

    RunConfig(
        model=ModelSpec(kind="mnist-cnn"),
        exec=ExecSpec(scheduler="sync", tau1=5, tau2=2, backend="auto"),
        num_clients=20, num_clusters=4, seed=0,
    )

Every scheduler of the port (``sync``, ``round``, ``async``) takes the
fleet's device profile (``profile``/``profile_seed``), its ``participation``
plan, its ``faults`` schedule and its client-state ``store``
(``repro_torch.state``).  ``validate`` checks their structure as the
reference does.  ``exec.mesh`` takes ``None``, ``"auto"`` or a
``launch.mesh.ClientMesh``: the sync and round schedulers resolve it
(``launch.mesh.resolve_client_mesh``) to a client mesh over an initialized
process group, one client a rank, or to no mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

__all__ = ["ModelSpec", "DataSpec", "FleetSpec", "ExecSpec", "RunConfig", "MODEL_KINDS"]

MODEL_KINDS = ("mnist-cnn", "cifar-cnn")

def _model_registry() -> dict:
    from ..models import CifarCNN, MnistCNN

    return {"mnist-cnn": MnistCNN, "cifar-cnn": CifarCNN}


@dataclasses.dataclass
class ModelSpec:
    """What trains: a registered architecture kind or a ready model object."""

    kind: Optional[str] = None
    instance: Any = None
    params: dict = dataclasses.field(default_factory=dict)

    def build(self):
        if self.instance is not None:
            return self.instance
        if self.kind is None:
            raise ValueError("ModelSpec needs a 'kind' or an 'instance'")
        reg = _model_registry()
        if self.kind not in reg:
            raise KeyError(f"unknown model kind {self.kind!r}; registered: {sorted(reg)}")
        self.instance = reg[self.kind](**self.params)
        return self.instance


@dataclasses.dataclass
class DataSpec:
    """The data environment (consumed by ``repro_torch.scenarios``, not make_run)."""

    dataset: str = "mnist"            # "mnist" | "cifar"
    partition: str = "label_skew"     # "iid" | "label_skew" | "dirichlet"
    partition_params: Optional[dict] = None
    num_samples: int = 2400
    batch_size: int = 10


@dataclasses.dataclass
class FleetSpec:
    """Who the clients are: device ``profile`` (a ``repro_torch.hetero``
    sampler spec), ``participation`` (a ``repro_torch.participation`` spec or
    plan), ``store`` (a ``repro_torch.state`` client-state store: a kind, a
    ``{"kind": ..., **params}`` dict or a store; ``None`` is dense resident
    state) and ``faults`` (a ``repro_torch.faults`` event list, spec dict,
    JSON string or schedule)."""

    profile: Any = None
    profile_seed: Optional[int] = None
    participation: Any = None
    store: Any = None
    faults: Any = None

    def resolve_profile(self, num_clients: int):
        """Materialize the ``DeviceProfile`` (or None) for this fleet size."""
        if self.profile is None:
            return None
        from ..hetero import sample_profile

        return sample_profile(
            self.profile, num_clients,
            seed=0 if self.profile_seed is None else self.profile_seed,
        )

    def resolve_store(self, num_clients: int):
        """The client-state store of this fleet (``repro_torch.state``)."""
        from ..state import resolve_store

        return resolve_store(self.store, num_clients)

    def is_default(self) -> bool:
        return (self.profile is None and self.profile_seed is None
                and self.participation is None and self.store is None
                and self.faults is None)

    def validate(self) -> None:
        """The reference's structural checks of ``participation``, ``store``
        and ``faults``; sizes are checked when a scheduler resolves them."""
        part = self.participation
        if part is not None and not isinstance(part, (str, dict)) and not hasattr(part, "mask"):
            raise TypeError(
                f"fleet.participation must be a strategy name, spec dict or "
                f"ParticipationPlan, got {type(part).__name__}"
            )
        if isinstance(self.store, (str, dict)):
            from ..state import STORE_REGISTRY

            kind = self.store if isinstance(self.store, str) else self.store.get("kind")
            if kind not in STORE_REGISTRY:
                raise KeyError(f"unknown state store {kind!r}; registered: "
                               f"{sorted(STORE_REGISTRY)}")
        faults = self.faults
        if faults is None:
            return
        from ..faults import FaultSchedule, parse_fault_spec, validate_fault_events

        if not isinstance(faults, FaultSchedule):
            validate_fault_events(parse_fault_spec(faults)[0])


@dataclasses.dataclass
class ExecSpec:
    """How training runs: scheduler, backend, schedule periods.

    ``None`` means "use the scheduler factory's default".  Unknown keys
    travel in ``extras`` and fail fast in the factory (unconsumed keys raise).
    """

    scheduler: str = "sync"
    backend: Any = None
    topology: Any = None
    tau1: Optional[int] = None
    tau2: Optional[int] = None
    alpha: Optional[int] = None
    learning_rate: Optional[float] = None
    prefetch: Optional[bool] = None
    graph: Optional[bool] = None    # sync, round, async: CUDA-graph steps (None: on CUDA)
    latency: Any = None
    mesh: Any = None
    extras: dict = dataclasses.field(default_factory=dict)


_TOP_KEYS = ("num_clients", "num_clusters", "clusters", "seed")
_FLEET_KEYS = ("profile", "profile_seed", "participation", "store", "faults")
_EXEC_KEYS = ("scheduler", "backend", "topology", "tau1", "tau2", "alpha",
              "learning_rate", "prefetch", "graph", "latency", "mesh")
_DATA_KEYS = ("dataset", "partition", "partition_params", "num_samples", "batch_size")
# the exec keys ``describe`` lists, the reference's: ``rounds_per_step`` is an
# ExecSpec field there and an extra here; ``graph``, the port's own key, is
# listed with the extras, where the reference keeps a key it has no field for
_DESCRIBE_EXEC_KEYS = ("scheduler", "backend", "topology", "tau1", "tau2", "alpha",
                       "learning_rate", "rounds_per_step", "prefetch", "latency", "mesh")


@dataclasses.dataclass
class RunConfig:
    """The validated schema behind ``make_run`` (and scenario resolution)."""

    model: ModelSpec
    fleet: FleetSpec = dataclasses.field(default_factory=FleetSpec)
    exec: ExecSpec = dataclasses.field(default_factory=ExecSpec)
    data: Optional[DataSpec] = None
    num_clients: Optional[int] = None
    num_clusters: Optional[int] = None
    clusters: Any = None
    seed: int = 0

    @classmethod
    def from_dict(cls, d: dict) -> "RunConfig":
        """Lift a flat ``make_run`` dict; unknown keys land in ``exec.extras``."""
        s = dict(d)
        model = s.pop("model", None)
        if isinstance(model, ModelSpec):
            mspec = model
        elif isinstance(model, str):
            mspec = ModelSpec(kind=model)
        else:
            mspec = ModelSpec(instance=model)
        fleet = s.pop("fleet", None)
        if fleet is None:
            fleet = FleetSpec(**{k: s.pop(k) for k in _FLEET_KEYS if k in s})
        elif not isinstance(fleet, FleetSpec):
            fleet = FleetSpec(**dict(fleet))
        data = None
        if any(k in s for k in _DATA_KEYS):
            data = DataSpec(**{k: s.pop(k) for k in _DATA_KEYS if k in s})
        ex = ExecSpec(**{k: s.pop(k) for k in _EXEC_KEYS if k in s})
        top = {k: s.pop(k) for k in _TOP_KEYS if k in s}
        ex.extras = s
        return cls(model=mspec, fleet=fleet, exec=ex, data=data, **top)

    def to_dict(self) -> dict:
        """Flatten back to the ``make_run`` dict (lossless)."""
        out: dict = {}
        if self.model.instance is not None or self.model.kind is not None:
            out["model"] = self.model.build()
        for k in _TOP_KEYS:
            v = getattr(self, k)
            if v is not None:
                out[k] = v
        for k in _FLEET_KEYS:
            v = getattr(self.fleet, k)
            if v is not None:
                out[k] = v
        out["scheduler"] = self.exec.scheduler
        for k in _EXEC_KEYS[1:]:
            v = getattr(self.exec, k)
            if v is not None:
                out[k] = v
        if self.data is not None:
            for k in _DATA_KEYS:
                v = getattr(self.data, k)
                if v is not None:
                    out[k] = v
        out.update(self.exec.extras)
        return out

    def scheduler_config(self) -> dict:
        """``to_dict`` minus the data-environment keys (those shape batches)."""
        out = self.to_dict()
        for k in _DATA_KEYS:
            out.pop(k, None)
        return out

    def validate(self) -> "RunConfig":
        from .runtime import SCHEDULER_REGISTRY

        if self.model.instance is None and self.model.kind is None:
            raise ValueError("RunConfig.model needs a kind or an instance")
        sched = self.exec.scheduler
        if sched not in SCHEDULER_REGISTRY:
            raise KeyError(
                f"unknown scheduler {sched!r}; registered: {sorted(SCHEDULER_REGISTRY)}"
            )
        for k in ("tau1", "tau2", "alpha"):
            v = getattr(self.exec, k)
            if v is not None and (not isinstance(v, int) or v < 1):
                raise ValueError(f"exec.{k} must be an int >= 1, got {v!r}")
        self.fleet.validate()
        if self.exec.mesh is not None:
            from ..launch.mesh import ClientMesh

            # its size is checked where it binds: against the aggregation's
            # clients, an offload store's slots
            if not (self.exec.mesh == "auto" or isinstance(self.exec.mesh, ClientMesh)):
                raise ValueError(f"exec.mesh must be None, 'auto', or a ClientMesh, got "
                                 f"{self.exec.mesh!r}")
        if self.clusters is not None and (
            self.num_clients is not None or self.num_clusters is not None
        ):
            raise ValueError(
                "pass either an explicit 'clusters' ClusterSpec or "
                "num_clients/num_clusters, not both"
            )
        return self

    # -- checkpoint metadata -------------------------------------------------
    def describe(self) -> dict:
        """JSON-safe summary for checkpoint metadata / manifests (the
        reference's layout)."""

        def safe(v):
            if v is None or isinstance(v, (bool, int, float, str)):
                return v
            if isinstance(v, dict):
                return {str(k): safe(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [safe(x) for x in v]
            if hasattr(v, "describe"):  # FaultSchedule and friends
                return safe(v.describe())
            return repr(v)

        extras = dict(self.exec.extras)
        exec_ = {k: getattr(self.exec, k, None) for k in _DESCRIBE_EXEC_KEYS}
        exec_["rounds_per_step"] = extras.pop("rounds_per_step", None)
        if self.exec.graph is not None:
            extras["graph"] = self.exec.graph
        return {
            "model": safe(self.model.kind or type(self.model.instance).__name__),
            "data": None if self.data is None else safe(dataclasses.asdict(self.data)),
            "fleet": {k: safe(getattr(self.fleet, k)) for k in _FLEET_KEYS},
            "exec": {k: safe(v) for k, v in exec_.items()} | {"extras": safe(extras)},
            "num_clients": self.num_clients,
            "num_clusters": self.num_clusters,
            "seed": self.seed,
        }
