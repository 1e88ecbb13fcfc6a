"""Typed run configuration: one validated schema behind ``make_run``.

The port's copy of ``repro.core.config``::

    RunConfig(
        model=ModelSpec(kind="mnist-cnn"),
        exec=ExecSpec(scheduler="sync", tau1=5, tau2=2, backend="auto"),
        num_clients=20, num_clusters=4, seed=0,
    )

The port runs resident dense client state, full participation, no faults
and no device mesh; a device profile (``profile``/``profile_seed``) is taken
by the async scheduler only.  ``validate`` rejects every other ``FleetSpec``
value and ``exec.mesh`` with ``NotImplementedError`` naming their ROADMAP
item.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

__all__ = ["ModelSpec", "DataSpec", "FleetSpec", "ExecSpec", "RunConfig", "MODEL_KINDS"]

MODEL_KINDS = ("mnist-cnn", "cifar-cnn")

# what is not ported yet, and where ROADMAP.md queues it
_NOT_PORTED = {
    "profile": "queue 1, 'Fleet axes' (profile-paced sync scheduler)",
    "profile_seed": "queue 1, 'Fleet axes' (profile-paced sync scheduler)",
    "participation": "queue 1, 'Fleet axes' (participation/)",
    "store": "queue 1, 'Fleet axes' (state/ client-state stores)",
    "faults": "queue 1, 'Fleet axes' (faults/)",
    "mesh": "queue 1, 'Multi-device and launch'",
}
# fleet keys a scheduler of the port takes; every other non-default raises
_PORTED_FLEET_KEYS = {"async": ("profile", "profile_seed")}


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
    """Who the clients are.  ``profile`` is ported for the async scheduler;
    every other field runs at its default (``None``) only."""

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

    def require_ported(self, scheduler: str) -> None:
        """Raise ``NotImplementedError`` for a field ``scheduler`` cannot take yet."""
        allowed = _PORTED_FLEET_KEYS.get(scheduler, ())
        for k in _FLEET_KEYS:
            if k not in allowed and getattr(self, k) is not None:
                raise NotImplementedError(
                    f"fleet.{k}={getattr(self, k)!r} is not ported yet for scheduler "
                    f"{scheduler!r} (ROADMAP.md {_NOT_PORTED[k]})"
                )


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
    latency: Any = None
    mesh: Any = None
    extras: dict = dataclasses.field(default_factory=dict)


_TOP_KEYS = ("num_clients", "num_clusters", "clusters", "seed")
_FLEET_KEYS = ("profile", "profile_seed", "participation", "store", "faults")
_EXEC_KEYS = ("scheduler", "backend", "topology", "tau1", "tau2", "alpha",
              "learning_rate", "prefetch", "latency", "mesh")
_DATA_KEYS = ("dataset", "partition", "partition_params", "num_samples", "batch_size")


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
        self.fleet.require_ported(sched)
        if self.exec.mesh is not None:
            raise NotImplementedError(
                f"exec.mesh is not ported yet (ROADMAP.md {_NOT_PORTED['mesh']})"
            )
        if self.clusters is not None and (
            self.num_clients is not None or self.num_clusters is not None
        ):
            raise ValueError(
                "pass either an explicit 'clusters' ClusterSpec or "
                "num_clients/num_clusters, not both"
            )
        return self
