"""Named scenario registry: one string == one full experimental setup.

The port's ``repro.scenarios`` for the scenarios it runs, with the
reference's parameters: the synchronous ``mnist-iid-ring``,
``mnist-noniid-ring``, ``mnist-noniid-star``, ``cifar-dirichlet-torus``, and
the asynchronous ``straggler-bimodal-async``, ``straggler-bimodal-vanilla``,
``dropout-heavy``, ``exponential-hetero-async``::

    run = build_scenario("mnist-noniid-ring", tau2=2)   # on the GPU
    run.run(10)
    build_scenario("straggler-bimodal-async", device="cpu", backend="cuda").run(12)

``build_scenario`` materializes the data environment (dataset, partition,
eval batch) from numpy with the reference's rng streams, so a seed gives
the same data and batches in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np

__all__ = [
    "Scenario",
    "ScenarioRun",
    "SCENARIOS",
    "register_scenario",
    "get_scenario",
    "build_scenario",
]


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One named point of the experiment grid (immutable template)."""

    name: str
    description: str
    scheduler: str                      # "sync" | "async"
    dataset: str = "mnist"              # "mnist" | "cifar"
    partition: str = "label_skew"       # "iid" | "label_skew" | "dirichlet"
    partition_params: Optional[dict] = None
    topology: str = "ring"
    backend: str = "auto"
    profile: Union[str, dict, None] = None   # repro_torch.hetero sampler spec
    num_clients: int = 20
    num_clusters: int = 4
    tau1: int = 5
    tau2: int = 1
    alpha: int = 1
    learning_rate: float = 0.05
    psi: str = "staleness"              # async only
    min_batches: int = 2                # async only
    theta_max: int = 8                  # async only
    batch_size: int = 10
    num_samples: int = 2400

    def _model(self):
        from ..models import CifarCNN, MnistCNN

        return {"mnist": MnistCNN, "cifar": CifarCNN}[self.dataset]()

    def _latency(self):
        from ..core import CIFAR_LATENCY, MNIST_LATENCY

        return {"mnist": MNIST_LATENCY, "cifar": CIFAR_LATENCY}[self.dataset]

    def _partition(self, labels: np.ndarray, num_clients: int, seed: int):
        from ..data import dirichlet_partition, iid_partition, skewed_label_partition

        params = dict(self.partition_params or {})
        if self.partition == "iid":
            return iid_partition(labels, num_clients, seed=seed)
        if self.partition == "dirichlet":
            return dirichlet_partition(labels, num_clients, seed=seed, **params)
        if self.partition == "label_skew":
            return skewed_label_partition(labels, num_clients, seed=seed, **params)
        raise KeyError(f"unknown partition {self.partition!r}")

    def _env(self, num_clients: int, num_samples: int, seed: int):
        from ..data import FederatedDataset, cifar_like, mnist_like

        data = {"mnist": mnist_like, "cifar": cifar_like}[self.dataset](num_samples, seed=seed)
        train, test = data.split(0.85)
        ds = FederatedDataset(train, self._partition(train.y, num_clients, seed))
        return ds, {"x": test.x[:512], "y": test.y[:512]}

    def config(self, **overrides) -> dict:
        """Flat ``make_run`` scenario dict, with ``overrides`` applied.

        ``num_clients``, ``num_clusters``, ``num_samples`` and ``model`` are
        consumed here; everything else lands in the dict verbatim (typos
        fail fast in ``make_run``).  The ``ClusterSpec`` data weights come
        from materializing the dataset + partition, deterministic in
        (``dataset``, ``num_samples``, ``seed``).
        """
        cfg, _, _ = self._resolve(overrides)
        return cfg

    def _resolve(self, overrides: dict):
        from ..core import ClusterSpec

        overrides = dict(overrides)
        seed = overrides.pop("seed", 0)
        c = int(overrides.pop("num_clients", self.num_clients))
        d = int(overrides.pop("num_clusters", self.num_clusters))
        n = int(overrides.pop("num_samples", self.num_samples))
        model = overrides.pop("model", None) or self._model()
        if c % d:
            raise ValueError(f"{self.name}: {c} clients do not divide into {d} clusters")
        ds, eval_batch = self._env(c, n, seed)
        assign = tuple(i * d // c for i in range(c))
        cfg: dict = {
            "scheduler": self.scheduler,
            "model": model,
            "topology": self.topology,
            "backend": self.backend,
            "learning_rate": self.learning_rate,
            "latency": self._latency(),
            "seed": seed,
            "clusters": ClusterSpec(c, assign, ds.data_sizes()),
        }
        if self.scheduler == "sync":
            cfg.update(tau1=self.tau1, tau2=self.tau2, alpha=self.alpha)
        if self.scheduler == "async":
            cfg.update(psi=self.psi, min_batches=self.min_batches, theta_max=self.theta_max)
        if self.profile is not None:
            cfg["profile"] = self.profile
        cfg.update(overrides)
        # the fleet sampler follows the run seed whether the profile came
        # from the template or an override (unless explicitly pinned)
        if cfg.get("profile") is not None:
            cfg.setdefault("profile_seed", seed)
        return cfg, ds, eval_batch

    def build(self, device=None, **overrides) -> "ScenarioRun":
        """Materialize runtime + data environment on ``device`` (None: CUDA)."""
        from ..core import make_run, resolve_device

        device = resolve_device(device)
        batch_size = int(overrides.pop("batch_size", self.batch_size))
        cfg, ds, eval_batch = self._resolve(overrides)
        runtime = make_run(cfg, device=device)
        return ScenarioRun(self, runtime, ds, eval_batch, batch_size, cfg["seed"])


@dataclasses.dataclass
class ScenarioRun:
    """A resolved scenario: runtime + data, with the right batch source."""

    scenario: Scenario
    runtime: "object"
    dataset: "object"
    eval_batch: dict
    batch_size: int
    seed: int

    def batch_source(self):
        """The batch source of the scheduler's contract: a ``ClientBatcher``
        for async, else ``k -> stacked batch`` from an rng seeded with the
        run seed."""
        if self.scenario.scheduler == "async":
            from ..data import ClientBatcher

            return ClientBatcher(self.dataset, self.batch_size, seed=self.seed)
        rng = np.random.default_rng(self.seed)
        return lambda k: self.dataset.stacked_batch(self.batch_size, rng)

    def run(self, num_steps: int, eval_every: Optional[int] = None):
        eval_every = eval_every or max(1, num_steps // 4)
        return self.runtime.run(
            num_steps, self.batch_source(), self.eval_batch, eval_every=eval_every
        )


SCENARIOS: dict[str, Scenario] = {}


def register_scenario(sc: Scenario) -> Scenario:
    if sc.name in SCENARIOS:
        raise ValueError(f"scenario {sc.name!r} already registered")
    SCENARIOS[sc.name] = sc
    return sc


def get_scenario(name: str) -> Scenario:
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; registered: {sorted(SCENARIOS)}")
    return SCENARIOS[name]


def build_scenario(name: str, device=None, **overrides) -> ScenarioRun:
    return get_scenario(name).build(device=device, **overrides)


# ---------------------------------------------------------------------------
# The synchronous scenarios (paper §V), as registered in the reference
# ---------------------------------------------------------------------------

register_scenario(Scenario(
    name="mnist-iid-ring",
    description="Sanity baseline: IID MNIST-like data, ring of 4 edge servers.",
    scheduler="sync", partition="iid",
))

register_scenario(Scenario(
    name="mnist-noniid-ring",
    description="Paper §V-A MNIST setting: 2-class label skew, ring topology.",
    scheduler="sync", partition="label_skew",
    partition_params={"classes_per_client": 2},
))

register_scenario(Scenario(
    name="mnist-noniid-star",
    description="Label-skew MNIST on a star hub (Fig. 8 topology ablation).",
    scheduler="sync", partition="label_skew",
    partition_params={"classes_per_client": 2},
    topology="star", alpha=2,
))

register_scenario(Scenario(
    name="cifar-dirichlet-torus",
    description="CIFAR-like task, Dir(0.5) partition, 2x2 torus of edge servers.",
    scheduler="sync", dataset="cifar", partition="dirichlet",
    partition_params={"beta": 0.5},
    topology="torus", learning_rate=0.02,
))


# ---------------------------------------------------------------------------
# The asynchronous scenarios (paper §IV, Fig. 8-10), as registered in the reference
# ---------------------------------------------------------------------------

register_scenario(Scenario(
    name="straggler-bimodal-async",
    description="Staleness-aware async SD-FEEL under a bimodal straggler fleet "
                "(Fig. 8-10 regime).",
    scheduler="async", partition="label_skew",
    partition_params={"classes_per_client": 2},
    profile={"kind": "bimodal-straggler", "straggler_frac": 0.25, "speedup": 10.0},
    psi="staleness",
))

register_scenario(Scenario(
    name="straggler-bimodal-vanilla",
    description="Same straggler fleet with staleness-oblivious constant mixing "
                "(the vanilla-async baseline of Fig. 10a).",
    scheduler="async", partition="label_skew",
    partition_params={"classes_per_client": 2},
    profile={"kind": "bimodal-straggler", "straggler_frac": 0.25, "speedup": 10.0},
    psi="constant",
))

register_scenario(Scenario(
    name="dropout-heavy",
    description="Flaky fleet: uniform speeds, 60% device availability; dropout "
                "retries stretch the async iteration gaps.",
    scheduler="async", partition="iid",
    profile={"kind": "uniform", "heterogeneity": 4.0, "availability": 0.6},
    psi="staleness",
))

register_scenario(Scenario(
    name="exponential-hetero-async",
    description="Heavy-tailed exponential speed distribution (a few very fast "
                "devices), staleness-aware async.",
    scheduler="async", partition="iid",
    profile={"kind": "exponential", "scale": 2.0},
    psi="staleness",
))
