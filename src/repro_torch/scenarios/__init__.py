"""Named scenario registry: one string == one full experimental setup.

The port's ``repro.scenarios`` for the scenarios it runs, with the
reference's parameters: the synchronous ``mnist-iid-ring``,
``mnist-noniid-ring``, ``mnist-noniid-star``, ``cifar-dirichlet-torus`` and
``sampled-k-ring`` (uniform-k participation); the round-engine
``round-compiled-ring``, ``round-superstep-ring``, ``chaos-ring`` (fault
injection), ``million-client-ring`` (10^6 procedural clients behind a
host-offload store of 32 slots), the federated-LM
``federated-lm-ring`` and the serving ``federated-lm-serving`` and
``lm-serving-continuous`` (``launch.serve.serve_scenario``); and the asynchronous
``straggler-bimodal-async``, ``straggler-bimodal-vanilla``,
``dropout-heavy``, ``exponential-hetero-async`` and
``dropout-participation-async`` (availability participation)::

    run = build_scenario("mnist-noniid-ring", tau2=2)   # on the GPU
    run.run(10)
    build_scenario("straggler-bimodal-async", device="cpu", backend="cuda").run(12)
    build_scenario("federated-lm-ring", device="cpu",
                   arch_overrides=dict(d_model=64, d_ff=128), seq_len=16).run(2)
    build_scenario("million-client-ring", device="cpu").run(2)

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
    "list_scenarios",
    "build_scenario",
]


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One named point of the experiment grid (immutable template)."""

    name: str
    description: str
    scheduler: str                      # "sync" | "round" | "async"
    dataset: str = "mnist"    # "mnist" | "cifar" | "procedural" | "lm" | "lm-clustered"
    partition: str = "label_skew"       # "iid" | "label_skew" | "dirichlet"
    partition_params: Optional[dict] = None
    topology: str = "ring"
    backend: str = "auto"
    profile: Union[str, dict, None] = None   # repro_torch.hetero sampler spec
    participation: Union[str, dict, None] = None  # repro_torch.participation spec
    store: Union[str, dict, None] = None     # repro_torch.state client-state store
    faults: Union[dict, list, None] = None   # repro_torch.faults event list / spec
    num_clients: int = 20
    num_clusters: int = 4
    tau1: int = 5
    tau2: int = 1
    alpha: int = 1
    rounds_per_step: int = 1            # round only: rounds per step
    learning_rate: float = 0.05
    psi: str = "staleness"              # async only
    min_batches: int = 2                # async only
    theta_max: int = 8                  # async only
    batch_size: int = 10
    num_samples: int = 2400
    arch: Optional[str] = None          # lm only: repro_torch.configs name
    arch_overrides: Optional[dict] = None  # lm only: ArchConfig field overrides
    seq_len: int = 64                   # lm only
    vocab_size: int = 512               # lm only (must match the arch's vocab)

    def _model(self):
        from ..models import CifarCNN, MnistCNN

        if self.dataset in ("lm", "lm-clustered"):
            from ..configs import get_config
            from ..models import CausalLM

            # reduced() shrinks the named family to test scale; arch_overrides
            # pins widths, precision or attn_impl per run
            arch = get_config(self.arch or "granite-8b").reduced()
            arch = dataclasses.replace(
                arch, vocab_size=self.vocab_size, **(self.arch_overrides or {})
            )
            return CausalLM(arch)
        # procedural data is MNIST-shaped (28x28x1 class prototypes)
        return {"mnist": MnistCNN, "cifar": CifarCNN, "procedural": MnistCNN}[self.dataset]()

    def _latency(self):
        from ..core import CIFAR_LATENCY, MNIST_LATENCY

        # no §V-B measurement exists for the LM tasks: pacing stays off
        return {"mnist": MNIST_LATENCY, "cifar": CIFAR_LATENCY, "procedural": MNIST_LATENCY,
                "lm": None, "lm-clustered": None}[self.dataset]

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

    def _env(self, num_clients: int, num_samples: int, seed: int, seq_len: int,
             vocab_size: int, num_clusters: int):
        from ..data import (FederatedDataset, FederatedLM, ProceduralFederated, cifar_like,
                            mnist_like)

        if self.dataset == "lm-clustered":
            ds = FederatedLM.generate_clustered(num_clients, num_samples, seq_len, vocab_size,
                                                num_clusters, seed=seed)
            return ds, ds.eval_batch(64, seed=seed)
        if self.dataset == "lm":
            ds = FederatedLM.generate(num_clients, num_samples, seq_len, vocab_size, seed=seed)
            return ds, ds.eval_batch(64, seed=seed)
        if self.dataset == "procedural":
            # batches made per (client, iteration) on demand: nothing is
            # materialized per client, so num_clients can be 10^6
            ds = ProceduralFederated(
                num_clients, batch_size=self.batch_size, seed=seed,
                classes_per_client=(self.partition_params or {}).get("classes_per_client", 2))
            return ds, ds.eval_batch(512)
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
        seq_len = int(overrides.pop("seq_len", self.seq_len))
        vocab_size = int(overrides.pop("vocab_size", self.vocab_size))
        arch_overrides = overrides.pop("arch_overrides", None)
        template = self
        if arch_overrides is not None or vocab_size != self.vocab_size:
            merged = dict(self.arch_overrides or {})
            merged.update(arch_overrides or {})
            template = dataclasses.replace(self, vocab_size=vocab_size, arch_overrides=merged)
        model = overrides.pop("model", None) or template._model()
        if c % d:
            raise ValueError(f"{self.name}: {c} clients do not divide into {d} clusters")
        ds, eval_batch = template._env(c, n, seed, seq_len, vocab_size, d)
        # an overriding scheduler gets its own keys (the reference's gives the
        # template's, which the overriding factory then refuses)
        scheduler = overrides.pop("scheduler", self.scheduler)
        cfg: dict = {
            "scheduler": scheduler,
            "model": model,
            "topology": self.topology,
            "backend": self.backend,
            "learning_rate": self.learning_rate,
            "latency": self._latency(),
            "seed": seed,
        }
        if scheduler == "round":
            # the round engine lays clients out uniformly itself
            cfg.update(num_clients=c, num_clusters=d, tau1=self.tau1, tau2=self.tau2,
                       alpha=self.alpha, rounds_per_step=self.rounds_per_step)
        else:
            assign = tuple(i * d // c for i in range(c))
            cfg["clusters"] = ClusterSpec(c, assign, ds.data_sizes())
        if scheduler == "sync":
            cfg.update(tau1=self.tau1, tau2=self.tau2, alpha=self.alpha)
        if scheduler == "async":
            cfg.update(psi=self.psi, min_batches=self.min_batches, theta_max=self.theta_max)
        if self.profile is not None:
            cfg["profile"] = self.profile
        if self.participation is not None:
            cfg["participation"] = self.participation
        if self.store is not None:
            store = self.store
            if isinstance(store, dict) and store.get("k_max") is not None:
                # the template's buffer size is an upper bound: a smaller
                # override fleet clips it to its client count
                store = dict(store, k_max=min(int(store["k_max"]), c))
            cfg["store"] = store
        if self.faults is not None:
            cfg["faults"] = self.faults
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
        """The batch source of the scheduler's contract: a procedural dataset
        itself (``(k, clients=None)`` with ``supports_clients``, and
        ``next_batch`` for async), a ``ClientBatcher`` for async, else ``k ->
        stacked batch`` from an rng seeded with the run seed."""
        from ..data import ProceduralFederated

        if isinstance(self.dataset, ProceduralFederated):
            return self.dataset
        if self.runtime.scheduler.name == "async":
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


def list_scenarios() -> list[Scenario]:
    return [SCENARIOS[k] for k in sorted(SCENARIOS)]


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


register_scenario(Scenario(
    name="sampled-k-ring",
    description="FedAvg-style partial participation: 2 of each cluster's 5 "
                "clients sampled per round (uniform-k), label-skew ring.",
    scheduler="sync", partition="label_skew",
    partition_params={"classes_per_client": 2},
    participation={"strategy": "uniform-k", "k": 2},
))


register_scenario(Scenario(
    name="million-client-ring",
    description="Scale lane: 10^6 procedurally-generated clients on a ring of "
                "8 edge servers; uniform-k sampling plus a host-offload state "
                "store keep the device footprint at k_max=32 client models "
                "regardless of fleet size.",
    scheduler="round", dataset="procedural", partition="label_skew",
    partition_params={"classes_per_client": 2},
    num_clients=1_000_000, num_clusters=8, tau1=2, tau2=1, alpha=1,
    participation={"strategy": "uniform-k", "k": 4},
    store={"kind": "host-offload", "k_max": 32},
    batch_size=4,
))


# ---------------------------------------------------------------------------
# The round-engine scenarios, as registered in the reference
# ---------------------------------------------------------------------------

register_scenario(Scenario(
    name="round-compiled-ring",
    description="Whole-round engine on IID data (uniform clusters).",
    scheduler="round", partition="iid", tau1=2, tau2=2, alpha=2,
    num_clients=8,
))

register_scenario(Scenario(
    name="round-superstep-ring",
    description="Superstep path: 4 rounds per step with batch prefetch (throughput lane).",
    scheduler="round", partition="iid", tau1=2, tau2=2, alpha=2,
    num_clients=8, rounds_per_step=4,
))

register_scenario(Scenario(
    name="federated-lm-ring",
    description="Federated LM: a reduced granite-family decoder per client, non-IID "
                "Markov corpora, whole-round supersteps on a ring of 4 edge servers.",
    scheduler="round", dataset="lm",
    num_clients=8, num_clusters=4, tau1=2, tau2=2, alpha=2,
    rounds_per_step=2, learning_rate=0.1,
    arch="granite-8b", batch_size=2, num_samples=1024,
    seq_len=64, vocab_size=512,
))


register_scenario(Scenario(
    name="federated-lm-serving",
    description="Training-to-serving loop: clustered corpora whose per-cluster "
                "successor tables CONFLICT on a shared vocabulary, round "
                "supersteps, and per-cluster personalized inference with "
                "live weight hot-swap (repro_torch.serving.FederatedServer).",
    scheduler="round", dataset="lm-clustered",
    num_clients=8, num_clusters=4, tau1=8, tau2=2, alpha=1,
    rounds_per_step=1, learning_rate=0.3,
    arch="granite-8b", batch_size=8, num_samples=256,
    seq_len=32, vocab_size=32,
))

register_scenario(Scenario(
    name="lm-serving-continuous",
    description="Continuous-batching serving lane: the clustered conflicting "
                "corpora of federated-lm-serving, served through the slot-pool "
                "engine (mid-decode admission, decode chunks on a CUDA graph, "
                "heavy-tailed per-request budgets) via "
                "repro_torch.serving.ContinuousFederatedServer.",
    scheduler="round", dataset="lm-clustered",
    num_clients=8, num_clusters=4, tau1=8, tau2=2, alpha=1,
    rounds_per_step=1, learning_rate=0.3,
    arch="granite-8b", batch_size=8, num_samples=256,
    seq_len=32, vocab_size=32,
))


register_scenario(Scenario(
    name="chaos-ring",
    description="Fault-injection lane: round supersteps on a ring of 4 edge "
                "servers that degrades to a line (link 0-3 down), loses server 2 "
                "outright (local-only rounds, staleness re-entry on rejoin), and "
                "sees client crashes and uplink drops, all as per-round "
                "weight and mixing operands of one captured graph.",
    scheduler="round", partition="iid", tau1=2, tau2=1, alpha=1,
    num_clients=8, num_clusters=4, rounds_per_step=2,
    profile={"kind": "uniform", "heterogeneity": 2.0},
    faults={"events": [
        {"kind": "link-down", "round": 2, "link": [0, 3], "until": 6},
        {"kind": "server-down", "round": 4, "server": 2, "until": 8},
        {"kind": "client-crash", "round": 3, "client": 5, "until": 7},
        {"kind": "uplink-drop", "round": 5, "client": 1},
        {"kind": "uplink-drop", "round": 9, "client": 6},
    ]},
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

register_scenario(Scenario(
    name="dropout-participation-async",
    description="Flaky fleet where dropout gates aggregation itself: "
                "Bernoulli availability participation on the async event "
                "queue (all-down cluster events are skipped).",
    scheduler="async", partition="iid",
    profile={"kind": "uniform", "heterogeneity": 4.0, "availability": 0.7},
    participation="availability", psi="staleness",
))
