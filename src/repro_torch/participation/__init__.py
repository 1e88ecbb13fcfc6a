"""Per-round client participation: masks + renormalized Lemma-1 weights.

A numpy copy of ``repro.participation`` (importing it would import JAX):
the same seed and round give the same masks and weights in both packages.

The paper's aggregation steps (Algorithm 1, Lemma 1) assume every client in
a cluster contributes each round.  The straggler analysis — and the
FedAvg-style sampling common since the fast-convergence SD-FEEL line
(arXiv:2104.12678) and the asynchronous companion (arXiv:2112.04737) —
hinges on *who* participates varying over time.  A
:class:`ParticipationPlan` makes that a first-class axis: for every round
``r`` it produces

* ``mask(r)``     — a boolean ``(C,)`` vector of participating clients, and
* ``weights(r)``  — the intra-cluster weights ``m^`` masked to the
  participants and renormalized per cluster (each cluster's participating
  weights sum to 1), the vector every ``AggregationBackend.transition``
  accepts as its ``weights`` argument.

A cluster whose every client is sampled out falls back to its *full*
weights for that round (aggregating everyone is the well-defined limit of
"nobody was sampled"; the async scheduler instead skips the cluster event
entirely — see ``runtime.AsyncScheduler``).

Strategies (registered; new ones plug in via ``register_participation``):

=================  =========================================================
``full``           Every client, every round.  ``weights(r)`` returns the
                   exact ``m^`` vector, and schedulers route this through
                   the legacy static-weight code path, so ``"full"`` is
                   bit-identical to a run with no plan at all.
``uniform-k``      FedAvg sampling: ``k`` clients drawn uniformly without
                   replacement from each cluster, fresh per round.
``availability``   Bernoulli draws from per-client availability — by
                   default the scenario's ``DeviceProfile.availability``,
                   so flaky devices drop out of aggregation, not just out
                   of the simulated wall-clock.
``trace``          Deterministic replay of a time-varying availability
                   schedule (``repro_torch.hetero.TraceSchedule``, or the
                   schedule attached to a 2-D ``trace`` device profile):
                   client ``i`` participates in round ``r`` iff its
                   scheduled availability is ``>= threshold``.
=================  =========================================================

Draws are deterministic in ``(seed, round)`` — ``mask(r)`` can be evaluated
in any order and any number of times (the superstep scheduler stacks ``R``
rounds ahead of time; prefetch must agree with execution).
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np

from ..core.protocol import ClusterSpec

__all__ = [
    "ParticipationPlan",
    "PARTICIPATION_REGISTRY",
    "register_participation",
    "renormalize_weights",
    "resolve_plan",
]

# mask factory: (clusters, seed=..., **params) -> (round -> bool (C,) mask)
MaskFactory = Callable[..., Callable[[int], np.ndarray]]

PARTICIPATION_REGISTRY: dict[str, MaskFactory] = {}


def register_participation(name: str):
    """Register a strategy ``(clusters, seed=0, **params) -> (r -> mask)``."""

    def deco(factory: MaskFactory) -> MaskFactory:
        PARTICIPATION_REGISTRY[name] = factory
        return factory

    return deco


def renormalize_weights(
    m_hat: np.ndarray, assignments, mask: np.ndarray
) -> np.ndarray:
    """Mask the intra-cluster weights and renormalize per cluster.

    ``w_i = m^_i s_i / sum_{j in C_d(i)} m^_j s_j`` — participating clients
    share their cluster's unit weight in data-ratio proportion, sampled-out
    clients get exactly 0 (their update is dropped, not merged).  A cluster
    with no participants falls back to its full ``m^`` column so the
    transition stays column-stochastic (every cluster aggregate remains a
    convex combination of client models).
    """
    m_hat = np.asarray(m_hat, dtype=np.float64)
    assign = np.asarray(assignments, dtype=np.int64)
    mask = np.asarray(mask, dtype=bool)
    if mask.shape != m_hat.shape or assign.shape != m_hat.shape:
        raise ValueError("m_hat, assignments and mask must share length")
    w = np.where(mask, m_hat, 0.0)
    z = np.zeros(int(assign.max()) + 1, dtype=np.float64)
    np.add.at(z, assign, w)
    empty = z <= 0.0
    denom = np.where(empty[assign], 1.0, z[assign])
    return np.where(empty[assign], m_hat, w / denom)


def _round_rng(seed: int, r: int) -> np.random.Generator:
    """Deterministic per-round stream: independent of evaluation order."""
    return np.random.default_rng([int(seed) & 0xFFFFFFFF, int(r)])


# ---------------------------------------------------------------------------
# Registered strategies
# ---------------------------------------------------------------------------

@register_participation("full")
def full_participation(clusters: ClusterSpec, seed: int = 0):
    ones = np.ones(clusters.num_clients, dtype=bool)
    return lambda r: ones.copy()


@register_participation("uniform-k")
def uniform_k_participation(clusters: ClusterSpec, seed: int = 0, k: int = 1):
    """FedAvg sampling: k uniform clients per cluster, fresh every round."""
    if k < 1:
        raise ValueError(f"uniform-k needs k >= 1, got k={k}")
    members = [np.asarray(clusters.clients_of(d)) for d in range(clusters.num_clusters)]

    def mask(r: int) -> np.ndarray:
        rng = _round_rng(seed, r)
        m = np.zeros(clusters.num_clients, dtype=bool)
        for idx in members:
            m[rng.choice(idx, size=min(k, len(idx)), replace=False)] = True
        return m

    return mask


@register_participation("availability")
def availability_participation(
    clusters: ClusterSpec,
    seed: int = 0,
    profile=None,
    availability=None,
):
    """Bernoulli(a_i) participation from per-client availability."""
    if availability is None:
        if profile is None:
            raise ValueError(
                "availability participation needs a DeviceProfile or an "
                "explicit per-client 'availability' vector"
            )
        availability = profile.availability
    a = np.asarray(availability, dtype=np.float64)
    if a.shape != (clusters.num_clients,):
        raise ValueError(
            f"availability vector has shape {a.shape}, expected "
            f"({clusters.num_clients},)"
        )
    if np.any(a < 0) or np.any(a > 1):
        raise ValueError("availability must lie in [0, 1]")

    def mask(r: int) -> np.ndarray:
        return _round_rng(seed, r).random(clusters.num_clients) < a

    return mask


@register_participation("trace")
def trace_participation(
    clusters: ClusterSpec,
    seed: int = 0,
    profile=None,
    schedule=None,
    availability=None,
    threshold: float = 0.5,
):
    """Deterministic replay of a time-varying availability schedule.

    ``schedule`` is a ``repro_torch.hetero.TraceSchedule`` (or the one attached to
    a 2-D ``trace`` profile); alternatively pass a raw ``(T, C)``
    ``availability`` array.  An explicitly passed schedule/array wins over
    the ambient profile's (the profile is only the default source).  Client
    ``i`` participates in round ``r`` iff its scheduled availability at step
    ``r`` (cycling) is ``>= threshold`` — one schedule row per aggregation
    round (or per cluster event in the async scheduler), not per protocol
    iteration.
    """
    if schedule is not None:
        avail = np.asarray(schedule.availability, dtype=np.float64)
    elif availability is not None:
        avail = np.atleast_2d(np.asarray(availability, dtype=np.float64))
    elif profile is not None and getattr(profile, "schedule", None) is not None:
        avail = np.asarray(profile.schedule.availability, dtype=np.float64)
    else:
        raise ValueError(
            "trace participation needs a TraceSchedule (e.g. from a 2-D "
            "'trace' device profile) or a (T, C) 'availability' array"
        )
    if avail.ndim != 2 or avail.shape[1] != clusters.num_clients:
        raise ValueError(
            f"trace availability has shape {avail.shape}, expected "
            f"(T, {clusters.num_clients})"
        )
    t_len = avail.shape[0]

    def mask(r: int) -> np.ndarray:
        return avail[r % t_len] >= threshold

    return mask


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

class ParticipationPlan:
    """Per-round participation masks + renormalized intra-cluster weights.

    ``weights(r)`` is the vector every backend's ``transition(...,
    weights=...)`` consumes; ``stacked_weights(r0, R)`` stacks ``R``
    consecutive rounds into the ``(R, C)`` array a superstep takes (values
    change per round, shapes never do, so one captured CUDA graph serves
    every round, subset and ``k``).
    """

    def __init__(self, strategy: str, clusters: ClusterSpec, seed: int = 0,
                 **params):
        if strategy not in PARTICIPATION_REGISTRY:
            raise KeyError(
                f"unknown participation strategy {strategy!r}; registered: "
                f"{sorted(PARTICIPATION_REGISTRY)}"
            )
        self.strategy = strategy
        self.clusters = clusters
        self.seed = int(seed)
        self.params = dict(params)
        self._m_hat = clusters.m_hat()
        self._assign = np.asarray(clusters.assignments, dtype=np.int64)
        self._mask_fn = PARTICIPATION_REGISTRY[strategy](
            clusters, seed=self.seed, **params
        )

    @property
    def is_full(self) -> bool:
        """True when every client participates every round (legacy path)."""
        return self.strategy == "full"

    def mask(self, r: int) -> np.ndarray:
        """Boolean (C,) participation mask for round ``r`` (deterministic)."""
        return self._mask_fn(r)

    def weights(self, r: int) -> np.ndarray:
        """Masked-and-renormalized (C,) intra-cluster weights for round ``r``.

        For the ``full`` strategy this returns the exact ``m^`` vector (no
        renormalization arithmetic), so full participation is bitwise the
        static-weight path.
        """
        if self.is_full:
            return self._m_hat.copy()
        return renormalize_weights(self._m_hat, self._assign, self.mask(r))

    def effective_mask(self, r: int) -> np.ndarray:
        """Clients whose models actually enter round ``r``'s aggregation.

        ``mask(r)`` with empty clusters backfilled to their full membership —
        the exact set ``renormalize_weights``'s fallback aggregates — so
        wall-clock pacing charges every client that uploads, including a
        straggler pulled back in by its cluster's fallback.
        """
        mask = self.mask(r)
        has = np.zeros(self.clusters.num_clusters, dtype=bool)
        np.logical_or.at(has, self._assign, mask)
        return np.where(has[self._assign], mask, True)

    def stacked_weights(self, start_round: int, num_rounds: int) -> np.ndarray:
        """(num_rounds, C) weights for rounds start_round..start_round+R-1."""
        return np.stack(
            [self.weights(start_round + i) for i in range(num_rounds)]
        )

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        extra = "".join(f", {k}={v!r}" for k, v in self.params.items())
        return (f"ParticipationPlan({self.strategy!r}, "
                f"C={self.clusters.num_clients}, seed={self.seed}{extra})")


ParticipationSpec = Union[str, dict, ParticipationPlan, None]


def resolve_plan(
    spec: ParticipationSpec,
    clusters: ClusterSpec,
    profile=None,
    seed: int = 0,
) -> Optional[ParticipationPlan]:
    """Resolve a scenario's ``"participation"`` key into a plan (or None).

    Accepts a strategy name, a ``{"strategy": name, **params}`` dict, an
    already-built :class:`ParticipationPlan` (validated for size), or
    ``None``.  ``profile`` is forwarded to strategies that read the fleet
    (``availability``, ``trace``) unless the spec pins its own; ``seed``
    seeds the draws unless the spec pins one.
    """
    if spec is None:
        return None
    if isinstance(spec, ParticipationPlan):
        if spec.clusters.num_clients != clusters.num_clients:
            raise ValueError(
                f"participation plan covers {spec.clusters.num_clients} "
                f"clients, scenario has {clusters.num_clients}"
            )
        return spec
    if isinstance(spec, str):
        strategy, params = spec, {}
    else:
        params = dict(spec)
        strategy = params.pop("strategy")
    params.setdefault("seed", seed)
    if strategy in ("availability", "trace"):
        params.setdefault("profile", profile)
    return ParticipationPlan(strategy, clusters, **params)
