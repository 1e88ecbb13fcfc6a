"""Device-heterogeneity profiles: per-client compute/link/availability fleets.

A numpy copy of ``repro.hetero.profiles`` so the port never imports the JAX
package; a seed draws the same fleet in both.

The paper's second pillar is *device heterogeneity*: clients differ in
compute speed (stragglers pace synchronous rounds, Fig. 10) and the
asynchronous algorithm of Section IV exists precisely to absorb that
variance.  A :class:`DeviceProfile` captures one simulated fleet:

* ``speeds`` — per-client relative compute speed ``h_i`` with the paper's
  normalization ``min h_i == 1`` (the slowest device is the §V-B reference
  CPU, so ``LatencyModel.t_comp(h_i)`` prices every client).
* ``bandwidths`` — per-client uplink scale relative to the paper's
  ``R^{ct-sr}``; a client at 0.5 uploads at half the Table-I rate.
* ``availability`` — per-client probability of being reachable when an
  iteration starts; the dropout process draws geometric retry counts from
  it (a device that is down delays its cluster by one compute deadline),
  and ``ParticipationPlan("availability")`` Bernoulli-samples it per round.
  ``availability == 0`` is legal: a permanently-dead client is meaningful
  under participation sampling (it simply never aggregates; the retry
  pricing caps its delay at ``timing.MAX_ATTEMPTS`` service times).

Fleets are drawn by *registered samplers* — ``uniform``,
``bimodal-straggler``, ``exponential``, ``trace`` — so scenarios name their
device mix the same way they name topologies.  ``sample_profile`` accepts a
name, a ``{"kind": name, ...params}`` dict, or a ready profile.

The ``trace`` sampler additionally accepts *time-varying* schedules: 2-D
``(T, n)`` ``speeds``/``availability`` arrays become a
:class:`TraceSchedule` attached to the profile (``profile.schedule``); the
static profile columns are the schedule's per-client time averages, and the
schedule itself drives trace-replay participation
(``ParticipationPlan("trace")`` advances one row per aggregation round) and
any other consumer via ``speeds_at(t)`` / ``availability_at(t)`` (cycling
when a run outlives the trace).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import numpy as np

__all__ = [
    "DeviceProfile",
    "TraceSchedule",
    "MAX_ATTEMPTS",
    "PROFILE_REGISTRY",
    "register_profile",
    "sample_profile",
]

# Bound on dropout retries per event: keeps Lemma-4 iteration gaps finite
# even under availability -> 0 (a device that never answers is eventually
# skipped by the edge server, not waited on forever).  Also the floor on
# effective pacing speed: availability below 1/MAX_ATTEMPTS prices like
# exactly MAX_ATTEMPTS retries.
MAX_ATTEMPTS = 10


@dataclasses.dataclass(frozen=True)
class TraceSchedule:
    """Time-varying per-device measurements: one row per schedule step.

    ``speeds[t, i]`` / ``availability[t, i]`` are device ``i``'s relative
    compute speed and up-probability at step ``t``; consumers cycle through
    the trace when a run is longer than it (``t % num_steps``) and choose
    the step granularity: ``ParticipationPlan("trace")`` advances one row
    per aggregation *round* (sync/round schedulers) or per cluster *event*
    (async), while a per-iteration pacing consumer may index per protocol
    iteration.
    """

    speeds: np.ndarray        # (T, N), > 0
    availability: np.ndarray  # (T, N), in [0, 1]

    def __post_init__(self):
        speeds = np.asarray(self.speeds, dtype=np.float64)
        avail = np.asarray(self.availability, dtype=np.float64)
        if speeds.ndim != 2 or avail.shape != speeds.shape:
            raise ValueError(
                "trace schedule needs matching 2-D (T, N) speed and "
                f"availability arrays; got {speeds.shape} / {avail.shape}"
            )
        if np.any(speeds <= 0):
            raise ValueError("trace speeds must be positive")
        if np.any(avail < 0) or np.any(avail > 1):
            raise ValueError("trace availability must lie in [0, 1]")
        object.__setattr__(self, "speeds", speeds)
        object.__setattr__(self, "availability", avail)

    @property
    def num_steps(self) -> int:
        return self.speeds.shape[0]

    @property
    def num_clients(self) -> int:
        return self.speeds.shape[1]

    def speeds_at(self, t: int) -> np.ndarray:
        return self.speeds[t % self.num_steps]

    def availability_at(self, t: int) -> np.ndarray:
        return self.availability[t % self.num_steps]


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """One simulated client fleet (immutable; arrays are per-client)."""

    speeds: np.ndarray        # h_i >= 1, min == 1 (slowest device = reference)
    bandwidths: np.ndarray    # uplink scale vs. paper R^{ct-sr}; > 0
    availability: np.ndarray  # P(device up at iteration start); in [0, 1]
    name: str = "custom"
    schedule: Optional["TraceSchedule"] = None  # time-varying trace, if any

    def __post_init__(self):
        speeds = np.asarray(self.speeds, dtype=np.float64)
        bw = np.asarray(self.bandwidths, dtype=np.float64)
        avail = np.asarray(self.availability, dtype=np.float64)
        n = len(speeds)
        if bw.shape != (n,) or avail.shape != (n,):
            raise ValueError("speeds, bandwidths, availability must share length")
        if np.any(speeds <= 0) or np.any(bw <= 0):
            raise ValueError("speeds and bandwidths must be positive")
        # 0 is legal: a permanently-dead client only matters to participation
        # sampling and the (capped) retry pricing, both of which handle it.
        if np.any(avail < 0) or np.any(avail > 1):
            raise ValueError("availability must lie in [0, 1]")
        if self.schedule is not None and self.schedule.num_clients != n:
            raise ValueError(
                f"trace schedule covers {self.schedule.num_clients} clients, "
                f"profile has {n}"
            )
        object.__setattr__(self, "speeds", speeds)
        object.__setattr__(self, "bandwidths", bw)
        object.__setattr__(self, "availability", avail)

    @property
    def num_clients(self) -> int:
        return len(self.speeds)

    def heterogeneity(self) -> float:
        """H = max h / min h, the paper's heterogeneity gap."""
        return float(self.speeds.max() / self.speeds.min())

    def effective_speeds(self) -> np.ndarray:
        """Availability-discounted throughput: expected useful speed.

        A device up with probability ``a`` needs ``1/a`` attempts per useful
        iteration in expectation, so its long-run pacing speed is ``h * a``
        — floored at ``h / MAX_ATTEMPTS``, the capped-retry model: after
        ``MAX_ATTEMPTS`` deadlines the edge server skips the device rather
        than waiting on it, so ``a == 0`` prices finitely.
        """
        return self.speeds * np.maximum(self.availability, 1.0 / MAX_ATTEMPTS)

    @staticmethod
    def homogeneous(num_clients: int) -> "DeviceProfile":
        """The implicit pre-heterogeneity fleet: every client is the reference."""
        ones = np.ones(num_clients)
        return DeviceProfile(ones, ones.copy(), ones.copy(), name="homogeneous")


# ---------------------------------------------------------------------------
# Registered samplers
# ---------------------------------------------------------------------------

ProfileSampler = Callable[..., DeviceProfile]

PROFILE_REGISTRY: dict[str, ProfileSampler] = {}


def register_profile(name: str):
    """Register a fleet sampler ``(num_clients, seed=0, **params) -> DeviceProfile``."""

    def deco(fn: ProfileSampler) -> ProfileSampler:
        PROFILE_REGISTRY[name] = fn
        return fn

    return deco


def _normalize_speeds(h: np.ndarray) -> np.ndarray:
    """Pin the slowest device to h == 1 (the §V-B reference CPU)."""
    return h / h.min()


@register_profile("uniform")
def uniform_profile(
    num_clients: int,
    seed: int = 0,
    heterogeneity: float = 5.0,
    bandwidth_spread: float = 1.0,
    availability: float = 1.0,
) -> DeviceProfile:
    """Speeds ~ U(1, H) with the extremes pinned (Fig. 10's H sweep)."""
    from ..core.async_engine import make_speeds

    if heterogeneity < 1.0:
        raise ValueError("heterogeneity gap H must be >= 1")
    h = _normalize_speeds(make_speeds(num_clients, heterogeneity, seed=seed))
    # independent stream for the link draws so they don't mirror the speeds
    rng = np.random.default_rng([seed, 1])
    bw = rng.uniform(1.0 / bandwidth_spread, bandwidth_spread, size=num_clients) \
        if bandwidth_spread > 1.0 else np.ones(num_clients)
    avail = np.full(num_clients, float(availability))
    return DeviceProfile(h, bw, avail, name="uniform")


@register_profile("bimodal-straggler")
def bimodal_straggler_profile(
    num_clients: int,
    seed: int = 0,
    straggler_frac: float = 0.25,
    speedup: float = 10.0,
    straggler_bandwidth: float = 0.5,
    availability: float = 1.0,
) -> DeviceProfile:
    """A slow minority paces the fleet: the Fig. 8-10 straggler regime.

    ``straggler_frac`` of clients run at the reference speed 1 on a degraded
    link (``straggler_bandwidth``); everyone else runs ``speedup``x faster on
    the nominal link.  At least one straggler and one fast device always
    exist so the heterogeneity gap equals ``speedup`` exactly.
    """
    if not 0.0 < straggler_frac < 1.0:
        raise ValueError("straggler_frac must be in (0, 1)")
    rng = np.random.default_rng(seed)
    n_slow = int(np.clip(round(straggler_frac * num_clients), 1, num_clients - 1))
    slow = np.zeros(num_clients, dtype=bool)
    slow[rng.choice(num_clients, size=n_slow, replace=False)] = True
    h = np.where(slow, 1.0, float(speedup))
    bw = np.where(slow, float(straggler_bandwidth), 1.0)
    avail = np.full(num_clients, float(availability))
    return DeviceProfile(h, bw, avail, name="bimodal-straggler")


@register_profile("exponential")
def exponential_profile(
    num_clients: int,
    seed: int = 0,
    scale: float = 2.0,
    availability: float = 1.0,
) -> DeviceProfile:
    """Heavy-tailed speeds 1 + Exp(scale): a few very fast devices."""
    rng = np.random.default_rng(seed)
    h = _normalize_speeds(1.0 + rng.exponential(scale, size=num_clients))
    bw = np.ones(num_clients)
    avail = np.full(num_clients, float(availability))
    return DeviceProfile(h, bw, avail, name="exponential")


@register_profile("trace")
def trace_profile(
    num_clients: int,
    seed: int = 0,
    speeds: Optional[np.ndarray] = None,
    bandwidths: Optional[np.ndarray] = None,
    availability: Optional[np.ndarray] = None,
) -> DeviceProfile:
    """Replay measured per-device traces, cycling when shorter than the fleet.

    ``speeds`` is required; bandwidth/availability default to nominal.

    Static mode (1-D arrays): one measurement per device, cycled over the
    fleet.

    Time-varying mode (2-D ``(T, n)`` ``speeds`` and/or ``availability``):
    per-iteration schedules become a :class:`TraceSchedule` on
    ``profile.schedule`` (a 1-D counterpart array is broadcast across the
    ``T`` rows).  The profile's static columns are the schedule's
    per-client time averages — they price deadlines/retries in the mean —
    while the schedule itself drives trace-replay participation
    (``ParticipationPlan("trace")``) and any per-iteration consumer.
    Speeds are normalized by the *global* trace minimum, so the
    slowest-ever measurement is the §V-B reference device.
    """
    if speeds is None:
        raise ValueError("trace profile requires a 'speeds' array")
    speeds = np.asarray(speeds, dtype=np.float64)
    avail_in = None if availability is None else np.asarray(
        availability, dtype=np.float64
    )

    def tile_cols(arr):
        """Cycle per-device columns up to the fleet size (1-D or 2-D rows)."""
        reps = -(-num_clients // arr.shape[-1])
        return np.tile(arr, (1,) * (arr.ndim - 1) + (reps,))[..., :num_clients]

    if speeds.ndim == 1 and (avail_in is None or avail_in.ndim == 1):
        # static mode: one measurement per device
        def tile(arr, fill):
            if arr is None:
                return np.full(num_clients, fill, dtype=np.float64)
            return tile_cols(np.asarray(arr, dtype=np.float64))

        return DeviceProfile(
            _normalize_speeds(tile(speeds, 1.0)),
            tile(bandwidths, 1.0),
            tile(availability, 1.0),
            name="trace",
        )

    # time-varying mode: align speed/availability columns and rows
    sp = tile_cols(np.atleast_2d(speeds))
    if avail_in is None:
        av = np.ones_like(sp)
    else:
        av = tile_cols(np.atleast_2d(avail_in))
    t_len = int(np.lcm(sp.shape[0], av.shape[0]))
    # near-coprime lengths (e.g. 1439 vs 1440 rows) only align after an
    # enormous joint period — refuse to materialize it rather than OOM
    if t_len > 100_000:
        raise ValueError(
            f"trace speed/availability lengths {sp.shape[0]} / {av.shape[0]} "
            f"only align after {t_len} rows; resample one trace so the "
            f"lengths share a small common multiple"
        )
    sp = np.tile(sp, (t_len // sp.shape[0], 1))
    av = np.tile(av, (t_len // av.shape[0], 1))
    schedule = TraceSchedule(sp / sp.min(), av)

    def tile_static(arr, fill):
        if arr is None:
            return np.full(num_clients, fill, dtype=np.float64)
        arr = np.asarray(arr, dtype=np.float64)
        if arr.ndim != 1:
            raise ValueError("trace bandwidths must be 1-D (static)")
        return tile_cols(arr)

    return DeviceProfile(
        schedule.speeds.mean(axis=0),
        tile_static(bandwidths, 1.0),
        schedule.availability.mean(axis=0),
        name="trace",
        schedule=schedule,
    )


ProfileSpec = Union[str, dict, DeviceProfile, None]


def sample_profile(spec: ProfileSpec, num_clients: int, seed: int = 0) -> DeviceProfile:
    """Resolve a profile spec into a concrete fleet.

    Accepts a registered sampler name, a ``{"kind": name, **params}`` dict,
    an already-built :class:`DeviceProfile` (validated for size), or ``None``
    (the homogeneous reference fleet).
    """
    if spec is None:
        return DeviceProfile.homogeneous(num_clients)
    if isinstance(spec, DeviceProfile):
        if spec.num_clients != num_clients:
            raise ValueError(
                f"profile has {spec.num_clients} clients, scenario has {num_clients}"
            )
        return spec
    if isinstance(spec, str):
        kind, params = spec, {}
    else:
        params = dict(spec)
        kind = params.pop("kind")
    if kind not in PROFILE_REGISTRY:
        raise KeyError(
            f"unknown device profile {kind!r}; registered: {sorted(PROFILE_REGISTRY)}"
        )
    params.setdefault("seed", seed)
    return PROFILE_REGISTRY[kind](num_clients, **params)
