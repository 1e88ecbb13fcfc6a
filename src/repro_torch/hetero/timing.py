"""Fleet-aware wall-clock pricing: DeviceProfile x LatencyModel -> times.

A numpy copy of ``repro.hetero.timing`` so the port never imports the JAX
package.  The async path wires ``cluster_service_times``,
``cluster_availability`` and ``dropout_process``; ``sync_event_time`` and
``uplink_retry_penalty`` come along for the fleet slice.

§V-B prices every iteration with *global* constants (one CPU rate, one
uplink rate).  With a :class:`DeviceProfile` the same primitives
become per-client:

* synchronous regimes are paced by the *slowest effective* client — the
  straggler effect the async algorithm exists to fix;
* the async event queue gets *per-cluster* service times (each cluster's
  deadline is set by its own slowest member and narrowest uplink), which is
  what makes the eq. 21-22 iteration gaps non-degenerate;
* an optional dropout process draws geometric retry counts from the
  availability vector, so flaky devices stretch their cluster's gaps.

All times remain the §V-B units (seconds) so accuracy-vs-time histories are
comparable across sync / round / async under one profile.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core.latency import LatencyModel
from ..core.protocol import ClusterSpec
from .profiles import MAX_ATTEMPTS, DeviceProfile

__all__ = ["FleetTiming", "ClusterDropout", "MAX_ATTEMPTS"]


class ClusterDropout:
    """Geometric retry process driven by per-cluster availability.

    When cluster ``d`` schedules its next iteration, the number of attempts
    until every required device is up is geometric in the cluster's
    availability; each failed attempt costs one full service time.  Draws
    are deterministic given ``seed``.
    """

    def __init__(self, availability: np.ndarray, seed: int = 0):
        avail = np.asarray(availability, dtype=np.float64)
        if np.any(avail < 0) or np.any(avail > 1):
            raise ValueError("availability must lie in [0, 1]")
        self.availability = avail
        self._rng = np.random.default_rng(seed)

    def attempts(self, d: int) -> int:
        """Total attempts (>= 1) for cluster ``d``'s next iteration.

        ``availability == 0`` (a permanently-dead member — meaningful under
        participation sampling) is priced at the retry cap rather than a
        geometric draw: the edge server gives up after ``MAX_ATTEMPTS``
        deadlines, it does not wait forever.
        """
        a = self.availability[d]
        if a >= 1.0:
            return 1
        if a <= 0.0:
            return MAX_ATTEMPTS
        return int(min(self._rng.geometric(a), MAX_ATTEMPTS))


@dataclasses.dataclass(frozen=True)
class FleetTiming:
    """Prices protocol events for one fleet under one latency model."""

    profile: DeviceProfile
    latency: Optional[LatencyModel] = None

    # -- time-varying fleets -------------------------------------------------
    def _effective_speeds(self, t: Optional[int]) -> np.ndarray:
        """Availability-discounted pacing speeds, per round when traced.

        A profile carrying a :class:`~repro_torch.hetero.TraceSchedule` is priced
        by the *round's actual row* — ``speeds_at(t)`` discounted by
        ``availability_at(t)`` with the same ``1 / MAX_ATTEMPTS`` capped-
        retry floor as the static path — instead of collapsing the trace to
        its time average.  ``t`` is the aggregation-round index (the same
        granularity ``ParticipationPlan("trace")`` replays); without a
        schedule, or with ``t=None``, the static pricing is unchanged.
        """
        sched = self.profile.schedule
        if t is None or sched is None:
            return self.profile.effective_speeds()
        return sched.speeds_at(t) * np.maximum(
            sched.availability_at(t), 1.0 / MAX_ATTEMPTS
        )

    # -- synchronous pacing --------------------------------------------------
    def sync_event_time(
        self, event: str, alpha: int = 1, participants=None, clusters=None,
        t: Optional[int] = None,
    ) -> float:
        """Per-iteration wall-clock of a synchronous step under this fleet.

        Local compute waits for the slowest *effective* client (speed
        discounted by availability: a device that answers half the time
        halves its useful speed in expectation); uploads at aggregation
        events wait for the narrowest uplink.  Availability is floored at
        ``1 / MAX_ATTEMPTS`` — the capped-retry model: a dead device is
        skipped after ``MAX_ATTEMPTS`` deadlines, never divided by.

        ``participants`` (optional boolean mask) restricts pacing to the
        round's participating clients — the wall-clock upside of sampling:
        an unsampled straggler paces nothing.  Pass the plan's
        ``effective_mask`` (empty clusters backfilled), not the raw mask, so
        clients pulled back in by the aggregation fallback are charged; a
        mask with no participants at all falls back to the full fleet.

        ``clusters`` (optional ``ClusterSpec``) prices the event along the
        per-cluster critical path: each edge server waits for *its own*
        slowest member's compute plus *its own* narrowest participating
        uplink, and the global step finishes when the last server does.
        Without it the event is priced by the fleet-global worst compute
        plus the fleet-global worst uplink — an envelope that can charge a
        single round the slow CPU of one cluster *and* the narrow link of
        another, quantizing every sampled round to the same straggler bound.

        ``t`` (optional round index) prices a trace-scheduled fleet by the
        round's actual speeds/availability instead of the trace's time
        average — see :meth:`_effective_speeds`.
        """
        if self.latency is None:
            return 0.0
        eff = self._effective_speeds(t)
        bw = self.profile.bandwidths
        mask = None
        if participants is not None:
            mask = np.asarray(participants, dtype=bool)
            if not mask.any():
                mask = None
        if clusters is None:
            if mask is not None:
                eff = eff[mask]
                bw = bw[mask]
            t = self.latency.t_comp(float(eff.min()))
            if event in ("intra", "inter"):
                t += self.latency.t_comm_client_server(float(bw.min()))
        else:
            assign = np.asarray(clusters.assignments, dtype=np.int64)
            if mask is not None:
                assign = assign[mask]
                eff = eff[mask]
                bw = bw[mask]
            d = clusters.num_clusters
            eff_min = np.full(d, np.inf)
            np.minimum.at(eff_min, assign, eff)
            per_cluster = self.latency.t_comp(1.0) / np.where(
                np.isinf(eff_min), np.inf, eff_min
            )
            if event in ("intra", "inter"):
                bw_min = np.full(d, np.inf)
                np.minimum.at(bw_min, assign, bw)
                per_cluster = per_cluster + np.where(
                    np.isinf(bw_min), 0.0,
                    self.latency.t_comm_client_server(1.0) / np.maximum(
                        bw_min, 1e-300
                    ),
                )
            # clusters with no participants this round contribute nothing
            t = float(per_cluster[np.isfinite(per_cluster)].max())
        if event == "inter":
            t += alpha * self.latency.t_comm_server_server()
        return t

    # -- fault-injection pricing ---------------------------------------------
    def uplink_retry_penalty(self, failed, t: Optional[int] = None) -> float:
        """Extra wall-clock charged when the round's uplinks fail.

        ``failed`` is a boolean (C,) mask of clients whose upload was dropped
        this round (``FaultSchedule.uplink_failed``).  The edge server
        re-requests each failed upload with the same capped-backoff it uses
        for flaky devices: ``MAX_ATTEMPTS - 1`` retries over the client's
        uplink before it gives up and aggregates without them (the first
        attempt is already priced by :meth:`sync_event_time`).  The round
        waits for the slowest retried link, so the penalty is priced by the
        narrowest failed uplink.  ``t`` is unused today (bandwidths are not
        trace-scheduled) but keeps the signature round-indexed like the rest
        of the pricing surface.
        """
        del t
        if self.latency is None:
            return 0.0
        mask = np.asarray(failed, dtype=bool)
        if not mask.any():
            return 0.0
        bw_min = float(self.profile.bandwidths[mask].min())
        return (MAX_ATTEMPTS - 1) * self.latency.t_comm_client_server(bw_min)

    # -- asynchronous per-cluster service times ------------------------------
    def cluster_service_times(
        self, clusters: ClusterSpec, min_batches: int
    ) -> np.ndarray:
        """T_iter^(d): each cluster paced by its own slowest member + uplink.

        Matches ``AsyncConfig.iter_times`` for the homogeneous fleet
        (including its latency-free fallback units) and generalizes it with
        per-client bandwidths.  Availability is *not* folded in here — the
        dropout process charges retries explicitly so gaps stay stochastic.
        """
        h = self.profile.speeds
        bw = self.profile.bandwidths
        times = np.zeros(clusters.num_clusters)
        for d in range(clusters.num_clusters):
            idx = clusters.clients_of(d)
            slowest = float(h[idx].min())
            bw_min = float(bw[idx].min())
            if self.latency is None:
                comp = min_batches / slowest
                comm = 0.5 / bw_min
            else:
                comp = min_batches * self.latency.t_comp(slowest)
                comm = (
                    self.latency.t_comm_client_server(bw_min)
                    + self.latency.t_comm_server_server()
                )
            times[d] = comp + comm
        return times

    def cluster_availability(self, clusters: ClusterSpec) -> np.ndarray:
        """Per-cluster availability: the flakiest member gates the deadline."""
        return np.array(
            [
                float(self.profile.availability[clusters.clients_of(d)].min())
                for d in range(clusters.num_clusters)
            ]
        )

    def dropout_process(self, clusters: ClusterSpec, seed: int = 0) -> ClusterDropout:
        return ClusterDropout(self.cluster_availability(clusters), seed=seed)
