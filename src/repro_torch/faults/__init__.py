"""Fault injection: topology churn and client failures as runtime operands.

A numpy copy of ``repro.faults`` (importing it would import JAX): the same
events give the same per-round graphs, masks and mixing matrices in both
packages.

SD-FEEL's analysis fixes the edge-server graph for the whole run; real edge
deployments lose links, lose whole edge servers, and see clients crash
mid-round.  This package makes those failures *schedulable* and compiles
them into per-round operands, so a ring that degrades to a line (and heals
back) changes the values of fixed-shape tensors — never a kernel or a
captured CUDA graph, as the participation weights do.

A :class:`FaultSchedule` holds a validated list of :class:`FaultEvent`\\ s
(registered kinds, extensible via :func:`register_fault_kind`):

=================  =========================================================
``link-down``      Edge ``(i, j)`` disappears from round ``round`` (until
                   ``until``, exclusive, or a matching ``link-up``).
``link-up``        Edge ``(i, j)`` (re)appears — heals a downed link or
                   rewires a new chord.
``server-down``    Edge server ``server`` goes dark: all its links drop and
                   its cluster falls back to local-only rounds (identity
                   row/column in the mixing matrix).
``server-up``      The server rejoins; its first round back applies the
                   eq-(22) staleness re-entry blend (gap = outage length)
                   instead of the regular gossip, so the stale model is
                   absorbed gradually, not averaged in at full weight.
``client-crash``   Client ``client`` stops participating from ``round``
                   (until ``until``); its weight in every aggregation of the
                   window is exactly 0 (mask folded into the participation
                   weights).
``uplink-drop``    Client ``client``'s upload fails for round ``round``
                   only: it is dropped from that round's aggregation and
                   ``FleetTiming.uplink_retry_penalty`` prices the edge
                   server's ``MAX_ATTEMPTS`` capped-backoff retries.
=================  =========================================================

From the schedule each round ``r`` gets, deterministically and in any
evaluation order (prefetch must agree with execution, and checkpoint resume
must replay the identical sequence):

* ``adjacency_at(r)`` — the surviving edge set;
* ``mixing_at(r)`` — a (D, D) mixing matrix built *per connected
  component*: each component of two or more servers gets the eq-(5) matrix
  of its subgraph with the component's renormalized data ratios (column
  sums 1 per component, the component's weighted mean is the fixed point);
  isolated servers — including every server behind an outage — get the
  identity (local-only rounds).  On a rejoin round the rejoiner's component
  instead applies the staleness re-entry matrix.
* ``mixing_stack(r0, R)`` — the per-round matrices stacked ``(R, D, D)``,
  the operand the round scheduler threads through each round's
  ``AggregationBackend.transition(..., p=...)`` (the sync scheduler takes
  ``mixing_at(r)``, one round at a time);
* ``client_mask(r)`` / ``uplink_failed(r)`` — who aggregates and whose
  retries the wall-clock pays.

``resolve_faults`` turns a scenario's ``"faults"`` spec (a JSON string, an
event list, a ``{"events": [...]}`` dict, or a built schedule) into a
``FaultSchedule`` — and returns ``None`` for an *empty* schedule, so a run
with no fault events takes the exact fault-free code path (bitwise
identical to a run with ``faults=None``).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Optional, Sequence, Union

import numpy as np

from ..core.protocol import ClusterSpec
from ..core.staleness import psi_constant, psi_exponential, psi_inverse, staleness_mixing_matrix
from ..core.topology import Topology, connected_components, mixing_matrix

__all__ = [
    "FaultEvent",
    "FaultSchedule",
    "FAULT_KINDS",
    "parse_fault_spec",
    "register_fault_kind",
    "resolve_faults",
    "validate_fault_events",
]


# ---------------------------------------------------------------------------
# Event kinds (registry)
# ---------------------------------------------------------------------------

# kind -> (required operand field, window allowed via `until`)
FAULT_KINDS: dict[str, tuple[str, bool]] = {}


def register_fault_kind(name: str, field: str, windowed: bool = True) -> None:
    """Register an event kind: ``field`` names its operand (``link`` |
    ``server`` | ``client``), ``windowed`` whether ``until`` is legal."""
    if field not in ("link", "server", "client"):
        raise ValueError(f"fault operand field must be link/server/client, got {field!r}")
    FAULT_KINDS[name] = (field, windowed)


register_fault_kind("link-down", "link")
register_fault_kind("link-up", "link", windowed=False)
register_fault_kind("server-down", "server")
register_fault_kind("server-up", "server", windowed=False)
register_fault_kind("client-crash", "client")
register_fault_kind("uplink-drop", "client", windowed=False)


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled failure (or recovery), effective from round ``round``.

    ``until`` (exclusive) auto-heals a windowed event; ``None`` means "until
    a matching recovery event, or forever".  Exactly one of ``link`` /
    ``server`` / ``client`` is set, per the kind's registered operand.
    """

    kind: str
    round: int
    link: Optional[tuple[int, int]] = None
    server: Optional[int] = None
    client: Optional[int] = None
    until: Optional[int] = None

    def to_dict(self) -> dict:
        out: dict = {"kind": self.kind, "round": self.round}
        for f in ("link", "server", "client", "until"):
            v = getattr(self, f)
            if v is not None:
                out[f] = list(v) if f == "link" else v
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "FaultEvent":
        d = dict(d)
        link = d.get("link")
        if link is not None:
            d["link"] = (int(link[0]), int(link[1]))
        return cls(**d)


def validate_fault_events(events: Sequence[Any]) -> list[FaultEvent]:
    """Parse + structurally validate an event list (no size information).

    Raises ``ValueError`` for unknown kinds, missing/extra operands, bad
    rounds or bad windows — the check ``RunConfig.validate()`` runs before
    any scheduler is built.  Range checks against D/C happen in
    :class:`FaultSchedule`, which knows the fleet size.
    """
    if not isinstance(events, (list, tuple)):
        raise ValueError(
            f"fault events must be a list of event dicts, got {type(events).__name__}"
        )
    out: list[FaultEvent] = []
    for i, raw in enumerate(events):
        ev = raw if isinstance(raw, FaultEvent) else None
        if ev is None:
            if not isinstance(raw, dict):
                raise ValueError(f"fault event #{i} must be a dict, got {raw!r}")
            unknown = set(raw) - {"kind", "round", "link", "server", "client", "until"}
            if unknown:
                raise ValueError(f"fault event #{i} has unknown fields {sorted(unknown)}")
            try:
                ev = FaultEvent.from_dict(raw)
            except TypeError as e:
                raise ValueError(f"malformed fault event #{i}: {e}") from e
        if ev.kind not in FAULT_KINDS:
            raise ValueError(
                f"fault event #{i}: unknown kind {ev.kind!r}; registered: "
                f"{sorted(FAULT_KINDS)}"
            )
        field, windowed = FAULT_KINDS[ev.kind]
        if not isinstance(ev.round, int) or ev.round < 0:
            raise ValueError(f"fault event #{i}: round must be an int >= 0, got {ev.round!r}")
        for f in ("link", "server", "client"):
            v = getattr(ev, f)
            if f == field and v is None:
                raise ValueError(f"fault event #{i} ({ev.kind}): missing {field!r}")
            if f != field and v is not None:
                raise ValueError(
                    f"fault event #{i} ({ev.kind}): unexpected operand {f!r}"
                )
        if ev.link is not None:
            if len(ev.link) != 2 or ev.link[0] == ev.link[1]:
                raise ValueError(
                    f"fault event #{i}: link must name two distinct servers, got {ev.link}"
                )
        if ev.until is not None:
            if not windowed:
                raise ValueError(f"fault event #{i} ({ev.kind}): 'until' not supported")
            if not isinstance(ev.until, int) or ev.until <= ev.round:
                raise ValueError(
                    f"fault event #{i}: until must be an int > round, got {ev.until!r}"
                )
        out.append(ev)
    return out


# ---------------------------------------------------------------------------
# Per-round state compilation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _RoundState:
    adjacency: np.ndarray          # (D, D) surviving edges (dead servers cut)
    server_alive: np.ndarray       # (D,) bool
    client_ok: np.ndarray          # (C,) bool — crashes + this round's uplink drops
    uplink_failed: np.ndarray      # (C,) bool — this round's terminal upload failures
    rejoins: dict                  # server -> outage gap, for rejoins at exactly r


_PSI = {"staleness": psi_inverse, "inverse": psi_inverse, "constant": psi_constant,
        "exponential": psi_exponential()}


class FaultSchedule:
    """Compiles fault events into per-round surviving graphs and operands.

    Everything is a pure function of the absolute round index ``r`` (events
    are replayed in ``(round, list order)``), so prefetch, execution and a
    checkpoint resume at any round all see the identical fault sequence —
    the schedule carries no mutable RNG state.
    """

    def __init__(self, topology: Topology, clusters: ClusterSpec,
                 events: Sequence[Any], psi: Union[str, Callable] = "staleness"):
        self.topology = topology
        self.clusters = clusters
        if topology.num_servers != clusters.num_clusters:
            raise ValueError(
                f"topology has {topology.num_servers} servers, clusters "
                f"{clusters.num_clusters}"
            )
        if isinstance(psi, str) and psi not in _PSI:
            raise ValueError(f"unknown psi {psi!r}; known: {sorted(_PSI)}")
        self.psi_name = psi if isinstance(psi, str) else getattr(psi, "__name__", repr(psi))
        self.psi = _PSI[psi] if isinstance(psi, str) else psi
        evs = validate_fault_events(events)
        d, c = topology.num_servers, clusters.num_clients
        for i, ev in enumerate(evs):
            if ev.link is not None and not all(0 <= x < d for x in ev.link):
                raise ValueError(f"fault event #{i}: link {ev.link} out of range for D={d}")
            if ev.server is not None and not 0 <= ev.server < d:
                raise ValueError(f"fault event #{i}: server {ev.server} out of range for D={d}")
            if ev.client is not None and not 0 <= ev.client < c:
                raise ValueError(f"fault event #{i}: client {ev.client} out of range for C={c}")
        # stable sort: same-round events apply in list order (last writer wins)
        self.events = sorted(evs, key=lambda e: e.round)
        self._ratios = np.asarray(clusters.m_tilde(), dtype=np.float64)
        self._state_cache: dict[int, _RoundState] = {}
        self._mix_cache: dict[int, np.ndarray] = {}

    @property
    def is_empty(self) -> bool:
        return not self.events

    def horizon(self) -> int:
        """First round after which the fault state no longer changes."""
        h = 0
        for ev in self.events:
            h = max(h, ev.round + 1, (ev.until or 0))
        return h

    # -- raw per-round state -------------------------------------------------
    def _state(self, r: int) -> _RoundState:
        if r in self._state_cache:
            return self._state_cache[r]
        d = self.topology.num_servers
        c = self.clusters.num_clients
        adj = self.topology.adjacency.astype(np.int64).copy()
        alive = np.ones(d, dtype=bool)
        down_at = np.full(d, -1, dtype=np.int64)   # round the current outage began
        rejoins: dict[int, int] = {}
        client_ok = np.ones(c, dtype=bool)
        uplink = np.zeros(c, dtype=bool)

        # Replay in (round, list) order, computing the state *at* round r:
        # a healed windowed event is a no-op on the surviving state (the
        # pre-event value was never disturbed in this replay) except for
        # rejoin bookkeeping when the window closes exactly at r.
        for ev in self.events:
            if ev.round > r:
                break
            healed = ev.until is not None and ev.until <= r
            if ev.kind == "link-down":
                if not healed:
                    i, j = ev.link
                    adj[i, j] = adj[j, i] = 0
            elif ev.kind == "link-up":
                i, j = ev.link
                adj[i, j] = adj[j, i] = 1
            elif ev.kind == "server-down":
                s = ev.server
                if healed:
                    if ev.until == r and alive[s]:
                        rejoins[s] = ev.until - ev.round
                elif alive[s]:
                    alive[s] = False
                    down_at[s] = ev.round
                    rejoins.pop(s, None)
            elif ev.kind == "server-up":
                s = ev.server
                if not alive[s]:
                    alive[s] = True
                    if ev.round == r and down_at[s] >= 0:
                        rejoins[s] = r - int(down_at[s])
                    down_at[s] = -1
            elif ev.kind == "client-crash":
                if not healed:
                    client_ok[ev.client] = False
            elif ev.kind == "uplink-drop":
                if ev.round == r:
                    client_ok[ev.client] = False
                    uplink[ev.client] = True
        # a dead server takes all its links with it
        if not alive.all():
            adj[~alive, :] = 0
            adj[:, ~alive] = 0
        st = _RoundState(adj, alive, client_ok, uplink, rejoins)
        self._state_cache[r] = st
        return st

    def adjacency_at(self, r: int) -> np.ndarray:
        """(D, D) surviving edge set of round ``r`` (dead servers isolated)."""
        return self._state(r).adjacency.copy()

    def server_alive(self, r: int) -> np.ndarray:
        """(D,) bool — edge servers up in round ``r``."""
        return self._state(r).server_alive.copy()

    def client_mask(self, r: int) -> np.ndarray:
        """(C,) bool — clients whose update enters round ``r``'s aggregation.

        ``False`` for crashed clients and for this round's uplink drops; the
        schedulers AND this into the participation plan's mask and
        renormalize, so a faulted client's weight is exactly 0.
        """
        return self._state(r).client_ok.copy()

    def uplink_failed(self, r: int) -> np.ndarray:
        """(C,) bool — round ``r``'s terminal upload failures (for pricing)."""
        return self._state(r).uplink_failed.copy()

    def rejoined_at(self, r: int) -> dict:
        """``{server: outage length}`` for servers whose outage ends at ``r``."""
        return dict(self._state(r).rejoins)

    # -- per-round mixing matrices (the topology axis) -----------------------
    def mixing_at(self, r: int) -> np.ndarray:
        """(D, D) float64 mixing matrix of round ``r``'s surviving graph.

        Per connected component of two or more servers, the eq-(5) matrix of
        the subgraph with the component's renormalized data ratios — column
        sums are 1 per component and the component's weighted mean is its
        fixed point, so each island keeps consensus among itself.  Isolated
        servers (including every server in an outage) get the identity:
        local-only rounds.  A component containing a rejoining server applies
        the eq-(22) staleness re-entry matrix instead (gap = outage length),
        so the stale model is blended back gradually.
        """
        if r in self._mix_cache:
            return self._mix_cache[r]
        st = self._state(r)
        d = self.topology.num_servers
        p = np.eye(d)
        for comp in connected_components(st.adjacency):
            comp_set = set(int(x) for x in comp)
            rejoiners = [s for s in st.rejoins if s in comp_set]
            if rejoiners:
                s_mat = np.eye(d)
                for s in rejoiners:
                    gaps = np.zeros(d)
                    gaps[s] = float(st.rejoins[s])
                    s_mat = s_mat @ staleness_mixing_matrix(
                        st.adjacency, s, gaps, self.psi
                    )
                p[np.ix_(comp, comp)] = s_mat[np.ix_(comp, comp)]
            elif len(comp) >= 2:
                sub = Topology(
                    "component", len(comp),
                    st.adjacency[np.ix_(comp, comp)],
                )
                ratios = self._ratios[comp]
                p[np.ix_(comp, comp)] = mixing_matrix(sub, ratios / ratios.sum())
        self._mix_cache[r] = p
        return p

    def mixing_stack(self, start_round: int, num_rounds: int,
                     require_ring_stencil: bool = False) -> np.ndarray:
        """(num_rounds, D, D) float32 stack for rounds ``start_round`` on.

        This is the per-round operand of a superstep: values change with the
        surviving edge set, shapes never do, so topology churn reuses one
        captured graph.  ``require_ring_stencil`` verifies on the host (where
        the values are known) that every matrix stays on the ring stencil —
        the structural constraint of the collective backend's ring gossip —
        and raises with the offending round.
        """
        stack = np.stack(
            [self.mixing_at(start_round + i) for i in range(num_rounds)]
        ).astype(np.float32)
        if require_ring_stencil:
            from ..core.aggregation import ring_mixing_weights

            for i in range(num_rounds):
                try:
                    ring_mixing_weights(stack[i].astype(np.float64))
                except ValueError as e:
                    raise ValueError(
                        f"faulted mixing matrix of round {start_round + i} "
                        f"leaves the ring stencil ({e}); the collective "
                        f"backend cannot apply it — use dense/cuda for "
                        f"this fault trace"
                    ) from e
        return stack

    # -- serialization (checkpoints, scenario describe) ----------------------
    def describe(self) -> dict:
        """JSON-safe spec: embedding this in checkpoint metadata pins the
        fault sequence, so a mid-outage resume replays it identically."""
        return {
            "events": [ev.to_dict() for ev in self.events],
            "psi": self.psi_name,
        }

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"FaultSchedule({len(self.events)} events, "
                f"D={self.topology.num_servers}, C={self.clusters.num_clients})")


# ---------------------------------------------------------------------------
# Spec resolution
# ---------------------------------------------------------------------------

FaultSpec = Union[str, dict, list, FaultSchedule, None]


def parse_fault_spec(spec) -> tuple[list, str]:
    """``(events, psi)`` of an event list, a ``{"events": [...], "psi": ...}``
    dict, or a JSON string of either; the events are not validated here."""
    if isinstance(spec, str):
        try:
            spec = json.loads(spec)
        except json.JSONDecodeError as e:
            raise ValueError(f"faults spec is not valid JSON: {e}") from e
    if isinstance(spec, dict):
        unknown = set(spec) - {"events", "psi"}
        if unknown:
            raise ValueError(f"faults spec has unknown keys {sorted(unknown)}")
        return spec.get("events", []), spec.get("psi", "staleness")
    if not isinstance(spec, (list, tuple)):
        raise TypeError(f"faults must be an event list, spec dict, JSON string or "
                        f"FaultSchedule, got {type(spec).__name__}")
    return spec, "staleness"


def resolve_faults(spec: FaultSpec, topology: Topology, clusters: ClusterSpec,
                   **_ignored) -> Optional[FaultSchedule]:
    """Resolve a scenario's ``"faults"`` key into a schedule (or ``None``).

    Accepts ``None``, a built :class:`FaultSchedule` (size-checked), an
    event list, a ``{"events": [...], "psi": ...}`` dict, or a JSON string
    of either.  An *empty* schedule resolves to ``None`` so that zero fault
    events and ``faults=None`` take the identical (fault-free, bitwise
    unchanged) scheduler code path.
    """
    if spec is None:
        return None
    if isinstance(spec, FaultSchedule):
        if (spec.topology.num_servers != topology.num_servers
                or spec.clusters.num_clients != clusters.num_clients):
            raise ValueError(
                f"fault schedule built for D={spec.topology.num_servers}/"
                f"C={spec.clusters.num_clients}, scenario has "
                f"D={topology.num_servers}/C={clusters.num_clients}"
            )
        return None if spec.is_empty else spec
    events, psi = parse_fault_spec(spec)
    sched = FaultSchedule(topology, clusters, events, psi=psi)
    return None if sched.is_empty else sched
