"""Port parity: fault injection (``repro_torch.faults``) and its schedulers.

The numpy module is a copy of ``repro.faults``: over a schedule's whole
horizon every round's surviving graph, server and client masks, uplink
failures, rejoins and mixing matrices equal the reference's exactly, and
malformed events are refused alike; ``from_edges`` and
``connected_components`` too.  Through the schedulers, both packages run
the same scenario from the same weights (JAX init, carried through numpy)
on the same batches: ``chaos-ring`` over 6 supersteps (12 rounds, past
every event, server 2's rejoin at round 8 included) and a faulted sync run
over 12 rounds stay within 1e-4 of JAX in parameters and losses and equal
it in wall-clock to 1e-9, on ``dense``, on the ``cuda`` backend's plain
path and on the ``collective`` backend (every faulted matrix of these traces
stays on the ring stencil); a faulted async run fires the reference's exact
``outage``, ``skipped`` and ``cluster`` events with ``y`` within 1e-4.  A
trace that rewires a chord leaves the stencil: ``mixing_stack(...,
require_ring_stencil=True)`` refuses it as the reference's does, naming the
round, and so does a collective scheduler at ``bind``.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.core.topology as jtopo
import repro.faults as jfaults
import repro.scenarios as jscenarios
import repro_torch.core as tcore
import repro_torch.core.topology as ttopo
import repro_torch.faults as tfaults
import repro_torch.scenarios as tscenarios
from repro_torch.convert import flatten_params, params_from_numpy, params_to_numpy

# six test workers share the host's cores: one intra-op thread each, also
# in the processes a test starts
os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(1)

CHAOS = tscenarios.get_scenario("chaos-ring").faults["events"]
TRACES = {
    "chaos-ring": (CHAOS, "ring", "staleness"),
    "every-kind": ([
        {"kind": "link-down", "round": 1, "link": [0, 3], "until": 4},
        {"kind": "server-down", "round": 2, "server": 2, "until": 5},
        {"kind": "client-crash", "round": 2, "client": 5, "until": 6},
        {"kind": "uplink-drop", "round": 3, "client": 1},
    ], "ring", "constant"),
    "explicit-recovery": ([
        {"kind": "server-down", "round": 1, "server": 0},
        {"kind": "link-down", "round": 2, "link": [1, 2]},
        {"kind": "server-up", "round": 4, "server": 0},
        {"kind": "link-up", "round": 5, "link": [1, 2]},
        {"kind": "link-up", "round": 5, "link": [0, 2]},  # a new chord
        {"kind": "client-crash", "round": 0, "client": 7},
    ], "ring", "exponential"),
    "torus-islands": ([
        {"kind": "link-down", "round": 0, "link": [0, 1]},
        {"kind": "link-down", "round": 0, "link": [2, 3]},
        {"kind": "server-down", "round": 2, "server": 3, "until": 3},
    ], "torus", "staleness"),
}


def _pair(topology, d=4, c=8):
    sizes = tuple(float(s) for s in np.random.default_rng(4).uniform(0.5, 2.0, c))
    assign = tuple(i * d // c for i in range(c))
    return ((jtopo.TOPOLOGIES[topology](d), jcore.ClusterSpec(c, assign, sizes)),
            (tcore.TOPOLOGIES[topology](d), tcore.ClusterSpec(c, assign, sizes)))


@pytest.mark.parametrize("name", sorted(TRACES))
def test_schedule_equals_reference_over_its_horizon(name):
    events, topology, psi = TRACES[name]
    (jt, jc), (tt, tc) = _pair(topology)
    js = jfaults.FaultSchedule(jt, jc, events, psi=psi)
    ts = tfaults.FaultSchedule(tt, tc, events, psi=psi)
    assert ts.horizon() == js.horizon() and ts.describe() == js.describe()
    for r in range(ts.horizon() + 2):
        for fn in ("adjacency_at", "server_alive", "client_mask", "uplink_failed", "mixing_at"):
            np.testing.assert_array_equal(getattr(ts, fn)(r), getattr(js, fn)(r),
                                          err_msg=f"{fn}({r})")
        assert ts.rejoined_at(r) == js.rejoined_at(r)
        # every column sums to 1: the transition stays column-stochastic
        np.testing.assert_allclose(ts.mixing_at(r).sum(axis=0), 1.0, atol=1e-12)
    stack = ts.mixing_stack(0, ts.horizon() + 1)
    assert stack.dtype == np.float32
    np.testing.assert_array_equal(stack, js.mixing_stack(0, js.horizon() + 1))


@pytest.mark.parametrize("name", sorted(TRACES))
def test_ring_stencil_gate_refuses_alike(name):
    events, topology, psi = TRACES[name]
    (jt, jc), (tt, tc) = _pair(topology)
    js = jfaults.FaultSchedule(jt, jc, events, psi=psi)
    ts = tfaults.FaultSchedule(tt, tc, events, psi=psi)
    n = ts.horizon() + 1
    try:
        ref, refused = js.mixing_stack(0, n, require_ring_stencil=True), None
    except ValueError as e:
        ref, refused = None, str(e)
    if refused is None:
        np.testing.assert_array_equal(ts.mixing_stack(0, n, require_ring_stencil=True), ref)
        return
    with pytest.raises(ValueError) as got:
        ts.mixing_stack(0, n, require_ring_stencil=True)
    # the same round and reason; the advice names the port's backends
    cut = "the collective backend cannot apply it"
    assert str(got.value).split(cut)[0] == refused.split(cut)[0]
    assert "leaves the ring stencil" in refused


def test_collective_schedulers_refuse_a_chord():
    events = TRACES["explicit-recovery"][0]
    for name in ("mnist-iid-ring", "round-compiled-ring"):
        with pytest.raises(ValueError, match="round 5 leaves the ring stencil"):
            tcore.make_run({"scenario": name, "num_samples": 200, "num_clients": 8,
                            "backend": "collective", "faults": events}, device="cpu")
    # async: each P_t is checked on the host as it is built (a chord from the
    # first round: the first event of one of its ends raises)
    chord = [{"kind": "link-up", "round": 0, "link": [0, 2]}]
    run = tscenarios.build_scenario("straggler-bimodal-async", device="cpu",
                                    backend="collective", faults=chord, **{
                                        k: v for k, v in ASYNC_KW.items() if k != "faults"})
    src = run.batch_source()
    with pytest.raises(ValueError, match="outside the ring stencil"):
        for _ in range(8):
            run.runtime.step(src)


def test_chaos_ring_rejoin_blends_by_staleness():
    ts = tfaults.resolve_faults({"events": CHAOS}, *_pair("ring")[1])
    assert not ts.server_alive(4)[2] and ts.server_alive(8)[2]
    assert ts.rejoined_at(8) == {2: 4}
    # down: an identity row and column for server 2; the rest one line component
    p = ts.mixing_at(5)
    np.testing.assert_array_equal(p[2], np.eye(4)[2])
    np.testing.assert_array_equal(p[:, 2], np.eye(4)[:, 2])
    assert not np.allclose(ts.mixing_at(8), ts.mixing_at(9))


BAD = [
    ([{"kind": "power-surge", "round": 0, "server": 1}], "unknown kind"),
    ([{"kind": "link-down", "round": 0}], "missing 'link'"),
    ([{"kind": "server-down", "round": 0, "server": 1, "client": 2}], "unexpected operand"),
    ([{"kind": "link-down", "round": -1, "link": [0, 1]}], "round must be"),
    ([{"kind": "link-down", "round": 0, "link": [1, 1]}], "distinct servers"),
    ([{"kind": "server-down", "round": 3, "server": 0, "until": 2}], "until must be"),
    ([{"kind": "uplink-drop", "round": 0, "client": 1, "until": 4}], "'until' not supported"),
    ([{"kind": "link-down", "round": 0, "link": [0, 1], "frequency": 2}], "unknown fields"),
    ("not-a-list", "must be a list"),
]


@pytest.mark.parametrize("bad,match", BAD)
def test_malformed_events_refused_alike(bad, match):
    for mod in (jfaults, tfaults):
        with pytest.raises(ValueError, match=match):
            mod.validate_fault_events(bad)
    with pytest.raises((ValueError, TypeError)):
        tcore.make_run({"scenario": "mnist-iid-ring", "num_samples": 400, "faults": bad},
                       device="cpu")


def test_resolve_faults_forms_and_refusals():
    _, (topo, spec) = _pair("ring")
    events = CHAOS[:2]
    for form in (events, {"events": events}, {"events": events, "psi": "staleness"},
                 json.dumps({"events": events})):
        sched = tfaults.resolve_faults(form, topo, spec)
        assert [e.to_dict() for e in sched.events] == events
    assert tfaults.resolve_faults(None, topo, spec) is None
    assert tfaults.resolve_faults([], topo, spec) is None  # empty: the fault-free path
    with pytest.raises(ValueError, match="out of range"):
        tfaults.FaultSchedule(topo, spec, [{"kind": "client-crash", "round": 0, "client": 8}])
    with pytest.raises(ValueError, match="unknown keys"):
        tfaults.resolve_faults({"events": [], "chaos": 1}, topo, spec)
    big = tfaults.FaultSchedule(tcore.ring(8), tcore.ClusterSpec.uniform(16, 8), events)
    with pytest.raises(ValueError, match="built for"):
        tfaults.resolve_faults(big, topo, spec)


@pytest.mark.parametrize("d,edges", [
    (4, [(0, 1), (1, 2), (2, 3), (3, 0)]),
    (5, [(0, 1), (2, 3), (3, 4)]),
    (6, [(0, 5)]),
])
def test_from_edges_and_components_equal_reference(d, edges):
    adj = np.zeros((d, d), dtype=np.int64)
    for i, j in edges:
        adj[i, j] = adj[j, i] = 1
    got, ref = ttopo.connected_components(adj), jtopo.connected_components(adj)
    assert [c.tolist() for c in got] == [c.tolist() for c in ref]
    if len(got) == 1:
        t, j = ttopo.from_edges(d, edges), jtopo.from_edges(d, edges)
        np.testing.assert_array_equal(t.adjacency, j.adjacency)
        assert [c.tolist() for c in t.connected_components()] == [list(range(d))]
    else:  # a disconnected edge set is no Topology, in either package
        for mod in (ttopo, jtopo):
            with pytest.raises(ValueError, match="not connected"):
                mod.from_edges(d, edges)
    for mod in (ttopo, jtopo):
        with pytest.raises(ValueError, match="duplicate"):
            mod.from_edges(d, edges + edges[:1])
        with pytest.raises(ValueError, match="self-loop"):
            mod.from_edges(d, [(0, 0)])


# -- chaos-ring (round supersteps) against the reference ------------------------

CHAOS_STEPS = 6  # 12 rounds at R = 2: past every event, the rejoin at round 8 included
CHAOS_KW = dict(num_samples=400, batch_size=2)


@pytest.fixture(scope="module")
def jax_chaos():
    jrun = jscenarios.build_scenario("chaos-ring", **CHAOS_KW)
    init = flatten_params(jax.tree.map(np.asarray, jrun.runtime.scheduler.params))
    src = jrun.batch_source()
    evs = [jrun.runtime.step(src) for _ in range(CHAOS_STEPS)]
    return {"init": init, "losses": np.concatenate([np.asarray(e.losses) for e in evs]),
            "dts": [e.dt for e in evs],
            "params": flatten_params(jax.tree.map(np.asarray, jrun.runtime.scheduler.params))}


@pytest.mark.parametrize("backend", ["dense", "cuda", "collective"])
def test_chaos_ring_tracks_jax(jax_chaos, backend):
    ref = jax_chaos
    trun = tscenarios.build_scenario("chaos-ring", device="cpu", backend=backend, **CHAOS_KW)
    sched = trun.runtime.scheduler
    assert sched.backend.name == backend and sched.axes.faults is not None
    assert sched.axes.faults.horizon() <= 2 * CHAOS_STEPS
    sched.params = params_from_numpy(ref["init"], "cpu")
    src = trun.batch_source()
    evs = [trun.runtime.step(src) for _ in range(CHAOS_STEPS)]
    np.testing.assert_allclose([e.dt for e in evs], ref["dts"], rtol=1e-9)
    got = np.concatenate([e.losses.numpy() for e in evs])
    np.testing.assert_allclose(got, ref["losses"], atol=1e-4)
    for k, v in params_to_numpy(sched.params).items():
        np.testing.assert_allclose(v, ref["params"][k], atol=1e-4, err_msg=k)


# -- a faulted sync run against the reference -----------------------------------

SYNC_KW = dict(num_clients=8, num_clusters=4, num_samples=400, tau1=1, tau2=1,
               profile={"kind": "uniform", "heterogeneity": 2.0},
               faults={"events": CHAOS})


@pytest.fixture(scope="module")
def jax_sync_faults():
    jrun = jscenarios.build_scenario("mnist-iid-ring", backend="dense", **SYNC_KW)
    init = jax.tree.map(np.asarray, jrun.runtime.scheduler.params)
    hist = jrun.runtime.run(12, jrun.batch_source(), jrun.eval_batch, eval_every=3)
    return {"init": init, "hist": hist,
            "params": jax.tree.map(np.asarray, jrun.runtime.scheduler.params)}


@pytest.mark.parametrize("backend", ["dense", "cuda", "collective"])
def test_sync_under_faults_tracks_jax(jax_sync_faults, backend):
    ref = jax_sync_faults
    trun = tscenarios.build_scenario("mnist-iid-ring", device="cpu", backend=backend, **SYNC_KW)
    sched = trun.runtime.scheduler
    assert sched.backend.name == backend and sched.axes.faults is not None
    sched.params = params_from_numpy(ref["init"], "cpu")
    hist = trun.runtime.run(12, trun.batch_source(), trun.eval_batch, eval_every=3)
    np.testing.assert_allclose(hist.wallclock, ref["hist"].wallclock, rtol=1e-9)
    np.testing.assert_allclose(hist.loss, ref["hist"].loss, rtol=1e-4)
    for k, v in params_to_numpy(sched.params).items():
        np.testing.assert_allclose(v, ref["params"][k], atol=1e-4, err_msg=k)


# -- async: outage and skipped events against the reference ---------------------

ASYNC_KW = dict(num_clients=8, num_clusters=4, num_samples=400, theta_max=3, batch_size=2,
                participation={"strategy": "uniform-k", "k": 1},
                faults={"events": [
                    {"kind": "server-down", "round": 2, "server": 1, "until": 6},
                    {"kind": "client-crash", "round": 0, "client": 0, "until": 9},
                    {"kind": "uplink-drop", "round": 3, "client": 6},
                    {"kind": "link-down", "round": 1, "link": [2, 3], "until": 7},
                ]})
ASYNC_EVENTS = 14


def _recording(runtime):
    events, step = [], runtime.scheduler.step

    def rec(k, src):
        ev = step(k, src)
        events.append((ev.kind, ev.cluster, ev.iteration))
        return ev

    runtime.scheduler.step = rec
    return events


@pytest.fixture(scope="module")
def jax_async_faults():
    jrun = jscenarios.build_scenario("straggler-bimodal-async", backend="dense", **ASYNC_KW)
    init = jax.tree.map(lambda a: np.array(a, copy=True), jrun.runtime.scheduler.y)
    events = _recording(jrun.runtime)
    hist = jrun.runtime.run(ASYNC_EVENTS, jrun.batch_source(), jrun.eval_batch, eval_every=7)
    return {"init": init, "events": events, "hist": hist,
            "y": jax.tree.map(np.asarray, jrun.runtime.scheduler.y)}


@pytest.mark.parametrize("backend", ["dense", "cuda", "collective"])
def test_async_outage_and_skipped_events_track_jax(jax_async_faults, backend):
    ref = jax_async_faults
    assert {k for k, _, _ in ref["events"]} == {"cluster", "outage", "skipped"}
    trun = tscenarios.build_scenario("straggler-bimodal-async", device="cpu", backend=backend,
                                     **ASYNC_KW)
    sched = trun.runtime.scheduler
    sched.y = params_from_numpy(ref["init"], "cpu")
    events = _recording(trun.runtime)
    hist = trun.runtime.run(ASYNC_EVENTS, trun.batch_source(), trun.eval_batch, eval_every=7)
    assert events == ref["events"]
    # an outage or a skipped event leaves t where it was
    assert sched.t == sum(k == "cluster" for k, _, _ in events)
    np.testing.assert_allclose(hist.wallclock, ref["hist"].wallclock, rtol=1e-12)
    np.testing.assert_allclose(hist.loss, ref["hist"].loss, rtol=1e-4)
    for k, v in params_to_numpy(sched.y).items():
        np.testing.assert_allclose(v, ref["y"][k], atol=1e-4, err_msg=k)
