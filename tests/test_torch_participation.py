"""Port parity: the participation axis (``repro_torch.participation``).

The numpy module is a copy of ``repro.participation``: every strategy's
masks, renormalized weights, effective masks and stacked weights equal the
reference's exactly, round by round.  Through the schedulers, both
packages run the same registered scenario from the same weights (JAX init,
carried through numpy) on the same batches: ``sampled-k-ring`` (sync, 10
iterations, ``tau2=2``) and a sampled, profile-paced round engine stay
within 1e-4 of JAX on parameters and losses and equal it in wall-clock to
1e-9, on ``dense``, on the ``cuda`` backend's plain path and on the
``collective`` backend (``sampled-k-ring``'s 5 clients a cluster refuse it
in both packages, and the legacy ``aggregation_impl="gossip"`` degrades to
dense); ``dropout-participation-async`` fires the reference's exact event
kinds (``cluster``/``skipped``) with ``y`` within 1e-4.  ``"full"``
participation is bitwise the run without a plan.
"""
import os

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.hetero as jhetero
import repro.participation as jpart
import repro.scenarios as jscenarios
import repro_torch.core as tcore
import repro_torch.hetero as thetero
import repro_torch.participation as tpart
import repro_torch.scenarios as tscenarios
from repro_torch.convert import flatten_params, params_from_numpy, params_to_numpy

# six test workers share the host's cores: one intra-op thread each, also
# in the processes a test starts
os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(1)

ROUNDS = 12
SIZES = tuple(float(s) for s in np.random.default_rng(3).uniform(0.5, 2.0, 12))


def _specs(c=12, d=4):
    assign = tuple(i * d // c for i in range(c))
    return jcore.ClusterSpec(c, assign, SIZES[:c]), tcore.ClusterSpec(c, assign, SIZES[:c])


def _trace_profiles(c=12):
    rng = np.random.default_rng(5)
    spec = {"kind": "trace", "speeds": rng.uniform(0.5, 4.0, (5, c)),
            "availability": rng.uniform(0.0, 1.0, (5, c))}
    return jhetero.sample_profile(spec, c), thetero.sample_profile(spec, c)


PLANS = [
    ("full", {}),
    ("uniform-k", {"k": 1}),
    ("uniform-k", {"k": 2}),
    ("uniform-k", {"k": 7}),  # more than a cluster holds: everyone
    ("availability", {"availability": np.linspace(0.05, 0.95, 12)}),
    ("availability", "profile"),
    ("trace", "profile"),
    ("trace", {"availability": np.random.default_rng(2).uniform(size=(4, 12)),
               "threshold": 0.7}),
]


@pytest.mark.parametrize("strategy,params", PLANS)
def test_plans_equal_reference(strategy, params):
    jspec, tspec = _specs()
    jprof, tprof = _trace_profiles()
    if params == "profile":
        jplan = jpart.resolve_plan(strategy, jspec, profile=jprof, seed=7)
        tplan = tpart.resolve_plan(strategy, tspec, profile=tprof, seed=7)
    else:
        jplan = jpart.resolve_plan({"strategy": strategy, **params}, jspec, seed=7)
        tplan = tpart.resolve_plan({"strategy": strategy, **params}, tspec, seed=7)
    assert tplan.is_full == jplan.is_full == (strategy == "full")
    for r in range(ROUNDS):
        np.testing.assert_array_equal(tplan.mask(r), jplan.mask(r))
        np.testing.assert_array_equal(tplan.weights(r), jplan.weights(r))
        np.testing.assert_array_equal(tplan.effective_mask(r), jplan.effective_mask(r))
    np.testing.assert_array_equal(tplan.stacked_weights(3, 4), jplan.stacked_weights(3, 4))
    # each participating cluster's weights sum to 1; the sampled-out weigh 0
    w, assign = tplan.weights(0), np.asarray(tspec.assignments)
    np.testing.assert_allclose(np.bincount(assign, weights=w), 1.0, rtol=1e-12)


@pytest.mark.parametrize("mask", [
    np.ones(12, bool),
    np.arange(12) % 3 == 0,
    np.r_[np.zeros(3, bool), np.ones(9, bool)],  # cluster 0 empty: its full m^ column
    np.zeros(12, bool),
])
def test_renormalize_weights_equals_reference(mask):
    jspec, tspec = _specs()
    got = tpart.renormalize_weights(tspec.m_hat(), tspec.assignments, mask)
    np.testing.assert_array_equal(
        got, jpart.renormalize_weights(jspec.m_hat(), jspec.assignments, mask))
    empty = ~np.bincount(np.asarray(tspec.assignments), weights=mask).astype(bool)
    full = empty[np.asarray(tspec.assignments)]
    np.testing.assert_array_equal(got[full], tspec.m_hat()[full])
    assert np.all(got[~full & ~mask] == 0.0)


def test_resolve_plan_refuses_alike():
    jspec, tspec = _specs()
    for mod, spec in ((jpart, jspec), (tpart, tspec)):
        assert mod.resolve_plan(None, spec) is None
        with pytest.raises(KeyError, match="unknown participation"):
            mod.resolve_plan("lottery", spec)
        with pytest.raises(ValueError, match="needs a DeviceProfile"):
            mod.resolve_plan("availability", spec)
        with pytest.raises(ValueError, match="k >= 1"):
            mod.resolve_plan({"strategy": "uniform-k", "k": 0}, spec)
        plan = mod.ParticipationPlan("full", spec)
        assert mod.resolve_plan(plan, spec) is plan


# -- the sync scheduler: sampled-k-ring against the reference ------------------

@pytest.fixture(scope="module")
def jax_sampled():
    jrun = jscenarios.build_scenario("sampled-k-ring", tau2=2, backend="dense")
    init = jax.tree.map(np.asarray, jrun.runtime.scheduler.params)
    hist = jrun.runtime.run(10, jrun.batch_source(), jrun.eval_batch, eval_every=5)
    return {"init": init, "hist": hist,
            "params": jax.tree.map(np.asarray, jrun.runtime.scheduler.params)}


@pytest.mark.parametrize("backend", ["dense", "cuda", "collective"])
def test_sampled_k_ring_tracks_jax(jax_sampled, backend):
    ref = jax_sampled
    if backend == "collective":
        # 5 clients a cluster: the hypercube cannot take it, in either package,
        # and the legacy aggregation_impl="gossip" degrades to dense (whose
        # run is the dense case's), as the reference's does
        for mod, kw in ((tscenarios, {"device": "cpu"}), (jscenarios, {})):
            with pytest.raises(ValueError, match="power-of-two cluster sizes"):
                mod.build_scenario("sampled-k-ring", tau2=2, backend="collective", **kw)
            legacy = mod.build_scenario("sampled-k-ring", tau2=2, backend=None,
                                        aggregation_impl="gossip", **kw)
            assert legacy.runtime.scheduler.backend.name == "dense"
        return
    trun = tscenarios.build_scenario("sampled-k-ring", device="cpu", tau2=2, backend=backend)
    sched = trun.runtime.scheduler
    assert sched.backend.name == backend and sched.axes.sampling
    sched.params = params_from_numpy(ref["init"], "cpu")
    hist = trun.runtime.run(10, trun.batch_source(), trun.eval_batch, eval_every=5)
    assert hist.iterations == ref["hist"].iterations
    np.testing.assert_allclose(hist.wallclock, ref["hist"].wallclock, rtol=1e-9)
    np.testing.assert_allclose(hist.loss, ref["hist"].loss, rtol=1e-4)
    for k, v in params_to_numpy(sched.params).items():
        np.testing.assert_allclose(v, ref["params"][k], atol=1e-4, err_msg=k)


# -- the round scheduler: sampled supersteps, paced by their participants ------

ROUND_KW = dict(num_samples=400, rounds_per_step=2, batch_size=2,
                participation={"strategy": "uniform-k", "k": 1},
                profile={"kind": "bimodal-straggler", "straggler_frac": 0.25, "speedup": 10.0})


@pytest.fixture(scope="module")
def jax_round_sampled():
    jrun = jscenarios.build_scenario("round-compiled-ring", **ROUND_KW)
    init = flatten_params(jax.tree.map(np.asarray, jrun.runtime.scheduler.params))
    src = jrun.batch_source()
    evs = [jrun.runtime.step(src) for _ in range(3)]
    return {"init": init, "losses": np.concatenate([np.asarray(e.losses) for e in evs]),
            "dts": [e.dt for e in evs],
            "params": flatten_params(jax.tree.map(np.asarray, jrun.runtime.scheduler.params))}


@pytest.mark.parametrize("backend", ["dense", "cuda", "collective"])
def test_round_participation_tracks_jax(jax_round_sampled, backend):
    ref = jax_round_sampled
    trun = tscenarios.build_scenario("round-compiled-ring", device="cpu", backend=backend,
                                     **ROUND_KW)
    sched = trun.runtime.scheduler
    assert sched.axes.sampling and sched.axes.faults is None
    sched.params = params_from_numpy(ref["init"], "cpu")
    src = trun.batch_source()
    evs = [trun.runtime.step(src) for _ in range(3)]
    np.testing.assert_allclose([e.dt for e in evs], ref["dts"], rtol=1e-9)
    # sampling paces the rounds by their participants: below the full fleet's
    assert all(e.dt <= 2 * sched._round_time for e in evs)
    np.testing.assert_allclose(torch.cat([e.losses for e in evs]).numpy(), ref["losses"],
                               atol=1e-4)
    for k, v in params_to_numpy(sched.params).items():
        np.testing.assert_allclose(v, ref["params"][k], atol=1e-4, err_msg=k)


def test_round_step_takes_its_operands():
    """The round engine's operand variants: every round's full ``m^`` and the
    bound P give the plain step's trajectory (within f32 rounding: the
    weighted factors multiply in f32 where the static ones were formed in
    float64), and a missing operand is refused."""
    from repro_torch.models import MnistCNN
    from repro_torch.optim import sgd

    fl = tcore.FLSpec(8, 4, tau1=2, tau2=1, alpha=2)
    proto, model = fl.protocol(), MnistCNN()
    rng = np.random.default_rng(0)
    batches = {"x": torch.as_tensor(rng.normal(size=(4, 8, 3, 28, 28, 1)), dtype=torch.float32),
               "y": torch.as_tensor(rng.integers(0, 10, (4, 8, 3)))}
    weights = torch.as_tensor(np.tile(proto.clusters.m_hat(), (2, 1)), dtype=torch.float32)
    mixing = torch.as_tensor(np.tile(proto.P(), (2, 1, 1)), dtype=torch.float32)
    init = tcore.stacked_init(model, 8, 0, "cpu")
    out = {}
    for flags, ops in (((False, False), ()), ((True, False), (weights,)),
                       ((True, True), (weights, mixing))):
        step = tcore.build_fl_round_step(model, sgd(0.1), fl, rounds_per_step=2,
                                         participation=flags[0], mixing=flags[1], device="cpu")
        params = {k: v.clone() for k, v in init.items()}
        out[flags] = step(params, (), batches, *ops)
        with pytest.raises(TypeError, match="takes weights"):
            step(params, (), batches, *ops[:-1]) if ops else step(params, (), batches, weights)
    for flags in ((True, False), (True, True)):
        np.testing.assert_allclose(out[flags][2].numpy(), out[(False, False)][2].numpy(),
                                   atol=1e-6)
        for k, v in out[flags][0].items():
            np.testing.assert_allclose(v.numpy(), out[(False, False)][0][k].numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="requires participation"):
        tcore.build_fl_round_step(model, sgd(0.1), fl, mixing=True, device="cpu")


# -- "full" is the run without a plan, bitwise ----------------------------------

@pytest.mark.parametrize("name,steps,kw", [
    ("mnist-iid-ring", 6, {"tau1": 2, "num_samples": 400}),
    ("round-compiled-ring", 2, {"num_samples": 400}),
    ("straggler-bimodal-async", 4, {"num_clients": 8, "num_samples": 400, "theta_max": 3,
                                    "batch_size": 2}),
])
def test_full_participation_is_the_plan_free_run(name, steps, kw):
    runs = []
    for part in (None, "full"):
        run = tscenarios.build_scenario(name, device="cpu", backend="cuda", participation=part,
                                        **kw)
        src = run.batch_source()
        kinds = [run.runtime.step(src).kind for _ in range(steps)]
        sched = run.runtime.scheduler
        assert sched.axes.plan is None if part is None else sched.axes.plan.is_full
        runs.append((kinds, params_to_numpy(run.runtime.cluster_params())))
    assert runs[0][0] == runs[1][0]
    for k, v in runs[0][1].items():
        np.testing.assert_array_equal(v, runs[1][1][k], err_msg=k)


# -- the async scheduler: dropout-participation-async against the reference ----

SMALL = {"num_clients": 8, "num_clusters": 4, "num_samples": 400, "theta_max": 3, "batch_size": 2}
EVENTS = 12


def _recording(runtime):
    events, step = [], runtime.scheduler.step

    def rec(k, src):
        ev = step(k, src)
        events.append((ev.kind, ev.cluster, ev.iteration))
        return ev

    runtime.scheduler.step = rec
    return events


@pytest.fixture(scope="module")
def jax_dropout():
    jrun = jscenarios.build_scenario("dropout-participation-async", backend="dense", **SMALL)
    init = jax.tree.map(lambda a: np.array(a, copy=True), jrun.runtime.scheduler.y)
    events = _recording(jrun.runtime)
    hist = jrun.runtime.run(EVENTS, jrun.batch_source(), jrun.eval_batch, eval_every=4)
    return {"init": init, "events": events, "hist": hist,
            "y": jax.tree.map(np.asarray, jrun.runtime.scheduler.y)}


@pytest.mark.parametrize("backend", ["dense", "cuda", "collective"])
def test_dropout_participation_async_tracks_jax(jax_dropout, backend):
    ref = jax_dropout
    assert {k for k, _, _ in ref["events"]} == {"cluster", "skipped"}
    trun = tscenarios.build_scenario("dropout-participation-async", device="cpu",
                                     backend=backend, **SMALL)
    sched = trun.runtime.scheduler
    assert sched.backend.name == backend and sched.axes.sampling
    sched.y = params_from_numpy(ref["init"], "cpu")
    events = _recording(trun.runtime)
    hist = trun.runtime.run(EVENTS, trun.batch_source(), trun.eval_batch, eval_every=4)
    assert events == ref["events"]
    np.testing.assert_allclose(hist.wallclock, ref["hist"].wallclock, rtol=1e-12)
    np.testing.assert_allclose(hist.loss, ref["hist"].loss, rtol=1e-4)
    for k, v in params_to_numpy(sched.y).items():
        np.testing.assert_allclose(v, ref["y"][k], atol=1e-4, err_msg=k)


def test_sampled_out_client_weighs_exactly_zero_in_the_async_update():
    run = tscenarios.build_scenario("dropout-participation-async", device="cpu",
                                    backend="cuda", **SMALL)
    sched = run.runtime.scheduler
    for k in range(1, 40):
        m_hat, took = sched._event_weights(k, 0)
        mask = sched.axes.plan.mask(k - 1)[sched._members[0]]
        if not took:
            assert not mask.any()
            continue
        assert torch.equal(m_hat == 0, torch.as_tensor(~mask))
        assert abs(float(m_hat.sum()) - 1.0) < 1e-6


# -- profile pacing: static and trace-scheduled fleets, with and without plans --

_T = np.random.default_rng(9)
TRACE_PROFILE = {"kind": "trace", "speeds": _T.uniform(0.5, 4.0, (3, 8)),
                 "availability": _T.uniform(0.2, 1.0, (3, 8))}


@pytest.mark.parametrize("participation", [None, {"strategy": "uniform-k", "k": 1}, "trace"])
@pytest.mark.parametrize("scenario,steps,kw", [
    ("mnist-iid-ring", 6, {"num_clients": 8, "tau1": 1, "tau2": 2}),
    ("round-compiled-ring", 3, {}),
])
def test_trace_profile_pacing_equals_reference(scenario, steps, kw, participation):
    """A trace-scheduled fleet prices each round by its own speeds, paced by
    the round's participants where a plan samples them."""
    dts = []
    for build in (jscenarios.build_scenario,
                  lambda name, **o: tscenarios.build_scenario(name, device="cpu", **o)):
        run = build(scenario, num_samples=400, profile=TRACE_PROFILE,
                    participation=participation, **kw)
        src = run.batch_source()
        dts.append([run.runtime.step(src).dt for _ in range(steps)])
    assert len(set(dts[1])) > 1  # the rounds are priced apart
    np.testing.assert_allclose(dts[1], dts[0], rtol=1e-9)
