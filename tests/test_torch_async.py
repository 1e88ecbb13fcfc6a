"""Port parity: asynchronous SD-FEEL (Section IV) end to end against the reference.

Both packages run the same registered scenario at a small size (C = 8
clients in D = 4 clusters, 400 samples, 12 events) from the same cluster
models (JAX init, carried through numpy), with the same batches (the
per-client numpy streams of ``ClientBatcher``) and the same device profile
(numpy samplers).  The event sequence ``(kind, cluster, iteration)`` is
identical and the wall-clock equal within 1e-12 (both are numpy on the
host).  The cluster models agree within 1e-4 max abs and the eval loss
within 1e-4 relative: oneDNN and XLA reduce the convolutions in different
orders, the difference compounds over the events, and the ``cuda``
backend's eq. 19 multiplies by ``1 / theta_i`` where the reference divides
(1 ulp).  On the CPU the ``cuda`` backend runs the kernels' plain versions.
"""
import jax
import numpy as np
import pytest
import torch

import repro.scenarios as jscenarios
import repro_torch.scenarios as tscenarios
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.kernels import cluster_agg, gossip_mix, normalized_update

SMALL = {"num_clients": 8, "num_clusters": 4, "num_samples": 400}
EVENTS = 12


def _recording(runtime):
    """Wrap ``runtime.scheduler.step`` to record ``(kind, cluster, iteration)``."""
    events, step = [], runtime.scheduler.step

    def rec(k, src):
        ev = step(k, src)
        events.append((ev.kind, ev.cluster, ev.iteration))
        return ev

    runtime.scheduler.step = rec
    return events


def _copy(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _jax_run(name, **overrides):
    jrun = jscenarios.build_scenario(name, backend="dense", **SMALL, **overrides)
    init = _copy(jrun.runtime.scheduler.y)
    events = _recording(jrun.runtime)
    hist = jrun.runtime.run(EVENTS, jrun.batch_source(), jrun.eval_batch, eval_every=4)
    return {"init": init, "hist": hist, "events": events,
            "clock": jrun.runtime.scheduler.clock,
            "y": _copy(jrun.runtime.scheduler.y),
            "global": _copy(jrun.runtime.global_params()),
            "clusters": _copy(jrun.runtime.cluster_params())}


@pytest.fixture(scope="module")
def jax_reference():
    return {name: _jax_run(name) for name in ("straggler-bimodal-async", "dropout-heavy")}


def _torch_run(name, init, backend="dense", **overrides):
    trun = tscenarios.build_scenario(name, device="cpu", backend=backend, **SMALL, **overrides)
    sched = trun.runtime.scheduler
    assert sched.backend.name == backend
    sched.y = params_from_numpy(init, "cpu")
    events = _recording(trun.runtime)
    hist = trun.runtime.run(EVENTS, trun.batch_source(), trun.eval_batch, eval_every=4)
    return trun, hist, events


@pytest.mark.parametrize("backend", ["dense", "cuda"])
@pytest.mark.parametrize("name", ["straggler-bimodal-async", "dropout-heavy"])
def test_async_scenario_tracks_jax(jax_reference, name, backend):
    ref = jax_reference[name]
    launches = (normalized_update.launches, cluster_agg.launches, gossip_mix.launches)
    trun, hist, events = _torch_run(name, ref["init"], backend)
    assert events == ref["events"]
    assert {c for _, c, _ in events} == {0, 1, 2, 3}
    assert hist.iterations == ref["hist"].iterations
    np.testing.assert_allclose(hist.wallclock, ref["hist"].wallclock, rtol=1e-12)
    assert trun.runtime.scheduler.clock == pytest.approx(ref["clock"], rel=1e-12)
    np.testing.assert_allclose(hist.loss, ref["hist"].loss, rtol=1e-4)
    for label, got in (("y", trun.runtime.scheduler.y),
                       ("global", trun.runtime.global_params()),
                       ("clusters", trun.runtime.cluster_params())):
        for k, v in params_to_numpy(got).items():
            assert np.isfinite(v).all()
            np.testing.assert_allclose(v, ref[label][k], atol=1e-4, err_msg=f"{label}/{k}")
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (normalized_update.launches, cluster_agg.launches, gossip_mix.launches) == launches


def test_dropout_heavy_stretches_the_queue(jax_reference):
    """Retries make some inter-event gaps a multiple of the service time."""
    ref = jax_reference["dropout-heavy"]
    trun, hist, _ = _torch_run("dropout-heavy", ref["init"])
    sched = trun.runtime.scheduler
    assert sched._dropout is not None
    assert sched.clock > EVENTS / len(sched.iter_times) * sched.iter_times.min()


@pytest.mark.parametrize("backend", ["dense", "cuda"])
def test_prefetch_off_draws_the_same_batches(jax_reference, backend):
    ref = jax_reference["straggler-bimodal-async"]
    on, _, ev_on = _torch_run("straggler-bimodal-async", ref["init"], backend)
    off, _, ev_off = _torch_run("straggler-bimodal-async", ref["init"], backend, prefetch=False)
    assert ev_on == ev_off
    for k, v in on.runtime.scheduler.y.items():
        torch.testing.assert_close(v, off.runtime.scheduler.y[k], atol=0, rtol=0)


def test_vanilla_constant_psi_differs_from_staleness_aware(jax_reference):
    ref = jax_reference["straggler-bimodal-async"]
    aware, _, ev_a = _torch_run("straggler-bimodal-async", ref["init"])
    vanilla, _, ev_v = _torch_run("straggler-bimodal-vanilla", ref["init"])
    assert ev_a == ev_v  # same fleet, same queue
    diff = max((aware.runtime.scheduler.y[k] - vanilla.runtime.scheduler.y[k]).abs().max().item()
               for k in aware.runtime.scheduler.y)
    assert diff > 1e-3


def test_cuda_backend_updates_y_in_place(jax_reference):
    ref = jax_reference["straggler-bimodal-async"]
    trun = tscenarios.build_scenario("straggler-bimodal-async", device="cpu", backend="cuda",
                                     **SMALL)
    sched = trun.runtime.scheduler
    leaves = dict(sched.y)
    trun.runtime.step(trun.batch_source())
    assert all(sched.y[k] is leaves[k] for k in leaves)
    assert trun.runtime.cluster_params() is sched.y
