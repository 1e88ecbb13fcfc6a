"""Port parity: the host-side model of asynchronous SD-FEEL, exactly.

Device profiles, fleet timing, dropout draws, the async configuration, the
eq. 22 staleness mixing matrix and the per-client batch streams are numpy
in both packages (the port keeps copies), so they must agree exactly (1e-12
for the float64 mixing matrix, whose sums run in the same order).
"""
import os

import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core.topology import TOPOLOGIES as J_TOPOLOGIES
import repro.data as jdata
import repro.hetero as jhetero
import repro_torch.core as tcore
import repro_torch.data as tdata
import repro_torch.hetero as thetero

# six test workers share the host's cores: one intra-op thread each, also
# in the processes a test starts
os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(1)

PROFILE_SPECS = {
    "uniform": {"kind": "uniform", "heterogeneity": 4.0, "bandwidth_spread": 2.0,
                "availability": 0.6},
    "bimodal-straggler": {"kind": "bimodal-straggler", "straggler_frac": 0.25,
                          "speedup": 10.0},
    "exponential": {"kind": "exponential", "scale": 2.0},
    "trace": {"kind": "trace", "speeds": [[1.0, 3.0, 2.0], [2.0, 1.5, 4.0]],
              "availability": [0.9, 0.5, 1.0], "bandwidths": [1.0, 0.5]},
}


def _assert_profiles_equal(a, b):
    for field in ("speeds", "bandwidths", "availability"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)
    assert a.name == b.name
    assert (a.schedule is None) == (b.schedule is None)
    if a.schedule is not None:
        np.testing.assert_array_equal(a.schedule.speeds, b.schedule.speeds)
        np.testing.assert_array_equal(a.schedule.availability, b.schedule.availability)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("kind", sorted(PROFILE_SPECS))
def test_sample_profile_matches_reference(kind, seed):
    assert set(thetero.PROFILE_REGISTRY) == set(jhetero.PROFILE_REGISTRY)
    spec = PROFILE_SPECS[kind]
    _assert_profiles_equal(thetero.sample_profile(spec, 20, seed=seed),
                           jhetero.sample_profile(spec, 20, seed=seed))


def _clusters(pkg, c=8, d=4):
    return pkg.ClusterSpec(c, tuple(i * d // c for i in range(c)),
                           tuple(float(s) for s in np.arange(1, c + 1)))


@pytest.mark.parametrize("latency", [False, True])
def test_fleet_timing_matches_reference(latency):
    spec = PROFILE_SPECS["uniform"]
    jt = jhetero.FleetTiming(jhetero.sample_profile(spec, 8, seed=3),
                             jcore.MNIST_LATENCY if latency else None)
    tt = thetero.FleetTiming(thetero.sample_profile(spec, 8, seed=3),
                             tcore.MNIST_LATENCY if latency else None)
    jc, tc = _clusters(jcore), _clusters(tcore)
    np.testing.assert_array_equal(tt.cluster_service_times(tc, 2), jt.cluster_service_times(jc, 2))
    np.testing.assert_array_equal(tt.cluster_availability(tc), jt.cluster_availability(jc))
    jd, td = jt.dropout_process(jc, seed=5), tt.dropout_process(tc, seed=5)
    draws = [(d, jd.attempts(d), td.attempts(d)) for _ in range(30) for d in range(4)]
    assert [t for _, _, t in draws] == [j for _, j, _ in draws]
    assert max(t for _, _, t in draws) > 1
    dead_j = jhetero.ClusterDropout(np.array([0.0, 1.0]), seed=1)
    dead_t = thetero.ClusterDropout(np.array([0.0, 1.0]), seed=1)
    assert [dead_t.attempts(0), dead_t.attempts(1)] == [dead_j.attempts(0), dead_j.attempts(1)]


@pytest.mark.parametrize("profile", [None, "bimodal-straggler"])
def test_async_config_and_speeds_match_reference(profile):
    for n, h, seed in ((8, 4.0, 2), (20, 1.0, 0), (5, 6.0, 9)):
        np.testing.assert_array_equal(tcore.make_speeds(n, h, seed=seed),
                                      jcore.make_speeds(n, h, seed=seed))
    kw = dict(min_batches=2, theta_max=8, learning_rate=0.05)
    if profile is None:
        jkw = dict(kw, speeds=jcore.make_speeds(8, 4.0, seed=2))
        tkw = dict(kw, speeds=tcore.make_speeds(8, 4.0, seed=2))
    else:
        jkw = dict(kw, profile=jhetero.sample_profile(PROFILE_SPECS[profile], 8, seed=1),
                   alpha_latency=jcore.MNIST_LATENCY)
        tkw = dict(kw, profile=thetero.sample_profile(PROFILE_SPECS[profile], 8, seed=1),
                   alpha_latency=tcore.MNIST_LATENCY)
    jcfg = jcore.AsyncConfig(clusters=_clusters(jcore), topology=jcore.ring(4), **jkw)
    tcfg = tcore.AsyncConfig(clusters=_clusters(tcore), topology=tcore.ring(4), **tkw)
    np.testing.assert_array_equal(tcfg.theta(), jcfg.theta())
    np.testing.assert_array_equal(tcfg.iter_times(), jcfg.iter_times())


@pytest.mark.parametrize("topo", ["ring", "star", "torus", "disconnected"])
@pytest.mark.parametrize("psi", ["psi_inverse", "psi_constant", "exponential"])
def test_staleness_mixing_matrix_matches_reference(topo, psi):
    rng = np.random.default_rng(len(topo))
    jpsi = jcore.psi_exponential(0.3) if psi == "exponential" else getattr(jcore, psi)
    tpsi = tcore.psi_exponential(0.3) if psi == "exponential" else getattr(tcore, psi)
    d = 4
    if topo == "disconnected":  # a surviving graph under faults: {0, 1} and {2, 3}
        jg = tg = np.array([[0, 1, 0, 0], [1, 0, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]])
    else:
        jg, tg = J_TOPOLOGIES[topo](d), tcore.TOPOLOGIES[topo](d)
    for trigger in range(d):
        gaps = rng.integers(0, 9, d).astype(float)
        gaps[trigger] = 0.0
        p = tcore.staleness_mixing_matrix(tg, trigger, gaps, tpsi)
        np.testing.assert_allclose(p, jcore.staleness_mixing_matrix(jg, trigger, gaps, jpsi),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(p.sum(axis=0), 1.0, atol=1e-12)


def _datasets():
    jd = jdata.mnist_like(200, seed=1)
    td = tdata.mnist_like(200, seed=1)
    parts = tdata.iid_partition(td.y, 6, seed=0)
    return jdata.FederatedDataset(jd, parts), tdata.FederatedDataset(td, parts)


def test_client_batcher_matches_reference_and_its_per_call_stream():
    jds, tds = _datasets()
    jb, tb, per_call = (jdata.ClientBatcher(jds, 4, seed=3), tdata.ClientBatcher(tds, 4, seed=3),
                        tdata.ClientBatcher(tds, 4, seed=3))
    clients = [4, 1, 2]
    for _ in range(2):
        got, ref = tb.next_batches(clients, 3), jb.next_batches(clients, 3)
        assert got["x"].shape == (3, 3, 4, 28, 28, 1)
        for k in ("x", "y"):
            np.testing.assert_array_equal(got[k], ref[k])
        for i, c in enumerate(clients):
            for j in range(3):
                b = per_call.next_batch(c)
                np.testing.assert_array_equal(got["x"][i, j], b["x"])
                np.testing.assert_array_equal(got["y"][i, j], b["y"])
    stacked_t, stacked_j = tb.next_stacked([0, 5]), jb.next_stacked([0, 5])
    for k in ("x", "y"):
        np.testing.assert_array_equal(stacked_t[k], stacked_j[k])


def test_gather_client_batches_bulk_and_per_call_shim_agree():
    _, tds = _datasets()

    class PerCallOnly:
        def __init__(self):
            self.inner = tdata.ClientBatcher(tds, 4, seed=9)

        def next_batch(self, c):
            return self.inner.next_batch(c)

    bulk = tcore.gather_client_batches(tdata.ClientBatcher(tds, 4, seed=9), [2, 0], 5)
    shim = tcore.gather_client_batches(PerCallOnly(), [2, 0], 5)
    assert bulk["x"].shape == (2, 5, 4, 28, 28, 1)
    for k in ("x", "y"):
        np.testing.assert_array_equal(bulk[k], shim[k])
