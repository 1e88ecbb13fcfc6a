"""Port parity: protocol math (topology, clusters, Lemma-1 matrices, schedule).

The port's numpy copies must give the reference's float64 matrices exactly.
"""
import os

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore

# six test workers share the host's cores: one intra-op thread each, also
# in the processes a test starts
os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(1)

CASES = [
    ("ring", lambda m: m.ClusterSpec.uniform(20, 4), 2),
    ("star", lambda m: m.ClusterSpec.uniform(20, 4), 2),
    ("torus", lambda m: m.ClusterSpec.uniform(20, 4), 1),
    ("ring", lambda m: m.ClusterSpec.imbalanced(10, 5, 2), 3),
    ("torus", lambda m: m.ClusterSpec(6, (0, 0, 1, 2, 3, 3), (3.0, 1.0, 2.0, 5.0, 1.0, 4.0)), 2),
]


def _config(mod, topo, make_clusters, alpha):
    clusters = make_clusters(mod)
    from_name = (jcore.runtime._as_topology if mod is jcore else tcore.runtime._as_topology)
    topology = from_name(topo, clusters.num_clusters)
    return mod.SDFEELConfig(clusters=clusters, topology=topology, tau1=3, tau2=2,
                            alpha=alpha, learning_rate=0.1)


@pytest.mark.parametrize("topo,make_clusters,alpha", CASES)
def test_matrices_equal(topo, make_clusters, alpha):
    jc = _config(jcore, topo, make_clusters, alpha)
    tc = _config(tcore, topo, make_clusters, alpha)
    for name in ("V", "B", "m_hat", "m", "m_tilde"):
        np.testing.assert_array_equal(getattr(tc.clusters, name)(), getattr(jc.clusters, name)())
    np.testing.assert_array_equal(tc.P(), jc.P())
    assert tc.zeta() == jc.zeta()
    for event in ("local", "intra", "inter"):
        np.testing.assert_array_equal(
            tcore.transition_matrix(tc, event), jcore.transition_matrix(jc, event)
        )


@pytest.mark.parametrize("tau1,tau2", [(5, 1), (5, 2), (2, 3), (1, 1)])
def test_event_at_agrees(tau1, tau2):
    jc = jcore.SDFEELConfig(jcore.ClusterSpec.uniform(8, 4), jcore.ring(4), tau1=tau1, tau2=tau2)
    tc = tcore.SDFEELConfig(tcore.ClusterSpec.uniform(8, 4), tcore.ring(4), tau1=tau1, tau2=tau2)
    assert [tc.event_at(k) for k in range(1, 40)] == [jc.event_at(k) for k in range(1, 40)]


@pytest.mark.parametrize("tau1,tau2", [(5, 1), (5, 2), (2, 3), (1, 1)])
def test_schedule_event_agrees(tau1, tau2):
    from repro.core.protocol import schedule_event as jschedule
    from repro_torch.core.protocol import schedule_event

    tc = tcore.SDFEELConfig(tcore.ClusterSpec.uniform(8, 4), tcore.ring(4), tau1=tau1, tau2=tau2)
    events = [schedule_event(k, tau1, tau2) for k in range(1, 40)]
    assert events == [jschedule(k, tau1, tau2) for k in range(1, 40)]
    assert events == [tc.event_at(k) for k in range(1, 40)]


def test_tau2_one_never_fires_intra():
    tc = tcore.SDFEELConfig(tcore.ClusterSpec.uniform(8, 4), tcore.ring(4), tau1=5, tau2=1)
    assert "intra" not in {tc.event_at(k) for k in range(1, 50)}


def test_latency_constants_equal():
    for name in ("MNIST_LATENCY", "CIFAR_LATENCY"):
        j, t = getattr(jcore, name), getattr(tcore, name)
        assert t.sdfeel_total(100, 5, 2, 1) == j.sdfeel_total(100, 5, 2, 1)
        assert t.t_comm_server_server() == j.t_comm_server_server()
