"""Port parity: Theorems 1-2 (``core/theory.py``) equal the reference exactly.

The port's ``repro_torch.core.theory`` is a numpy copy of
``repro.core.theory``: the same inputs give the same floats, bit for bit,
and the same refusals.
"""
import os

import numpy as np
import pytest
import torch

import repro.core.theory as jtheory
import repro_torch.core.theory as ttheory
from repro_torch.core import ClusterSpec, mixing_matrix, ring, zeta

# six test workers share the host's cores: one intra-op thread each, also
# in the processes a test starts
os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(1)

M = ClusterSpec.uniform(20, 4).m()
# (tau1, tau2, alpha, zeta, eta, L, sigma2, kappa2)
CASES = [
    (5, 1, 1, 0.5, 0.01, 1.0, 1.0, 1.0),
    (5, 2, 2, 0.7, 0.005, 2.0, 0.5, 3.0),
    (1, 1, 1, 0.0, 0.01, 1.0, 1.0, 1.0),
    (10, 4, 3, 0.9, 1e-5, 5.0, 2.0, 0.1),
]


@pytest.mark.parametrize("case", CASES)
def test_theorem1_terms_and_bound_equal_reference(case):
    tau1, tau2, alpha, z, eta, L, s2, k2 = case
    got = ttheory.theorem1_terms(tau1, tau2, alpha, z, eta, L, s2, k2, M)
    ref = jtheory.theorem1_terms(tau1, tau2, alpha, z, eta, L, s2, k2, M)
    assert got == ttheory.TheoremTerms(**vars(ref))
    for k in (10, 1000):
        assert (ttheory.theorem1_bound(k, 3.0, tau1, tau2, alpha, z, eta, L, s2, k2, M)
                == jtheory.theorem1_bound(k, 3.0, tau1, tau2, alpha, z, eta, L, s2, k2, M))


@pytest.mark.parametrize("case", CASES)
def test_max_learning_rate_equals_reference(case):
    tau1, tau2, alpha, z, _, L, _, _ = case
    assert (ttheory.max_learning_rate(tau1, tau2, alpha, z, L)
            == jtheory.max_learning_rate(tau1, tau2, alpha, z, L))


def test_condition_15_refused_alike():
    with pytest.raises(ValueError, match="condition"):
        ttheory.theorem1_terms(10, 10, 1, 0.9, 1.0, 10.0, 1.0, 1.0, M)
    with pytest.raises(ValueError, match="condition"):
        jtheory.theorem1_terms(10, 10, 1, 0.9, 1.0, 10.0, 1.0, 1.0, M)


@pytest.mark.parametrize("times", [[1.0, 1.0, 1.0], [1.0, 2.5, 10.0, 3.0], [0.3, 7.0]])
def test_delta_max_equals_reference(times):
    assert ttheory.delta_max(np.asarray(times)) == jtheory.delta_max(np.asarray(times))


@pytest.mark.parametrize("eta", [1e-4, 1e-3, 1e-2, 0.1])
@pytest.mark.parametrize("dmax", [0, 3, 12])
def test_theorem2_learning_rate_ok_equals_reference(eta, dmax):
    for theta_min, theta_max in ((1, 8), (2, 20)):
        assert (ttheory.theorem2_learning_rate_ok(eta, 1.0, theta_min, theta_max, dmax)
                == jtheory.theorem2_learning_rate_ok(eta, 1.0, theta_min, theta_max, dmax))


def test_theorem1_on_the_ring_of_the_main_path():
    # the main path's ring: zeta from the port's eq. 5, bound finite and
    # decreasing in K, as the paper's Remark 1 reads
    z = zeta(mixing_matrix(ring(4)))
    bounds = [ttheory.theorem1_bound(k, 1.0, 5, 2, 1, z, 0.01, 1.0, 1.0, 1.0, M)
              for k in (10, 100, 1000)]
    assert all(np.isfinite(bounds)) and bounds == sorted(bounds, reverse=True)
