"""Numeric evaluation of the paper's convergence bounds (Theorems 1 & 2).

A numpy copy of ``repro.core.theory`` (which cannot be imported without
JAX): the constants of Lemma 2 / Theorem 1, the learning-rate condition
(15) solved by bisection, and Lemma 4 / condition (27) of the asynchronous
Theorem 2.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TheoremTerms", "theorem1_terms", "theorem1_bound", "max_learning_rate",
           "theorem2_learning_rate_ok", "delta_max"]


@dataclasses.dataclass(frozen=True)
class TheoremTerms:
    """The V/Lambda/Phi constants of Lemma 2 / Theorem 1."""

    Lambda: float
    V1: float
    V2: float
    V3: float
    Phi0: float
    Phi: float


def _lambda_term(zeta: float, alpha: int) -> float:
    za = zeta ** alpha
    z2a = zeta ** (2 * alpha)
    if za >= 1.0:
        return np.inf
    return z2a / (1 - z2a) + 2 * za / (1 - za) + z2a / (1 - za) ** 2


def theorem1_terms(
    tau1: int,
    tau2: int,
    alpha: int,
    zeta: float,
    eta: float,
    L: float,
    sigma2: float,
    kappa2: float,
    m: np.ndarray,
) -> TheoremTerms:
    """Compute Lambda, V1-V3, Phi0, Phi(tau1,tau2,alpha,zeta) of Theorem 1."""
    t12 = tau1 * tau2
    za = zeta ** alpha
    z2a = zeta ** (2 * alpha)
    lam = _lambda_term(zeta, alpha)
    v3 = t12 * (t12 * lam + (t12 - 1) / 2.0 * (2 - za) / (1 - za)) if za < 1 else np.inf
    denom = 1.0 - 16.0 * eta**2 * L**2 * v3
    if denom <= 0:
        raise ValueError("learning rate violates condition (15): 1 - 16 eta^2 L^2 V3 <= 0")
    v1 = (t12 * z2a / (1 - z2a) + (t12 - 1) / 2.0) / denom if z2a < 1 else np.inf
    v2 = v3 / denom
    m = np.asarray(m, dtype=np.float64)
    phi0 = float((m**2).sum() * sigma2)
    phi = 2 * v1 * sigma2 + 8 * v2 * kappa2
    return TheoremTerms(Lambda=lam, V1=v1, V2=v2, V3=v3, Phi0=phi0, Phi=phi)


def theorem1_bound(
    K: int,
    delta: float,
    tau1: int,
    tau2: int,
    alpha: int,
    zeta: float,
    eta: float,
    L: float,
    sigma2: float,
    kappa2: float,
    m: np.ndarray,
) -> float:
    """RHS of (16): 2*Delta/(eta K) + eta L Phi0 + eta^2 L^2 Phi."""
    t = theorem1_terms(tau1, tau2, alpha, zeta, eta, L, sigma2, kappa2, m)
    return 2 * delta / (eta * K) + eta * L * t.Phi0 + eta**2 * L**2 * t.Phi


def max_learning_rate(
    tau1: int, tau2: int, alpha: int, zeta: float, L: float, tol: float = 1e-10
) -> float:
    """Largest eta satisfying condition (15) by bisection."""
    def ok(eta: float) -> bool:
        t12 = tau1 * tau2
        za, z2a = zeta**alpha, zeta ** (2 * alpha)
        lam = _lambda_term(zeta, alpha)
        v3 = t12 * (t12 * lam + (t12 - 1) / 2.0 * (2 - za) / (1 - za))
        d = 1 - 16 * eta**2 * L**2 * v3
        if d <= 0:
            return False
        v2 = v3 / d
        return 1 - eta * L - 8 * eta**2 * L**2 * v2 >= 0

    lo, hi = 0.0, 1.0 / L
    while hi - lo > tol:
        mid = (lo + hi) / 2
        if ok(mid):
            lo = mid
        else:
            hi = mid
    return lo


# -- Theorem 2 (asynchronous) ------------------------------------------------

def delta_max(iter_times: np.ndarray) -> int:
    """Lemma 4: delta_max = sum_d (ceil(T_iter^{j*} / T_iter^{d}) - 1)."""
    t = np.asarray(iter_times, dtype=np.float64)
    slowest = t.max()
    return int(np.sum(np.ceil(slowest / t) - 1))


def theorem2_learning_rate_ok(
    eta: float,
    L: float,
    theta_min: int,
    theta_max: int,
    dmax: int,
) -> bool:
    """Check condition (27) with the C(theta_max, delta_max) term evaluated at
    its dominant closed-form part (rho terms <= 1)."""
    u2 = theta_max * (theta_max - 1)
    if 1 - 2 * eta**2 * L**2 * u2 <= 0:
        return False
    u3 = 144 * eta**2 * L**2 * u2 / (1 - 2 * eta**2 * L**2 * u2)
    c = 8 * eta**2 * L**2 * dmax**2 * theta_max * (1 + u3) + 16 * eta**2 * L**2 * theta_max**2 * u3
    return 1 - eta * L * theta_max**2 / theta_min - c >= 0
