"""Port parity: the kernels' plain versions against the Pallas kernels.

On the CPU the port's wrappers take their plain PyTorch versions; here they
are held against the JAX wrappers running the Pallas kernels in interpret
mode, over the sweeps of ``tests/test_kernels.py`` (alpha 0-3, bf16, ragged
leaves).  Tolerances as there: 1e-5 f32 transition, gossip and cluster
aggregation, 1e-6 f32 SGD and normalized update, 3e-2 bf16.
``test_torch_cuda.py`` holds each CUDA kernel against its plain version on
the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ClusterSpec, mixing_matrix, ring, staleness_mixing_matrix
from repro.kernels import cluster_agg as j_cluster_agg
from repro.kernels import cluster_agg_tree as j_cluster_agg_tree
from repro.kernels import fused_transition as j_fused_transition
from repro.kernels import fused_transition_tree as j_fused_transition_tree
from repro.kernels import gossip_mix as j_gossip_mix
from repro.kernels import gossip_mix_tree as j_gossip_mix_tree
from repro.kernels import normalized_update as j_normalized_update
from repro.kernels import sgd_update as j_sgd_update
from repro.kernels import sgd_update_tree as j_sgd_update_tree
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.kernels import (
    cluster_agg, cluster_agg_tree, fused_transition, fused_transition_tree, gossip_mix,
    gossip_mix_tree, normalized_update, sgd_update, sgd_update_tree,
)

RNG = np.random.default_rng(0)


def _factors(c, d, rng=RNG):
    spec = ClusterSpec(c, tuple(i // (c // d) for i in range(c)), tuple(rng.uniform(0.5, 2.0, c)))
    return (spec.V().T.astype(np.float32), mixing_matrix(ring(d), spec.m_tilde()).astype(np.float32),
            spec.B().T.astype(np.float32))


def _t(a, dtype=torch.float32):
    return torch.tensor(a, dtype=torch.float32).to(dtype)


@pytest.mark.parametrize("c,d,m,alpha", [
    (8, 4, 512, 0), (8, 4, 512, 1), (16, 4, 1024, 2), (20, 5, 512, 3),
])
def test_fused_transition_sweep(c, d, m, alpha):
    vt, p, bt = _factors(c, d)
    w = RNG.normal(size=(c, m)).astype(np.float32)
    ref = j_fused_transition(jnp.asarray(w), jnp.asarray(vt), jnp.asarray(p), jnp.asarray(bt),
                             alpha=alpha, interpret=True, tile_m=256)
    out = fused_transition(_t(w), _t(vt), _t(p), _t(bt), alpha=alpha)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 3e-2)])
def test_fused_transition_dtypes(dtype, tol):
    vt, p, bt = _factors(8, 4)
    w = RNG.normal(size=(8, 512)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = j_fused_transition(jnp.asarray(w, jdt), jnp.asarray(vt), jnp.asarray(p),
                             jnp.asarray(bt), alpha=2, interpret=True)
    out = fused_transition(_t(w, dtype), _t(vt), _t(p), _t(bt), alpha=2)
    assert out.dtype == dtype
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=tol)


@pytest.mark.parametrize("inplace", [False, True])
def test_fused_transition_tree_ragged_leaves(inplace):
    vt, p, bt = _factors(8, 4)
    tree = {"a": RNG.normal(size=(8, 3, 7)).astype(np.float32),
            "b": RNG.normal(size=(8, 130)).astype(np.float32)}
    ref = j_fused_transition_tree({k: jnp.asarray(v) for k, v in tree.items()},
                                  jnp.asarray(vt), jnp.asarray(p), jnp.asarray(bt),
                                  alpha=1, interpret=True, tile_m=64)
    tp = params_from_numpy(tree, "cpu")
    out = fused_transition_tree(tp, _t(vt), _t(p), _t(bt), alpha=1, inplace=inplace)
    for k in tree:
        assert out[k].shape == tree[k].shape
        assert (out[k] is tp[k]) == inplace
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=1e-5)


@pytest.mark.parametrize("n,lr", [(1024, 0.1), (4096, 0.001)])
def test_sgd_update(n, lr):
    w, g = RNG.normal(size=n).astype(np.float32), RNG.normal(size=n).astype(np.float32)
    ref = j_sgd_update(jnp.asarray(w), jnp.asarray(g), lr, interpret=True)
    np.testing.assert_allclose(sgd_update(_t(w), _t(g), lr).numpy(), np.asarray(ref), atol=1e-6)


def test_sgd_update_bf16():
    w, g = RNG.normal(size=2048).astype(np.float32), RNG.normal(size=2048).astype(np.float32)
    ref = j_sgd_update(jnp.asarray(w, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16), 0.05,
                       interpret=True)
    out = sgd_update(_t(w, torch.bfloat16), _t(g, torch.bfloat16), 0.05)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=3e-2)


@pytest.mark.parametrize("inplace", [False, True])
def test_sgd_update_tree_ragged(inplace):
    params = {"w": RNG.normal(size=(3, 5, 7)).astype(np.float32),
              "b": RNG.normal(size=(11,)).astype(np.float32)}
    grads = {k: RNG.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
    ref = j_sgd_update_tree({k: jnp.asarray(v) for k, v in params.items()},
                            {k: jnp.asarray(v) for k, v in grads.items()},
                            0.05, interpret=True, tile_m=64)
    tp = params_from_numpy(params, "cpu")
    out = sgd_update_tree(tp, params_from_numpy(grads, "cpu"), 0.05, inplace=inplace)
    for k, v in params_to_numpy(out).items():
        assert (out[k] is tp[k]) == inplace
        np.testing.assert_allclose(v, np.asarray(ref[k]), atol=1e-6)


def test_wrappers_reject_bad_operands():
    vt, p, bt = (_t(a) for a in _factors(8, 4))
    with pytest.raises(ValueError):
        fused_transition(torch.zeros(6, 16), vt, p, bt)          # C mismatch
    with pytest.raises(ValueError):
        fused_transition(torch.zeros(8, 16), vt, p, bt, alpha=-1)
    with pytest.raises(ValueError):
        sgd_update(torch.zeros(4), torch.zeros(5), 0.1)
    with pytest.raises(ValueError):
        sgd_update(torch.zeros(4), torch.zeros(4, dtype=torch.float64), 0.1)


def test_cpu_calls_do_not_count_launches():
    wrappers = (fused_transition, sgd_update, gossip_mix, cluster_agg, normalized_update)
    before = [f.launches for f in wrappers]
    vt, p, bt = (_t(a) for a in _factors(8, 4))
    fused_transition(torch.zeros(8, 16), vt, p, bt)
    sgd_update(torch.zeros(4), torch.zeros(4), 0.1)
    gossip_mix(torch.zeros(4, 16), p, alpha=1)
    cluster_agg(torch.zeros(8, 16), torch.ones(8), 4)
    normalized_update(torch.zeros(5, 16), torch.zeros(5, 16), torch.ones(5))
    assert [f.launches for f in wrappers] == before


# -- the async path's kernels --------------------------------------------------

def _mixing(kind, d, rng=RNG):
    """The ring P (eq. 5) or an eq. 22 P_t with random gaps, f32."""
    spec = ClusterSpec(d, tuple(range(d)), tuple(rng.uniform(0.5, 2.0, d)))
    if kind == "ring":
        return mixing_matrix(ring(d), spec.m_tilde()).astype(np.float32)
    gaps = rng.integers(0, 6, d).astype(float)
    gaps[1] = 0.0
    return staleness_mixing_matrix(ring(d), 1, gaps).astype(np.float32)


@pytest.mark.parametrize("kind", ["ring", "p_t"])
@pytest.mark.parametrize("alpha", [0, 1, 2])
@pytest.mark.parametrize("d", [2, 4, 8])
def test_gossip_mix_matches_jax(d, alpha, kind):
    p = _mixing(kind, d)
    tree = {"w": RNG.normal(size=(d, 3, 7)).astype(np.float32),     # ragged: M = 21
            "b": RNG.normal(size=(d, 512)).astype(np.float32)}
    ref = j_gossip_mix_tree({k: jnp.asarray(v) for k, v in tree.items()}, jnp.asarray(p),
                            alpha=alpha, interpret=True, tile_m=128)
    tp = params_from_numpy(tree, "cpu")
    out = gossip_mix_tree(tp, _t(p), alpha=alpha, inplace=True)
    for k in tree:
        assert out[k] is tp[k]
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=1e-5, err_msg=k)


def test_gossip_mix_bf16():
    p = _mixing("p_t", 4)
    y = RNG.normal(size=(4, 512)).astype(np.float32)
    ref = j_gossip_mix(jnp.asarray(y, jnp.bfloat16), jnp.asarray(p), alpha=2, interpret=True)
    out = gossip_mix(_t(y, torch.bfloat16), _t(p), alpha=2)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=3e-2)


@pytest.mark.parametrize("c,d", [(8, 2), (20, 4), (5, 1), (12, 12)])
@pytest.mark.parametrize("masked", [False, True])
def test_cluster_agg_matches_jax(c, d, masked):
    w = RNG.normal(size=(c, 512)).astype(np.float32)
    wt = RNG.uniform(0.1, 1.0, c).astype(np.float32)
    if masked:  # participation masks give weights of exactly 0
        wt[:: 3] = 0.0
    ref = j_cluster_agg(jnp.asarray(w), jnp.asarray(wt), d, interpret=True, tile_m=256)
    out = cluster_agg(_t(w), _t(wt), d)
    assert out.shape == (d, 512)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_cluster_agg_tree_ragged_leaves():
    tree = {"a": RNG.normal(size=(8, 3, 7)).astype(np.float32),
            "b": RNG.normal(size=(8, 130)).astype(np.float32)}
    wt = RNG.uniform(0.1, 1.0, 8).astype(np.float32)
    ref = j_cluster_agg_tree({k: jnp.asarray(v) for k, v in tree.items()}, jnp.asarray(wt), 4,
                             interpret=True, tile_m=64)
    out = cluster_agg_tree(params_from_numpy(tree, "cpu"), _t(wt), 4)
    for k in tree:
        assert out[k].shape == (4,) + tree[k].shape[1:]
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=1e-5)


def test_normalized_update_scalar_matches_jax():
    wf, w0 = RNG.normal(size=2048).astype(np.float32), RNG.normal(size=2048).astype(np.float32)
    ref = j_normalized_update(jnp.asarray(wf), jnp.asarray(w0), 1.0 / 7.0, interpret=True)
    np.testing.assert_allclose(normalized_update(_t(wf), _t(w0), 1.0 / 7.0).numpy(),
                               np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6), (torch.bfloat16, 3e-2)])
def test_normalized_update_per_row(dtype, tol):
    theta = np.array([1, 3, 7, 8, 2], np.float32)
    wf = RNG.normal(size=(5, 3, 7)).astype(np.float32)
    w0 = RNG.normal(size=(5, 3, 7)).astype(np.float32)
    out = normalized_update(_t(wf, dtype), _t(w0, dtype), _t(1.0 / theta))
    assert out.dtype == dtype and out.shape == wf.shape
    wf_r, w0_r = (_t(a, dtype).float().numpy() for a in (wf, w0))
    np.testing.assert_allclose(out.float().numpy(),
                               (wf_r - w0_r) / theta[:, None, None], atol=tol)
    with pytest.raises(ValueError, match="one factor per row"):
        normalized_update(_t(wf), _t(w0), _t(1.0 / theta[:4]))
