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
from repro_torch.kernels.fused_sgd.ops import plan_launches as sgd_plan
from repro_torch.kernels.fused_transition.ops import MAX_LEAVES, plan_launches

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


# -- launch planning of the leaf-table kernels ----------------------------------

@pytest.mark.parametrize("source", ["fused_transition/csrc/fused_transition.cu",
                                    "fused_sgd/csrc/sgd_update.cu",
                                    "cluster_agg/csrc/cluster_agg.cu"])
def test_planner_table_size_matches_the_kernel(source):
    """The tree wrappers plan with one planner, and its MAX_LEAVES is the
    leaf-table size the CUDA source was written for."""
    import re
    from pathlib import Path

    import repro_torch.kernels as kernels
    from repro_torch.kernels.cluster_agg.ops import plan_launches as agg_plan

    text = (Path(kernels.__file__).parent / source).read_text()
    assert sgd_plan is plan_launches and agg_plan is plan_launches
    assert int(re.search(r"constexpr int kMaxLeaves = (\d+);", text).group(1)) == MAX_LEAVES


@pytest.mark.parametrize("n,dtypes", [
    (1, (torch.float32,)), (12, (torch.bfloat16,)), (64, (torch.float32,)),
    (65, (torch.float32,)), (130, (torch.float32,)), (40, (torch.float32, torch.bfloat16)),
    (150, (torch.bfloat16, torch.float32, torch.bfloat16)),
])
def test_plan_launches_covers_every_leaf_once_in_order(n, dtypes):
    leaves = [(dtypes[i % len(dtypes)], 4 * (i + 1), (1024 * i,)) for i in range(n)]
    plan = plan_launches(leaves)
    seen = [i for _, members in plan for i, _ in members]
    assert sorted(seen) == list(range(n))
    for dtype, members in plan:
        assert 1 <= len(members) <= MAX_LEAVES
        assert all(leaves[i][0] == dtype for i, _ in members)
        assert [i for i, _ in members] == sorted(i for i, _ in members)
    for dtype in set(dtypes):  # ceil(n_dtype / K) launches per dtype, leaves in order
        idx = [i for i, leaf in enumerate(leaves) if leaf[0] == dtype]
        assert [i for dt, members in plan if dt == dtype for i, _ in members] == idx
        assert sum(dt == dtype for dt, _ in plan) == -(-len(idx) // MAX_LEAVES)
    assert [dt for dt, _ in plan][0] == dtypes[0]  # dtypes in order of first appearance


@pytest.mark.parametrize("dtype,m,offset,vec", [
    (torch.float32, 1024, 0, True),      # aligned, M a multiple of 4
    (torch.float32, 10, 0, False),       # MnistCNN's b4: M % 4 != 0
    (torch.float32, 333, 0, False),      # odd M
    (torch.float32, 1024, 1, False),     # offset view: base 4 bytes past 16
    (torch.float32, 1024, 4, True),      # offset by one vector: aligned again
    (torch.bfloat16, 4096, 0, True),     # aligned, M a multiple of 8
    (torch.bfloat16, 4, 0, False),       # M % 8 != 0
    (torch.bfloat16, 4096, 2, False),    # offset view: base 4 bytes past 16
    (torch.bfloat16, 0, 0, True),        # no columns: nothing to load
])
def test_plan_launches_vector_flag(dtype, m, offset, vec):
    buf = torch.zeros(3 * m + offset + 16, dtype=dtype)
    base = buf.data_ptr()
    w = buf[(-base // buf.element_size()) % 8:][offset:offset + 3 * m]  # from a 16-byte boundary
    out = torch.zeros(3 * m, dtype=dtype)
    assert (w.data_ptr() - offset * w.element_size()) % 16 == 0
    ((dt, [(i, flag)]),) = plan_launches([(dtype, m, (w.data_ptr(), out.data_ptr()))])
    assert (dt, i, flag) == (dtype, 0, vec)
    # every operand must be aligned: a misaligned g or out turns the flag off too
    ((_, [(_, flag)]),) = plan_launches([(dtype, m, (out.data_ptr(), w.data_ptr()))])
    assert flag == vec


def _trees(kind):
    """(params, grads) that differ in ``kind``, the mismatch in the last leaf."""
    params = {"a": torch.ones(3, 4), "b": torch.ones(3, 5)}
    grads = {"a": torch.ones(3, 4), "b": torch.ones(3, 5)}
    if kind == "keys":
        grads = {"a": grads["a"], "c": grads["b"]}
    elif kind == "shape":
        grads["b"] = torch.ones(3, 6)
    elif kind == "dtype":
        grads["b"] = torch.ones(3, 5, dtype=torch.bfloat16)
    elif kind == "missing":
        del grads["b"]
    return params, grads


@pytest.mark.parametrize("kind", ["keys", "shape", "dtype", "missing"])
def test_sgd_update_tree_refuses_mismatched_trees_before_any_dispatch(kind):
    params, grads = _trees(kind)
    before = sgd_update.launches
    with pytest.raises(ValueError):
        sgd_update_tree(params, grads, 0.5, inplace=True)
    assert all(bool((w == 1).all()) for w in params.values())  # no leaf was touched
    assert sgd_update.launches == before


@pytest.mark.parametrize("bad", ["leading_dim", "scalar_leaf", "factor_device"])
def test_fused_transition_tree_refuses_before_any_dispatch(bad):
    vt, p, bt = (_t(a) for a in _factors(8, 4))
    tree = {"a": torch.ones(8, 5), "b": torch.ones(8, 3)}
    if bad == "leading_dim":
        tree["b"] = torch.ones(6, 3)
    elif bad == "scalar_leaf":
        tree["b"] = torch.tensor(1.0)
    else:
        p = p.to("meta")
    with pytest.raises(ValueError):
        fused_transition_tree(tree, vt, p, bt, alpha=1, inplace=True)
    assert bool((tree["a"] == 1).all())


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


@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("masked", [False, True])
def test_cluster_agg_tree_ragged_matches_jax(d, masked):
    """The tree call's CPU path on a ragged tree (1-column, odd, 3-D and
    4-D leaves) against JAX's ``cluster_agg_tree`` in interpret mode."""
    c = 8
    tree = {"one": RNG.normal(size=(c, 1)), "odd": RNG.normal(size=(c, 333)),
            "w3d": RNG.normal(size=(c, 3, 7)), "w4d": RNG.normal(size=(c, 2, 3, 5)),
            "wide": RNG.normal(size=(c, 1024))}
    tree = {k: v.astype(np.float32) for k, v in tree.items()}
    wt = RNG.uniform(0.1, 1.0, c).astype(np.float32)
    if masked:
        wt[1::3] = 0.0
    ref = j_cluster_agg_tree({k: jnp.asarray(v) for k, v in tree.items()}, jnp.asarray(wt), d,
                             interpret=True, tile_m=128)
    out = cluster_agg_tree(params_from_numpy(tree, "cpu"), _t(wt), d)
    assert list(out) == list(tree)
    for k in tree:
        assert out[k].shape == (d,) + tree[k].shape[1:]
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=1e-5)


@pytest.mark.parametrize("bad", ["rows", "devices", "non_contiguous", "weights"])
def test_cluster_agg_tree_refuses_before_any_dispatch(bad):
    """Every leaf is checked before anything runs: C rows, the weights'
    device, contiguity (and weights of one row per client)."""
    tree = {"a": torch.ones(8, 5), "b": torch.ones(8, 3)}
    wt = torch.ones(8)
    if bad == "rows":
        tree["b"] = torch.ones(6, 3)
    elif bad == "devices":
        tree["b"] = torch.ones(8, 3, device="meta")
    elif bad == "non_contiguous":
        tree["b"] = torch.ones(3, 8).T
    else:
        wt = torch.ones(8, 1)
    before = cluster_agg.launches
    with pytest.raises(ValueError, match={"rows": "inconsistent with C=6",
                                          "devices": "one device",
                                          "non_contiguous": "contiguous",
                                          "weights": "must be"}[bad]):
        cluster_agg_tree(tree, wt, 4)
    assert cluster_agg.launches == before


def test_cluster_agg_tree_outputs_one_aligned_buffer_per_dtype():
    """The tree call's new outputs: one allocation per dtype, each leaf's
    (D, M) view starting on a 16-byte boundary and apart from the others."""
    from repro_torch.kernels.cluster_agg.ops import _outputs

    flats = [torch.zeros(8, m, dtype=dt) for m, dt in ((10, torch.float32), (3, torch.bfloat16),
                                                       (333, torch.float32), (7, torch.bfloat16))]
    given = torch.zeros(4, 3, dtype=torch.bfloat16)
    outs = _outputs(flats, [None, given, None, None], 4)
    assert outs[1] is given
    assert [tuple(o.shape) for o in outs] == [(4, 10), (4, 3), (4, 333), (4, 7)]
    assert outs[0].untyped_storage().data_ptr() == outs[2].untyped_storage().data_ptr()
    for o in outs:
        assert o.dtype in (torch.float32, torch.bfloat16) and o.is_contiguous()
        assert (o.data_ptr() - o.untyped_storage().data_ptr()) % 16 == 0
    for o in outs:
        o.zero_()
    outs[0].fill_(1.0)
    assert all(bool((o == 0).all()) for o in outs[1:])


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
