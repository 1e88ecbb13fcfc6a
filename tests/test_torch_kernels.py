"""Port parity: the kernels' plain versions against the Pallas kernels.

On the CPU the port's wrappers take their plain PyTorch versions; here they
are held against the JAX wrappers running the Pallas kernels in interpret
mode, over the sweeps of ``tests/test_kernels.py`` (alpha 0-3, bf16, ragged
leaves).  Tolerances as there: 1e-5 f32 transition, gossip and cluster
aggregation, 1e-6 f32 SGD and normalized update, 3e-2 bf16.
``test_torch_cuda.py`` holds each CUDA kernel against its plain version on
the card.
"""
import os

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
    gossip_mix_tree, normalized_update, normalized_update_tree, sgd_update, sgd_update_tree,
)
from repro_torch.kernels.fused_sgd.ops import plan_launches as sgd_plan
from repro_torch.kernels.fused_transition.ops import MAX_LEAVES, plan_launches

# six test workers share the host's cores: one intra-op thread each, also
# in the processes a test starts
os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(1)

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
    gossip_mix_tree({"y": torch.zeros(4, 16)}, p, alpha=1)
    normalized_update_tree({"w": torch.zeros(5, 16)}, {"w": torch.zeros(5, 16)}, torch.ones(5))
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


@pytest.mark.parametrize("caller", ["cluster_agg", "normalized_update"])
def test_cluster_agg_tree_outputs_one_aligned_buffer_per_dtype(caller):
    """The tree calls' new outputs (``_leaves.leaf_outputs``, shared by
    ``cluster_agg`` with its ``(D, M)`` outputs and ``normalized_update``
    with outputs shaped as its inputs): one allocation per dtype, each
    leaf's view starting on a 16-byte boundary and apart from the others."""
    from repro_torch.kernels._leaves import leaf_outputs
    from repro_torch.kernels.cluster_agg.ops import leaf_outputs as agg_outputs
    from repro_torch.kernels.fused_sgd.ops import leaf_outputs as sgd_outputs

    assert agg_outputs is leaf_outputs and sgd_outputs is leaf_outputs
    dts = (torch.float32, torch.bfloat16, torch.float32, torch.bfloat16)
    shapes = {"cluster_agg": [(4, 10), (4, 3), (4, 333), (4, 7)],  # (D, M) from (C, M)
              "normalized_update": [(5, 10), (5, 3), (5, 3, 7), (5, 7, 1)]}[caller]
    given = torch.zeros(shapes[1], dtype=torch.bfloat16)
    outs = leaf_outputs(list(zip(shapes, dts)), [None, given, None, None], "cpu")
    assert outs[1] is given
    assert [tuple(o.shape) for o in outs] == shapes
    assert outs[0].untyped_storage().data_ptr() == outs[2].untyped_storage().data_ptr()
    for o, dt in zip(outs, dts):
        assert o.dtype == dt and o.is_contiguous()
        assert (o.data_ptr() - o.untyped_storage().data_ptr()) % 16 == 0
    for o in outs:
        o.zero_()
    outs[0].fill_(1.0)
    outs[3].fill_(1.0)
    assert all(bool((o == 0).all()) for o in outs[1:3])


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


# -- the async path's tree calls ---------------------------------------------

def _ragged_rows(rows, rng=RNG):
    """``(rows, ...)`` f32 leaves with 1-column, odd, 3-D and wide rows."""
    tree = {"one": rng.normal(size=(rows, 1)), "odd": rng.normal(size=(rows, 333)),
            "w3d": rng.normal(size=(rows, 3, 7)), "wide": rng.normal(size=(rows, 1024))}
    return {k: v.astype(np.float32) for k, v in tree.items()}


@pytest.mark.parametrize("alpha", [0, 1, 3])
@pytest.mark.parametrize("d", [1, 4, 5, 16])
def test_gossip_mix_tree_ragged_matches_jax(d, alpha):
    """The tree call's CPU path on a ragged tree against JAX's
    ``gossip_mix_tree`` in interpret mode, for D on every side of the
    kernel's register sizes (4, 8, 16), within 1e-6 (f32 sums of D
    products in another order)."""
    rng = np.random.default_rng(d * 10 + alpha)
    p = rng.uniform(0.0, 1.0, (d, d))
    p = (p / p.sum(axis=0)).astype(np.float32)  # columns sum to 1, as a mixing matrix
    tree = _ragged_rows(d, rng)
    ref = j_gossip_mix_tree({k: jnp.asarray(v) for k, v in tree.items()}, jnp.asarray(p),
                            alpha=alpha, interpret=True, tile_m=128)
    out = gossip_mix_tree(params_from_numpy(tree, "cpu"), _t(p), alpha=alpha)
    assert list(out) == list(tree)
    for k in tree:
        assert out[k].shape == tree[k].shape
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=1e-6, err_msg=k)


@pytest.mark.parametrize("per_row", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_normalized_update_tree_matches_jax_rows_bitwise(dtype, per_row):
    """The tree call's CPU path against JAX's ``normalized_update`` (the
    Pallas kernel in interpret mode) on each row with its scalar factor,
    bit for bit: both take an f32 difference and product and one cast."""
    theta = np.array([1.0, 3.0, 7.0], np.float32)
    inv = (1.0 / theta).astype(np.float32)
    wf, w0 = _ragged_rows(3), _ragged_rows(3)
    tw = {k: _t(v, dtype) for k, v in wf.items()}
    t0 = {k: _t(v, dtype) for k, v in w0.items()}
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    out = normalized_update_tree(tw, t0, _t(inv) if per_row else float(inv[1]))
    assert list(out) == list(wf)
    for k in wf:
        assert out[k].shape == wf[k].shape and out[k].dtype == dtype
        for r in range(3):
            a, b = (jnp.asarray(x[k][r].reshape(-1), jdt) for x in (wf, w0))
            ref = j_normalized_update(a, b, float(inv[r] if per_row else inv[1]),
                                      interpret=True, tile_m=a.size)
            np.testing.assert_array_equal(out[k][r].reshape(-1).float().numpy(),
                                          np.asarray(ref, np.float32), err_msg=f"{k}[{r}]")


def _async_trees(bad):
    """(y for gossip_mix_tree, p, w_final, w_start, out, inv_theta), all
    ones, with ``bad`` broken in the last leaf (or operand)."""
    y = {"a": torch.ones(4, 5), "b": torch.ones(4, 3)}
    p = torch.eye(4)
    wf = {"a": torch.ones(5, 4), "b": torch.ones(5, 3, 2)}
    w0 = {k: torch.ones_like(v) for k, v in wf.items()}
    inv = torch.ones(5)
    if bad == "keys":
        w0 = {"a": w0["a"], "c": w0["b"]}
    elif bad == "shape":
        w0["b"] = torch.ones(5, 3, 3)
    elif bad == "dtype":
        w0["b"] = torch.ones(5, 3, 2, dtype=torch.bfloat16)
    elif bad == "devices":
        y["b"] = torch.ones(4, 3, device="meta")
        wf["b"], w0["b"] = (torch.ones(5, 3, 2, device="meta") for _ in range(2))
    elif bad == "non_contiguous":
        y["b"] = torch.ones(3, 4).T
        wf["b"] = torch.ones(2, 3, 5).permute(2, 1, 0)
    elif bad == "rows":
        y["b"] = torch.ones(5, 3)
        inv = torch.ones(4)
    return y, p, wf, w0, inv


@pytest.mark.parametrize("bad", ["keys", "shape", "dtype", "devices", "non_contiguous", "rows"])
def test_async_trees_refuse_before_any_dispatch(bad):
    """Both tree calls check every leaf before any is touched (in place, so
    a touched leaf would show) and launch nothing when they refuse."""
    y, p, wf, w0, inv = _async_trees(bad)
    before = gossip_mix.launches, normalized_update.launches
    if bad in ("devices", "non_contiguous", "rows"):  # gossip_mix_tree has one tree
        with pytest.raises(ValueError, match={"devices": "one device", "rows": "inconsistent",
                                              "non_contiguous": "contiguous"}[bad]):
            gossip_mix_tree(y, p * 0.5, alpha=1, inplace=True)
        assert bool((y["a"] == 1).all())
    with pytest.raises(ValueError, match={"keys": "different keys", "shape": "does not match",
                                          "dtype": "does not match", "devices": "one device",
                                          "non_contiguous": "contiguous",
                                          "rows": "one factor per row"}[bad]):
        normalized_update_tree(wf, w0, inv, out=wf)
    assert all(bool((v == 1).all()) for v in wf.values() if v.device.type == "cpu")
    assert (gossip_mix.launches, normalized_update.launches) == before
