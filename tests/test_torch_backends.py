"""Port parity: aggregation backends against the reference's DenseBackend.

Dense and ``cuda`` (on the CPU: the kernel's plain version) must agree with
JAX ``DenseBackend`` on every event, with masked participation weights and a
faulted mixing matrix (a ring with one link removed), within 1e-5 (f32;
the static path forms T_k in float64, the kernel path factors it).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro_torch.convert import params_from_numpy, params_to_numpy

# six test workers share the host's cores: one intra-op thread each, also
# in the processes a test starts
os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(1)

ATOL = 1e-5


def _setup(c=8, d=4, alpha=2, seed=0):
    rng = np.random.default_rng(seed)
    sizes = tuple(rng.uniform(0.5, 2.0, c))
    assign = tuple(i // (c // d) for i in range(c))
    jcl, tcl = jcore.ClusterSpec(c, assign, sizes), tcore.ClusterSpec(c, assign, sizes)
    p = jcore.mixing_matrix(jcore.ring(d), jcl.m_tilde())
    tree = {"w": rng.normal(size=(c, 3, 5)).astype(np.float32),
            "b": rng.normal(size=(c, 7)).astype(np.float32)}
    mask = rng.uniform(size=c) > 0.3
    mask[:: c // d] = True  # no empty cluster
    w = np.where(mask, np.asarray(sizes), 0.0)
    totals = np.zeros(d)
    np.add.at(totals, list(assign), w)
    weights = (w / totals[list(assign)]).astype(np.float32)
    p_fault = jcore.mixing_matrix(jcore.chain(d), jcl.m_tilde()).astype(np.float32)
    return jcl, tcl, p, alpha, tree, weights, p_fault


def _jax_tree(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("backend", ["dense", "cuda"])
@pytest.mark.parametrize("event", ["local", "intra", "inter"])
@pytest.mark.parametrize("operands", ["static", "weights", "p", "weights+p"])
def test_transition_matches_jax_dense(backend, event, operands):
    jcl, tcl, p, alpha, tree, weights, p_fault = _setup()
    kw_np = {}
    if "weights" in operands:
        kw_np["weights"] = weights
    if operands.endswith("p"):
        kw_np["p"] = p_fault
    ref = jcore.DenseBackend(jcl, p, alpha).transition(
        _jax_tree(tree), event, **{k: jnp.asarray(v) for k, v in kw_np.items()}
    )
    be = tcore.resolve_backend(backend, tcl, p, alpha, device="cpu")
    assert be.name == backend
    out = be.transition(params_from_numpy(tree, "cpu"), event,
                        **{k: torch.from_numpy(v) for k, v in kw_np.items()})
    for k, v in params_to_numpy(out).items():
        np.testing.assert_allclose(v, np.asarray(ref[k]), atol=ATOL, err_msg=k)


def test_dense_factors_match_jax():
    jcl, tcl, p, alpha, tree, weights, _ = _setup()
    jb, tb = jcore.DenseBackend(jcl, p, alpha), tcore.DenseBackend(tcl, p, alpha, device="cpu")
    y_ref = jb.intra_cluster(_jax_tree(tree), jnp.asarray(weights))
    y = tb.intra_cluster(params_from_numpy(tree, "cpu"), torch.from_numpy(weights))
    for k, v in params_to_numpy(y).items():
        assert v.shape == (jcl.num_clusters,) + tree[k].shape[1:]
        np.testing.assert_allclose(v, np.asarray(y_ref[k]), atol=ATOL)
    mixed_ref = jb.inter_cluster(y_ref, jnp.asarray(p, jnp.float32), alpha=3)
    mixed = tb.inter_cluster(y, torch.tensor(p, dtype=torch.float32), alpha=3)
    for k, v in params_to_numpy(mixed).items():
        np.testing.assert_allclose(v, np.asarray(mixed_ref[k]), atol=ATOL)


def test_auto_resolves_dense_on_cpu_and_cuda_on_gpu_device():
    _, tcl, p, alpha, *_ = _setup()
    assert tcore.resolve_backend("auto", tcl, p, alpha, device="cpu").name == "dense"
    assert tcore.resolve_backend(None, tcl, p, alpha, device="cpu").name == "dense"
    assert tcore.select_auto_backend(tcl, torch.device("cuda")) == "cuda"
    ragged = tcore.ClusterSpec(5, (0, 0, 1, 1, 1), (1.0,) * 5)
    assert tcore.select_auto_backend(ragged, torch.device("cuda")) == "dense"


def test_cuda_backend_guards():
    _, tcl, p, alpha, tree, weights, _ = _setup()
    ragged = tcore.ClusterSpec(5, (0, 0, 1, 1, 1), (1.0,) * 5)
    with pytest.raises(ValueError, match="contiguous uniform"):
        tcore.CudaBackend(ragged, np.eye(2), 1, device="cpu")
    be = tcore.CudaBackend(tcl, p, alpha, device="cpu")
    with pytest.raises(ValueError, match="inconsistent with C=8"):
        be.intra_cluster(params_from_numpy(tree, "cpu"), torch.ones(6))
    with pytest.raises(ValueError, match="inconsistent with D=4"):
        be.inter_cluster({"w": torch.zeros(4, 3)}, torch.eye(3), 1)
    with pytest.raises(KeyError, match="unknown aggregation backend"):
        tcore.resolve_backend("pallas", tcl, p, alpha, device="cpu")


@pytest.mark.parametrize("reference", ["dense", "pallas"])
def test_cuda_factors_match_jax(reference):
    """``CudaBackend.intra_cluster`` (cluster_agg) and ``inter_cluster``
    (gossip_mix, in place) against the reference's factors, with masked
    participation weights and a faulted mixing matrix."""
    jcl, tcl, p, alpha, tree, weights, p_fault = _setup()
    jb = (jcore.DenseBackend(jcl, p, alpha) if reference == "dense"
          else jcore.PallasBackend(jcl, p, alpha, interpret=True, tile_m=128))
    tb = tcore.CudaBackend(tcl, p, alpha, device="cpu")
    y_ref = jb.intra_cluster(_jax_tree(tree), jnp.asarray(weights))
    y = tb.intra_cluster(params_from_numpy(tree, "cpu"), torch.from_numpy(weights))
    for k, v in params_to_numpy(y).items():
        assert v.shape == (jcl.num_clusters,) + tree[k].shape[1:]
        np.testing.assert_allclose(v, np.asarray(y_ref[k]), atol=ATOL)
    for mix, a in ((p.astype(np.float32), 3), (p_fault, 1)):
        mixed_ref = jb.inter_cluster(y_ref, jnp.asarray(mix), alpha=a)
        mixed = tb.inter_cluster(y, torch.from_numpy(mix), alpha=a)
        assert all(mixed[k] is y[k] for k in y)
        for k, v in params_to_numpy(mixed).items():
            np.testing.assert_allclose(v, np.asarray(mixed_ref[k]), atol=ATOL)
        y_ref = mixed_ref


def test_cuda_backend_transition_is_in_place():
    _, tcl, p, alpha, tree, *_ = _setup()
    params = params_from_numpy(tree, "cpu")
    out = tcore.CudaBackend(tcl, p, alpha, device="cpu").transition(params, "inter")
    assert all(out[k] is params[k] for k in tree)


@pytest.mark.parametrize("backend", ["dense", "cuda"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_transition_takes_tensor_operands_as_they_are(backend, dtype):
    """A per-call ``p`` (and ``weights``) tensor is converted on its device,
    never through numpy: a tensor that numpy() refuses (it requires grad)
    is taken, in either float type, and gives the numpy operands' result."""
    _, tcl, p, alpha, tree, weights, p_fault = _setup()
    be = tcore.resolve_backend(backend, tcl, p, alpha, device="cpu")
    want = be.transition(params_from_numpy(tree, "cpu"), "inter", weights=weights, p=p_fault)
    p_t = torch.tensor(p_fault, dtype=dtype, requires_grad=True)
    w_t = torch.tensor(weights, dtype=dtype, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        np.asarray(p_t)
    got = be.transition(params_from_numpy(tree, "cpu"), "inter", weights=w_t, p=p_t)
    for k, v in got.items():
        np.testing.assert_array_equal(v.detach().numpy(), want[k].numpy(), err_msg=k)
