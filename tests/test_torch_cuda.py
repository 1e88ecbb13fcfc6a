"""The port's CUDA kernels and kernel path on the card (skip without one).

Imports torch and ``repro_torch`` only, so it also runs on a machine without
JAX: ``PYTHONPATH=src python3 -m pytest -q tests/test_torch_cuda.py``.
Each kernel is held against its plain PyTorch version on the same CUDA
inputs (1e-5 f32 transition, gossip and cluster aggregation, 1e-6 f32 SGD
and normalized update, 3e-2 bf16, as the reference's kernel tests), and the
kernel backend's training runs against the dense backend's (1e-4 after
several iterations or events: the kernels' f32 sums run in another order
than the dense products, and the normalized update multiplies by
``1 / theta`` where the dense path divides).  Flash attention: 2e-5 f32 and
3e-2 bf16 forward, as the reference's kernel tests; gradients 1e-4 (f32) and
3e-2 (bf16) relative to the largest reference entry, since each gradient
entry sums up to S * G products in another order than the plain version
and, in bf16, is rounded once to 2^-8 relative.  The captured steps
(``core/cuda_graph.py``) are held to eager runs of the same scenario under
cuDNN's deterministic algorithms, where eager repeats itself bitwise, with
the eager runs' exact kernel runs in every step, counted on the device by
the profiler (a replay launches nothing from the host, so the wrappers'
counters move only at a key's warm-up and capture); a new batch shape or
new parameter tensors re-capture, and the old tensors are never written.
The collective backend (plain PyTorch: hypercube all-reduce and ring gossip)
replays on the sync, round and async graphs at 0.0 from its eager runs.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.core import ClusterSpec, build_local_update, chain, mixing_matrix, ring
from repro_torch.core import resolve_backend, staleness_mixing_matrix
from repro_torch.kernels import (
    cluster_agg, cluster_agg_ref, cluster_agg_tree, flash_attention, flash_attention_bwd,
    flash_attention_bwd_ref, flash_attention_fwd, flash_attention_fwd_ref, fused_transition,
    fused_transition_ref,
    fused_transition_tree, gossip_mix, gossip_mix_ref, gossip_mix_tree, device_launches,
    normalized_update, normalized_update_ref, normalized_update_tree, sgd_update, sgd_update_ref,
    sgd_update_tree,
)
from repro_torch.kernels.fused_transition.ops import MAX_LEAVES
from repro_torch.kernels.flash_attention import route
from repro_torch.models import MnistCNN
from repro_torch.optim import sgd
from repro_torch.scenarios import build_scenario

# six test workers share the host's cores: one intra-op thread each, also
# in the processes a test starts
os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(1)

RNG = np.random.default_rng(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _factors(device, c=20, d=4, faulted=False):
    spec = ClusterSpec(c, tuple(i // (c // d) for i in range(c)), tuple(RNG.uniform(0.5, 2.0, c)))
    topo = chain(d) if faulted else ring(d)
    f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=device)
    return f32(spec.V().T), f32(mixing_matrix(topo, spec.m_tilde())), f32(spec.B().T)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("alpha", [0, 1, 2])
@pytest.mark.parametrize("m", [10, 333, 16_000])
@pytest.mark.parametrize("faulted", [False, True])
def test_fused_transition_matches_plain(cuda, dtype, tol, alpha, m, faulted):
    vt, p, bt = _factors(cuda, faulted=faulted)
    w = torch.tensor(RNG.normal(size=(20, m)), dtype=torch.float32, device=cuda).to(dtype)
    n = fused_transition.launches
    out = fused_transition(w, vt, p, bt, alpha=alpha)
    torch.cuda.synchronize()
    assert fused_transition.launches == n + 1
    ref = fused_transition_ref(w, vt, p, bt, alpha)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)
    fused_transition(w, vt, p, bt, alpha=alpha, out=w)  # in place
    torch.testing.assert_close(w.float(), ref.float(), atol=tol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("n,offset", [(4096, 0), (1001, 1)])
def test_sgd_update_matches_plain(cuda, dtype, tol, n, offset):
    w = torch.tensor(RNG.normal(size=n + offset), device=cuda).to(dtype)[offset:]
    g = torch.tensor(RNG.normal(size=n + offset), device=cuda).to(dtype)[offset:]
    out = sgd_update(w, g, 0.05)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), sgd_update_ref(w, g, 0.05).float(), atol=tol, rtol=0)


def _ragged_tree(device, dtype, c, seed=0):
    """(C, ...) leaves mixing vector-aligned and unaligned M: M = 0, M = 10
    (MnistCNN's b4), an odd M, aligned M, a 3-D leaf and an offset view."""
    gen = torch.Generator(device=device).manual_seed(seed)
    mk = lambda *shape: torch.randn(shape, generator=gen, device=device).to(dtype)
    buf = mk(c * 1024 + 1)
    return {"m0": mk(c, 0), "m10": mk(c, 10), "m333": mk(c, 333), "m1024": mk(c, 1024),
            "m16000": mk(c, 16_000), "w3d": mk(c, 5, 5, 8), "offset": buf[1:].view(c, 1024)}


def _uniform_factors(device, c, d, faulted=False):
    spec = ClusterSpec(c, tuple(i // (c // d) for i in range(c)), tuple(RNG.uniform(0.5, 2.0, c)))
    p = np.ones((1, 1)) if d == 1 else mixing_matrix(chain(d) if faulted else ring(d),
                                                     spec.m_tilde())
    f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=device)
    return f32(spec.V().T), f32(p), f32(spec.B().T)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("alpha", [0, 1, 2])
@pytest.mark.parametrize("d", [1, 4, 8, 16])
def test_fused_transition_tree_ragged_one_launch(cuda, dtype, tol, alpha, d):
    """One launch for the whole ragged tree; each leaf within ``tol`` of the
    plain version; in place and out of place bitwise equal; the tree equal,
    bit for bit, to one single-leaf call per leaf."""
    c = 16
    vt, p, bt = _uniform_factors(cuda, c, d, faulted=d == 4)
    tree = _ragged_tree(cuda, dtype, c, seed=alpha)
    n = fused_transition.launches
    out = fused_transition_tree(tree, vt, p, bt, alpha=alpha)
    torch.cuda.synchronize()
    assert fused_transition.launches == n + 1
    for k, w in tree.items():
        flat = w.reshape(c, w.numel() // c)
        assert out[k].shape == w.shape and out[k].dtype == dtype
        ref = fused_transition_ref(flat, vt, p, bt, alpha).view(w.shape)
        torch.testing.assert_close(out[k].float(), ref.float(), atol=tol, rtol=0)
        assert torch.equal(fused_transition(flat, vt, p, bt, alpha=alpha).view(w.shape), out[k])
    inplace = {k: w.clone() if k != "offset" else w for k, w in tree.items()}
    n = fused_transition.launches
    res = fused_transition_tree(inplace, vt, p, bt, alpha=alpha, inplace=True)
    torch.cuda.synchronize()
    assert fused_transition.launches == n + 1
    for k in tree:
        assert res[k] is inplace[k] and torch.equal(res[k], out[k])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sgd_update_tree_ragged_bitwise(cuda, dtype):
    """One launch for the tree, bitwise equal to the plain version, to the
    in-place update and to one single-leaf call per leaf."""
    params = _ragged_tree(cuda, dtype, 4, seed=1)
    params["odd"] = torch.randn(1001, device=cuda).to(dtype)
    grads = {k: torch.randn_like(w, dtype=torch.float32).to(dtype) for k, w in params.items()}
    n = sgd_update.launches
    out = sgd_update_tree(params, grads, 0.05)
    torch.cuda.synchronize()
    assert sgd_update.launches == n + 1
    for k, w in params.items():
        assert torch.equal(out[k], sgd_update_ref(w, grads[k], 0.05))
        assert torch.equal(out[k], sgd_update(w, grads[k], 0.05))
    res = sgd_update_tree(params, grads, 0.05, inplace=True)
    for k in params:
        assert res[k] is params[k] and torch.equal(params[k], out[k])


@pytest.mark.cuda
def test_tree_kernels_launch_per_dtype_and_per_max_leaves(cuda):
    """A tree of more than MAX_LEAVES leaves of one dtype takes two launches,
    a tree mixing f32 and bf16 two, and each leaf still matches."""
    vt, p, bt = _uniform_factors(cuda, 20, 4)
    big = {f"l{i}": torch.randn(20, 90 + 3 * i, device=cuda) for i in range(MAX_LEAVES + 6)}
    mixed = {"a": torch.randn(20, 64, device=cuda),
             "b": torch.randn(20, 64, device=cuda).to(torch.bfloat16),
             "c": torch.randn(20, 7, device=cuda), "d": torch.randn(20, 9, device=cuda).to(
                 torch.bfloat16)}
    for tree, tol in ((big, {torch.float32: 1e-5}), (mixed, {torch.float32: 1e-5,
                                                             torch.bfloat16: 3e-2})):
        n = fused_transition.launches, sgd_update.launches
        out = fused_transition_tree(tree, vt, p, bt, alpha=2)
        grads = {k: torch.randn_like(w, dtype=torch.float32).to(w.dtype) for k, w in tree.items()}
        new = sgd_update_tree(tree, grads, 0.1)
        torch.cuda.synchronize()
        assert (fused_transition.launches - n[0], sgd_update.launches - n[1]) == (2, 2)
        for k, w in tree.items():
            ref = fused_transition_ref(w, vt, p, bt, 2)
            torch.testing.assert_close(out[k].float(), ref.float(), atol=tol[w.dtype], rtol=0)
            assert torch.equal(new[k], sgd_update_ref(w, grads[k], 0.1))


@pytest.mark.cuda
def test_wrappers_raise_instead_of_falling_back(cuda):
    vt, p, bt = _factors(cuda)
    with pytest.raises(TypeError):
        fused_transition(torch.zeros(20, 8, dtype=torch.float64, device=cuda), vt, p, bt)
    with pytest.raises(ValueError, match="contiguous"):
        sgd_update(torch.zeros(4, 4, device=cuda).T, torch.zeros(4, 4, device=cuda).T, 0.1)
    with pytest.raises(ValueError, match="one device"):
        fused_transition(torch.zeros(20, 8, device=cuda), vt.cpu(), p, bt)
    with pytest.raises(TypeError):
        gossip_mix(torch.zeros(4, 8, dtype=torch.float64, device=cuda), torch.eye(4, device=cuda))
    with pytest.raises(ValueError, match="D <= 16"):
        gossip_mix(torch.zeros(17, 8, device=cuda), torch.eye(17, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        gossip_mix(torch.zeros(8, 4, device=cuda).T, torch.eye(4, device=cuda))
    with pytest.raises(ValueError, match="leaves' device"):  # no silent host round trip
        gossip_mix(torch.zeros(4, 8, device=cuda), torch.eye(4))
    with pytest.raises(ValueError, match="one device"):
        cluster_agg(torch.zeros(20, 8, device=cuda), torch.ones(20), 4)
    with pytest.raises(TypeError, match="float32 weights"):
        cluster_agg(torch.zeros(20, 8, device=cuda), torch.ones(20, device=cuda).double(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        normalized_update(torch.zeros(8, 5, device=cuda).T, torch.zeros(8, 5, device=cuda).T,
                          torch.ones(5, device=cuda))
    with pytest.raises(ValueError, match="one device"):
        normalized_update(torch.zeros(5, 8, device=cuda), torch.zeros(5, 8, device=cuda),
                          torch.ones(5))


def _p_t(device, d=4, trigger=1):
    gaps = RNG.integers(0, 6, d).astype(float)
    gaps[trigger] = 0.0
    return torch.tensor(staleness_mixing_matrix(ring(d), trigger, gaps), dtype=torch.float32,
                        device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("alpha", [0, 1, 2])
@pytest.mark.parametrize("m", [10, 333, 16_000])
@pytest.mark.parametrize("mixing", ["ring", "p_t"])
def test_gossip_mix_matches_plain_in_place(cuda, dtype, tol, alpha, m, mixing):
    p = _p_t(cuda) if mixing == "p_t" else _factors(cuda)[1]
    y = torch.tensor(RNG.normal(size=(4, m)), dtype=torch.float32, device=cuda).to(dtype)
    ref = gossip_mix_ref(y, p, alpha)
    n = gossip_mix.launches
    out = gossip_mix(y, p, alpha=alpha)
    torch.cuda.synchronize()
    assert gossip_mix.launches == n + 1
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)
    gossip_mix(y, p, alpha=alpha, out=y)  # in place
    torch.testing.assert_close(y.float(), ref.float(), atol=tol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("m", [10, 333, 16_000])
@pytest.mark.parametrize("c,d", [(20, 4), (5, 1)])
def test_cluster_agg_matches_plain_and_skips_masked_rows(cuda, dtype, tol, m, c, d):
    w = torch.tensor(RNG.normal(size=(c, m)), dtype=torch.float32, device=cuda).to(dtype)
    wt = torch.tensor(RNG.uniform(0.1, 1.0, c), dtype=torch.float32, device=cuda)
    wt[1::3] = 0.0  # masked participation
    out = cluster_agg(w, wt, d)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), cluster_agg_ref(w, wt, d).float(), atol=tol, rtol=0)
    # a masked row contributes exactly nothing, whatever it holds
    w[1::3] = float("nan")
    assert torch.equal(cluster_agg(w, wt, d), out)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 4])
def test_cluster_agg_tree_ragged_one_launch_per_dtype_group(cuda, d):
    """A ragged tree mixing f32 and bf16 leaves (one of them off a 16-byte
    boundary) takes one launch per dtype; a tree of 96 f32 leaves takes two.
    Each leaf is bitwise the one-leaf call and within tolerance of the plain
    version, and a masked row contributes exactly nothing, even NaN."""
    c = 20
    gen = torch.Generator(device=cuda).manual_seed(d)
    mk = lambda dtype, *shape: torch.randn(shape, generator=gen, device=cuda).to(dtype)
    buf = mk(torch.float32, c * 1024 + 1)
    tree = {"m10": mk(torch.float32, c, 10), "bf333": mk(torch.bfloat16, c, 333),
            "w3d": mk(torch.float32, c, 5, 5, 8), "bf16000": mk(torch.bfloat16, c, 16_000),
            "offset": buf[1:].view(c, 1024), "m0": mk(torch.float32, c, 0),
            "m4096": mk(torch.float32, c, 4096), "bf1024": mk(torch.bfloat16, c, 1024)}
    assert tree["offset"].data_ptr() % 16
    wt = torch.tensor(RNG.uniform(0.1, 1.0, c), dtype=torch.float32, device=cuda)
    wt[1::3] = 0.0  # masked participation
    n = cluster_agg.launches
    out = cluster_agg_tree(tree, wt, d)
    torch.cuda.synchronize()
    assert cluster_agg.launches == n + 2  # one per dtype
    tol = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
    for k, w in tree.items():
        flat = w.reshape(c, -1)
        assert out[k].shape == (d,) + w.shape[1:] and out[k].dtype == w.dtype
        assert torch.equal(cluster_agg(flat, wt, d).view(out[k].shape), out[k])
        torch.testing.assert_close(out[k].float().reshape(d, -1),
                                   cluster_agg_ref(flat, wt, d).float(), atol=tol[w.dtype], rtol=0)
    for w in tree.values():
        w.view(c, -1)[1::3] = float("nan")
    again = cluster_agg_tree(tree, wt, d)
    for k in tree:
        assert torch.equal(again[k], out[k])
    many = {f"l{i}": mk(torch.float32, c, 90 + 3 * i) for i in range(96)}
    n = cluster_agg.launches
    res = cluster_agg_tree(many, wt, d)
    torch.cuda.synchronize()
    assert cluster_agg.launches == n + 2
    for k, w in many.items():
        assert torch.equal(res[k], cluster_agg(w, wt, d))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("m", [10, 333, 16_000])
@pytest.mark.parametrize("offset", [0, 1])
def test_normalized_update_matches_plain(cuda, dtype, tol, m, offset):
    theta = torch.tensor([1.0, 3.0, 7.0, 8.0, 2.0], device=cuda)
    n = 5 * m + offset
    wf = torch.tensor(RNG.normal(size=n), device=cuda).to(dtype)[offset:].view(5, m)
    w0 = torch.tensor(RNG.normal(size=n), device=cuda).to(dtype)[offset:].view(5, m)
    out = normalized_update(wf, w0, 1.0 / theta)
    torch.cuda.synchronize()
    ref = normalized_update_ref(wf, w0, 1.0 / theta)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)
    if dtype == torch.float32:  # no FMA contraction: equal bit for bit
        assert torch.equal(out, ref)
    flat = normalized_update(wf[0], w0[0], 1.0 / 7.0)
    torch.testing.assert_close(flat.float(), normalized_update_ref(wf[0], w0[0], 1.0 / 7.0)
                               .float(), atol=tol, rtol=0)


def _column_stochastic(d, seed, device):
    p = np.random.default_rng(seed).uniform(0.0, 1.0, (d, d))
    return torch.tensor(p / p.sum(axis=0), dtype=torch.float32, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("d", [1, 4, 5, 8, 13, 16])
def test_gossip_mix_tree_in_place_every_maxd(cuda, dtype, tol, d):
    """D on every register size of the kernel (MAXD 4, 8, 16): the ragged
    tree (vector and scalar leaves, an offset view) is one launch, each leaf
    within ``tol`` of the plain version and bitwise its one-leaf call, and
    the in-place call bitwise the out-of-place one."""
    p = _column_stochastic(d, d, cuda)
    tree = _ragged_tree(cuda, dtype, d, seed=d)
    for alpha in (0, 1, 2):
        n = gossip_mix.launches
        out = gossip_mix_tree(tree, p, alpha=alpha)
        torch.cuda.synchronize()
        assert gossip_mix.launches == n + 1
        for k, y in tree.items():
            flat = y.reshape(d, -1)
            assert out[k].shape == y.shape and out[k].dtype == dtype
            ref = gossip_mix_ref(flat, p, alpha).view(y.shape)
            torch.testing.assert_close(out[k].float(), ref.float(), atol=tol, rtol=0)
            assert torch.equal(gossip_mix(flat, p, alpha=alpha).view(y.shape), out[k])
        inplace = {k: y.clone() for k, y in tree.items()}  # the offset view stays off 16 bytes
        inplace["offset"] = torch.empty(d * 1024 + 1, device=cuda, dtype=dtype)[1:].view(
            d, 1024).copy_(tree["offset"])
        n = gossip_mix.launches
        res = gossip_mix_tree(inplace, p, alpha=alpha, inplace=True)
        torch.cuda.synchronize()
        assert gossip_mix.launches == n + 1
        for k in tree:
            assert res[k] is inplace[k] and torch.equal(res[k], out[k])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("per_row", [True, False])
def test_normalized_update_tree_bitwise(cuda, dtype, per_row):
    """One launch for the ragged tree (vector and scalar leaves), bitwise
    equal to the plain version and to one single-leaf call per leaf, and
    in place (``out`` aliasing ``w_final``) bitwise the same."""
    inv = 1.0 / torch.tensor([1.0, 3.0, 7.0, 8.0, 2.0], device=cuda) if per_row else 1.0 / 7.0
    wf = _ragged_tree(cuda, dtype, 5, seed=3)
    w0 = _ragged_tree(cuda, dtype, 5, seed=4)
    n = normalized_update.launches
    out = normalized_update_tree(wf, w0, inv)
    torch.cuda.synchronize()
    assert normalized_update.launches == n + 1
    for k, a in wf.items():
        assert out[k].shape == a.shape and out[k].dtype == dtype
        assert torch.equal(out[k], normalized_update_ref(a, w0[k], inv))
        assert torch.equal(out[k], normalized_update(a, w0[k], inv))
        assert out[k].numel() == 0 or out[k].data_ptr() % 16 == 0
    res = normalized_update_tree(wf, w0, inv, out=wf)
    for k in wf:
        assert res[k] is wf[k] and torch.equal(wf[k], out[k])


@pytest.mark.cuda
def test_async_trees_launch_per_dtype_and_per_max_leaves(cuda):
    """More than MAX_LEAVES leaves of one dtype take two launches of each
    async tree kernel, a tree mixing f32 and bf16 two, and each leaf is
    bitwise its one-leaf call."""
    p = _p_t(cuda)
    inv = 1.0 / torch.tensor([1.0, 3.0, 7.0, 8.0, 2.0], device=cuda)
    big = {f"l{i}": torch.randn(4, 5, 18 + 3 * i, device=cuda) for i in range(MAX_LEAVES + 6)}
    mixed = {"a": torch.randn(4, 5, 64, device=cuda),
             "b": torch.randn(4, 5, 64, device=cuda).to(torch.bfloat16),
             "c": torch.randn(4, 5, 7, device=cuda),
             "d": torch.randn(4, 5, 9, device=cuda).to(torch.bfloat16)}
    for tree in (big, mixed):
        y = {k: w[:, 0].contiguous() for k, w in tree.items()}           # (D, M)
        wf = {k: w[0].contiguous() for k, w in tree.items()}             # (R, M)
        w0 = {k: w[1].contiguous() for k, w in tree.items()}
        n = gossip_mix.launches, normalized_update.launches
        mixed_y = gossip_mix_tree(y, p, alpha=1)
        deltas = normalized_update_tree(wf, w0, inv)
        torch.cuda.synchronize()
        assert (gossip_mix.launches - n[0], normalized_update.launches - n[1]) == (2, 2)
        for k in tree:
            assert torch.equal(mixed_y[k], gossip_mix(y[k], p, alpha=1))
            assert torch.equal(deltas[k], normalized_update(wf[k], w0[k], inv))


@pytest.mark.cuda
def test_fused_local_step_and_transition_match_dense(cuda):
    c = 8
    clusters = ClusterSpec.uniform(c, 4)
    p = mixing_matrix(ring(4))
    model, opt = MnistCNN(), sgd(0.05)
    w0 = model.init(torch.Generator().manual_seed(0))
    fresh = lambda: {k: v[None].repeat((c,) + (1,) * v.dim()).to(cuda) for k, v in w0.items()}
    batch = {"x": torch.tensor(RNG.normal(size=(c, 6, 28, 28, 1)), dtype=torch.float32,
                               device=cuda),
             "y": torch.tensor(RNG.integers(0, 10, size=(c, 6)), dtype=torch.int32, device=cuda)}
    results = {}
    for name in ("cuda", "dense"):
        backend = resolve_backend(name, clusters, p, 2, device=cuda)
        params, _, _ = build_local_update(model, opt, backend=backend)(fresh(), (), batch)
        results[name] = backend.transition(params, "inter")
    for k in w0:
        torch.testing.assert_close(results["cuda"][k], results["dense"][k], atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_async_events_on_kernels_match_dense(cuda):
    small = {"num_clients": 8, "num_clusters": 4, "num_samples": 400}
    runs = {}
    for backend in ("cuda", "dense"):
        # eager: the wrappers' host counters move at every event (a graph
        # launches from the host at its warm-up and capture only)
        run = build_scenario("straggler-bimodal-async", device=cuda, backend=backend,
                             graph=False, **small)
        assert run.runtime.scheduler.backend.name == backend
        src = run.batch_source()
        n = (normalized_update.launches, cluster_agg.launches, gossip_mix.launches)
        events = [run.runtime.step(src).cluster for _ in range(6)]
        launched = (normalized_update.launches - n[0], cluster_agg.launches - n[1],
                    gossip_mix.launches - n[2])
        runs[backend] = (run.runtime.scheduler.y, events, launched)
    # each of the three once per event: one tree call, and the tree's
    # leaves fit one table
    leaves = len(runs["cuda"][0])
    assert leaves <= MAX_LEAVES
    assert runs["cuda"][2] == (6, 6, 6)
    assert runs["dense"][2] == (0, 0, 0)
    assert runs["cuda"][1] == runs["dense"][1]
    for k, v in runs["cuda"][0].items():
        torch.testing.assert_close(v, runs["dense"][0][k], atol=1e-4, rtol=0)


# (B, S, Hq, Hkv, hd, window, cap): MHA; GQA with a ragged S and hd 96; MQA
# with a window and a cap; gemma2's hd 256 with both; S below one tile; a
# long S at granite's hd 128 and GQA 4
FLASH_CASES = [
    (2, 64, 4, 4, 64, None, None),
    (2, 80, 8, 2, 96, None, None),
    (1, 200, 4, 1, 128, 48, 30.0),
    (1, 96, 8, 4, 256, 40, 50.0),
    (2, 16, 8, 2, 128, None, None),
    (1, 2048, 8, 2, 128, None, None),
]


# the split-TF32 forward's own edges: S = 1, an S that is not a multiple of
# 16, hd 32, hd 80, and hd 30 (hd % 4 != 0: its scalar path); bf16 with hd
# 100 (hd % 8 != 0) takes it too
SPLIT_CASES = [
    (torch.float32, (1, 1, 4, 2, 64, None, None)),
    (torch.float32, (2, 37, 8, 2, 64, None, None)),
    (torch.float32, (2, 50, 4, 2, 32, None, None)),
    (torch.float32, (2, 70, 4, 2, 80, 24, None)),
    (torch.float32, (2, 45, 4, 2, 30, None, 20.0)),
    (torch.bfloat16, (2, 40, 4, 2, 100, None, None)),
]


def _qkvg(device, dtype, b, s, hq, hkv, hd):
    mk = lambda *shape: torch.tensor(RNG.normal(size=shape), dtype=torch.float32,
                                     device=device).to(dtype)
    return mk(b, s, hq, hd), mk(b, s, hkv, hd), mk(b, s, hkv, hd), mk(b, s, hq, hd)


def _close(got, ref, rel):
    scale = max(1.0, ref.float().abs().max().item())
    torch.testing.assert_close(got.float(), ref.float(), atol=rel * scale, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,fwd_tol,grad_tol", [(torch.float32, 2e-5, 1e-4),
                                                    (torch.bfloat16, 3e-2, 3e-2)])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_matches_plain(cuda, dtype, fwd_tol, grad_tol, case):
    b, s, hq, hkv, hd, window, cap = case
    q, k, v, dout = _qkvg(cuda, dtype, b, s, hq, hkv, hd)
    n = flash_attention_fwd.launches, flash_attention_bwd.launches
    ways = route(dtype, hd), route(dtype, hd, backward=True)
    by_route = flash_attention_fwd.routes[ways[0]], flash_attention_bwd.routes[ways[1]]
    out, lse = flash_attention_fwd(q, k, v, window, cap)
    ref_out, ref_lse = flash_attention_fwd_ref(q, k, v, window, cap)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref_out.float(), atol=fwd_tol, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
    grads = flash_attention_bwd(q, k, v, out, lse, dout, window, cap)
    refs = flash_attention_bwd_ref(q, k, v, out, lse, dout, window, cap)
    torch.cuda.synchronize()
    assert (flash_attention_fwd.launches - n[0], flash_attention_bwd.launches - n[1]) == (1, 1)
    assert (flash_attention_fwd.routes[ways[0]] - by_route[0],
            flash_attention_bwd.routes[ways[1]] - by_route[1]) == (1, 1)
    for got, ref in zip(grads, refs):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        _close(got, ref, grad_tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,case", SPLIT_CASES)
def test_flash_split_tf32_forward_matches_plain(cuda, dtype, case):
    """The split-TF32 forward at its edges, within the forward tolerances
    (2e-5 f32, 3e-2 bf16; lse 1e-4), one launch on its route."""
    b, s, hq, hkv, hd, window, cap = case
    q, k, v, _ = _qkvg(cuda, dtype, b, s, hq, hkv, hd)
    assert route(dtype, hd) == "split_tf32"
    n = flash_attention_fwd.routes["split_tf32"]
    out, lse = flash_attention_fwd(q, k, v, window, cap)
    ref_out, ref_lse = flash_attention_fwd_ref(q, k, v, window, cap)
    torch.cuda.synchronize()
    assert flash_attention_fwd.routes["split_tf32"] == n + 1
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)


# 'flash rows': (dtype, (B, S, Hq, Hkv, hd), chunk, ranks, window, cap) of a
# sequence-parallel split, each rank's rows one call through the query-row
# map: gemma2-2b's heads (hd 256, cap 50) on 16 ranks with and without its
# window, hd 128 on 2 ranks, bf16 hd 96 with a ragged tile (the narrow
# backward), f32 hd 64 and bf16 hd 100 (split-TF32 forward, CUDA-core
# backward)
ROWS_CASES = [
    (torch.bfloat16, (1, 2048, 8, 4, 256), 512, 16, 1024, 50.0),
    (torch.bfloat16, (1, 2048, 8, 4, 256), 512, 16, None, 50.0),
    (torch.bfloat16, (1, 1024, 16, 4, 128), 512, 2, None, None),
    (torch.bfloat16, (2, 480, 8, 2, 96), 160, 4, 100, None),
    (torch.float32, (2, 512, 8, 2, 64), 128, 4, 100, None),
    (torch.bfloat16, (2, 240, 4, 2, 100), 80, 2, None, 20.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape,chunk,ranks,window,cap", ROWS_CASES)
def test_flash_rows_match_plain_and_the_full_kernel(cuda, dtype, shape, chunk, ranks, window,
                                                    cap):
    """Each rank's map call against its plain version (the tolerances
    above), its rows against the same rows of the full kernel, its dQ rows
    against the full dQ's, and dK and dV summed over the ranks against the
    full kernel's (gradient tolerances); one launch each way a call."""
    from repro_torch.kernels.flash_attention.ref import query_positions

    b, s, hq, hkv, hd = shape
    f_tol, g_tol = (2e-5, 1e-4) if dtype == torch.float32 else (3e-2, 3e-2)
    q, k, v, dout = _qkvg(cuda, dtype, b, s, hq, hkv, hd)
    out, lse = flash_attention_fwd(q, k, v, window, cap)
    dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, window, cap)
    dk_sum = torch.zeros(dk.shape, dtype=torch.float32, device=cuda)
    dv_sum = torch.zeros_like(dk_sum)
    rl = chunk // ranks
    for r in range(ranks):
        rows = (rl, chunk, r * rl)
        pos = query_positions(s // chunk * rl, rows, cuda)
        qr, dor = q[:, pos].contiguous(), dout[:, pos].contiguous()
        n = flash_attention_fwd.launches, flash_attention_bwd.launches
        o_r, l_r = flash_attention_fwd(qr, k, v, window, cap, rows)
        grads = flash_attention_bwd(qr, k, v, o_r, l_r, dor, window, cap, rows)
        assert (flash_attention_fwd.launches - n[0], flash_attention_bwd.launches - n[1]) == (1, 1)
        ref_o, ref_l = flash_attention_fwd_ref(qr, k, v, window, cap, rows)
        refs = flash_attention_bwd_ref(qr, k, v, o_r, l_r, dor, window, cap, rows)
        torch.cuda.synchronize()
        torch.testing.assert_close(o_r.float(), ref_o.float(), atol=f_tol, rtol=0)
        torch.testing.assert_close(l_r, ref_l, atol=1e-4, rtol=0)
        torch.testing.assert_close(o_r.float(), out[:, pos].float(), atol=f_tol, rtol=0)
        for got, ref in zip(grads, refs):
            _close(got, ref, g_tol)
        _close(grads[0], dq[:, pos], g_tol)
        dk_sum += grads[1].float()
        dv_sum += grads[2].float()
    _close(dk_sum, dk, g_tol)
    _close(dv_sum, dv, g_tol)


@pytest.mark.cuda
def test_flash_rows_keys_past_every_row_get_zero_gradients(cuda):
    """Under a map whose last row sits far before the last key, the keys
    past it are read by no row: dK and dV are zero there, on every route."""
    for dtype, hd in ((torch.bfloat16, 128), (torch.bfloat16, 256), (torch.float32, 64)):
        q, k, v, dout = _qkvg(cuda, dtype, 1, 512, 4, 2, hd)
        rows = (32, 128, 0)                 # rows 0..31 of 4 chunks: the last at 415
        qr, dor = q[:, :128].contiguous(), dout[:, :128].contiguous()
        o, lse = flash_attention_fwd(qr, k, v, None, None, rows)
        _, dk, dv = flash_attention_bwd(qr, k, v, o, lse, dor, None, None, rows)
        torch.cuda.synchronize()
        assert not dk[:, 416:].any() and not dv[:, 416:].any()
        assert dk[:, :416].abs().sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_bf16_takes_tensor_cores_and_is_deterministic(cuda, case):
    """bf16 with hd % 8 == 0 runs the wgmma/TMA kernels, forward and
    backward (hd 256's backward on the wide kernels), and the backward,
    which sums without atomics, is bitwise the same from call to call."""
    b, s, hq, hkv, hd, window, cap = case
    q, k, v, dout = _qkvg(cuda, torch.bfloat16, b, s, hq, hkv, hd)
    n = flash_attention_fwd.routes["tensor_core"], flash_attention_bwd.routes["tensor_core"]
    out, lse = flash_attention_fwd(q, k, v, window, cap)
    first = flash_attention_bwd(q, k, v, out, lse, dout, window, cap)
    second = flash_attention_bwd(q, k, v, out, lse, dout, window, cap)
    torch.cuda.synchronize()
    assert flash_attention_fwd.routes["tensor_core"] - n[0] == 1
    assert flash_attention_bwd.routes["tensor_core"] - n[1] == 2
    for a, c in zip(first, second):
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_refuses_misaligned_view_and_op_copies_it(cuda, dtype):
    """TMA needs 16-byte aligned bases: a view that starts one element into
    its buffer is refused by the wrapper, and the op copies it."""
    b, s, hq, hkv, hd = 1, 32, 4, 2, 64
    q, k, v, _ = _qkvg(cuda, dtype, b, s, hq, hkv, hd)
    n = q.numel()
    off = torch.empty(n + 1, dtype=dtype, device=cuda)[1:].view(b, s, hq, hd)
    off.copy_(q)
    assert off.is_contiguous() and off.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_fwd(off, k, v)
    out, _ = flash_attention_fwd(q, k, v)
    torch.testing.assert_close(flash_attention(off, k, v), out, atol=0, rtol=0)


@pytest.mark.cuda
def test_flash_attention_vmap_grad_folds_clients(cuda):
    c, (b, s, hq, hkv, hd, window, cap) = 3, FLASH_CASES[2]
    q, k, v, w = (torch.stack([x] * c) for x in _qkvg(cuda, torch.float32, b, s, hq, hkv, hd))
    q = q + 0.1 * torch.arange(c, device=cuda).view(c, 1, 1, 1, 1)  # distinct clients

    def loss(q, k, v, w):
        return (flash_attention(q, k, v, window, cap) * w).sum()

    n = flash_attention_fwd.launches, flash_attention_bwd.launches
    got = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2)))(q, k, v, w)
    torch.cuda.synchronize()
    assert (flash_attention_fwd.launches - n[0], flash_attention_bwd.launches - n[1]) == (1, 1)
    for i in range(c):
        out, lse = flash_attention_fwd_ref(q[i], k[i], v[i], window, cap)
        refs = flash_attention_bwd_ref(q[i], k[i], v[i], out, lse, w[i], window, cap)
        for g, ref in zip(got, refs):
            _close(g[i], ref, 1e-4)


@pytest.mark.cuda
def test_flash_attention_refuses(cuda):
    q, k, v, _ = _qkvg(cuda, torch.float32, 1, 16, 4, 2, 64)
    with pytest.raises(TypeError):
        flash_attention_fwd(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        flash_attention_fwd(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention_fwd(q[:, :, :3].contiguous(), k, v)
    with pytest.raises(ValueError, match="256"):
        big = torch.zeros(1, 16, 2, 320, device=cuda)
        flash_attention_fwd(big, big, big)
    with pytest.raises(ValueError, match="on cpu"):
        flash_attention_fwd(q, k.cpu(), v)


@pytest.mark.cuda
def test_federated_lm_ring_on_kernels_matches_dense_plain(cuda):
    """Two supersteps (16 iterations) with the flash kernels, ``sgd_update``
    and ``fused_transition`` against the dense backend with plain attention."""
    counters = (flash_attention_fwd, flash_attention_bwd, sgd_update, fused_transition)
    runs = {}
    for backend, impl in (("cuda", "cuda"), ("dense", "plain")):
        run = build_scenario("federated-lm-ring", device=cuda, backend=backend,
                             arch_overrides={"attn_impl": impl}, num_samples=64, seq_len=32)
        src = run.batch_source()
        n = [c.launches for c in counters]
        losses = torch.cat([run.runtime.step(src).losses for _ in range(2)])
        launched = tuple(c.launches - k for c, k in zip(counters, n))
        runs[backend] = (run.runtime.scheduler.params, losses, launched,
                         run.runtime.evaluate(run.eval_batch)[0])
    # 2 attention layers x 16 iterations, clients folded into each launch;
    # one SGD launch per iteration and one per transition (the 12 leaves
    # fit one leaf table), 2 rounds x (2 intra + 1 inter) transitions per
    # superstep
    assert len(runs["cuda"][0]) <= MAX_LEAVES
    assert runs["cuda"][2] == (32, 32, 16, 12)
    assert runs["dense"][2] == (0, 0, 0, 0)
    torch.testing.assert_close(runs["cuda"][1], runs["dense"][1], atol=1e-4, rtol=0)
    for k, v in runs["cuda"][0].items():
        torch.testing.assert_close(v, runs["dense"][0][k], atol=1e-4, rtol=0)
    assert abs(runs["cuda"][3] - runs["dense"][3]) <= 1e-4 * abs(runs["dense"][3])


# -- the model families ----------------------------------------------------------

@pytest.mark.cuda
def test_moe_superstep_graph_replays_equal_eager(cuda):
    """Reduced mixtral's federated-lm-ring superstep captures into one CUDA
    graph (no host sync in the MoE dispatch) and its replays equal the eager
    loop bitwise, under deterministic algorithms (the index backwards'
    atomics otherwise sum in any order)."""
    _assert_superstep_graph_replays_equal_eager(cuda, "mixtral-8x7b")


@pytest.mark.cuda
def test_gemma2_superstep_graph_replays_equal_eager(cuda):
    """Reduced gemma2's superstep (embedding scale, both softcaps, post-norms,
    local and global layers) captures into one CUDA graph (its embedding
    scale copies nothing from the host) and replays equal to the eager loop
    bitwise, under deterministic algorithms."""
    _assert_superstep_graph_replays_equal_eager(cuda, "gemma2-2b")


def _assert_superstep_graph_replays_equal_eager(cuda, name):
    import os

    from repro_torch.configs import get_config
    from repro_torch.models import CausalLM

    cfg = get_config(name).reduced()
    before = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        got = {}
        for graph in (False, True):
            run = build_scenario("federated-lm-ring", device=cuda, graph=graph,
                                 model=CausalLM(cfg), num_samples=64)
            src = run.batch_source()
            losses = torch.cat([run.runtime.step(src).losses for _ in range(3)])
            sched = run.runtime.scheduler
            assert (sched._graph is not None) == graph
            if graph:
                assert sched._graph.replays >= 1
            got[graph] = (losses, {k: w.clone() for k, w in sched.params.items()})
    finally:
        torch.use_deterministic_algorithms(False)
        if before is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = before
    assert torch.equal(got[True][0], got[False][0])
    for k, w in got[False][1].items():
        assert torch.equal(got[True][1][k], w), k


@pytest.mark.cuda
def test_flash_attention_hd160_bf16_matches_plain(cuda):
    """pixtral-12b's head width, 160, in bf16: the forward on the tensor
    cores (``fwd<256, 64, 2>``), the backward too (the wide kernels' hd-160
    tile), each against the plain version (3e-2 forward, lse 1e-4,
    gradients 3e-2 of the largest reference entry)."""
    b, s, hq, hkv, hd = 2, 320, 8, 2, 160
    q, k, v, dout = _qkvg(cuda, torch.bfloat16, b, s, hq, hkv, hd)
    assert (route(torch.bfloat16, hd), route(torch.bfloat16, hd, backward=True)) == (
        "tensor_core", "tensor_core")
    n = flash_attention_fwd.routes["tensor_core"], flash_attention_bwd.routes["tensor_core"]
    out, lse = flash_attention_fwd(q, k, v)
    ref_out, ref_lse = flash_attention_fwd_ref(q, k, v)
    grads = flash_attention_bwd(q, k, v, out, lse, dout)
    refs = flash_attention_bwd_ref(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    assert (flash_attention_fwd.routes["tensor_core"] - n[0],
            flash_attention_bwd.routes["tensor_core"] - n[1]) == (1, 1)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=3e-2, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
    for got, ref in zip(grads, refs):
        _close(got, ref, 3e-2)


# the wide backward's cases (B, S, Hq, Hkv): G = 1 and 4, a ragged S of 80
# and one of 16 (below every tile); each hd at both tile widths' edges (136
# and pixtral's 160 on the hd-160 tile, 168 and 256 on the hd-256 one) and
# two partly filled 256 tiles (192, 200).  Masks: none, gemma2's cap 50 with a
# window, and a cap of 2, under which the unit-variance scores of these inputs
# make the cap's derivative 1 - tanh^2(s / cap) small where p is large (under
# cap 50 it stays above 0.99, so p in place of p times it would pass)
WIDE_HDS = (136, 160, 168, 192, 200, 256)
WIDE_CASES = [(2, 80, 4, 4), (2, 80, 8, 2), (1, 16, 4, 1)]
WIDE_MASKS = [(None, None), (24, 50.0), (None, 2.0)]


def _wide_grads(device, hd, case, window, cap):
    b, s, hq, hkv = case
    q, k, v, dout = _qkvg(device, torch.bfloat16, b, s, hq, hkv, hd)
    out, lse = flash_attention_fwd(q, k, v, window, cap)
    return q, k, v, out, lse, dout


@pytest.mark.cuda
@pytest.mark.parametrize("hd", WIDE_HDS)
@pytest.mark.parametrize("case", WIDE_CASES)
@pytest.mark.parametrize("window,cap", WIDE_MASKS)
def test_flash_wide_bf16_backward_matches_plain(cuda, hd, case, window, cap):
    """The bf16 backward past hd 128 on the tensor cores (one count on the
    route, none on the CUDA cores) against ``flash_attention_bwd_ref``: 3e-2
    of the largest reference entry."""
    args = _wide_grads(cuda, hd, case, window, cap)
    n = dict(flash_attention_bwd.routes)
    grads = flash_attention_bwd(*args, window, cap)
    refs = flash_attention_bwd_ref(*args, window, cap)
    torch.cuda.synchronize()
    assert {r: c - n[r] for r, c in flash_attention_bwd.routes.items()} == {
        "tensor_core": 1, "split_tf32": 0, "cuda_core": 0}
    for got, ref in zip(grads, refs):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        _close(got, ref, 3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", WIDE_HDS)
@pytest.mark.parametrize("window,cap", WIDE_MASKS)
def test_flash_wide_bf16_backward_is_bitwise_deterministic(cuda, hd, window, cap):
    """Two calls of the wide backward on the same inputs are bitwise equal
    (no atomics: dK and dV sum over the G heads in registers)."""
    args = _wide_grads(cuda, hd, (2, 80, 8, 2), window, cap)
    first = flash_attention_bwd(*args, window, cap)
    second = flash_attention_bwd(*args, window, cap)
    torch.cuda.synchronize()
    for a, c in zip(first, second):
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", WIDE_HDS)
@pytest.mark.parametrize("window,cap", WIDE_MASKS)
def test_flash_wide_bf16_backward_matches_cuda_core_kernel(cuda, hd, window, cap):
    """The wide tensor-core backward against the CUDA-core kernel that took
    these widths before it, called directly on the same inputs: 3e-2 of the
    largest entry of the CUDA-core gradient."""
    from repro_torch.kernels.flash_attention.ops import _bwd_launch

    args = _wide_grads(cuda, hd, (1, 300, 8, 2), window, cap)
    grads = flash_attention_bwd(*args, window, cap)
    olds = _bwd_launch("cuda_core", *args, window, cap)
    torch.cuda.synchronize()
    for got, old in zip(grads, olds):
        _close(got, old, 3e-2)


@pytest.mark.cuda
def test_mixed_dtype_family_trees_match_plain(cuda):
    """A bf16 jamba tree (its MoE router and mamba ``A_log``, ``D`` and
    ``dt_bias`` stay f32) stacked over 8 clients: the transition and SGD each
    take one launch a table of one dtype (four: 138 bf16 leaves in three
    tables of up to 64, 25 f32 leaves in one), the transition within 1e-5 (f32) and 3e-2 (bf16) of its plain version,
    SGD bitwise."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels._leaves import plan_launches
    from repro_torch.models import CausalLM

    cfg = dataclasses.replace(get_config("jamba-1.5-large-398b").reduced(), dtype="bfloat16",
                              d_model=64, d_ff=64)
    w0 = CausalLM(cfg).init(torch.Generator().manual_seed(0))
    gen = torch.Generator(device=cuda).manual_seed(1)
    tree = {k: torch.randn((8,) + tuple(w.shape), generator=gen, device=cuda).to(w.dtype)
            for k, w in w0.items()}
    assert {w.dtype for w in tree.values()} == {torch.float32, torch.bfloat16}
    groups = len(plan_launches([(w.dtype, 0, ()) for w in tree.values()]))
    assert groups == 4
    vt, p, bt = _uniform_factors(cuda, 8, 4)
    grads = {k: torch.randn(w.shape, generator=gen, device=cuda).to(w.dtype)
             for k, w in tree.items()}
    n = fused_transition.launches, sgd_update.launches
    out = fused_transition_tree(tree, vt, p, bt, alpha=2)
    new = sgd_update_tree(tree, grads, 0.1)
    torch.cuda.synchronize()
    assert (fused_transition.launches - n[0], sgd_update.launches - n[1]) == (groups, groups)
    for k, w in tree.items():
        ref = fused_transition_ref(w.reshape(8, -1), vt, p, bt, 2).reshape(w.shape)
        tol = 1e-5 if w.dtype == torch.float32 else 3e-2
        torch.testing.assert_close(out[k].float(), ref.float(), atol=tol, rtol=0)
        assert torch.equal(new[k], sgd_update_ref(w, grads[k], 0.1)), k


# -- captured steps (core/cuda_graph.py) --------------------------------------

_HOST_COUNTED = {"fused_transition": fused_transition, "sgd_update": sgd_update,
                 "flash_attention_fwd": flash_attention_fwd,
                 "flash_attention_bwd": flash_attention_bwd}


def _host_counts() -> dict:
    """The wrappers' host counters, flash ones by route too, keyed as
    ``kernels.count_kernels`` keys its device counts."""
    out = {k: fn.launches for k, fn in _HOST_COUNTED.items()}
    for k in ("flash_attention_fwd", "flash_attention_bwd"):
        out.update({f"{k}.{r}": n for r, n in _HOST_COUNTED[k].routes.items()})
    return out


def _graph_run(device, name, steps, graph, **kw):
    """(scheduler, [(step kind, device launches, host launches)] a step,
    params, losses) of ``steps`` steps; a sync run's losses are its eval loss."""
    run = build_scenario(name, device=device, graph=graph, **kw)
    src = run.batch_source()
    counted, losses = [], []
    for _ in range(steps):
        before = _host_counts()
        event, ran = device_launches(lambda: run.runtime.step(src))
        host = {k: n - before[k] for k, n in _host_counts().items() if n != before[k]}
        counted.append((event.kind, ran, host))
        losses.append(event.losses)
    sched = run.runtime.scheduler
    if losses[0] is None:
        losses = [torch.tensor([run.runtime.evaluate(run.eval_batch)[0]])]
    return sched, counted, {k: v.clone() for k, v in sched.params.items()}, torch.cat(losses)


@pytest.mark.cuda
@pytest.mark.parametrize("name,steps,kw", [
    # 30 sync iterations: three intra and three inter events, so every kind's
    # graph warms up, captures and is replayed twice
    ("mnist-noniid-ring", 30, {"tau2": 2}),
    ("round-superstep-ring", 3, {"num_samples": 400}),
    ("federated-lm-ring", 3, {}),
    # the fleet axes: a uniform-k draw a round (sync), and the fault trace's
    # weights and mixing stacks (round supersteps), read from static buffers
    ("sampled-k-ring", 30, {"tau2": 2}),
    ("chaos-ring", 6, {}),
    # host-offloaded client state: the residents change every round (sync, 8
    # slots for C = 20) and every superstep (10^6 clients, 32 slots)
    ("sampled-k-ring", 30, {"tau2": 2, "store": {"kind": "host-offload", "k_max": 8}}),
    ("million-client-ring", 6, {}),
])
def test_graph_replays_match_eager(cuda, name, steps, kw):
    """Graph runs against eager runs, in turns eager, graph, graph, eager,
    under cuDNN's deterministic algorithms: eager repeats itself bitwise, so
    a replay, the same kernels in the same order, is held to that
    difference, and to the eager run's exact launch counts."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = {label: _graph_run(cuda, name, steps, graph, **kw)
                for label, graph in (("eager", False), ("graph", True), ("graph2", True),
                                     ("eager2", False))}
    finally:
        torch.backends.cudnn.deterministic = deterministic

    def diff(a, b):
        return max(max((a[2][k] - v).abs().max().item() for k, v in b[2].items()),
                   (a[3] - b[3]).abs().max().item())

    ee = diff(runs["eager"], runs["eager2"])
    ge = max(diff(runs[g], runs[e]) for g in ("graph", "graph2") for e in ("eager", "eager2"))
    assert ge <= ee, (ge, ee)
    if name in ("sampled-k-ring", "chaos-ring", "million-client-ring"):
        assert ge == ee == 0.0, (ge, ee)
    # every step runs the eager step's kernels on the device; the host counts
    # a graph's launches at its warm-up and capture (the first two steps of
    # each kind), and none at a replay
    ran = [r for _, r, _ in runs["eager"][1]]
    assert all(ran) and all([r for _, r, _ in run[1]] == ran for run in runs.values()), [
        (label, i, r, ran[i]) for label, run in runs.items()
        for i, (_, r, _) in enumerate(run[1]) if r != ran[i]]
    for label, run in runs.items():
        seen: dict = {}
        for kind, dev, host in run[1]:
            seen[kind] = seen.get(kind, 0) + 1
            want = dev if label.startswith("eager") or seen[kind] <= 2 else {}
            assert host == want, (label, kind, seen[kind], host, dev)
    for label in ("graph", "graph2"):
        sched = runs[label][0]
        if hasattr(sched, "_graphs"):
            assert all(g.replays >= 2 for g in sched._graphs.values()), sched._graphs
        else:
            assert sched._graph.replays == steps - 1
    eager = runs["eager"][0]
    assert getattr(eager, "_graphs", getattr(eager, "_graph", None)) is None


@pytest.mark.cuda
def test_momentum_on_the_round_graph_equals_eager(cuda):
    """``round-superstep-ring`` with ``optim.momentum``: turns eager, graph,
    graph, eager under cuDNN's deterministic algorithms, graph = eager at
    0.0 (parameters, momentum buffers, losses); one capture whose momentum
    buffers keep the addresses ``bind`` gave them over every replay; the
    transition kernel runs, and ``sgd_update`` never launches (momentum is
    not plain SGD)."""
    from repro_torch.optim import momentum

    steps, runs = 3, {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for label, graph in (("eager", False), ("graph", True), ("graph2", True),
                             ("eager2", False)):
            run = build_scenario("round-superstep-ring", device=cuda, graph=graph,
                                 num_samples=400, optimizer=momentum(0.05))
            sched, src = run.runtime.scheduler, run.batch_source()
            state_ptrs = {k: v.data_ptr() for k, v in sched.opt_state.items()}
            before = (sgd_update.launches, fused_transition.launches)
            losses = torch.cat([run.runtime.step(src).losses for _ in range(steps)])
            torch.cuda.synchronize()
            assert sgd_update.launches == before[0]
            assert fused_transition.launches > before[1]
            if graph:
                g = sched._graph
                assert (g.captured, len(g._entries), g.replays) == (1, 1, steps - 1)
                assert {k: v.data_ptr() for k, v in sched.opt_state.items()} == state_ptrs
            assert all(bool(v.abs().max() > 0) for v in sched.opt_state.values())
            runs[label] = ({k: v.clone() for k, v in sched.params.items()},
                           {k: v.clone() for k, v in sched.opt_state.items()}, losses)
    finally:
        torch.backends.cudnn.deterministic = deterministic

    def diff(a, b):
        return max(max((x - b[i][k]).abs().max().item() for k, x in a[i].items())
                   for i in (0, 1)) + (a[2] - b[2]).abs().max().item()

    ee = diff(runs["eager"], runs["eager2"])
    ge = max(diff(runs[g], runs[e]) for g in ("graph", "graph2") for e in ("eager", "eager2"))
    assert ge == ee == 0.0, (ge, ee)


@pytest.mark.cuda
def test_graph_recaptures_on_a_new_batch_shape(cuda):
    run = build_scenario("mnist-noniid-ring", device=cuda, tau2=2)
    rng = np.random.default_rng(0)
    sources = {b: (lambda k, b=b: run.dataset.stacked_batch(b, rng)) for b in (10, 6)}
    local = run.runtime.scheduler._graphs["local"]
    for b in (10, 10, 10, 6):  # iterations 1-4 are local: warm-up, capture, replay; warm-up
        run.runtime.step(sources[b])
    assert (local.captured, local.replays) == (1, 2)
    run.runtime.step(sources[6])  # iteration 5: the intra event's warm-up
    run.runtime.step(sources[6])  # iteration 6: local batch 6 captured and replayed
    torch.cuda.synchronize()
    assert (local.captured, local.replays, len(local._entries)) == (2, 3, 2)
    for w in run.runtime.scheduler.params.values():
        assert bool(torch.isfinite(w).all())


@pytest.mark.cuda
def test_graph_recaptures_when_params_are_replaced_and_spares_the_old(cuda):
    run = build_scenario("mnist-noniid-ring", device=cuda, tau2=2)
    sched, src = run.runtime.scheduler, run.batch_source()
    local = sched._graphs["local"]
    for _ in range(3):  # local: warm-up, capture and replay, replay
        run.runtime.step(src)
    assert (local.captured, local.replays) == (1, 2)
    old = sched.params
    torch.cuda.synchronize()
    kept = {k: v.clone() for k, v in old.items()}
    sched.params = {k: v.clone() for k, v in old.items()}
    for _ in range(4):  # iteration 4: warm-up on the new tensors; 5 intra; 6-7 replays
        run.runtime.step(src)
    torch.cuda.synchronize()
    assert (local.captured, local.replays, len(local._entries)) == (1, 4, 1)
    for k, v in old.items():
        assert torch.equal(v, kept[k]), k
    assert any(not torch.equal(v, kept[k]) for k, v in sched.params.items())


@pytest.mark.cuda
def test_graph_replays_new_masks_round_after_round(cuda):
    """sampled-k-ring: every round draws another uniform-k mask; the replayed
    steps read each round's weights from their static buffers and move
    exactly as eager does, iteration by iteration."""
    from repro_torch.core.runtime import WEIGHTS

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = [build_scenario("sampled-k-ring", device=cuda, graph=graph, tau2=2)
                for graph in (False, True)]
        srcs = [r.batch_source() for r in runs]
        eager, graphed = (r.runtime.scheduler for r in runs)
        masks = {tuple(eager.axes.plan.mask(r)) for r in range(4)}
        assert len(masks) == 4  # four rounds, four draws
        for k in range(1, 41):
            for run, src in zip(runs, srcs):
                run.runtime.step(src)
            for key, v in eager.params.items():
                assert torch.equal(graphed.params[key], v), (k, key)
            if k % 10 == 0:  # an inter event: its buffers hold this round's weights
                (entry,) = graphed._graphs["inter"]._entries.values()
                want = torch.as_tensor(graphed.axes.plan.weights(graphed._round_of(k)),
                                       dtype=torch.float32, device=cuda)
                assert torch.equal(entry.static[WEIGHTS], want)
        assert all(g.replays >= 2 for g in graphed._graphs.values())
    finally:
        torch.backends.cudnn.deterministic = deterministic


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["cuda", "dense"])
def test_transition_reads_p_and_weights_from_device_buffers_in_a_graph(cuda, backend):
    """``transition(..., weights=, p=)`` on CUDA tensors captured in a graph:
    a replay after new values are written into the buffers gives the eager
    result for those values (nothing was baked in at capture)."""
    c, d = 20, 4
    spec = ClusterSpec(c, tuple(i // (c // d) for i in range(c)), tuple(RNG.uniform(0.5, 2, c)))
    be = resolve_backend(backend, spec, mixing_matrix(ring(d), spec.m_tilde()), 2, device=cuda)
    tree = {"w": torch.tensor(RNG.normal(size=(c, 3, 50)), dtype=torch.float32, device=cuda),
            "b": torch.tensor(RNG.normal(size=(c, 7)), dtype=torch.float32, device=cuda)}
    operands = []
    for topo in (ring(d), chain(d)):
        mask = RNG.uniform(size=c) > 0.4
        mask[:: c // d] = True
        w = np.where(mask, spec.m_hat(), 0.0)
        w = w / np.bincount(spec.assignments, weights=w)[list(spec.assignments)]
        operands.append((torch.tensor(w, dtype=torch.float32, device=cuda),
                         torch.tensor(mixing_matrix(topo, spec.m_tilde()), dtype=torch.float32,
                                      device=cuda)))
    w_buf, p_buf = (t.clone() for t in operands[0])
    state = {k: v.clone() for k, v in tree.items()}
    out = {}

    def body():
        res = be.transition(state, "inter", weights=w_buf, p=p_buf)
        for k, v in res.items():
            if v is not state[k]:
                out[k] = v

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    for w, p in operands[::-1]:
        for k in tree:
            state[k].copy_(tree[k])
        w_buf.copy_(w)
        p_buf.copy_(p)
        graph.replay()
        want = be.transition({k: v.clone() for k, v in tree.items()}, "inter", weights=w, p=p)
        for k in tree:
            got = out.get(k, state[k])
            assert torch.equal(got, want[k]), k


@pytest.mark.cuda
def test_dropout_participation_async_on_kernels_matches_dense(cuda):
    small = {"num_clients": 8, "num_clusters": 4, "num_samples": 400}
    runs = {}
    for backend in ("cuda", "dense"):
        run = build_scenario("dropout-participation-async", device=cuda, backend=backend,
                             graph=False, **small)
        src = run.batch_source()
        n = cluster_agg.launches
        kinds = [run.runtime.step(src).kind for _ in range(12)]
        runs[backend] = (run.runtime.scheduler.y, kinds, cluster_agg.launches - n)
    kinds = runs["cuda"][1]
    assert kinds == runs["dense"][1] and {"cluster", "skipped"} == set(kinds)
    assert runs["cuda"][2] == kinds.count("cluster") and runs["dense"][2] == 0
    for k, v in runs["cuda"][0].items():
        torch.testing.assert_close(v, runs["dense"][0][k], atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fedavg", "hierfavg", "feel"])
def test_baselines_on_the_sgd_kernel_match_the_plain_path(cuda, name):
    from repro_torch.core import FEELTrainer, FedAvgTrainer, HierFAVGTrainer, MNIST_LATENCY
    from repro_torch.data import FederatedDataset, iid_partition, mnist_like

    train, test = mnist_like(400, seed=0).split(0.85)
    ds = FederatedDataset(train, iid_partition(train.y, 8, seed=0))
    ev = {"x": test.x[:64], "y": test.y[:64]}
    make = {
        "fedavg": lambda b: FedAvgTrainer(MnistCNN(), 8, tau=3, lr=0.05, latency=MNIST_LATENCY,
                                          device=cuda, backend=b),
        "hierfavg": lambda b: HierFAVGTrainer(MnistCNN(), ClusterSpec.uniform(8, 4), tau1=2,
                                              tau2=2, lr=0.05, device=cuda, backend=b),
        "feel": lambda b: FEELTrainer(MnistCNN(), 8, schedule_size=3, tau=2, lr=0.05,
                                      device=cuda, backend=b),
    }[name]
    out = {}
    for backend in ("auto", "dense"):
        tr = make(backend)
        n = sgd_update.launches
        hist = tr.run(10, lambda k: ds.stacked_batch(4, np.random.default_rng(100 + k)), ev,
                      eval_every=5)
        out[tr.route] = (tr.params, hist, sgd_update.launches - n)
    assert out["cuda"][2] == 10 and out["dense"][2] == 0
    assert out["cuda"][1].wallclock == out["dense"][1].wallclock
    np.testing.assert_allclose(out["cuda"][1].loss, out["dense"][1].loss, rtol=1e-4)
    for k, v in out["cuda"][0].items():
        torch.testing.assert_close(v, out["dense"][0][k], atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("name,steps,kw", [
    ("million-client-ring", 5, {}),
    ("sampled-k-ring", 40, {"tau2": 2, "store": {"kind": "host-offload", "k_max": 8}}),
])
def test_offload_captures_once_across_residencies(cuda, name, steps, kw):
    """The store's buffer keeps its addresses: the residents change every
    round, and each event kind (sync) or the superstep (round) is captured
    exactly once, by the wrappers' host counters, and replayed after."""
    from repro_torch.kernels import fused_transition, sgd_update

    run = build_scenario(name, device=cuda, **kw)
    sched, src = run.runtime.scheduler, run.batch_source()
    ptrs = [t.data_ptr() for t in sched.params.values()]
    before = (fused_transition.launches, sgd_update.launches)
    for _ in range(steps):
        run.runtime.step(src)
    torch.cuda.synchronize()
    host = (fused_transition.launches - before[0], sgd_update.launches - before[1])
    assert [t.data_ptr() for t in sched.params.values()] == ptrs
    if name == "million-client-ring":
        residents = {tuple(sched._residency_for_step(k).clients) for k in range(1, steps + 1)}
        assert len(residents) == steps
        g = sched._graph
        assert (g.captured, len(g._entries), g.replays) == (1, 1, steps - 1)
        assert host == (4, 4)  # two supersteps (warm-up, capture) of 2 transitions, 2 SGDs
    else:
        residents = {tuple(sched._residency_for_round(r).clients) for r in range(4)}
        assert len(residents) == 4
        assert all(g.captured == 1 and len(g._entries) == 1 for g in sched._graphs.values())
        assert all(g.replays >= 2 for g in sched._graphs.values())
        # each kind's warm-up and capture: local 2 x SGD, intra and inter 2 x (SGD + transition)
        assert host == (4, 6)
    for v in sched.store.cluster_models.values():
        assert bool(torch.isfinite(v).all())


@pytest.mark.cuda
def test_transition_factors_are_contiguous_and_copy_free(cuda):
    """``CudaBackend`` binds V^T and B^T contiguous (and B for the weights
    path), so an inter transition, static or with runtime weights, runs the
    transition kernel once on the device and no copy (the weights path also
    runs its one product ``B * w``)."""
    from repro_torch.kernels import device_kernel_names

    run = build_scenario("mnist-noniid-ring", device=cuda, tau2=2)
    backend, params = run.runtime.scheduler.backend, run.runtime.scheduler.params
    assert all(t.is_contiguous() for t in (backend._vt, backend._bt, backend._b))
    for kw in ({}, {"weights": torch.full((20,), 0.2, device=cuda)}):
        backend.transition(params, "inter", **kw)
        torch.cuda.synchronize()
        _, names = device_kernel_names(lambda: backend.transition(params, "inter", **kw))
        assert sum("fused_transition_kernel" in n for n in names) == 1, names
        assert not any("copy" in n.lower() for n in names), names
        assert len(names) == (1 if not kw else 2), names


@pytest.mark.cuda
def test_device_launches_repeated_sessions(cuda):
    """200 profiler sessions over replayed sync iterations, each counted
    exactly by ``kernels.device_launches``: one-step sessions (the kind that
    came back empty without the session's starting margin) and ten-step ones."""
    run = build_scenario("mnist-noniid-ring", device=cuda, tau2=2)
    src = run.batch_source()
    for _ in range(20):  # every event kind warmed up, captured and replayed
        run.runtime.step(src)
    off = []
    for _ in range(100):
        ev, got = device_launches(lambda: run.runtime.step(src))
        if got != {"sgd_update": 1, **({"fused_transition": 1} if ev.kind != "local" else {})}:
            off.append((ev.kind, got))
    want = {"fused_transition": 2, "sgd_update": 10}
    for _ in range(100):
        got = device_launches(lambda: [run.runtime.step(src) for _ in range(10)])[1]
        if got != want:
            off.append(("ten steps", got))
    assert off == []


# -- the async event on a CUDA graph, and gossip_mix reading P from the card ----

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gossip_mix_reads_p_from_device_memory_in_a_graph(cuda, dtype):
    """The tree call reads P from device memory: bitwise its one-leaf calls,
    and a captured launch replayed after a new P is written into its buffer
    gives the eager call on that P, bitwise (nothing was baked in)."""
    tree = _ragged_tree(cuda, dtype, 4, seed=7)
    ps = [_p_t(cuda, trigger=t) for t in (1, 3)]
    for p in ps:
        out = gossip_mix_tree(tree, p, alpha=1)
        for k, y in tree.items():
            assert torch.equal(out[k].reshape(4, -1), gossip_mix(y.reshape(4, -1), p, alpha=1))
    p_buf = ps[0].clone()
    state = {k: y.clone() for k, y in tree.items()}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gossip_mix_tree(state, p_buf, alpha=1, inplace=True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gossip_mix_tree(state, p_buf, alpha=1, inplace=True)
    for p in ps[::-1]:
        for k in tree:
            state[k].copy_(tree[k])
        p_buf.copy_(p)
        graph.replay()
        want = gossip_mix_tree(tree, p, alpha=1)
        for k in tree:
            assert torch.equal(state[k], want[k]), k


def _async_run(device, name, events, graph, **kw):
    """(scheduler, [(kind, device kernel runs, host launches)] an event, y)."""
    run = build_scenario(name, device=device, graph=graph, **kw)
    src = run.batch_source()
    counted = []
    for _ in range(events):
        before = {k: fn.launches for k, fn in _ASYNC_COUNTED.items()}
        ev, ran = device_launches(lambda: run.runtime.step(src))
        host = {k: fn.launches - before[k] for k, fn in _ASYNC_COUNTED.items()
                if fn.launches != before[k]}
        counted.append((ev.kind, ran, host))
    sched = run.runtime.scheduler
    return sched, counted, {k: v.clone() for k, v in sched.y.items()}


_ASYNC_COUNTED = {"normalized_update": normalized_update, "cluster_agg": cluster_agg,
                  "gossip_mix": gossip_mix}


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw", [
    ("straggler-bimodal-async", {}),
    ("dropout-participation-async", {}),  # masked m^ and skipped events
    ("straggler-bimodal-async", {"store": "host-offload"}),
])
def test_async_graph_replays_match_eager(cuda, name, kw):
    """The graphed async event against its eager twin, in turns eager,
    graph, graph, eager under cuDNN's deterministic algorithms: y at 0.0,
    the same event sequence, the same device kernel runs in every event (one
    of each async kernel per cluster event, none per skipped one), host
    launches only at the graph's warm-up and capture."""
    events = 12
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = {label: _async_run(cuda, name, events, graph, **kw)
                for label, graph in (("eager", False), ("graph", True), ("graph2", True),
                                     ("eager2", False))}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    kinds = [k for k, _, _ in runs["eager"][1]]
    one = dict.fromkeys(_ASYNC_COUNTED, 1)
    for label, (sched, counted, y) in runs.items():
        assert [k for k, _, _ in counted] == kinds, label
        assert [r for _, r, _ in counted] == [one if k == "cluster" else {} for k in kinds], label
        for k, v in y.items():
            assert torch.equal(v, runs["eager"][2][k]), (label, k)
        fired = 0
        for kind, _, host in counted:
            fired += kind == "cluster"
            want = one if kind == "cluster" and (label.startswith("eager") or fired <= 2) else {}
            assert host == want, (label, kind, fired, host)
        if label.startswith("graph"):
            assert sched._graph.captured == 1 and sched._graph.replays == fired - 1
        else:
            assert sched._graph is None
        if kw.get("store"):
            for k, v in sched.store.cluster_models.items():
                assert torch.equal(v, y[k]), (label, k)
    assert "cluster" in kinds


@pytest.mark.cuda
def test_capture_after_a_body_raised_during_its_capture(cuda):
    """A body that raises on its capturing call: the step raises the body's
    own error, ends and discards the capture and restores the stream; a
    fresh step then captures and replays, though the failed step and a dead
    captured graph are freed by a collection in the middle of its capture
    (a graph freed mid-capture invalidates a global-mode capture:
    ``core/capture_check.py``)."""
    import gc

    from repro_torch.core.cuda_graph import GraphedStep

    state = {"w": torch.zeros(256, device=cuda)}
    x = {"x": torch.ones(256, device=cuda)}
    calls = []

    def failing_body(batch):
        state["w"].add_(batch["x"])
        calls.append(1)
        if len(calls) == 2:
            raise ValueError("the body fails while it is captured")

    failing = GraphedStep(failing_body, lambda: state, cuda)
    failing(x)  # warm-up
    with pytest.raises(ValueError, match="fails while it is captured"):
        failing(x)
    assert torch.cuda.current_stream() == torch.cuda.default_stream()
    assert failing.captured == 0
    dead = GraphedStep(lambda b: state["w"].mul_(b["x"]), lambda: state, cuda)
    for _ in range(3):
        dead(x)
    assert dead.captured == 1
    cycle = [failing, dead]
    cycle.append(cycle)
    del cycle, failing, dead
    fresh_state = {"w": torch.zeros(256, device=cuda)}

    def fresh_body(batch):
        fresh_state["w"].add_(batch["x"])
        gc.collect()

    fresh = GraphedStep(fresh_body, lambda: fresh_state, cuda)
    for i in range(4):
        fresh({"x": torch.full((256,), float(i), device=cuda)})
    torch.cuda.synchronize()
    assert (fresh.captured, fresh.replays) == (1, 3)
    assert float(fresh_state["w"][0]) == 6.0


@pytest.mark.cuda
def test_capture_after_an_offload_superstep_raised(cuda):
    """million-client-ring on its graph raises mid-way through a superstep
    (after the replay, in the store's scatter); with the failed run kept
    alive by its traceback in a cycle, as a failed smoke phase kept it, a
    fresh run captures its steps, one of whose bodies runs the collector
    mid-capture."""
    import gc
    import sys

    run = build_scenario("million-client-ring")
    sched, src = run.runtime.scheduler, run.batch_source()
    for _ in range(3):  # warm-up, capture, replay
        run.runtime.step(src)
    assert sched._graph.captured == 1

    def scatter(*args):
        raise AssertionError("a check fails mid-superstep")

    sched.store.scatter = scatter
    with pytest.raises(AssertionError, match="mid-superstep"):
        run.runtime.step(src)
    kept = [sys.exc_info(), run]
    kept.append(kept)
    del kept, run, sched, src
    fresh = build_scenario("mnist-noniid-ring", tau2=2)
    fsched, fsrc = fresh.runtime.scheduler, fresh.batch_source()
    real = fsched._update

    def collecting(event, batch):
        out = real(event, batch)
        gc.collect()
        return out

    fsched._update = collecting
    for _ in range(12):  # local: warm-up, capture, replays; intra and inter warm-ups
        fresh.runtime.step(fsrc)
    torch.cuda.synchronize()
    assert fsched._graphs["local"].captured == 1 and fsched._graphs["local"].replays >= 2
    for w in fsched.params.values():
        assert bool(torch.isfinite(w).all())


@pytest.mark.cuda
def test_device_kernel_names_raises_on_a_session_without_device_records(cuda, monkeypatch):
    """A session whose CUDA records are lost (dropped here after the session
    stops) while the host's launches are recorded raises rather than
    counting; the same session with its records counts exactly."""
    import torch.profiler
    from torch.autograd import DeviceType

    from repro_torch.kernels import EmptySessionError

    y = torch.randn(4, 1024, device=cuda)
    p = _p_t(cuda)
    gossip_mix(y, p)
    assert device_launches(lambda: gossip_mix(y, p))[1] == {"gossip_mix": 1}
    real = torch.profiler.profile

    class LosesDeviceRecords(real):
        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            res = self.profiler.kineto_results
            kept = [e for e in res.events() if e.device_type() != DeviceType.CUDA]
            self.profiler.kineto_results = type("Lost", (), {
                "events": lambda s: kept, "trace_start_ns": lambda s: res.trace_start_ns()})()
            return out

    monkeypatch.setattr(torch.profiler, "profile", LosesDeviceRecords)
    with pytest.raises(EmptySessionError) as err:
        device_launches(lambda: gossip_mix(y, p))
    assert any(name in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")
               for name, _ in err.value.host_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("name,steps,kw", [
    # sync: one graph per event kind, the round's weights and faulted mixing
    # matrix read from the graph's static buffers
    ("mnist-iid-ring", 12, {"num_clients": 8, "tau1": 2, "tau2": 2,
                            "participation": {"strategy": "uniform-k", "k": 1},
                            "faults": [{"kind": "link-down", "round": 1, "link": [0, 3],
                                        "until": 3}]}),
    # round: the fault trace's (R, C) weights and (R, D, D) mixing stacks
    ("chaos-ring", 4, {}),
    # async: P_t's ring stencil gathered from the MIXING batch entry
    ("straggler-bimodal-async", 12, {"num_clients": 8}),
])
def test_collective_transition_on_graphs_equals_eager(cuda, name, steps, kw):
    """The collective backend on the sync, round and async graphs against its
    eager runs, under cuDNN's deterministic algorithms: the state at 0.0, the
    graphs replayed."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    states = {}
    try:
        for graph in (False, True):
            run = build_scenario(name, device=cuda, backend="collective", graph=graph,
                                 num_samples=400, **kw)
            sched = run.runtime.scheduler
            assert sched.backend.name == "collective"
            src = run.batch_source()
            for _ in range(steps):
                run.runtime.step(src)
            state = sched.y if name.endswith("async") else sched.params
            states[graph] = {k: v.clone() for k, v in state.items()}
            if graph:
                graphs = getattr(sched, "_graphs", None) or {"step": sched._graph}
                assert sum(g.replays for g in graphs.values()) >= 2, graphs
    finally:
        torch.backends.cudnn.deterministic = deterministic
    for k, v in states[False].items():
        assert torch.equal(v, states[True][k]), k


# -- graphs on a mesh: one NCCL rank (the card's machine has one GPU) ------------

@pytest.fixture
def nccl_rank(cuda):
    """A process group of one NCCL rank on a free local port (a timeout on
    its init), destroyed after the test."""
    import datetime
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        yield cuda
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_mesh_exchanges_replay_bitwise_eager_on_one_nccl_rank(nccl_rank):
    """The exchanges of the mesh steps' bodies in one ``GraphedStep`` on one
    NCCL rank (``capture_check.hold_mesh_exchanges``): warm-up, capture,
    replays, each call bitwise an eager run of the body on the same inputs
    (new inputs every call: the tree in place, the weight and losses
    through the static buffers)."""
    from repro_torch.core.capture_check import hold_mesh_exchanges
    from repro_torch.launch.mesh import make_client_mesh

    mesh = make_client_mesh(1)
    assert (mesh.device.type, mesh.backend) == ("cuda", "nccl")
    gen = torch.Generator(device=nccl_rank).manual_seed(0)
    tree = {"w": torch.randn((1, 64, 33), generator=gen, device=nccl_rank).bfloat16(),
            "b": torch.randn((1, 17), generator=gen, device=nccl_rank)}
    step, _, _ = hold_mesh_exchanges(tree, mesh, calls=5)
    torch.cuda.synchronize()
    assert step.captured == 1 and step.replays == 4


@pytest.mark.cuda
def test_mesh_server_graph_equals_eager_on_one_nccl_rank(nccl_rank):
    """``ContinuousFederatedServer`` on a cluster mesh of one NCCL rank with
    ``graph=True``: the chunk's token all-reduce captured in its graph, one
    capture, the tokens those of ``graph=False`` on the mesh and of the
    off-mesh server."""
    from repro_torch.launch.mesh import make_cluster_mesh
    from repro_torch.models import CausalLM
    from repro_torch.models.config import ArchConfig
    from repro_torch.serving import ContinuousFederatedServer, Request

    cfg = ArchConfig(name="spmd-serve", family="dense", num_layers=2, d_model=32, d_ff=64,
                     vocab_size=64, num_heads=2, num_kv_heads=1, head_dim=16, dtype="float32",
                     remat=False, attn_chunk=16, tie_embeddings=True)
    model = CausalLM(cfg)
    stack = {k: v[None].to(nccl_rank) for k, v in
             model.init(torch.Generator().manual_seed(0)).items()}
    rng = np.random.default_rng(0)
    reqs = [dict(uid=i, prompt=rng.integers(0, cfg.vocab_size, int(rng.integers(3, 17))),
                 max_new_tokens=int(rng.integers(1, 9)), eos_id=int(rng.integers(0, 64)),
                 cluster_id=0) for i in range(12)]
    tokens, servers = {}, {}
    for label, mesh, graph in (("graph", make_cluster_mesh(1), True),
                               ("eager", make_cluster_mesh(1), False), ("off", None, None)):
        srv = ContinuousFederatedServer(model, stack, mesh=mesh, graph=graph, max_batch=4,
                                        length_buckets=(8, 16), gen_cap=8, chunk_steps=3)
        batch = [Request(**r) for r in reqs]
        for r in batch:
            srv.submit(r)
        srv.run()
        tokens[label], servers[label] = [r.output for r in batch], srv
    for label in ("eager", "off"):
        for a, b in zip(tokens["graph"], tokens[label]):
            np.testing.assert_array_equal(a, b, err_msg=label)
    graphed = servers["graph"]._chunk_p.graphed
    assert servers["graph"].mesh is not None and servers["eager"]._chunk_p.graphed is None
    assert graphed.captured == 1 and graphed.replays >= 1


@pytest.mark.cuda
def test_nccl_outstanding_capture(cuda):
    """``core/capture_check.py``'s ``nccl-outstanding`` case in its own
    process: with an eager all-reduce outstanding, the port's
    ``GraphedStep`` captures an all-reduce at once and replays it, and a
    fresh step captures after it."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.core.capture_check", "--case",
                           "nccl-outstanding"], capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["graphed_step"] == {"captured": 1, "replays": 3, "value": 6.0}, res
    assert res["fresh_capture"] is True, res
