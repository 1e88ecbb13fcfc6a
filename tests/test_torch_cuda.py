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
and, in bf16, is rounded once to 2^-8 relative.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import ClusterSpec, build_local_update, chain, mixing_matrix, ring
from repro_torch.core import resolve_backend, staleness_mixing_matrix
from repro_torch.kernels import (
    cluster_agg, cluster_agg_ref, cluster_agg_tree, flash_attention, flash_attention_bwd,
    flash_attention_bwd_ref, flash_attention_fwd, flash_attention_fwd_ref, fused_transition,
    fused_transition_ref,
    fused_transition_tree, gossip_mix, gossip_mix_ref, normalized_update, normalized_update_ref,
    sgd_update, sgd_update_ref, sgd_update_tree,
)
from repro_torch.kernels.fused_transition.ops import MAX_LEAVES
from repro_torch.kernels.flash_attention import route
from repro_torch.models import MnistCNN
from repro_torch.optim import sgd
from repro_torch.scenarios import build_scenario

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
        gossip_mix(torch.zeros(4, 8, dtype=torch.float64, device=cuda), torch.eye(4))
    with pytest.raises(ValueError, match="D <= 16"):
        gossip_mix(torch.zeros(17, 8, device=cuda), torch.eye(17))
    with pytest.raises(ValueError, match="contiguous"):
        gossip_mix(torch.zeros(8, 4, device=cuda).T, torch.eye(4))
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
    return torch.tensor(staleness_mixing_matrix(ring(d), trigger, gaps), dtype=torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("alpha", [0, 1, 2])
@pytest.mark.parametrize("m", [10, 333, 16_000])
@pytest.mark.parametrize("mixing", ["ring", "p_t"])
def test_gossip_mix_matches_plain_in_place(cuda, dtype, tol, alpha, m, mixing):
    p = _p_t(cuda) if mixing == "p_t" else _factors("cpu")[1]
    y = torch.tensor(RNG.normal(size=(4, m)), dtype=torch.float32, device=cuda).to(dtype)
    ref = gossip_mix_ref(y, p.to(cuda), alpha)
    n = gossip_mix.launches
    out = gossip_mix(y, p, alpha=alpha)
    torch.cuda.synchronize()
    assert gossip_mix.launches == n + 1
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)
    gossip_mix(y, p.to(cuda), alpha=alpha, out=y)  # in place, P read back from the card
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
        run = build_scenario("straggler-bimodal-async", device=cuda, backend=backend, **small)
        assert run.runtime.scheduler.backend.name == backend
        src = run.batch_source()
        n = (normalized_update.launches, cluster_agg.launches, gossip_mix.launches)
        events = [run.runtime.step(src).cluster for _ in range(6)]
        launched = (normalized_update.launches - n[0], cluster_agg.launches - n[1],
                    gossip_mix.launches - n[2])
        runs[backend] = (run.runtime.scheduler.y, events, launched)
    # normalized_update and gossip_mix once per leaf per event, cluster_agg
    # once per event (the tree's leaves fit one table)
    leaves = len(runs["cuda"][0])
    assert leaves <= MAX_LEAVES
    assert runs["cuda"][2] == (6 * leaves, 6, 6 * leaves)
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


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_bf16_takes_tensor_cores_and_is_deterministic(cuda, case):
    """bf16 at hd <= 128 runs the wgmma/TMA kernels, forward and backward
    (hd 256's backward stays on the CUDA cores), and the backward, which
    sums without atomics, is bitwise the same from call to call."""
    b, s, hq, hkv, hd, window, cap = case
    q, k, v, dout = _qkvg(cuda, torch.bfloat16, b, s, hq, hkv, hd)
    n = flash_attention_fwd.routes["tensor_core"], flash_attention_bwd.routes["tensor_core"]
    out, lse = flash_attention_fwd(q, k, v, window, cap)
    first = flash_attention_bwd(q, k, v, out, lse, dout, window, cap)
    second = flash_attention_bwd(q, k, v, out, lse, dout, window, cap)
    torch.cuda.synchronize()
    assert flash_attention_fwd.routes["tensor_core"] - n[0] == 1
    assert flash_attention_bwd.routes["tensor_core"] - n[1] == (2 if hd <= 128 else 0)
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
