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
    cluster_agg, cluster_agg_ref, flash_attention, flash_attention_bwd, flash_attention_bwd_ref,
    flash_attention_fwd, flash_attention_fwd_ref, fused_transition, fused_transition_ref,
    gossip_mix, gossip_mix_ref, normalized_update, normalized_update_ref, sgd_update,
    sgd_update_ref,
)
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
    leaves = len(runs["cuda"][0])
    assert runs["cuda"][2] == (6 * leaves,) * 3
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
    leaves = len(runs["cuda"][0])
    # 2 attention layers x 16 iterations, clients folded into each launch;
    # one SGD launch per leaf per iteration; 2 rounds x (2 intra + 1 inter)
    # transitions per superstep
    assert runs["cuda"][2] == (32, 32, 16 * leaves, 12 * leaves)
    assert runs["dense"][2] == (0, 0, 0, 0)
    torch.testing.assert_close(runs["cuda"][1], runs["dense"][1], atol=1e-4, rtol=0)
    for k, v in runs["cuda"][0].items():
        torch.testing.assert_close(v, runs["dense"][0][k], atol=1e-4, rtol=0)
    assert abs(runs["cuda"][3] - runs["dense"][3]) <= 1e-4 * abs(runs["dense"][3])
