"""Port parity: flash attention's plain versions and the differentiable op.

The plain forward (what CPU tensors take, and what the CUDA kernel is held
to on the card) against the reference's Pallas kernel in interpret mode and
its exact oracle, with the cases and tolerances of the reference's kernel
tests (2e-5 f32, 3e-2 bf16).  The plain backward against ``jax.vjp`` of the
oracle (1e-5 f32).  The op under ``torch.func.vmap(grad)`` against a
per-sample loop, ragged sequence lengths, and the wrappers' refusals.  The
route each dtype and head width takes on the card, and the bf16 rounding of
P and dS that the tensor-core kernels do, held to the card's tolerances.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels import (
    flash_attention, flash_attention_bwd, flash_attention_bwd_ref, flash_attention_fwd,
    flash_attention_fwd_ref,
)
from repro_torch.kernels.flash_attention import route

# six test workers share the host's cores: one intra-op thread each, also
# in the processes a test starts
os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(1)

RNG = np.random.default_rng(0)


def _arr(shape, dtype=np.float32):
    return RNG.normal(size=shape).astype(dtype)


def _qkv(b, s, hq, hkv, hd):
    return _arr((b, s, hq, hd)), _arr((b, s, hkv, hd)), _arr((b, s, hkv, hd))


def _t(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


def _check_forward(q, k, v, window=None, cap=None, tol=2e-5):
    out, lse = flash_attention_fwd_ref(*_t(q, k, v), window, cap)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    pallas = jax_flash_attention(jq, jk, jv, window=window, logit_cap=cap, interpret=True)
    oracle = flash_attention_ref(jq, jk, jv, window=window, logit_cap=cap)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), atol=tol)
    np.testing.assert_allclose(out.numpy(), np.asarray(oracle), atol=tol)
    assert lse.shape == (q.shape[0], q.shape[2], q.shape[1]) and lse.dtype == torch.float32


@pytest.mark.parametrize("b,s,hq,hkv,hd", [
    (1, 256, 4, 4, 64),    # MHA
    (2, 256, 8, 2, 64),    # GQA
    (1, 512, 4, 1, 128),   # MQA, larger hd
])
def test_plain_forward_matches_pallas_shapes(b, s, hq, hkv, hd):
    _check_forward(*_qkv(b, s, hq, hkv, hd))


@pytest.mark.parametrize("window,cap", [(None, None), (128, None), (None, 30.0), (192, 50.0)])
def test_plain_forward_matches_pallas_window_softcap(window, cap):
    _check_forward(*_qkv(2, 512, 4, 2, 64), window=window, cap=cap)


def test_plain_forward_matches_pallas_bf16():
    q, k, v = (jnp.asarray(_arr((1, 256, 4, 64)), jnp.bfloat16) for _ in range(3))
    tq, tk, tv = (torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
                  for x in (q, k, v))
    out, _ = flash_attention_fwd_ref(tq, tk, tv)
    assert out.dtype == torch.bfloat16
    pallas = jax_flash_attention(q, k, v, interpret=True)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(pallas, np.float32), atol=3e-2)


def test_plain_forward_matches_pallas_nonaligned_head_dim():
    _check_forward(*_qkv(1, 256, 2, 2, 96))


def _jax_grads(q, k, v, dout, window, cap):
    _, vjp = jax.vjp(lambda a, b, c: flash_attention_ref(a, b, c, window=window, logit_cap=cap),
                     *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(dout))]


@pytest.mark.parametrize("b,s,hq,hkv,hd,window,cap", [
    (2, 64, 4, 4, 32, None, None),
    (1, 96, 8, 2, 64, 24, None),
    (2, 64, 4, 1, 32, None, 30.0),
    (1, 80, 4, 2, 96, 33, 50.0),   # ragged S, hd 96, both
])
def test_plain_backward_matches_jax_grad(b, s, hq, hkv, hd, window, cap):
    q, k, v = _qkv(b, s, hq, hkv, hd)
    dout = _arr((b, s, hq, hd))
    out, lse = flash_attention_fwd_ref(*_t(q, k, v), window, cap)
    got = flash_attention_bwd_ref(*_t(q, k, v), out, lse, torch.from_numpy(dout), window, cap)
    for g, ref in zip(got, _jax_grads(q, k, v, dout, window, cap)):
        np.testing.assert_allclose(g.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("window,cap", [(None, None), (7, 5.0)])
def test_vmap_grad_through_op_matches_per_sample_loop(window, cap):
    """``vmap(grad_and_value)`` over a client axis folds the clients into the
    batch: one forward and one backward call serve the fleet."""
    c, (b, s, hq, hkv, hd) = 3, (2, 40, 4, 2, 16)
    q, k, v = (torch.from_numpy(np.stack([_arr(x.shape) for _ in range(c)]))
               for x in _qkv(b, s, hq, hkv, hd))
    w = torch.from_numpy(_arr((c, b, s, hq, hd)))

    def loss(q, k, v, w):
        return (flash_attention(q, k, v, window, cap) * w).sum()

    grads, losses = torch.func.vmap(torch.func.grad_and_value(loss, argnums=(0, 1, 2)))(
        q, k, v, w)
    assert losses.shape == (c,)
    for i in range(c):
        leaves = [x[i].clone().requires_grad_() for x in (q, k, v)]
        out, _ = flash_attention_fwd_ref(*leaves, window, cap)
        ref_loss = (out * w[i]).sum()
        ref_loss.backward()
        np.testing.assert_allclose(losses[i].item(), ref_loss.item(), rtol=1e-6)
        for g, leaf in zip(grads, leaves):
            np.testing.assert_allclose(g[i].numpy(), leaf.grad.numpy(), atol=1e-5)
    # nested vmap (clients, then microbatches) folds twice
    inner = torch.func.vmap(torch.func.vmap(flash_attention))(q[:, :, None], k[:, :, None],
                                                              v[:, :, None])
    np.testing.assert_allclose(inner[:, :, 0].numpy(),
                               torch.func.vmap(flash_attention)(q, k, v).numpy(), atol=1e-6)


@pytest.mark.parametrize("s", [1, 17, 80])
def test_ragged_sequence_lengths(s):
    q, k, v = _qkv(1, s, 4, 2, 32)
    out, lse = flash_attention_fwd_ref(*_t(q, k, v))
    oracle = flash_attention_ref(*(jnp.asarray(x) for x in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(oracle), atol=2e-5)
    dout = _arr(q.shape)
    got = flash_attention_bwd(*_t(q, k, v), out, lse, torch.from_numpy(dout))
    for g, ref in zip(got, _jax_grads(q, k, v, dout, None, None)):
        np.testing.assert_allclose(g.numpy(), ref, atol=1e-5)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    q, k, v = _t(*_qkv(1, 16, 4, 2, 32))
    with pytest.raises(TypeError):
        flash_attention_fwd(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        flash_attention_fwd(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention_fwd(q[:, :, :3].contiguous(), k, v)
    with pytest.raises(ValueError, match="256"):
        big = torch.zeros(1, 16, 2, 320)
        flash_attention_fwd(big, big, big)
    with pytest.raises(ValueError, match="window"):
        flash_attention_fwd(q, k, v, window=0)
    with pytest.raises(ValueError, match="logit_cap"):
        flash_attention_fwd(q, k, v, logit_cap=-1.0)
    # a meta tensor holds no data: the wrapper takes its traced path (the dry
    # run's), which launches nothing and returns the kernel's shapes, and
    # still refuses what the kernels do not take
    launched = flash_attention_fwd.launches
    mo, ml = flash_attention_fwd(q.to("meta"), k.to("meta"), v.to("meta"))
    assert (mo.is_meta, tuple(mo.shape), tuple(ml.shape), ml.dtype) == (
        True, tuple(q.shape), (1, 4, 16), torch.float32)
    assert flash_attention_fwd.launches == launched
    with pytest.raises(ValueError, match="window"):
        flash_attention_fwd(q.to("meta"), k.to("meta"), v.to("meta"), window=0)
    out, lse = flash_attention_fwd(q, k, v)
    with pytest.raises(TypeError, match="lse"):
        flash_attention_bwd(q, k, v, out, lse.double(), out)
    with pytest.raises(ValueError, match="do not match"):
        flash_attention_bwd(q, k, v, out, lse[:, :, :8].contiguous(), out)


@pytest.mark.parametrize("dtype,hd,backward,want", [
    (torch.bfloat16, 64, False, "tensor_core"),
    (torch.bfloat16, 96, False, "tensor_core"),
    (torch.bfloat16, 128, False, "tensor_core"),
    (torch.bfloat16, 256, False, "tensor_core"),
    (torch.bfloat16, 64, True, "tensor_core"),
    (torch.bfloat16, 96, True, "tensor_core"),
    (torch.bfloat16, 128, True, "tensor_core"),
    (torch.bfloat16, 256, True, "tensor_core"),  # dK and dV in one warpgroup each
    (torch.bfloat16, 160, True, "tensor_core"),  # on the hd-160 tile
    (torch.bfloat16, 136, True, "tensor_core"),
    (torch.bfloat16, 132, True, "cuda_core"),    # hd % 8 != 0
    (torch.bfloat16, 100, False, "split_tf32"),  # hd % 8 != 0: no 16-byte TMA strides
    (torch.bfloat16, 100, True, "cuda_core"),
    (torch.float32, 128, False, "split_tf32"),   # f32 stays f32-accurate: split TF32
    (torch.float32, 64, True, "cuda_core"),
    (torch.float32, 256, False, "split_tf32"),
    (torch.float32, 30, False, "split_tf32"),
    (torch.bfloat16, 30, False, "split_tf32"),
    (torch.float32, 256, True, "cuda_core"),
])
def test_route_by_dtype_and_head_width(dtype, hd, backward, want):
    assert route(dtype, hd, backward=backward) == want


def _bf16_rounded_forward(q, k, v, window, cap):
    """The plain forward with P rounded to bf16 before P V, as the tensor-core
    kernel rounds it (``l`` sums the unrounded P)."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, hd).float()
    raw = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * hd ** -0.5
    sc = raw if cap is None else cap * torch.tanh(raw / cap)
    pos = torch.arange(s)
    mask = pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= (pos[:, None] - pos[None, :]) < window
    sc = torch.where(mask, sc, -1e30)
    p = torch.where(mask, torch.exp(sc - sc.amax(-1, keepdim=True)), 0.0)
    pv = torch.einsum("bhgqk,bkhd->bqhgd", p.to(torch.bfloat16).float(), v.float())
    out = pv / p.sum(-1).clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, s, hq, hd).to(q.dtype)


def _bf16_rounded_backward(q, k, v, out, lse, dout, window, cap):
    """The plain backward with P and dS rounded to bf16 before the dV, dQ and
    dK products, as the tensor-core kernels round them."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = hd ** -0.5
    qg = q.reshape(b, s, hkv, g, hd).float()
    raw = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    sc = raw if cap is None else cap * torch.tanh(raw / cap)
    pos = torch.arange(s)
    mask = pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= (pos[:, None] - pos[None, :]) < window
    p = torch.where(mask, torch.exp(sc - lse.reshape(b, hkv, g, s)[..., None]), 0.0)
    do = dout.reshape(b, s, hkv, g, hd).float()
    delta = torch.einsum("bqhgd,bqhgd->bhgq", do, out.reshape(b, s, hkv, g, hd).float())
    dp = torch.einsum("bqhgd,bkhd->bhgqk", do, v.float())
    ds = p * (dp - delta[..., None])
    if cap is not None:
        ds = ds * (1.0 - torch.tanh(raw / cap) ** 2)
    r = lambda x: x.to(torch.bfloat16).float()
    dv = torch.einsum("bhgqk,bqhgd->bkhd", r(p), do)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", r(ds), k.float()) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", r(ds), qg) * scale
    return tuple(x.to(t.dtype) for x, t in ((dq.reshape(b, s, hq, hd), q), (dk, k), (dv, v)))


@pytest.mark.parametrize("window,cap", [(None, None), (48, 30.0)])
@pytest.mark.parametrize("hd", [64, 96, 128, 256])
def test_bf16_rounding_of_p_and_ds_within_card_tolerances(hd, window, cap):
    """The tensor-core kernels round P (and dS) to bf16 before the second
    product, where the plain version keeps f32.  With that rounding the plain
    formulas still meet the card tests' bf16 tolerances (3e-2 forward, 3e-2
    relative to the largest entry for the gradients), so a later redesign
    that rounds more cannot pass unseen."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _qkv(1, 160, 4, 2, hd))
    dout = torch.from_numpy(_arr((1, 160, 4, hd))).to(torch.bfloat16)
    out, lse = flash_attention_fwd_ref(q, k, v, window, cap)
    got = _bf16_rounded_forward(q, k, v, window, cap)
    np.testing.assert_allclose(got.float().numpy(), out.float().numpy(), atol=3e-2)
    refs = flash_attention_bwd_ref(q, k, v, out, lse, dout, window, cap)
    for g, r in zip(_bf16_rounded_backward(q, k, v, out, lse, dout, window, cap), refs):
        scale = max(1.0, r.float().abs().max().item())
        np.testing.assert_allclose(g.float().numpy(), r.float().numpy(), atol=3e-2 * scale)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32's 10 mantissa bits, to nearest (ties away), as
    ``cvt.rna.tf32.f32`` rounds it."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _split_tf32_product(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum(eq, a, b)`` as the split-TF32 kernel forms it: hi.hi + hi.lo +
    lo.hi of the TF32 splits (lo.lo dropped), summed in f64 and rounded to f32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    terms = [(ah, bh), (ah, bl), (al, bh)]
    return sum(torch.einsum(eq, x.double(), y.double()) for x, y in terms).float()


@pytest.mark.parametrize("window,cap", [(None, None), (48, 30.0)])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_split_tf32_arithmetic_within_card_tolerances(hd, window, cap):
    """The split-TF32 forward keeps Q K^T and P V to about 21 bits: with its
    splits (and lo.lo dropped) the plain formulas still meet the card tests'
    f32 tolerances (2e-5 on out, 1e-4 on lse), at every head width the
    kernel is built for, with and without a window and a cap."""
    b, s, hq, hkv = 1, 160, 4, 2
    q, k, v = (torch.from_numpy(x) for x in _qkv(b, s, hq, hkv, hd))
    out, lse = flash_attention_fwd_ref(q, k, v, window, cap)
    g = hq // hkv
    qg = q.reshape(b, s, hkv, g, hd)
    raw = _split_tf32_product("bqhgd,bkhd->bhgqk", qg, k) * hd ** -0.5
    sc = raw if cap is None else cap * torch.tanh(raw / cap)
    pos = torch.arange(s)
    mask = pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= (pos[:, None] - pos[None, :]) < window
    sc = torch.where(mask, sc, -1e30)
    m = sc.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(sc - m), 0.0)
    l = p.sum(-1)
    pv = _split_tf32_product("bhgqk,bkhd->bqhgd", p, v)
    got = (pv / l.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]).reshape(b, s, hq, hd)
    got_lse = (m[..., 0] + torch.log(l)).reshape(b, hq, s)
    np.testing.assert_allclose(got.numpy(), out.numpy(), atol=2e-5)
    np.testing.assert_allclose(got_lse.numpy(), lse.numpy(), atol=1e-4)
    # the splits matter: TF32 alone (hi.hi) misses the forward tolerance
    plain_tf32 = torch.einsum("bhgqk,bkhd->bqhgd", _tf32(p), _tf32(v))
    assert not np.allclose((plain_tf32 / l.permute(0, 3, 1, 2)[..., None]).reshape(b, s, hq, hd)
                           .numpy(), out.numpy(), atol=2e-5)
