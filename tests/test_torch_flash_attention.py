"""Port parity: flash attention's plain versions and the differentiable op.

The plain forward (what CPU tensors take, and what the CUDA kernel is held
to on the card) against the reference's Pallas kernel in interpret mode and
its exact oracle, with the cases and tolerances of the reference's kernel
tests (2e-5 f32, 3e-2 bf16).  The plain backward against ``jax.vjp`` of the
oracle (1e-5 f32).  The op under ``torch.func.vmap(grad)`` against a
per-sample loop, ragged sequence lengths, and the wrappers' refusals.
"""
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
    with pytest.raises(ValueError, match="cpu or cuda"):
        flash_attention_fwd(q.to("meta"), k.to("meta"), v.to("meta"))
    out, lse = flash_attention_fwd(q, k, v)
    with pytest.raises(TypeError, match="lse"):
        flash_attention_bwd(q, k, v, out, lse.double(), out)
    with pytest.raises(ValueError, match="do not match"):
        flash_attention_bwd(q, k, v, out, lse[:, :, :8].contiguous(), out)
