"""Port parity: the flash kernels' query-row map ('flash rows').

Sequence-parallel attention splits every query chunk of ``c`` positions
over ``m`` model ranks: rank ``r`` takes rows ``r * rl .. (r + 1) * rl`` of
each chunk (``rl = c / m``) against the whole K and V, as the reference's
``blocked_causal_attention(shard_chunk=True)`` does.  The port passes a
rank's rows to the flash kernels as one call with the map ``rows = (rl, c,
r * rl)``.  Held here on the plain versions (what CPU tensors take, and
what the kernels are held to on the card), f32, for ``m`` in {2, 4},
windows and caps included:

* each rank's rows, and their lse, equal the same rows of the full call
  (1e-6);
* each rank's dQ rows equal the full dQ's rows (1e-6), and dK and dV
  summed over the ``m`` ranks equal the full dK and dV (1e-6, and 1e-6 of
  the value: the same f32 sum taken in another order);
* the rows equal the reference's ``blocked_causal_attention`` at their
  positions (1e-5);
* the differentiable op under ``torch.func.vmap(grad)`` carries the map;
* ``live_pairs`` counts the map's live pairs, and the wrappers refuse a map
  that does not fit the keys.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import blocked_causal_attention as jax_blocked
from repro_torch.kernels import flash_attention, flash_attention_bwd, flash_attention_fwd
from repro_torch.kernels.flash_attention.ops import live_pairs
from repro_torch.kernels.flash_attention.ref import query_positions

# six test workers share the host's cores: one intra-op thread each, also
# in the processes a test starts
os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(1)

B, S, HQ, HKV, HD, CHUNK = 2, 64, 4, 2, 16, 16


def _inputs(seed: int):
    rng = np.random.default_rng(seed)
    q, k, v, dout = (rng.normal(size=(B, S, h, HD)).astype(np.float32)
                     for h in (HQ, HKV, HKV, HQ))
    return q, k, v, dout


def _rank_rows(m: int, r: int):
    """(the map, the positions of rank ``r``'s rows)."""
    rl = CHUNK // m
    rows = (rl, CHUNK, r * rl)
    return rows, query_positions(S // CHUNK * rl, rows)


@pytest.mark.parametrize("cap", [None, 50.0])
@pytest.mark.parametrize("window", [None, 24, 8])
@pytest.mark.parametrize("m", [2, 4])
def test_rank_rows_equal_the_full_calls_rows(m, window, cap):
    q, k, v, dout = (torch.from_numpy(x) for x in _inputs(m))
    out, lse = flash_attention_fwd(q, k, v, window, cap)
    dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, window, cap)
    jout = np.asarray(jax_blocked(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                                  jnp.asarray(v.numpy()), window=window, logit_cap=cap,
                                  chunk=CHUNK))
    dk_sum, dv_sum = torch.zeros_like(dk), torch.zeros_like(dv)
    for r in range(m):
        rows, pos = _rank_rows(m, r)
        qr, do_r = q[:, pos].contiguous(), dout[:, pos].contiguous()
        out_r, lse_r = flash_attention_fwd(qr, k, v, window, cap, rows)
        np.testing.assert_allclose(out_r.numpy(), out[:, pos].numpy(), atol=1e-6)
        np.testing.assert_allclose(lse_r.numpy(), lse[:, :, pos].numpy(), atol=1e-6)
        np.testing.assert_allclose(out_r.numpy(), jout[:, pos.numpy()], atol=1e-5)
        dq_r, dk_r, dv_r = flash_attention_bwd(qr, k, v, out_r, lse_r, do_r, window, cap, rows)
        np.testing.assert_allclose(dq_r.numpy(), dq[:, pos].numpy(), atol=1e-6)
        dk_sum += dk_r
        dv_sum += dv_r
    # an f32 sum over the same rows in another order: 1e-6 of the value too
    np.testing.assert_allclose(dk_sum.numpy(), dk.numpy(), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(dv_sum.numpy(), dv.numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("window", [None, 8])
def test_the_op_carries_the_map_under_vmap_grad(window):
    """A fleet of 3 clients' rank-1 rows through ``vmap(grad)`` of the op
    against each client's full attention's gradient at those rows."""
    rng = np.random.default_rng(5)
    qs, ks, vs = (torch.from_numpy(rng.normal(size=(3, B, S, h, HD)).astype(np.float32))
                  for h in (HQ, HKV, HKV))
    rows, pos = _rank_rows(2, 1)

    def rank_loss(q, k, v):
        return flash_attention(q[:, pos], k, v, window, 50.0, rows).square().sum()

    def full_loss(q, k, v):
        return flash_attention(q, k, v, window, 50.0)[:, pos].square().sum()

    got = torch.func.vmap(torch.func.grad(rank_loss, argnums=(0, 1, 2)))(qs, ks, vs)
    want = torch.func.vmap(torch.func.grad(full_loss, argnums=(0, 1, 2)))(qs, ks, vs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6)


@pytest.mark.parametrize("window", [None, 1, 8, 24, 100])
def test_live_pairs_counts_the_maps_live_pairs(window):
    for m in (1, 2, 4):
        for r in range(m):
            rows, pos = _rank_rows(m, r)
            kp = torch.arange(S)
            live = pos[:, None] >= kp[None, :]
            if window is not None:
                live &= pos[:, None] - kp[None, :] < window
            assert live_pairs(len(pos), window, rows) == int(live.sum())
    # a one-chunk map at positions 0.. is the map-less call
    assert live_pairs(S, window, (S, S, 0)) == live_pairs(S, window)


def test_the_wrappers_refuse_a_map_that_does_not_fit():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(0))
    rows, pos = _rank_rows(2, 1)
    qr = q[:, pos].contiguous()
    with pytest.raises(ValueError, match="query-row map"):
        flash_attention_fwd(qr, k, v)                       # Sq != Sk, no map
    with pytest.raises(ValueError, match="past k's"):
        flash_attention_fwd(qr, k[:, :40].contiguous(), v[:, :40].contiguous(), rows=rows)
    with pytest.raises(ValueError, match="0 <= r0 <= c - rl"):
        flash_attention_fwd(qr, k, v, rows=(8, 16, 9))
    with pytest.raises(ValueError, match="1 <= rl <= c"):
        flash_attention_fwd(qr, k, v, rows=(0, 16, 0))
    with pytest.raises(ValueError, match="three ints"):
        flash_attention_fwd(qr, k, v, rows=(8, 16))
