"""Plain PyTorch versions of the flash-attention forward and backward.

The exact softmax of ``repro/kernels/flash_attention/ref.py`` (causal GQA,
optional sliding ``window`` and ``logit_cap``), f32 arithmetic, output in the
input dtype; with a query-row map (``query_positions``) the query rows sit
at positions of a longer key sequence, causal from the bottom right.  The forward also returns ``lse = m + log l`` (f32, ``(B, Hq,
S)``), which the backward recomputes the probabilities from.  The backward
is written out with the kernels' formulas (FlashAttention-2), not taken from
autograd.  CPU tensors take these; ``chip_smoke.py`` and the card tests hold
the CUDA kernels to them.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["flash_attention_fwd_ref", "flash_attention_bwd_ref", "query_positions",
           "NEG_INF"]

NEG_INF = -1e30


def query_positions(sq: int, rows: Optional[tuple], device=None) -> torch.Tensor:
    """The positions of a call's ``sq`` query rows: row ``j`` at ``j``, or
    under a query-row map ``rows = (rl, c, r0)`` at ``(j // rl) * c + r0 + j
    % rl`` (``rl`` rows of each chunk of ``c`` positions, from its row
    ``r0``: one rank's rows of a sequence-parallel split)."""
    j = torch.arange(sq, device=device)
    if rows is None:
        return j
    rl, c, r0 = rows
    return torch.div(j, rl, rounding_mode="floor") * c + r0 + j % rl


def _mask(q_pos: torch.Tensor, sk: int, window: Optional[int]) -> torch.Tensor:
    """(Sq, Sk): key ``kp`` live for the query at ``qp`` when ``kp <= qp``
    (and ``qp - kp < window``)."""
    kp = torch.arange(sk, device=q_pos.device)
    mask = q_pos[:, None] >= kp[None, :]
    if window is not None:
        mask &= (q_pos[:, None] - kp[None, :]) < window
    return mask


def _scores(q, k, window, logit_cap, rows=None):
    """(raw scores, capped and masked scores, mask), each (B, Hkv, G, Sq, Sk) f32."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, hd).float()
    raw = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * hd ** -0.5
    capped = raw if logit_cap is None else logit_cap * torch.tanh(raw / logit_cap)
    mask = _mask(query_positions(s, rows, q.device), k.shape[1], window)
    return raw, torch.where(mask, capped, NEG_INF), mask


def flash_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            window: Optional[int] = None,
                            logit_cap: Optional[float] = None, rows: Optional[tuple] = None):
    """q ``(B, Sq, Hq, hd)``, k/v ``(B, Sk, Hkv, hd)`` -> (out ``(B, Sq, Hq,
    hd)``, lse ``(B, Hq, Sq)`` f32); ``Sq == Sk`` without a query-row map
    ``rows`` (``query_positions``)."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    _, scores, _ = _scores(q, k, window, logit_cap, rows)
    lse = torch.logsumexp(scores, dim=-1)                       # (B, Hkv, G, S)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    # contiguous, as the kernel writes them
    return (out.reshape(b, s, hq, hd).to(q.dtype).contiguous(),
            lse.reshape(b, hq, s).contiguous())


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                            window: Optional[int] = None,
                            logit_cap: Optional[float] = None, rows: Optional[tuple] = None):
    """(dq, dk, dv) in the inputs' dtypes, from the forward's ``out`` and ``lse``.

    ``P = exp(s - lse)`` (0 where masked); ``dV = P^T dO``; ``dP = dO V^T``;
    ``Delta = rowsum(dO * O)``; ``dS = P (dP - Delta)``, times ``1 -
    tanh^2(s_raw / cap)`` under a cap; ``dQ = scale dS K``, ``dK = scale
    dS^T Q``.  GQA sums the G query heads of a KV head into its dK and dV;
    under a query-row map ``rows`` a key no row reads gets zeros.
    """
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = hd ** -0.5
    raw, scores, mask = _scores(q, k, window, logit_cap, rows)
    lse_g = lse.reshape(b, hkv, g, s)
    p = torch.where(mask, torch.exp(scores - lse_g[..., None]), 0.0)
    do = dout.reshape(b, s, hkv, g, hd).float()
    o = out.reshape(b, s, hkv, g, hd).float()
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, do)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", do, v.float())
    delta = torch.einsum("bqhgd,bqhgd->bhgq", do, o)
    ds = p * (dp - delta[..., None])
    if logit_cap is not None:
        ds = ds * (1.0 - torch.tanh(raw / logit_cap) ** 2)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, q.reshape(b, s, hkv, g, hd).float()) * scale
    return tuple(x.to(t.dtype).contiguous() for x, t in
                 ((dq.reshape(b, s, hq, hd), q), (dk, k), (dv, v)))
