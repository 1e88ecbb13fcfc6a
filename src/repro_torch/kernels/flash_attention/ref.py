"""Plain PyTorch versions of the flash-attention forward and backward.

The exact softmax of ``repro/kernels/flash_attention/ref.py`` (causal GQA,
optional sliding ``window`` and ``logit_cap``), f32 arithmetic, output in the
input dtype.  The forward also returns ``lse = m + log l`` (f32, ``(B, Hq,
S)``), which the backward recomputes the probabilities from.  The backward
is written out with the kernels' formulas (FlashAttention-2), not taken from
autograd.  CPU tensors take these; ``chip_smoke.py`` and the card tests hold
the CUDA kernels to them.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["flash_attention_fwd_ref", "flash_attention_bwd_ref", "NEG_INF"]

NEG_INF = -1e30


def _mask(s: int, window: Optional[int], device) -> torch.Tensor:
    pos = torch.arange(s, device=device)
    mask = pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= (pos[:, None] - pos[None, :]) < window
    return mask


def _scores(q, k, window, logit_cap):
    """(raw scores, capped and masked scores, mask), each (B, Hkv, G, S, S) f32."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, hd).float()
    raw = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * hd ** -0.5
    capped = raw if logit_cap is None else logit_cap * torch.tanh(raw / logit_cap)
    mask = _mask(s, window, q.device)
    return raw, torch.where(mask, capped, NEG_INF), mask


def flash_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            window: Optional[int] = None,
                            logit_cap: Optional[float] = None):
    """q ``(B, S, Hq, hd)``, k/v ``(B, S, Hkv, hd)`` -> (out ``(B, S, Hq, hd)``,
    lse ``(B, Hq, S)`` f32)."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    _, scores, _ = _scores(q, k, window, logit_cap)
    lse = torch.logsumexp(scores, dim=-1)                       # (B, Hkv, G, S)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    # contiguous, as the kernel writes them
    return (out.reshape(b, s, hq, hd).to(q.dtype).contiguous(),
            lse.reshape(b, hq, s).contiguous())


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                            window: Optional[int] = None,
                            logit_cap: Optional[float] = None):
    """(dq, dk, dv) in the inputs' dtypes, from the forward's ``out`` and ``lse``.

    ``P = exp(s - lse)`` (0 where masked); ``dV = P^T dO``; ``dP = dO V^T``;
    ``Delta = rowsum(dO * O)``; ``dS = P (dP - Delta)``, times ``1 -
    tanh^2(s_raw / cap)`` under a cap; ``dQ = scale dS K``, ``dK = scale
    dS^T Q``.  GQA sums the G query heads of a KV head into its dK and dV.
    """
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = hd ** -0.5
    raw, scores, mask = _scores(q, k, window, logit_cap)
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
