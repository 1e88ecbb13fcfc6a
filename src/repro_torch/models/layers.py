"""Core neural layers: RMSNorm, RoPE, causal GQA attention, gated MLP.

The port's ``repro.models.layers`` for full-sequence training.  Attention
has two executions, chosen by ``ArchConfig.attn_impl``:

* ``"cuda"``: ``kernels.flash_attention``, the hand-written CUDA forward and
  backward kernels (their plain versions on CPU tensors), one launch per
  layer for a vmapped fleet;
* ``"plain"``: ``blocked_causal_attention``, the reference's chunked online
  softmax in PyTorch, differentiated by autograd.

Both take the reference's layout: q ``(B, S, Hq, hd)``, k/v ``(B, S, Hkv,
hd)``.  Decode attends one new token a row against a KV cache
(``decode_attention``): plain PyTorch with f32 scores, as the reference has
no Pallas kernel there, with the (accumulator, sum, max) stats exposed
(``decode_attention_stats``) as the reference's for an LSE merge.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = [
    "rms_norm",
    "rope",
    "blocked_causal_attention",
    "causal_attention",
    "decode_attention",
    "decode_attention_stats",
    "finalize_decode_stats",
    "gated_mlp",
    "dense",
    "init_dense",
    "softcap",
]

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * scale.float()
    return out.to(dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0) -> torch.Tensor:
    """Rotary embeddings. x: (B, S, H, hd); positions: (S,) or (B, S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.arange(half, dtype=torch.float32, device=x.device) / half
    inv = theta ** (-freqs)  # (half,)
    angles = positions.float()[..., None] * inv            # (S, half) or (B, S, half)
    angles = angles[..., None, :]                          # (S, 1, half) or (B, S, 1, half)
    if positions.dim() == 1:
        angles = angles[None]                              # (1, S, 1, half)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def blocked_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                             window: Optional[int] = None,
                             logit_cap: Optional[float] = None,
                             chunk: int = 512) -> torch.Tensor:
    """Causal GQA attention with online softmax over KV chunks.

    The reference's ``blocked_causal_attention`` (without sequence
    sharding): f32 scores per (q chunk, kv chunk) pair, running max, sum and
    accumulator.  KV chunks wholly above the diagonal or below the window
    are skipped: in the reference they leave the running state exactly as it
    was (their probabilities are 0, or scaled by 0 once a live chunk sets
    the max).  Requires ``S % chunk == 0`` after ``chunk = min(chunk, S)``.
    """
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} must be divisible by chunk {chunk}")
    n = s // chunk
    scale = hd ** -0.5
    pos = torch.arange(s, device=q.device).reshape(n, chunk)
    qb = q.reshape(b, n, chunk, hkv, g, hd).float()
    kb = k.reshape(b, n, chunk, hkv, hd).float()
    vb = v.reshape(b, n, chunk, hkv, hd).float()

    outs = []
    for i in range(n):
        qi, q_pos = qb[:, i], pos[i]
        m = torch.full((b, hkv, g, chunk), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, hkv, g, chunk), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, hkv, g, chunk, hd), dtype=torch.float32, device=q.device)
        first = 0 if window is None else max(0, (i * chunk - window + 1) // chunk)
        for j in range(first, i + 1):
            k_pos = pos[j]
            scores = torch.einsum("bqhgd,bkhd->bhgqk", qi, kb[:, j]) * scale
            scores = softcap(scores, logit_cap)
            mask = q_pos[:, None] >= k_pos[None, :]
            if window is not None:
                mask &= (q_pos[:, None] - k_pos[None, :]) < window
            scores = torch.where(mask, scores, NEG_INF)
            m_new = torch.maximum(m, scores.amax(dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(scores - m_new[..., None])
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vb[:, j])
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))  # (B, qc, Hkv, G, hd)
    return torch.stack(outs, dim=1).reshape(b, s, hq, hd).to(q.dtype)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     window: Optional[int], logit_cap: Optional[float], impl: str,
                     chunk: int = 512) -> torch.Tensor:
    """Causal GQA attention through the flash kernels (``impl="cuda"``) or the
    plain blocked path (``impl="plain"``)."""
    if impl == "cuda":
        from ..kernels import flash_attention

        return flash_attention(q, k, v, window, logit_cap)
    if impl == "plain":
        return blocked_causal_attention(q, k, v, window=window, logit_cap=logit_cap,
                                        chunk=chunk)
    raise ValueError(f"attention impl must be 'cuda' or 'plain', got {impl!r}")


def decode_attention_stats(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           slot_pos: torch.Tensor, q_pos: torch.Tensor, *,
                           window: Optional[int] = None, logit_cap: Optional[float] = None):
    """Partial attention stats for one query token a row.

    q: (B, Hq, hd); k_cache/v_cache: (B, Sc, Hkv, hd); slot_pos: the
    absolute position in each cache slot (-1 = empty), (Sc,) shared or (B,
    Sc) a row; q_pos: the query's position, a scalar or (B,).  Returns
    (acc, l, m): (B, Hq, hd), (B, Hq), (B, Hq), f32."""
    b, hq, hd = q.shape
    hkv = k_cache.shape[2]
    g = hq // hkv
    scale = hd ** -0.5
    qg = q.reshape(b, hkv, g, hd).float()
    # the cache is cast to f32 and laid out for the products in one pass each
    # ((B, Hkv, hd, Sc) and (B, Hkv, Sc, hd)), not cast and then permuted
    f32 = dict(dtype=torch.float32, memory_format=torch.contiguous_format)
    kt = k_cache.permute(0, 2, 3, 1).to(**f32)
    scores = torch.matmul(qg, kt) * scale                 # (B, Hkv, G, Sc)
    scores = softcap(scores, logit_cap)
    slot_pos = slot_pos.reshape(-1, slot_pos.shape[-1])    # (1 or B, Sc)
    q_pos = q_pos.reshape(-1, 1)                           # (1 or B, 1)
    valid = (slot_pos >= 0) & (slot_pos <= q_pos)
    if window is not None:
        valid &= (q_pos - slot_pos) < window
    valid = valid[:, None, None, :]
    scores = torch.where(valid, scores, NEG_INF)
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    p = torch.where(valid, p, 0.0)
    l = p.sum(dim=-1)
    acc = torch.matmul(p, v_cache.permute(0, 2, 1, 3).to(**f32))   # (B, Hkv, G, hd)
    return acc.reshape(b, hq, hd), l.reshape(b, hq), m.reshape(b, hq)


def finalize_decode_stats(acc: torch.Tensor, l: torch.Tensor, m: torch.Tensor,
                          dtype) -> torch.Tensor:
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(dtype)


def decode_attention(q, k_cache, v_cache, slot_pos, q_pos, *, window=None,
                     logit_cap=None) -> torch.Tensor:
    """One query token a row against its cache: (B, Hq, hd) in q's dtype."""
    acc, l, m = decode_attention_stats(q, k_cache, v_cache, slot_pos, q_pos,
                                       window=window, logit_cap=logit_cap)
    return finalize_decode_stats(acc, l, m, q.dtype)


def dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def gated_mlp(x: torch.Tensor, params: dict) -> torch.Tensor:
    gate = dense(x, params["w_gate"])
    up = dense(x, params["w_up"])
    hidden = F.silu(gate.float()).to(x.dtype) * up
    return dense(hidden, params["w_down"])


def init_dense(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float | None = None) -> torch.Tensor:
    scale = scale if scale is not None else d_in ** -0.5
    return (torch.randn((d_in, d_out), generator=gen, dtype=torch.float32) * scale).to(dtype)
