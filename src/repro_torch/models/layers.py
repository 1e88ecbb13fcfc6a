"""Core neural layers: RMSNorm, RoPE, causal GQA attention, gated MLP.

The port's ``repro.models.layers`` for full-sequence training.  Attention
has two executions, chosen by ``ArchConfig.attn_impl``:

* ``"cuda"``: ``kernels.flash_attention``, the hand-written CUDA forward and
  backward kernels (their plain versions on CPU tensors), one launch per
  layer for a vmapped fleet;
* ``"plain"``: ``blocked_causal_attention``, the reference's chunked online
  softmax in PyTorch, differentiated by autograd.

Both take the reference's layout: q ``(B, S, Hq, hd)``, k/v ``(B, S, Hkv,
hd)``.  On ``DTensor`` operands (the step builders of ``launch.steps``)
attention runs per rank under ``local_map`` on local tensors, so the flash
wrappers only see plain ones: a rank whose q heads are sharded attends with
the KV heads its heads read (GQA by the heads' global index), and with
``shard_chunk`` (a head count the model axis does not divide, gemma2's) each
model rank takes its own rows of every query chunk against the whole K/V,
the reference's sequence-parallel attention, in the plain blocked form
(``_rows_attention``).  The flash kernels take equal query and key lengths,
so ``impl="cuda"`` there raises ``NotImplementedError`` (ROADMAP.md §1 item
4, 'flash rows') rather than give way to the plain form.  ``embedding`` looks a
vocab-sharded ``DTensor`` table up by rows on each rank and sums the
partial rows.  Decode attends one new token a row against a KV cache
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
    "embedding",
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


def _rows_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_pos: torch.Tensor,
                    *, window: Optional[int], logit_cap: Optional[float],
                    chunk: int) -> torch.Tensor:
    """Causal GQA attention of the query rows at ``q_pos`` (``(n, r)``: ``r``
    rows of each of the ``n`` query chunks of ``chunk`` positions) against
    the whole K/V: q ``(B, n, r, Hq, hd)`` -> ``(B, n, r, Hq, hd)``.  Each
    chunk's rows attend to the keys up to the chunk's end (from the first
    key the window reaches), exact softmax in f32."""
    b, n, r, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = hd ** -0.5
    outs = []
    for i in range(n):
        first = 0 if window is None else max(0, (i * chunk - window + 1) // chunk) * chunk
        end = (i + 1) * chunk
        kp = torch.arange(first, end, device=q.device)
        qi = q[:, i].reshape(b, r, hkv, g, hd).float()
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qi, k[:, first:end].float()) * scale
        scores = softcap(scores, logit_cap)
        mask = q_pos[i][:, None] >= kp[None, :]
        if window is not None:
            mask &= (q_pos[i][:, None] - kp[None, :]) < window
        scores = torch.where(mask, scores, NEG_INF)
        p = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhgqk,bkhd->bqhgd", p, v[:, first:end].float())
        outs.append(out.reshape(b, r, hq, hd))
    return torch.stack(outs, dim=1).to(q.dtype)


def _attention_on_mesh(q, k, v, attend, *, shard_chunk: bool, chunk: int):
    """Causal attention of DTensor q, k, v, one rank's share under
    ``local_map``.  The batch stays sharded where q's is; q's heads stay
    sharded where they are (K/V whole there, the rank reading its heads'
    KV heads); every other dimension is gathered.  With ``shard_chunk`` the
    context's model axis shards the rows of each query chunk instead, for
    ``attend.impl == "plain"`` only."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from ..sharding.context import current, mesh_axis_sizes, mesh_coord

    mesh = q.device_mesh
    names = list(mesh.mesh_dim_names)
    sizes = mesh_axis_sizes(mesh)
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    ctx = current()
    row_axis = None
    if shard_chunk and ctx is not None and ctx["model_axis"] in sizes:
        c = min(chunk, s)
        if s % c == 0 and c % sizes[ctx["model_axis"]] == 0:
            row_axis = ctx["model_axis"]
    if row_axis is not None and attend.impl == "cuda":
        raise NotImplementedError(
            f"sequence-parallel attention ({hq} heads on a model axis of "
            f"{sizes[row_axis]}) through the flash kernels, which take equal query and key "
            f"lengths, is not ported yet (ROADMAP.md §1 item 4, 'Multi-device and launch': "
            f"'flash rows'); attn_impl='plain' runs it in the reference's blocked form")
    q_pl, kv_pl, out_pl, kv_grad, head_axes = [], [], [], [], []
    for n, p in zip(names, q.placements):
        if n == row_axis:
            q_pl.append(Replicate()), kv_pl.append(Replicate())
            out_pl.append(Shard(2)), kv_grad.append(Partial())
        elif isinstance(p, Shard) and p.dim == 0:
            q_pl.append(p), kv_pl.append(p), out_pl.append(p), kv_grad.append(p)
        elif isinstance(p, Shard) and p.dim == 2 and hq % sizes[n] == 0:
            head_axes.append(n)
            q_pl.append(p), kv_pl.append(Replicate())
            out_pl.append(Shard(3) if row_axis else p), kv_grad.append(Partial())
        else:
            q_pl.append(Replicate()), kv_pl.append(Replicate())
            out_pl.append(Replicate()), kv_grad.append(Replicate())
    q_grad = [Partial() if n == row_axis else pl for n, pl in zip(names, q_pl)]
    heads = 1
    for n in head_axes:
        heads *= sizes[n]
    h0 = mesh_coord(mesh, head_axes) * (hq // heads)
    r_idx = mesh_coord(mesh, [row_axis]) if row_axis else 0

    def local(ql, kl, vl):
        hq_l = ql.shape[2]
        if hq_l != hq:
            if hq_l % g == 0:          # whole KV groups
                kl, vl = (t[:, :, h0 // g:(h0 + hq_l) // g] for t in (kl, vl))
            elif g % hq_l == 0:        # the rank's heads share one KV head
                kl, vl = (t[:, :, h0 // g:h0 // g + 1] for t in (kl, vl))
            else:                      # one KV head a query head
                kl, vl = (t.repeat_interleave(g, dim=2)[:, :, h0:h0 + hq_l] for t in (kl, vl))
        if row_axis is None:
            return attend(ql, kl, vl)
        c = min(chunk, s)
        m = sizes[row_axis]
        rl = c // m
        pos = torch.arange(s, device=ql.device).reshape(s // c, c)[:, r_idx * rl:(r_idx + 1) * rl]
        qr = ql.reshape(ql.shape[0], s // c, c, hq_l, hd)[:, :, r_idx * rl:(r_idx + 1) * rl]
        return _rows_attention(qr, kl, vl, pos, window=attend.window, logit_cap=attend.cap,
                               chunk=c)

    out = local_map(local, out_placements=list(out_pl),
                    in_placements=(tuple(q_pl), tuple(kv_pl), tuple(kv_pl)),
                    in_grad_placements=(tuple(q_grad), tuple(kv_grad), tuple(kv_grad)),
                    device_mesh=mesh, redistribute_inputs=True)(q, k, v)
    if row_axis is None:
        return out
    # the rows gathered back (all-gather over the model axis) before the
    # chunks merge into the sequence
    whole = tuple(Replicate() if n == row_axis else p for n, p in zip(names, out.placements))
    return out.redistribute(mesh, whole).reshape(b, s, hq, hd)


class _Attend:
    """The one-device attention of ``causal_attention`` with its options bound."""

    def __init__(self, impl: str, window, cap, chunk: int):
        self.impl, self.window, self.cap, self.chunk = impl, window, cap, chunk

    def __call__(self, q, k, v):
        if self.impl == "cuda":
            from ..kernels import flash_attention

            return flash_attention(q, k, v, self.window, self.cap)
        return blocked_causal_attention(q, k, v, window=self.window, logit_cap=self.cap,
                                        chunk=self.chunk)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     window: Optional[int], logit_cap: Optional[float], impl: str,
                     chunk: int = 512, shard_chunk: bool = False) -> torch.Tensor:
    """Causal GQA attention through the flash kernels (``impl="cuda"``) or the
    plain blocked path (``impl="plain"``).  On DTensors each rank computes
    its share (``_attention_on_mesh``); ``shard_chunk`` asks for the
    sequence-parallel split over the context's model axis, which
    ``impl="cuda"`` refuses (``NotImplementedError``)."""
    if impl not in ("cuda", "plain"):
        raise ValueError(f"attention impl must be 'cuda' or 'plain', got {impl!r}")
    from ..sharding.context import is_dtensor

    if is_dtensor(q):
        return _attention_on_mesh(q, k, v, _Attend(impl, window, logit_cap, chunk),
                                  shard_chunk=shard_chunk, chunk=chunk)
    return _Attend(impl, window, logit_cap, chunk)(q, k, v)


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


def embedding(tokens: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``F.embedding(tokens, weight)``.  A ``DTensor`` table sharded on its
    vocabulary dimension is looked up under ``local_map``: each rank gathers
    the rows it holds (zeros for a token outside them) and the partial rows
    are summed over the vocabulary's axes (a ``Partial`` result made
    ``Replicate``); the table's other placements pass through."""
    from ..sharding.context import is_dtensor, mesh_coord

    if not is_dtensor(weight):
        return F.embedding(tokens, weight)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = weight.device_mesh
    names = list(mesh.mesh_dim_names)
    if not is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, mesh, (Replicate(),) * mesh.ndim, run_check=False)
    vocab_axes, t_pl, out_pl, w_grad = [], [], [], []
    for n, pw, pt in zip(names, weight.placements, tokens.placements):
        if isinstance(pw, Shard) and pw.dim == 0:
            vocab_axes.append(n)
            t_pl.append(Replicate()), out_pl.append(Partial()), w_grad.append(pw)
        elif isinstance(pw, Shard):
            t_pl.append(Replicate()), out_pl.append(Shard(tokens.dim())), w_grad.append(pw)
        elif isinstance(pt, Shard):
            # the table whole, the tokens split: each rank's gradient of the
            # table is its share of the sum
            t_pl.append(pt), out_pl.append(pt), w_grad.append(Partial())
        else:
            t_pl.append(Replicate()), out_pl.append(Replicate()), w_grad.append(pw)
    v_local = weight.to_local().shape[0]
    lo = mesh_coord(mesh, vocab_axes) * v_local

    def local(t, w):
        mine = (t >= lo) & (t < lo + v_local)
        rows = F.embedding(torch.where(mine, t - lo, torch.zeros_like(t)), w)
        return rows * mine[..., None].to(rows.dtype)

    out = local_map(local, out_placements=list(out_pl),
                    in_placements=(tuple(t_pl), tuple(weight.placements)),
                    in_grad_placements=(tuple(t_pl), tuple(w_grad)),
                    device_mesh=mesh, redistribute_inputs=True)(tokens, weight)
    full = tuple(Replicate() if isinstance(p, Partial) else p for p in out.placements)
    return out.redistribute(mesh, full) if full != tuple(out.placements) else out


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
