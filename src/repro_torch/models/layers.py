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
the reference's sequence-parallel attention: through the flash kernels as
one call of the rank's rows under their query-row map (``rows``: row ``j``
at position ``(j // rl) * chunk + r * rl + j % rl``), or in the plain
blocked form (``_rows_attention``).  ``embedding`` looks a
vocab-sharded ``DTensor`` table up by rows on each rank and sums the
partial rows.  Decode attends one new token a row against a KV cache
(``decode_attention``): plain PyTorch with f32 scores, as the reference has
no Pallas kernel there, with the (accumulator, sum, max) stats exposed
(``decode_attention_stats``) as the reference's for an LSE merge.
"""
from __future__ import annotations

import contextlib
import threading
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
    "saved_products",
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


def _head_split(q):
    """(the mesh axes that shard the heads of DTensor ``q`` (B, S, Hq, hd),
    their number of shards, this rank's first head)."""
    from torch.distributed.tensor import Shard

    from ..sharding.context import mesh_axis_sizes, mesh_coord

    mesh = q.device_mesh
    sizes = mesh_axis_sizes(mesh)
    hq = q.shape[2]
    axes = [n for n, p in zip(mesh.mesh_dim_names, q.placements)
            if isinstance(p, Shard) and p.dim == 2 and hq % sizes[n] == 0]
    heads = 1
    for n in axes:
        heads *= sizes[n]
    return axes, heads, mesh_coord(mesh, axes) * (hq // heads)


def rank_kv(x, wk, bk, wv, bv, q, hkv: int):
    """K and V of the DTensor activation ``x`` (B, S, d) with only the KV
    heads that each rank's q heads read, where ``q``'s heads shard over mesh
    axes: ``(B, S, n * L, hd)`` DTensors sharded on dim 2 over those axes, a
    rank's ``L`` KV heads its q heads' whole KV groups, or the one KV head
    that ``n // hkv`` ranks share (``whole_kv`` makes the true K and V of
    them).  Each rank computes only its columns of the two projections, as
    the reference's partitioner does; ``x``'s and the weights' gradients are
    the ranks' sums.  ``None`` where ``q``'s heads are whole on each rank,
    or where a rank's q heads read a number of KV heads that varies from
    rank to rank: K and V are then computed whole."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    axes, heads, h0 = _head_split(q)
    b, s, hq, hd = q.shape
    g, hq_l = hq // hkv, hq // heads
    if not axes or (hq_l % g and g % hq_l):
        return None
    n_l = max(1, hq_l // g)
    lo = (h0 // g) * hd
    hi = lo + n_l * hd
    mesh = q.device_mesh
    x_pl, out_pl, x_grad, w_grad = [], [], [], []
    for n, p in zip(mesh.mesh_dim_names, x.placements):
        if n in axes:
            x_pl.append(Replicate()), out_pl.append(Shard(2))
            x_grad.append(Partial()), w_grad.append(Partial())
        elif isinstance(p, Shard) and p.dim == 0:
            x_pl.append(p), out_pl.append(p), x_grad.append(p), w_grad.append(Partial())
        else:
            x_pl.append(Replicate()), out_pl.append(Replicate())
            x_grad.append(Replicate()), w_grad.append(Replicate())
    w_pl = (Replicate(),) * mesh.ndim
    b_pl, b_grad = (w_pl, tuple(w_grad)) if bk is not None else (None, None)

    def local(xl, wkl, bkl, wvl, bvl):
        def proj(w, bias):
            y = dense(xl, w[:, lo:hi], None if bias is None else bias[lo:hi])
            return y.reshape(xl.shape[0], s, n_l, hd)

        return proj(wkl, bkl), proj(wvl, bvl)

    return local_map(local, out_placements=(tuple(out_pl), tuple(out_pl)),
                     in_placements=(tuple(x_pl), w_pl, b_pl, w_pl, b_pl),
                     in_grad_placements=(tuple(x_grad), tuple(w_grad), b_grad, tuple(w_grad),
                                         b_grad),
                     device_mesh=mesh, redistribute_inputs=True)(x, wk, bk, wv, bv)


def whole_kv(t, hkv: int):
    """The true K (or V) ``(B, S, hkv, hd)`` of ``rank_kv``'s per-rank form:
    gathered over the axes that shard its heads, one of each group of
    ranks that share a KV head kept.  Anything else passes through."""
    from ..sharding.context import is_dtensor

    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard

    whole = tuple(Replicate() if isinstance(p, Shard) and p.dim == 2 else p
                  for p in t.placements)
    if whole != tuple(t.placements):
        t = t.redistribute(t.device_mesh, whole)
    return t if t.shape[2] == hkv else t[:, :, ::t.shape[2] // hkv]


def _attention_on_mesh(q, k, v, attend, *, shard_chunk: bool, chunk: int):
    """Causal attention of DTensor q, k, v, one rank's share under
    ``local_map``.  The batch stays sharded where q's is; q's heads stay
    sharded where they are (K/V either the rank's KV heads already,
    ``rank_kv``, or whole there, the rank reading its heads' KV heads);
    every other dimension is gathered.  With ``shard_chunk`` the context's
    model axis shards the rows of each query chunk instead: through the
    flash kernels one call of the rank's rows under the query-row map
    (``attend.impl == "cuda"``), or the plain blocked form
    (``_rows_attention``)."""
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
    head_axes, _, h0 = _head_split(q)
    # K and V already the rank's KV heads (rank_kv), or whole
    kv_local = bool(head_axes) and all(
        k.placements[names.index(n)] == Shard(2) for n in head_axes)
    q_pl, kv_pl, out_pl, kv_grad = [], [], [], []
    for n, p in zip(names, q.placements):
        if n == row_axis:
            q_pl.append(Replicate()), kv_pl.append(Replicate())
            out_pl.append(Shard(2)), kv_grad.append(Partial())
        elif isinstance(p, Shard) and p.dim == 0:
            q_pl.append(p), kv_pl.append(p), out_pl.append(p), kv_grad.append(p)
        elif n in head_axes:
            q_pl.append(p), out_pl.append(Shard(3) if row_axis else p)
            kv_pl.append(p if kv_local else Replicate())
            kv_grad.append(p if kv_local else Partial())
        else:
            q_pl.append(Replicate()), kv_pl.append(Replicate())
            out_pl.append(Replicate()), kv_grad.append(Replicate())
    q_grad = [Partial() if n == row_axis else pl for n, pl in zip(names, q_pl)]
    r_idx = mesh_coord(mesh, [row_axis]) if row_axis else 0

    def local(ql, kl, vl):
        hq_l = ql.shape[2]
        if hq_l != hq and not kv_local:
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
        bl = ql.shape[0]
        qr = ql.reshape(bl, s // c, c, hq_l, hd)[:, :, r_idx * rl:(r_idx + 1) * rl]
        if attend.impl == "cuda":
            # the rank's rows of every chunk as one call: row j of it sits at
            # position (j // rl) * c + r_idx * rl + j % rl
            from ..kernels import flash_attention

            out = flash_attention(qr.reshape(bl, s // c * rl, hq_l, hd), kl, vl, attend.window,
                                  attend.cap, rows=(rl, c, r_idx * rl))
            return out.reshape(bl, s // c, rl, hq_l, hd)
        pos = torch.arange(s, device=ql.device).reshape(s // c, c)[:, r_idx * rl:(r_idx + 1) * rl]
        return _rows_attention(qr, kl, vl, pos, window=attend.window, logit_cap=attend.cap,
                               chunk=c)

    out = local_map(local, out_placements=list(out_pl),
                    in_placements=(tuple(q_pl), tuple(kv_pl), tuple(kv_pl)),
                    in_grad_placements=(tuple(q_grad), tuple(kv_grad), tuple(kv_grad)),
                    device_mesh=mesh, redistribute_inputs=True)(q, k, v)
    if row_axis is None:
        return out
    # the rows gathered back (all-gather over the model axis), then the
    # chunks merged into the sequence on each rank's local tensor: a view of
    # the DTensor would unflatten the sequence, which the gradient may come
    # back sharded on unevenly (under remat's recomputation)
    whole = tuple(Replicate() if n == row_axis else p for n, p in zip(names, out.placements))
    merged = tuple(Shard(2) if isinstance(p, Shard) and p.dim == 3 else p for p in whole)
    return local_map(lambda t: t.reshape(t.shape[0], s, t.shape[3], hd),
                     out_placements=list(merged), in_placements=(whole,), device_mesh=mesh,
                     redistribute_inputs=True)(out)


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
    sequence-parallel split over the context's model axis."""
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
    """``x @ w (+ b)``, ``w`` cast to ``x``'s dtype.  Every product of the
    model without batch dimensions of its own goes through here: the
    projections, the MoE router and mamba's projections, which remat's
    ``"dots"`` policy keeps (``saved_products``)."""
    w = w.to(x.dtype)
    tape = getattr(_TAPE, "tape", None)
    y = x @ w if tape is None else tape.product(x, w)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


# -- remat's "dots" policy: the products a block keeps ---------------------------

_TAPE = threading.local()


class _Tape:
    """The products of one block's run, in call order: recorded by the
    forward, handed back one by one by the recomputation."""

    def __init__(self, saved: Optional[list]):
        self.replay = saved is not None
        self.saved = list(saved) if self.replay else []
        self.next = 0

    def product(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if not self.replay:
            y = x @ w
            self.saved.append(y)
            return y
        i, self.next = self.next, self.next + 1
        return _Product.apply(x, w, self.saved[i] if i < len(self.saved) else None)


@contextlib.contextmanager
def saved_products(saved: Optional[list] = None):
    """Inside, ``dense`` records its products on the yielded tape
    (``saved=None``, the block's forward) or returns ``saved``'s in turn
    without multiplying (the block's recomputation).  A product past the
    end of ``saved`` is one whose value the backward never reads: zeros
    stand for it, and its gradients are still those of the product."""
    prev = getattr(_TAPE, "tape", None)
    _TAPE.tape = tape = _Tape(saved)
    try:
        yield tape
    finally:
        _TAPE.tape = prev


def _mm_grads(x2: torch.Tensor, w: torch.Tensor, g: torch.Tensor, need: tuple):
    """The gradients of ``x2 @ w`` (both 2-d) for the output gradient ``g``,
    by the formulas autograd's ``mm`` takes (a column-major operand gets its
    gradient column-major), so that they equal the unsaved product's bit for
    bit."""
    dx = dw = None
    if need[0]:
        col = x2.stride(0) == 1 and x2.stride(1) == x2.shape[0]
        dx = w.mm(g.t()).t() if col else g.mm(w.t())
    if need[1]:
        col = w.stride(0) == 1 and w.stride(1) == w.shape[0]
        dw = g.t().mm(x2).t() if col else x2.t().mm(g)
    return dx, dw


class _Product(torch.autograd.Function):
    """``x @ w`` whose value was kept by the forward (``y``; ``None`` for
    zeros): no product is taken again, and the backward gives ``dy @ w^T``
    and ``x^T dy`` as ``x @ w``'s would: ``x`` folded to 2-d as ``matmul``
    folds it.  The products it stands for are taken outside any ``vmap``
    inside the gradient's transform (the MoE router's logits too), so its
    generated vmap rule batches these formulas as the product's own."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, w, y):
        if y is None:
            return torch.zeros_like(x[..., :1]).expand(*x.shape[:-1], w.shape[-1])
        return y.view_as(y)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, _ = inputs
        ctx.save_for_backward(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        x2 = x.reshape(-1, x.shape[-1])
        dx, dw = _mm_grads(x2, w, dy.reshape(-1, dy.shape[-1]), ctx.needs_input_grad[:2])
        return (None if dx is None else dx.reshape(x.shape)), dw, None


def gated_mlp(x: torch.Tensor, params: dict) -> torch.Tensor:
    gate = dense(x, params["w_gate"])
    up = dense(x, params["w_up"])
    hidden = F.silu(gate.float()).to(x.dtype) * up
    return dense(hidden, params["w_down"])


def init_dense(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float | None = None) -> torch.Tensor:
    scale = scale if scale is not None else d_in ** -0.5
    return (torch.randn((d_in, d_out), generator=gen, dtype=torch.float32) * scale).to(dtype)
