"""Mamba2 (SSD, state-space duality, arXiv:2405.21060) mixer for training.

The port's ``repro.models.mamba`` over full sequences: the chunked SSD
algorithm, a quadratic attention-like term *within* chunks of length Q and
a linear recurrence *across* chunks (the reference's ``lax.scan``, here a
Python loop over the chunks), O(S * Q) work.  One B/C group (G = 1); heads
H = d_inner / head_dim.  As in the reference, the z, x, B, C and dt streams
have separate projections, and each of x, B and C its own depthwise causal
conv, which is conv-then-split computed per stream.

The reference computes the mixer in plain ``jnp`` with no Pallas kernel;
here the SSD products are ``torch.einsum`` and the projections
``layers.dense`` (which remat's ``"dots"`` policy keeps).  Decode keeps an O(1)-size
state a layer (``init_mamba_cache``, ``mamba_decode_step``): the SSM state
and a (conv_width - 1)-deep tail of each conv's inputs,

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * (B_t (x) x_t),   y_t = C_t . h_t + D x_t.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .config import ArchConfig
from .layers import dense, rms_norm

__all__ = ["init_mamba_params", "mamba_forward", "ssd_chunked", "init_mamba_cache",
           "mamba_decode_step"]

NEG_INF = -1e30


def init_mamba_params(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """One mixer's leaves, names relative to ``mamba``; ``A_log``, ``D`` and
    ``dt_bias`` are f32 in every dtype."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    dt = cfg.param_dtype
    s = d ** -0.5

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, dtype=torch.float32) * scale).to(dt)

    return {
        "w_z": normal((d, di), s),
        "w_x": normal((d, di), s),
        "w_b": normal((d, n), s),
        "w_c": normal((d, n), s),
        "w_dt": normal((d, h), s),
        "conv_x": normal((cfg.ssm_conv, di), 0.2),
        "conv_b": normal((cfg.ssm_conv, n), 0.2),
        "conv_c": normal((cfg.ssm_conv, n), 0.2),
        "bias_x": torch.zeros(di, dtype=dt),
        "bias_b": torch.zeros(n, dtype=dt),
        "bias_c": torch.zeros(n, dtype=dt),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32)),
        "D": torch.ones(h, dtype=torch.float32),
        "dt_bias": torch.zeros(h, dtype=torch.float32),
        "norm_scale": torch.ones(di, dtype=dt),
        "out_proj": normal((di, d), di ** -0.5),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor] = None):
    """Depthwise causal conv of width W: y_t = sum_w w[w] * x_{t-W+1+w} + b.

    x: (B, S, ch); tail: (B, W-1, ch) previous inputs (zeros when None).
    Returns (silu(y), new_tail), the tail the last W-1 inputs."""
    width = w.shape[0]
    bsz, s, ch = x.shape
    if tail is None:
        tail = torch.zeros((bsz, width - 1, ch), dtype=x.dtype, device=x.device)
    ext = torch.cat([tail, x], dim=1)  # (B, S+W-1, ch)
    y = ext[:, 0:s, :] * w[0].to(x.dtype)
    for i in range(1, width):
        y = y + ext[:, i:i + s, :] * w[i].to(x.dtype)
    y = y + b.to(x.dtype)
    new_tail = ext[:, s:, :] if s >= width - 1 else ext[:, -(width - 1):, :]
    return F.silu(y.float()).to(x.dtype), new_tail


def ssd_chunked(x, b_mat, c_mat, a_log_inc, dt_scale, h0, chunk: int):
    """Chunked SSD core.

    x: (B, S, H, P) inputs; b_mat/c_mat: (B, S, N); a_log_inc: (B, S, H)
    negative decay log-increments (dt * A); dt_scale: (B, S, H) input gains
    (dt); h0: (B, H, N, P); chunk: Q.  Returns (y (B, S, H, P) f32, h_final
    (B, H, N, P))."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"seq {s} not divisible by chunk {q}")
    nc = s // q

    xf = x.float().reshape(bsz, nc, q, h, p)
    bf = b_mat.float().reshape(bsz, nc, q, n)
    cf = c_mat.float().reshape(bsz, nc, q, n)
    af = a_log_inc.float().reshape(bsz, nc, q, h)
    dtf = dt_scale.float().reshape(bsz, nc, q, h)

    seg = torch.cumsum(af, dim=2)                           # (B,nc,Q,H) cumulative decay
    total = seg[:, :, -1, :]                                # (B,nc,H)

    # intra-chunk: Y[i] += sum_{j<=i} C_i.B_j * exp(seg_i - seg_j) * dt_j * x_j
    scores = torch.einsum("bcin,bcjn->bcij", cf, bf)        # (B,nc,Q,Q)
    decay = seg[:, :, :, None, :] - seg[:, :, None, :, :]   # (B,nc,Qi,Qj,H)
    causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    # mask BEFORE exp: the masked (i < j) entries have decay > 0 and would
    # overflow to inf, and the backward through the mask would give inf * 0
    lmat = torch.exp(torch.where(causal[None, None, :, :, None], decay,
                                 torch.full((), NEG_INF, device=x.device)))
    m = scores[..., None] * lmat * dtf[:, :, None, :, :]    # (B,nc,Qi,Qj,H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", m, xf)

    # each chunk's contribution to the state at its end:
    #   S_c = sum_j exp(total - seg_j) * dt_j * B_j (x) x_j
    w = torch.exp(total[:, :, None, :] - seg) * dtf         # (B,nc,Q,H)
    xw = xf * w[..., None]                                  # (B,nc,Q,H,P)
    s_c = torch.einsum("bcqn,bcqhp->bchnp", bf, xw)         # (B,nc,H,N,P)

    y_off, h_final = _ssd_recurrence(s_c, total, cf, seg, h0)
    y = y_intra + y_off                                     # (B,nc,Q,H,P)
    return y.reshape(bsz, s, h, p), h_final


def _ssd_recurrence(s_c, total, cf, seg, h0):
    """The inter-chunk recurrence (the reference's ``lax.scan``) and the
    off-diagonal output term: s_c (B,nc,H,N,P), total (B,nc,H), cf
    (B,nc,Q,N), seg (B,nc,Q,H), h0 (B,H,N,P) -> (y_off (B,nc,Q,H,P),
    h_final)."""
    hprev = h0.float()
    y_offs = []
    for c in range(s_c.shape[1]):
        # y_off[i] = C_i . (exp(seg_i) * h_prev)
        y_offs.append(torch.einsum("bqn,bhnp->bqhp", cf[:, c], hprev)
                      * torch.exp(seg[:, c])[..., None])
        hprev = torch.exp(total[:, c])[:, :, None, None] * hprev + s_c[:, c]
    return torch.stack(y_offs, dim=1), hprev


def _project(params: dict, x: torch.Tensor):
    """x: (B, S, d) -> (z, xr, b, c, dt_raw), the pre-conv streams."""
    return (dense(x, params["w_z"]), dense(x, params["w_x"]), dense(x, params["w_b"]),
            dense(x, params["w_c"]), dense(x, params["w_dt"]))


def mamba_forward(params: dict, x: torch.Tensor, cfg: ArchConfig, h0=None, conv_tail=None):
    """Full-sequence mamba2 mixer. x: (B, S, d) -> (y (B, S, d), (h_final,
    conv tails {"x", "b", "c"}))."""
    bsz, s, _ = x.shape
    di, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xr, b_raw, c_raw, dt_raw = _project(params, x)
    tails = conv_tail or {"x": None, "b": None, "c": None}
    xr, tail_x = _causal_conv(xr, params["conv_x"], params["bias_x"], tails["x"])
    b_mat, tail_b = _causal_conv(b_raw, params["conv_b"], params["bias_b"], tails["b"])
    c_mat, tail_c = _causal_conv(c_raw, params["conv_c"], params["bias_c"], tails["c"])
    xi = xr.reshape(bsz, s, h, p)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])                 # (B,S,H)
    a = -torch.exp(params["A_log"])                                     # (H,)
    a_inc = dt * a[None, None, :]
    if h0 is None:
        h0 = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    y, h_final = ssd_chunked(xi, b_mat, c_mat, a_inc, dt, h0, cfg.ssm_chunk)
    y = y + params["D"][None, None, :, None] * xi.float()
    y = y.reshape(bsz, s, di)
    gated = y * F.silu(z.float())
    out = rms_norm(gated.to(x.dtype), params["norm_scale"], cfg.norm_eps)
    out = dense(out, params["out_proj"])
    return out, (h_final, {"x": tail_x, "b": tail_b, "c": tail_c})


def init_mamba_cache(cfg: ArchConfig, batch: int, dtype, device=None) -> dict:
    """An empty decode cache: ``ssm`` (B, H, N, P) f32 and the conv tails
    ``conv_x`` (B, W-1, d_inner), ``conv_b``/``conv_c`` (B, W-1, N) in ``dtype``."""
    di, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    w = cfg.ssm_conv - 1
    return {
        "ssm": torch.zeros((batch, h, n, p), dtype=torch.float32, device=device),
        "conv_x": torch.zeros((batch, w, di), dtype=dtype, device=device),
        "conv_b": torch.zeros((batch, w, n), dtype=dtype, device=device),
        "conv_c": torch.zeros((batch, w, n), dtype=dtype, device=device),
    }


def mamba_decode_step(params: dict, x: torch.Tensor, cfg: ArchConfig, cache: dict):
    """One-token decode. x: (B, 1, d) -> (y (B, 1, d), new cache); ``cache``
    is read, not written."""
    bsz = x.shape[0]
    di, h, p = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    z, xr, b_raw, c_raw, dt_raw = _project(params, x)
    xr, tail_x = _causal_conv(xr, params["conv_x"], params["bias_x"], cache["conv_x"])
    b_mat, tail_b = _causal_conv(b_raw, params["conv_b"], params["bias_b"], cache["conv_b"])
    c_mat, tail_c = _causal_conv(c_raw, params["conv_c"], params["bias_c"], cache["conv_c"])
    xi = xr[:, 0].reshape(bsz, h, p).float()
    b_vec = b_mat[:, 0].float()
    c_vec = c_mat[:, 0].float()
    dt = F.softplus(dt_raw[:, 0].float() + params["dt_bias"])          # (B,H)
    a = -torch.exp(params["A_log"])
    decay = torch.exp(dt * a[None, :])                                 # (B,H)
    h_new = decay[:, :, None, None] * cache["ssm"] + torch.einsum(
        "bn,bhp->bhnp", b_vec, xi * dt[..., None])
    y = torch.einsum("bn,bhnp->bhp", c_vec, h_new) + params["D"][None, :, None] * xi
    y = y.reshape(bsz, 1, di)
    gated = y * F.silu(z.float())
    out = rms_norm(gated.to(x.dtype), params["norm_scale"], cfg.norm_eps)
    out = dense(out, params["out_proj"])
    return out, {"ssm": h_new, "conv_x": tail_x, "conv_b": tail_b, "conv_c": tail_c}
