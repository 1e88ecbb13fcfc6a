"""Causal GQA flash attention on tensors: forward, backward, and the
differentiable, vmappable op the model calls.

* ``flash_attention_fwd(q, k, v, window, logit_cap) -> (out, lse)``: replaces
  ``repro/kernels/flash_attention/kernel.py::flash_attention_kernel`` (TPU,
  via ``flash_attention_pallas``) with a CUDA kernel.  ``flash_attention_fwd
  .launches`` counts its launches, ``.routes`` the same by route.
* ``flash_attention_bwd(q, k, v, out, lse, dout, window, logit_cap) -> (dq,
  dk, dv)``: the gradient, which has no TPU kernel (the reference
  differentiates its plain attention through XLA).  One call launches three
  kernels (delta, dK/dV, dQ) and counts once in
  ``flash_attention_bwd.launches`` (and ``.routes``).
* ``flash_attention(q, k, v, window=None, logit_cap=None) -> out``: both as
  one op that ``torch.func.grad`` and ``torch.func.vmap`` go through.  Its
  vmap rule folds the mapped dimension into the batch, ``(C, B, S, H, hd)
  -> (C*B, S, H, hd)``, so a vmapped fleet is one launch per layer, forward
  and backward alike.

Three routes, chosen by ``route(dtype, hd, backward)`` alone, never by a
failure: ``"tensor_core"`` (``csrc/flash_attention_sm90.cu``: wgmma and
TMA, bf16 with ``hd % 8 == 0`` and hd <= 256, forward and backward; the
backward's kernels up to hd 128 hold dK and dV in each thread, its wide
ones (tiles of 160 and 256 columns) split them over two warpgroups),
``"split_tf32"`` (``csrc/flash_attention_split_tf32.cu``: every other
forward, f32 and bf16 with ``hd % 8 != 0``, on the tensor cores in split
TF32, an f32-accurate emulation) and ``"cuda_core"``
(``csrc/flash_attention.cu``: every other backward, f32 and bf16 with
``hd % 8 != 0``, f32 math on the CUDA cores).  Bound by operations at the
path's shapes: ``4 * hd`` flops per live (query, key) pair forward (``S (S
+ 1) / 2`` pairs per head causally, fewer under a window), about 2.5x that
backward, against q, k, v, out (dO, dq, dk, dv) and lse of traffic.

Layouts are the reference's: q ``(B, S, Hq, hd)``, k and v ``(B, S, Hkv,
hd)``; lse ``(B, Hq, S)`` f32.  Dispatch is by the tensor's device: CPU
tensors take the plain versions (``ref.py``), CUDA tensors launch the
kernels or raise — there is no fallback.  CUDA tensors must start on a
16-byte boundary (TMA's rule); ``flash_attention`` copies one that does not.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .._build import check, load, stream_of
from .._trace import nbytes, report, traced
from .ref import flash_attention_bwd_ref, flash_attention_fwd_ref

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd", "MAX_HEAD_DIM",
           "route", "live_pairs"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256  # widest tile the kernels are built for
ROUTES = ("tensor_core", "split_tf32", "cuda_core")


def route(dtype: torch.dtype, hd: int, backward: bool = False) -> str:
    """The kernel a CUDA call of this dtype and head width launches:
    ``"tensor_core"`` for bf16 with ``hd % 8 == 0`` (TMA's 16-byte strides)
    up to 256, forward and backward (past hd 128 the backward's dK and dV
    sit in the two consumer warpgroups, one each, as a thread has no room
    for both); else ``"split_tf32"`` forward and ``"cuda_core"`` backward."""
    if dtype == torch.bfloat16 and hd % 8 == 0 and hd <= MAX_HEAD_DIM:
        return "tensor_core"
    return "cuda_core" if backward else "split_tf32"


@functools.cache
def _bind():
    """(lib, {route: forward launcher}, {route: backward launcher})."""
    lib = load("flash_attention")
    tail = [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fwd, bwd = {}, {}
    for rname, suffix in (("split_tf32", "_split_tf32"), ("tensor_core", "_sm90")):
        fwd[rname] = getattr(lib, f"flash_attention_fwd{suffix}_launch")
        fwd[rname].argtypes = [ctypes.c_void_p] * 5 + tail
        fwd[rname].restype = ctypes.c_int
    for rname, suffix in (("cuda_core", ""), ("tensor_core", "_sm90")):
        bwd[rname] = getattr(lib, f"flash_attention_bwd{suffix}_launch")
        bwd[rname].argtypes = [ctypes.c_void_p] * 10 + tail
        bwd[rname].restype = ctypes.c_int
    return lib, fwd, bwd


def _check(q, k, v, window, logit_cap, extra=()):
    """Shape, dtype, layout and device checks shared by both wrappers."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be (B, S, H, hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    if tuple(k.shape) != (b, s, hkv, hd) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"({b}, {s}, Hkv, {hd}) for q {tuple(q.shape)}")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"Hq={hq} must be a multiple of Hkv={hkv}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} exceeds the kernels' {MAX_HEAD_DIM}")
    if window is not None and (not isinstance(window, int) or window < 1):
        raise ValueError(f"window must be None or an int >= 1, got {window!r}")
    if logit_cap is not None and not logit_cap > 0:
        raise ValueError(f"logit_cap must be None or > 0, got {logit_cap!r}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes float32/bfloat16 tensors, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)) + tuple(extra):
        want = torch.float32 if name == "lse" else q.dtype
        if t.dtype != want:
            raise TypeError(f"flash_attention takes {want} {name}, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device} but q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention needs a contiguous {name}")
        if t.device.type == "cuda" and not traced(t) and t.data_ptr() % 16:
            raise ValueError(f"flash_attention needs {name} on a 16-byte boundary (TMA)")
    if q.device.type not in ("cpu", "cuda") and not traced(q):
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, got {q.device}")


def _scale(hd: int) -> float:
    return hd ** -0.5  # the original hd, as the reference


# the peak each route's products run at (roofline.analysis.PEAK_FLOPS)
_CLASS = {"tensor_core": "bf16", "split_tf32": "split_tf32", "cuda_core": "f32"}


def live_pairs(s: int, window: Optional[int]) -> int:
    """(query, key) pairs a head attends causally over ``s`` positions,
    the last ``window`` keys of each query where one is set."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def _flops(q: torch.Tensor, window: Optional[int]) -> float:
    """The forward's counted flops: ``4 * hd`` a live pair, every head."""
    b, s, hq, hd = q.shape
    return 4.0 * hd * live_pairs(s, window) * b * hq


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        window: Optional[int] = None,
                        logit_cap: Optional[float] = None):
    """(out ``(B, S, Hq, hd)`` in q's dtype, lse ``(B, Hq, S)`` f32)."""
    _check(q, k, v, window, logit_cap)
    b, s, hq, hd = q.shape
    if traced(q):
        out = torch.empty_like(q)
        lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
        report("flash_attention_fwd", _flops(q, window), _CLASS[route(q.dtype, hd)],
               nbytes(q, k, v, out, lse))
        return out, lse
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v, window, logit_cap)
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    lib, fns, _ = _bind()
    way = route(q.dtype, hd)
    rc = fns[way](q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                  b, s, hq, k.shape[2], hd, window or 0, float(logit_cap or 0.0), _scale(hd),
                  _DTYPES[q.dtype], stream_of(q.device))
    check(lib, rc, f"flash_attention forward ({way})")
    flash_attention_fwd.launches += 1
    flash_attention_fwd.routes[way] += 1
    return out, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.routes = dict.fromkeys(ROUTES, 0)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                        window: Optional[int] = None,
                        logit_cap: Optional[float] = None):
    """(dq, dk, dv) in the dtypes and shapes of (q, k, v)."""
    _check(q, k, v, window, logit_cap, (("out", out), ("dout", dout), ("lse", lse)))
    b, s, hq, hd = q.shape
    if out.shape != q.shape or dout.shape != q.shape or tuple(lse.shape) != (b, hq, s):
        raise ValueError(f"out {tuple(out.shape)}, dout {tuple(dout.shape)} and lse "
                         f"{tuple(lse.shape)} do not match q {tuple(q.shape)}")
    if traced(q):
        grads = tuple(torch.empty_like(t) for t in (q, k, v))
        report("flash_attention_bwd", 2.5 * _flops(q, window),
               _CLASS[route(q.dtype, hd, backward=True)], nbytes(q, k, v, out, lse, dout, *grads))
        return grads
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, dout, window, logit_cap)
    way = route(q.dtype, hd, backward=True)
    grads = _bwd_launch(way, q, k, v, out, lse, dout, window, logit_cap)
    flash_attention_bwd.launches += 1
    flash_attention_bwd.routes[way] += 1
    return grads


flash_attention_bwd.launches = 0
flash_attention_bwd.routes = dict.fromkeys(ROUTES, 0)


def _bwd_launch(way, q, k, v, out, lse, dout, window, logit_cap):
    """The backward's launches on route ``way``, uncounted, for CUDA tensors
    that ``flash_attention_bwd`` checked; a comparison of two routes on the
    same inputs may also name a route that ``route()`` would not pick."""
    b, s, hq, hd = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib, _, fns = _bind()
    # f32 scratch: delta (B, Hq, S); on the tensor cores delta and lse log2(e)
    # in rows padded to the dK/dV kernel's query tile
    rows = s if way == "cuda_core" else 2 * lib.flash_attention_sm90_rows(s)
    delta = torch.empty((b, hq, rows), dtype=torch.float32, device=q.device)
    rc = fns[way](q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                  lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                  b, s, hq, k.shape[2], hd, window or 0, float(logit_cap or 0.0), _scale(hd),
                  _DTYPES[q.dtype], stream_of(q.device))
    check(lib, rc, f"flash_attention backward ({way})")
    return dq, dk, dv


# ---------------------------------------------------------------------------
# The differentiable op: autograd.Functions with explicit vmap rules
# ---------------------------------------------------------------------------

def _fold(x: torch.Tensor, dim: Optional[int], n: int) -> torch.Tensor:
    """Move the vmapped dimension to the front and merge it into the batch."""
    x = x.expand((n,) + tuple(x.shape)) if dim is None else x.movedim(dim, 0)
    return x.reshape((n * x.shape[1],) + tuple(x.shape[2:])).contiguous()


def _unfold(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x``, copied if it is a CUDA tensor off a 16-byte boundary (a view
    into the middle of a buffer), since the kernels' TMA loads need one."""
    return x.clone() if x.device.type == "cuda" and x.data_ptr() % 16 else x


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(q, k, v, window, logit_cap):
        return flash_attention_fwd(_aligned(q), _aligned(k), _aligned(v), window, logit_cap)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, window, logit_cap = inputs
        out, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window, ctx.logit_cap = window, logit_cap

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _FlashAttentionBackward.apply(q, k, v, out, lse, dout.contiguous(),
                                                   ctx.window, ctx.logit_cap)
        return dq, dk, dv, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, window, logit_cap):
        n = info.batch_size
        q, k, v = (_fold(x, d, n) for x, d in zip((q, k, v), in_dims[:3]))
        out, lse = _FlashAttention.apply(q, k, v, window, logit_cap)
        return (_unfold(out, n), _unfold(lse, n)), (0, 0)


class _FlashAttentionBackward(torch.autograd.Function):
    @staticmethod
    def forward(q, k, v, out, lse, dout, window, logit_cap):
        q, k, v, out, lse, dout = map(_aligned, (q, k, v, out, lse, dout))
        return flash_attention_bwd(q, k, v, out, lse, dout, window, logit_cap)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("flash_attention has no second derivative")

    @staticmethod
    def vmap(info, in_dims, q, k, v, out, lse, dout, window, logit_cap):
        n = info.batch_size
        q, k, v, out, lse, dout = (_fold(x, d, n) for x, d in
                                   zip((q, k, v, out, lse, dout), in_dims[:6]))
        grads = _FlashAttentionBackward.apply(q, k, v, out, lse, dout, window, logit_cap)
        return tuple(_unfold(g, n) for g in grads), (0, 0, 0)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: Optional[int] = None,
                    logit_cap: Optional[float] = None) -> torch.Tensor:
    """Causal GQA attention: q ``(B, S, Hq, hd)``, k/v ``(B, S, Hkv, hd)`` ->
    ``(B, S, Hq, hd)``; differentiable and vmappable.  Inputs are made
    contiguous here, and copied where they are off a 16-byte boundary; the
    kernel wrappers above refuse either."""
    out, _ = _FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                   window, logit_cap)
    return out
