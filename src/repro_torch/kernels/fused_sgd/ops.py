"""Fused SGD step and eq-19 normalized update on tensors and parameter dicts.

* ``sgd_update``: ``w <- w - lr * g``; replaces
  ``repro/kernels/fused_sgd/kernel.py::_sgd_kernel`` (TPU, via
  ``sgd_update_pallas``) with the CUDA kernel in ``csrc/sgd_update.cu``.
  Bound by bytes: ``3 * numel * itemsize`` (read w and g, write w).
  ``sgd_update_tree`` launches once per tree (once per group of
  ``plan_launches``: one launch for every tree of one dtype and at most
  ``MAX_LEAVES`` leaves); ``sgd_update`` is the one-leaf case.
* ``normalized_update``: ``(w_final - w_start) * inv_theta``, one factor
  per row; replaces ``_norm_update_kernel`` (via
  ``normalized_update_pallas``) with ``csrc/normalized_update.cu``.  Bound
  by bytes: ``3 * R * M * itemsize``.

Both sources build into one library.  Dispatch is by the tensor's device: a
CPU tensor takes the plain version (``ref.py``), a CUDA tensor launches the
kernel or raises — there is no fallback.  ``sgd_update.launches`` and
``normalized_update.launches`` count kernel launches (CPU calls do not
count).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .._build import check, load, stream_of
from .._leaves import MAX_LEAVES, plan_launches
from .ref import normalized_update_ref, sgd_update_ref

__all__ = ["sgd_update", "sgd_update_tree", "normalized_update", "plan_launches", "MAX_LEAVES"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _bind():
    lib = load("fused_sgd")
    fn = lib.sgd_update_launch
    fn.argtypes = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_float, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    norm = lib.normalized_update_launch
    norm.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_float, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                     ctypes.c_void_p]
    norm.restype = ctypes.c_int
    return lib, fn, norm


def _check_leaf(w: torch.Tensor, g: torch.Tensor, out: torch.Tensor | None, what: str) -> None:
    if g.shape != w.shape or g.dtype != w.dtype or g.device != w.device:
        raise ValueError(f"{what}: g {tuple(g.shape)}/{g.dtype}/{g.device} does not match "
                         f"w {tuple(w.shape)}/{w.dtype}/{w.device}")
    if out is not None and (out.shape != w.shape or out.dtype != w.dtype
                            or out.device != w.device):
        raise ValueError(f"{what}: out must match w in shape, dtype and device")


def _sgd(ws: list, gs: list, outs: list, lr: float) -> list:
    """``w - lr * g`` for every (checked) leaf, all on one device, into
    ``outs`` (a tensor, which may alias ``w``, or None for a new one)."""
    device = ws[0].device
    if device.type == "cpu":
        res = [sgd_update_ref(w, g, lr) for w, g in zip(ws, gs)]
        return [r if o is None else o.copy_(r) for r, o in zip(res, outs)]
    if device.type != "cuda":
        raise ValueError(f"sgd_update runs on cpu or cuda tensors, got {device}")
    for w, g, o in zip(ws, gs, outs):
        if w.dtype not in _DTYPES:
            raise TypeError(f"sgd_update kernel supports float32/bfloat16, got {w.dtype}")
        if not (w.is_contiguous() and g.is_contiguous() and (o is None or o.is_contiguous())):
            raise ValueError("sgd_update kernel needs a contiguous w, g and out")
    outs = [torch.empty_like(w, memory_format=torch.contiguous_format) if o is None else o
            for w, o in zip(ws, outs)]
    leaves = [(w.dtype, w.numel(), (w.data_ptr(), g.data_ptr(), o.data_ptr()))
              for w, g, o in zip(ws, gs, outs)]
    lib, fn, _ = _bind()
    stream = stream_of(device)
    for dtype, members in plan_launches(leaves):
        rows = []
        for i, vec in members:
            _, n, ptrs = leaves[i]
            rows += (*ptrs, n, vec)
        rc = fn((ctypes.c_longlong * len(rows))(*rows), len(members), float(lr),
                _DTYPES[dtype], stream)
        check(lib, rc, "sgd_update")
        if any(leaves[i][1] for i, _ in members):  # the launcher skips a launch with no work
            sgd_update.launches += 1
    return outs


def sgd_update(w: torch.Tensor, g: torch.Tensor, lr: float,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """``w - lr * g`` computed in f32 and stored in ``w.dtype``.

    ``out`` (may be ``w`` itself) receives the result; otherwise a new
    tensor is returned.  Any shape; all tensors contiguous and alike.
    """
    _check_leaf(w, g, out, "sgd_update")
    return _sgd([w], [g], [out], lr)[0]


sgd_update.launches = 0


def normalized_update(w_final: torch.Tensor, w_start: torch.Tensor, inv_theta,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """``(w_final - w_start) * inv_theta`` computed in f32, stored in ``w_final.dtype``.

    ``inv_theta`` is either an ``(R,)`` f32 tensor, one factor per row of
    ``(R, ...)`` operands (the fired cluster's ``1 / theta_i``), or a float
    for every element (the reference's flat signature, the ``R = 1`` case).
    ``out`` (may alias an input) receives the result; otherwise a new tensor
    is returned.  All tensors contiguous and alike.
    """
    if w_start.shape != w_final.shape or w_start.dtype != w_final.dtype \
            or w_start.device != w_final.device:
        raise ValueError(f"w_start {tuple(w_start.shape)}/{w_start.dtype}/{w_start.device} "
                         f"does not match w_final {tuple(w_final.shape)}/{w_final.dtype}/"
                         f"{w_final.device}")
    if out is not None and (out.shape != w_final.shape or out.dtype != w_final.dtype
                            or out.device != w_final.device):
        raise ValueError("out must match w_final in shape, dtype and device")
    per_row = isinstance(inv_theta, torch.Tensor)
    if per_row:
        if inv_theta.dim() != 1 or w_final.dim() < 1 or inv_theta.shape[0] != w_final.shape[0]:
            raise ValueError(f"inv_theta {tuple(inv_theta.shape)} must hold one factor per "
                             f"row of w_final {tuple(w_final.shape)}")
        if inv_theta.device != w_final.device:
            raise ValueError("w_final and inv_theta must lie on one device")
    if w_final.device.type == "cpu":
        res = normalized_update_ref(w_final, w_start, inv_theta)
        return res if out is None else out.copy_(res)
    if w_final.device.type != "cuda":
        raise ValueError(f"normalized_update runs on cpu or cuda tensors, got {w_final.device}")
    if w_final.dtype not in _DTYPES:
        raise TypeError(f"normalized_update kernel supports float32/bfloat16, "
                        f"got {w_final.dtype}")
    if per_row and inv_theta.dtype != torch.float32:
        raise TypeError(f"normalized_update kernel takes float32 inv_theta, got {inv_theta.dtype}")
    if out is None:
        out = torch.empty_like(w_final, memory_format=torch.contiguous_format)
    checked = [("w_final", w_final), ("w_start", w_start), ("out", out)]
    if per_row:
        checked.append(("inv_theta", inv_theta))
    for name, t in checked:
        if not t.is_contiguous():
            raise ValueError(f"normalized_update kernel needs a contiguous {name}")
    rows = inv_theta.shape[0] if per_row else 1
    lib, _, fn = _bind()
    rc = fn(w_final.data_ptr(), w_start.data_ptr(), out.data_ptr(),
            inv_theta.data_ptr() if per_row else None, 0.0 if per_row else float(inv_theta),
            rows, w_final.numel() // rows, _DTYPES[w_final.dtype], stream_of(w_final.device))
    check(lib, rc, "normalized_update")
    normalized_update.launches += 1
    return out


normalized_update.launches = 0


def sgd_update_tree(params: dict, grads: dict, lr: float, inplace: bool = False) -> dict:
    """``sgd_update`` on every leaf: one launch per group of ``plan_launches``
    on CUDA.

    ``grads`` must hold the keys of ``params`` with leaves of the same shape,
    dtype and device; every leaf is checked before any is touched.  With
    ``inplace`` each leaf of ``params`` is overwritten and the same tensors
    are returned — safe because the update is elementwise.
    """
    if params.keys() != grads.keys():
        raise ValueError(f"params and grads hold different keys: "
                         f"{sorted(params.keys() ^ grads.keys())}")
    if not params:
        return {}
    ws, gs = list(params.values()), [grads[k] for k in params]
    device = ws[0].device
    for k, w, g in zip(params, ws, gs):
        _check_leaf(w, g, None, f"sgd_update_tree leaf {k!r}")
        if w.device != device:
            raise ValueError(f"leaf {k!r} on {w.device}, the first leaf on {device}")
    res = _sgd(ws, gs, ws if inplace else [None] * len(ws), lr)
    return dict(zip(params, res))
