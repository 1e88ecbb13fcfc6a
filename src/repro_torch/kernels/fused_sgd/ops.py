"""Fused SGD step ``w <- w - lr * g`` on tensors and parameter dicts.

Replaces ``repro/kernels/fused_sgd/kernel.py::_sgd_kernel`` (TPU, via
``sgd_update_pallas``) with the CUDA kernel in ``csrc/sgd_update.cu``.
Bound by bytes: ``3 * numel * itemsize`` (read w and g, write w) per call.

Dispatch is by the tensor's device: a CPU tensor takes the plain version
(``ref.py``), a CUDA tensor launches the kernel or raises — there is no
fallback.  ``sgd_update.launches`` counts kernel launches (CPU calls do
not count).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .._build import check, load, stream_of
from .ref import sgd_update_ref

__all__ = ["sgd_update", "sgd_update_tree"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _bind():
    lib = load("fused_sgd")
    fn = lib.sgd_update_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def sgd_update(w: torch.Tensor, g: torch.Tensor, lr: float,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """``w - lr * g`` computed in f32 and stored in ``w.dtype``.

    ``out`` (may be ``w`` itself) receives the result; otherwise a new
    tensor is returned.  Any shape; all tensors contiguous and alike.
    """
    if g.shape != w.shape or g.dtype != w.dtype or g.device != w.device:
        raise ValueError(f"g {tuple(g.shape)}/{g.dtype}/{g.device} does not match "
                         f"w {tuple(w.shape)}/{w.dtype}/{w.device}")
    if out is not None and (out.shape != w.shape or out.dtype != w.dtype
                            or out.device != w.device):
        raise ValueError("out must match w in shape, dtype and device")
    if w.device.type == "cpu":
        res = sgd_update_ref(w, g, lr)
        return res if out is None else out.copy_(res)
    if w.device.type != "cuda":
        raise ValueError(f"sgd_update runs on cpu or cuda tensors, got {w.device}")
    if w.dtype not in _DTYPES:
        raise TypeError(f"sgd_update kernel supports float32/bfloat16, got {w.dtype}")
    if out is None:
        out = torch.empty_like(w, memory_format=torch.contiguous_format)
    for name, t in (("w", w), ("g", g), ("out", out)):
        if not t.is_contiguous():
            raise ValueError(f"sgd_update kernel needs a contiguous {name}")
    lib, fn = _bind()
    rc = fn(w.data_ptr(), g.data_ptr(), out.data_ptr(), w.numel(), float(lr),
            _DTYPES[w.dtype], stream_of(w.device))
    check(lib, rc, "sgd_update")
    sgd_update.launches += 1
    return out


sgd_update.launches = 0


def sgd_update_tree(params: dict, grads: dict, lr: float, inplace: bool = False) -> dict:
    """``sgd_update`` on every leaf (one launch per leaf on CUDA).

    With ``inplace`` each leaf of ``params`` is overwritten and the same
    tensors are returned — safe because the update is elementwise.
    """
    return {
        k: sgd_update(w, grads[k], lr, out=w if inplace else None)
        for k, w in params.items()
    }
