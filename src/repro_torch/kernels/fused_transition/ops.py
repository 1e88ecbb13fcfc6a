"""Fused Lemma-1 transition ``W <- B^T (P^T)^alpha V^T W`` on tensors and dicts.

Replaces ``repro/kernels/fused_transition/kernel.py::fused_transition_kernel``
(TPU, via ``fused_transition_pallas``) with the CUDA kernel in
``csrc/fused_transition.cu``.  Bound by bytes: ``2 * C * M * itemsize``
(W read once, written once) per leaf; the (D, M) cluster intermediate
stays in registers.

Dispatch is by the tensor's device: a CPU tensor takes the plain version
(``ref.py``), a CUDA tensor launches the kernel or raises — there is no
fallback.  ``fused_transition.launches`` counts kernel launches.

``fused_transition_tree`` stands in for the reference's
``_tiling.py::_tiled_tree_apply``: it views each ``(C, ...)`` leaf as
``(C, M)`` and launches once per leaf.  The kernel masks the ragged edge
itself, so nothing is padded.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .._build import check, load, stream_of
from .ref import fused_transition_ref

__all__ = ["fused_transition", "fused_transition_tree", "MAX_D"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 16  # largest register array the kernel is instantiated for


@functools.cache
def _bind():
    lib = load("fused_transition")
    fn = lib.fused_transition_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def fused_transition(w: torch.Tensor, vt: torch.Tensor, p: torch.Tensor,
                     bt: torch.Tensor, alpha: int = 1,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """``w (C, M)``; ``vt (D, C)`` = V^T; ``p (D, D)``; ``bt (C, D)`` = B^T.

    ``alpha`` gossip rounds (0 gives the intra event ``W @ V B``).  ``out``
    (may be ``w`` itself) receives the result; otherwise a new tensor is
    returned.
    """
    if w.dim() != 2:
        raise ValueError(f"w must be (C, M), got shape {tuple(w.shape)}")
    c = w.shape[0]
    d = p.shape[0]
    if vt.shape != (d, c) or bt.shape != (c, d) or p.shape != (d, d):
        raise ValueError(f"factor shapes vt {tuple(vt.shape)}, p {tuple(p.shape)}, "
                         f"bt {tuple(bt.shape)} inconsistent with C={c}, D={d}")
    if not isinstance(alpha, int) or alpha < 0:
        raise ValueError(f"alpha must be an int >= 0, got {alpha!r}")
    if out is not None and (out.shape != w.shape or out.dtype != w.dtype
                            or out.device != w.device):
        raise ValueError("out must match w in shape, dtype and device")
    if any(t.device != w.device for t in (vt, p, bt)):
        raise ValueError("w and the factors vt, p, bt must lie on one device")
    if w.device.type == "cpu":
        res = fused_transition_ref(w, vt, p, bt, alpha)
        return res if out is None else out.copy_(res)
    if w.device.type != "cuda":
        raise ValueError(f"fused_transition runs on cpu or cuda tensors, got {w.device}")
    if w.dtype not in _DTYPES:
        raise TypeError(f"fused_transition kernel supports float32/bfloat16, got {w.dtype}")
    if d > MAX_D:
        raise ValueError(f"fused_transition kernel supports D <= {MAX_D} clusters, got {d}")
    if (2 * d * c + d * d) * 4 > 48 * 1024:
        raise ValueError(f"factors for C={c}, D={d} exceed the kernel's 48 KB of shared memory")
    if out is None:
        out = torch.empty_like(w, memory_format=torch.contiguous_format)
    for name, t in (("w", w), ("out", out)):
        if not t.is_contiguous():
            raise ValueError(f"fused_transition kernel needs a contiguous {name}")
    vt, p, bt = (t.to(torch.float32).contiguous() for t in (vt, p, bt))
    lib, fn = _bind()
    rc = fn(w.data_ptr(), out.data_ptr(), vt.data_ptr(), p.data_ptr(), bt.data_ptr(),
            c, d, w.shape[1], alpha, _DTYPES[w.dtype], stream_of(w.device))
    check(lib, rc, "fused_transition")
    fused_transition.launches += 1
    return out


fused_transition.launches = 0


def fused_transition_tree(tree: dict, vt: torch.Tensor, p: torch.Tensor,
                          bt: torch.Tensor, alpha: int = 1,
                          inplace: bool = False) -> dict:
    """Apply the fused transition to every ``(C, ...)`` leaf of a parameter dict.

    With ``inplace`` every leaf is overwritten and the same tensors are
    returned — safe because each column of a leaf belongs to one thread.
    """
    c = vt.shape[1]
    out = {}
    for k, w in tree.items():
        if inplace and not w.is_contiguous():
            raise ValueError(f"in-place transition needs contiguous leaves; {k!r} is not")
        flat = w.reshape(c, -1)  # a view of a contiguous leaf
        res = fused_transition(flat, vt, p, bt, alpha=alpha, out=flat if inplace else None)
        out[k] = w if inplace else res.view(w.shape)
    return out
