"""Fused Lemma-1 transition ``W <- B^T (P^T)^alpha V^T W`` on tensors and dicts.

Replaces ``repro/kernels/fused_transition/kernel.py::fused_transition_kernel``
(TPU, via ``fused_transition_pallas``) with the CUDA kernel in
``csrc/fused_transition.cu``.  Bound by bytes: ``2 * C * M * itemsize``
(W read once, written once) per leaf; the (D, M) cluster intermediate
stays in registers.

Dispatch is by the tensor's device: a CPU tensor takes the plain version
(``ref.py``) leaf by leaf, a CUDA tensor launches the kernel or raises —
there is no fallback.  ``fused_transition.launches`` counts kernel launches.

``fused_transition_tree`` stands in for the reference's
``_tiling.py::_tiled_tree_apply``: it views each ``(C, ...)`` leaf as
``(C, M)`` and launches once per tree — once per group of
``plan_launches``, which is one launch for every tree of one dtype and at
most ``MAX_LEAVES`` leaves.  ``fused_transition`` is the one-leaf case.
The kernel masks the ragged edges itself, so nothing is padded.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .._build import check, load, stream_of
from .._leaves import MAX_LEAVES, plan_launches
from .ref import fused_transition_ref

__all__ = ["fused_transition", "fused_transition_tree", "plan_launches", "MAX_D", "MAX_LEAVES"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 16  # largest register array the kernel is instantiated for


@functools.cache
def _bind():
    lib = load("fused_transition")
    fn = lib.fused_transition_launch
    fn.argtypes = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int] + [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check_factors(c: int, vt: torch.Tensor, p: torch.Tensor, bt: torch.Tensor,
                   alpha) -> None:
    d = p.shape[0] if p.dim() == 2 else -1
    if vt.shape != (d, c) or bt.shape != (c, d) or p.shape != (d, d):
        raise ValueError(f"factor shapes vt {tuple(vt.shape)}, p {tuple(p.shape)}, "
                         f"bt {tuple(bt.shape)} inconsistent with C={c}, D={d}")
    if not isinstance(alpha, int) or alpha < 0:
        raise ValueError(f"alpha must be an int >= 0, got {alpha!r}")
    if p.device != vt.device or bt.device != vt.device:
        raise ValueError("the factors vt, p, bt must lie on one device")


def _transition(flats: list, outs: list, vt, p, bt, alpha: int) -> list:
    """The transition of every ``(C, M)`` tensor of ``flats`` (checked alike
    and on the factors' device) into ``outs`` (a tensor, which may alias its
    input, or None for a new one); returns the results."""
    if vt.device.type == "cpu":
        res = [fused_transition_ref(w, vt, p, bt, alpha) for w in flats]
        return [r if o is None else o.copy_(r) for r, o in zip(res, outs)]
    if vt.device.type != "cuda":
        raise ValueError(f"fused_transition runs on cpu or cuda tensors, got {vt.device}")
    d, c = vt.shape
    if d > MAX_D:
        raise ValueError(f"fused_transition kernel supports D <= {MAX_D} clusters, got {d}")
    if (2 * d * c + d * d) * 4 > 48 * 1024:
        raise ValueError(f"factors for C={c}, D={d} exceed the kernel's 48 KB of shared memory")
    for w, o in zip(flats, outs):
        if w.dtype not in _DTYPES:
            raise TypeError(f"fused_transition kernel supports float32/bfloat16, got {w.dtype}")
        if not (w.is_contiguous() and (o is None or o.is_contiguous())):
            raise ValueError("fused_transition kernel needs contiguous leaves and outputs")
    outs = [torch.empty_like(w, memory_format=torch.contiguous_format) if o is None else o
            for w, o in zip(flats, outs)]
    leaves = [(w.dtype, w.shape[1], (w.data_ptr(), o.data_ptr())) for w, o in zip(flats, outs)]
    vt, p, bt = (t.to(torch.float32).contiguous() for t in (vt, p, bt))  # once per call
    lib, fn = _bind()
    stream = stream_of(vt.device)
    for dtype, members in plan_launches(leaves):
        rows = []
        for i, vec in members:
            _, m, (w_ptr, o_ptr) = leaves[i]
            rows += (w_ptr, o_ptr, m, vec)
        rc = fn((ctypes.c_longlong * len(rows))(*rows), len(members), vt.data_ptr(),
                p.data_ptr(), bt.data_ptr(), c, d, alpha, _DTYPES[dtype], stream)
        check(lib, rc, "fused_transition")
        if any(leaves[i][1] for i, _ in members):  # the launcher skips a launch with no work
            fused_transition.launches += 1
    return outs


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
    _check_factors(w.shape[0], vt, p, bt, alpha)
    if out is not None and (out.shape != w.shape or out.dtype != w.dtype
                            or out.device != w.device):
        raise ValueError("out must match w in shape, dtype and device")
    if w.device != vt.device:
        raise ValueError("w and the factors vt, p, bt must lie on one device")
    return _transition([w], [out], vt, p, bt, alpha)[0]


fused_transition.launches = 0


def fused_transition_tree(tree: dict, vt: torch.Tensor, p: torch.Tensor,
                          bt: torch.Tensor, alpha: int = 1,
                          inplace: bool = False) -> dict:
    """Apply the fused transition to every ``(C, ...)`` leaf of a parameter dict.

    Every leaf is checked before any is touched; on CUDA the tree takes one
    launch per group of ``plan_launches``.  With ``inplace`` every leaf is
    overwritten and the same tensors are returned — safe because each
    column of a leaf belongs to one thread.
    """
    c = vt.shape[1] if vt.dim() == 2 else -1
    _check_factors(c, vt, p, bt, alpha)
    flats = []
    for k, w in tree.items():
        if w.dim() < 1 or w.shape[0] != c:
            raise ValueError(f"leaf {k!r} of shape {tuple(w.shape)} is not (C={c}, ...)")
        if w.device != vt.device:
            raise ValueError(f"leaf {k!r} on {w.device}, the factors on {vt.device}")
        if inplace and not w.is_contiguous():
            raise ValueError(f"in-place transition needs contiguous leaves; {k!r} is not")
        flats.append(w.reshape(c, w.numel() // c))  # a view of a contiguous leaf
    res = _transition(flats, flats if inplace else [None] * len(flats), vt, p, bt, alpha)
    return {k: w if inplace else r.view(w.shape) for (k, w), r in zip(tree.items(), res)}
