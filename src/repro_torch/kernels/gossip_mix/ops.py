"""Inter-cluster gossip mixing ``Y <- Y @ P^alpha`` on tensors and dicts.

Replaces ``repro/kernels/gossip_mix/kernel.py::gossip_mix_kernel`` (TPU, via
``gossip_mix_pallas``) with the CUDA kernel in ``csrc/gossip_mix.cu``.  Bound
by bytes: ``2 * D * M * itemsize`` (Y read once, written once) per leaf.

``gossip_mix_tree`` views each ``(D, ...)`` leaf as ``(D, M)`` and launches
once per tree — once per group of ``plan_launches``, which is one launch for
every tree of one dtype and at most ``MAX_LEAVES`` leaves.  ``gossip_mix`` is
the one-leaf case.

Dispatch is by the tensor's device: a CPU tensor takes the plain version
(``ref.py``), a CUDA tensor launches the kernel or raises — there is no
fallback.  ``gossip_mix.launches`` counts kernel launches.

``P`` is read from device memory: the kernel takes a pointer to the
row-major ``(D, D)`` f32 matrix beside its leaf table, so a CUDA graph that
captures the launch reads whatever the buffer holds at each replay (the async
scheduler writes each event's ``P_t`` there).  ``p`` must lie on the leaves'
device: a host ``p`` with CUDA leaves is refused, not copied.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .._build import check, load, stream_of
from .._leaves import MAX_LEAVES, leaf_outputs, plan_launches
from .._trace import nbytes, report, traced
from .ref import gossip_mix_ref

__all__ = ["gossip_mix", "gossip_mix_tree", "plan_launches", "MAX_D", "MAX_LEAVES"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 16  # largest register array (and shared-memory P) the kernel is built for


@functools.cache
def _bind():
    lib = load("gossip_mix")
    fn = lib.gossip_mix_launch
    fn.argtypes = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check_mixing(d: int, p: torch.Tensor, alpha) -> None:
    if d < 1 or tuple(p.shape) != (d, d):
        raise ValueError(f"p {tuple(p.shape)} inconsistent with D={d} (D >= 1)")
    if not isinstance(alpha, int) or alpha < 0:
        raise ValueError(f"alpha must be an int >= 0, got {alpha!r}")


def _mix(flats: list, outs: list, p: torch.Tensor, alpha: int) -> list:
    """``Y @ P^alpha`` for every ``(D, M)`` tensor of ``flats`` (checked
    alike, all on one device) into ``outs`` (a ``(D, M)`` tensor, which may
    alias its input, or None for a new one); returns the results."""
    device = flats[0].device
    if traced(flats[0]):
        outs = [torch.empty_like(y) if o is None else o for y, o in zip(flats, outs)]
        d = p.shape[0]
        report("gossip_mix", 2.0 * alpha * d * sum(y.numel() for y in flats), "f32",
               nbytes(*flats, *outs, p))
        return outs
    if p.device != device:
        raise ValueError(f"p on {p.device}, the leaves on {device}: p must lie on the "
                         f"leaves' device")
    if device.type == "cpu":
        res = [gossip_mix_ref(y, p, alpha) for y in flats]
        return [r if o is None else o.copy_(r) for r, o in zip(res, outs)]
    if device.type != "cuda":
        raise ValueError(f"gossip_mix runs on cpu or cuda tensors, got {device}")
    d = p.shape[0]
    if d > MAX_D:
        raise ValueError(f"gossip_mix kernel supports D <= {MAX_D} clusters, got {d}")
    for y, o in zip(flats, outs):
        if y.dtype not in _DTYPES:
            raise TypeError(f"gossip_mix kernel supports float32/bfloat16, got {y.dtype}")
        if not (y.is_contiguous() and (o is None or o.is_contiguous())):
            raise ValueError("gossip_mix kernel needs a contiguous y and out")
    outs = leaf_outputs([(tuple(y.shape), y.dtype) for y in flats], outs, device)
    leaves = [(y.dtype, y.shape[1], (y.data_ptr(), o.data_ptr())) for y, o in zip(flats, outs)]
    # the kernel reads P from device memory when it runs: the stream keeps a
    # converted copy alive until then (the caching allocator is stream-ordered)
    p_dev = p.detach().to(torch.float32).contiguous()
    lib, fn = _bind()
    stream = stream_of(device)
    for dtype, members in plan_launches(leaves):
        rows = []
        for i, vec in members:
            _, m, (y_ptr, o_ptr) = leaves[i]
            rows += (y_ptr, o_ptr, m, vec)
        rc = fn((ctypes.c_longlong * len(rows))(*rows), len(members), p_dev.data_ptr(), d,
                alpha, _DTYPES[dtype], stream)
        check(lib, rc, "gossip_mix")
        if any(leaves[i][1] for i, _ in members):  # the launcher skips a launch with no work
            gossip_mix.launches += 1
    return outs


def gossip_mix(y: torch.Tensor, p: torch.Tensor, alpha: int = 1,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """``y (D, M)``; ``p (D, D)`` on ``y``'s device, with column convention
    (``Y @ P^alpha``).

    ``alpha`` gossip rounds (0 copies).  ``out`` (may be ``y`` itself)
    receives the result; otherwise a new tensor is returned.
    """
    if y.dim() != 2:
        raise ValueError(f"y must be (D, M), got shape {tuple(y.shape)}")
    _check_mixing(y.shape[0], p, alpha)
    if out is not None and (out.shape != y.shape or out.dtype != y.dtype
                            or out.device != y.device):
        raise ValueError("out must match y in shape, dtype and device")
    return _mix([y], [out], p, alpha)[0]


gossip_mix.launches = 0


def gossip_mix_tree(tree: dict, p: torch.Tensor, alpha: int = 1,
                    inplace: bool = False) -> dict:
    """Gossip-mix every ``(D, ...)`` leaf of a parameter dict.

    Every leaf is checked before any is touched: D rows, contiguous, all on
    one device with ``p`` (and, on CUDA, float32 or bfloat16).  On CUDA the
    tree takes one launch per group of ``plan_launches``, each reading ``p``
    from device memory.  With ``inplace`` every leaf is overwritten and the same
    tensors are returned — safe because each column of a leaf belongs to one
    thread, which reads it whole before writing it.
    """
    d = p.shape[0] if p.dim() == 2 else -1
    _check_mixing(d, p, alpha)
    if not tree:
        return {}
    device = next(iter(tree.values())).device
    for k, y in tree.items():
        if y.dim() < 1 or y.shape[0] != d:
            raise ValueError(f"p {tuple(p.shape)} inconsistent with D="
                             f"{y.shape[0] if y.dim() else None} rows of leaf {k!r} "
                             f"{tuple(y.shape)}")
        if y.device != device:
            raise ValueError(f"leaf {k!r} on {y.device}, the first leaf on {device}: the "
                             f"leaves must lie on one device")
        if not y.is_contiguous():
            raise ValueError(f"gossip_mix_tree needs contiguous leaves; {k!r} is not")
    flats = [y.view(d, y.numel() // d) for y in tree.values()]
    res = _mix(flats, flats if inplace else [None] * len(flats), p, alpha)
    return {k: y if inplace else r.view(y.shape) for (k, y), r in zip(tree.items(), res)}
