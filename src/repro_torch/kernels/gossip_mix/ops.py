"""Inter-cluster gossip mixing ``Y <- Y @ P^alpha`` on tensors and dicts.

Replaces ``repro/kernels/gossip_mix/kernel.py::gossip_mix_kernel`` (TPU, via
``gossip_mix_pallas``) with the CUDA kernel in ``csrc/gossip_mix.cu``.  Bound
by bytes: ``2 * D * M * itemsize`` (Y read once, written once) per leaf.

Dispatch is by the tensor's device: a CPU tensor takes the plain version
(``ref.py``), a CUDA tensor launches the kernel or raises — there is no
fallback.  ``gossip_mix.launches`` counts kernel launches.

``P`` travels by value in the kernel's parameters, so the kernel reads it
from host memory at launch: a CPU ``p`` costs nothing, a CUDA ``p`` is first
copied back to the host (the host waits for it).  The async scheduler builds
its per-event ``P_t`` on the host for that reason.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .._build import check, load, stream_of
from .ref import gossip_mix_ref

__all__ = ["gossip_mix", "gossip_mix_tree", "MAX_D"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 16  # largest register array (and by-value P) the kernel is built for


@functools.cache
def _bind():
    lib = load("gossip_mix")
    fn = lib.gossip_mix_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def gossip_mix(y: torch.Tensor, p: torch.Tensor, alpha: int = 1,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """``y (D, M)``; ``p (D, D)`` with column convention (``Y @ P^alpha``).

    ``alpha`` gossip rounds (0 copies).  ``out`` (may be ``y`` itself)
    receives the result; otherwise a new tensor is returned.
    """
    if y.dim() != 2:
        raise ValueError(f"y must be (D, M), got shape {tuple(y.shape)}")
    d = y.shape[0]
    if tuple(p.shape) != (d, d):
        raise ValueError(f"p {tuple(p.shape)} inconsistent with D={d}")
    if not isinstance(alpha, int) or alpha < 0:
        raise ValueError(f"alpha must be an int >= 0, got {alpha!r}")
    if out is not None and (out.shape != y.shape or out.dtype != y.dtype
                            or out.device != y.device):
        raise ValueError("out must match y in shape, dtype and device")
    if y.device.type == "cpu":
        res = gossip_mix_ref(y, p.to("cpu"), alpha)
        return res if out is None else out.copy_(res)
    if y.device.type != "cuda":
        raise ValueError(f"gossip_mix runs on cpu or cuda tensors, got {y.device}")
    if y.dtype not in _DTYPES:
        raise TypeError(f"gossip_mix kernel supports float32/bfloat16, got {y.dtype}")
    if d > MAX_D:
        raise ValueError(f"gossip_mix kernel supports D <= {MAX_D} clusters, got {d}")
    if out is None:
        out = torch.empty_like(y, memory_format=torch.contiguous_format)
    for name, t in (("y", y), ("out", out)):
        if not t.is_contiguous():
            raise ValueError(f"gossip_mix kernel needs a contiguous {name}")
    # host copy of P, read by the launcher into the kernel's parameters
    p_host = p.detach().to("cpu", torch.float32).contiguous()
    lib, fn = _bind()
    rc = fn(y.data_ptr(), out.data_ptr(), p_host.data_ptr(), d, y.shape[1], alpha,
            _DTYPES[y.dtype], stream_of(y.device))
    check(lib, rc, "gossip_mix")
    gossip_mix.launches += 1
    return out


gossip_mix.launches = 0


def gossip_mix_tree(tree: dict, p: torch.Tensor, alpha: int = 1,
                    inplace: bool = False) -> dict:
    """Gossip-mix every ``(D, ...)`` leaf of a parameter dict, one launch per leaf.

    With ``inplace`` every leaf is overwritten and the same tensors are
    returned — safe because each column of a leaf belongs to one thread,
    which reads it whole before writing it.
    """
    if p.device.type == "cuda":
        p = p.cpu()  # once for all leaves, not once per leaf
    out = {}
    for k, y in tree.items():
        if inplace and not y.is_contiguous():
            raise ValueError(f"in-place gossip needs contiguous leaves; {k!r} is not")
        flat = y.reshape(y.shape[0], -1)  # a view of a contiguous leaf
        res = gossip_mix(flat, p, alpha=alpha, out=flat if inplace else None)
        out[k] = y if inplace else res.view(y.shape)
    return out
