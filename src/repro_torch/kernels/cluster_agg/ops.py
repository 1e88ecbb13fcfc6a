"""Intra-cluster weighted aggregation ``(C, M) -> (D, M)`` on tensors and dicts.

Replaces ``repro/kernels/cluster_agg/kernel.py::cluster_agg_kernel`` (TPU, via
``cluster_agg_pallas``) with the CUDA kernel in ``csrc/cluster_agg.cu``.
Bound by bytes: ``(C + D) * M * itemsize`` (W read once, Y written once) per
leaf, less the rows whose weight is 0, which the kernel skips.

Clusters are contiguous blocks of ``g = C / num_clusters`` rows; ``weights``
is a runtime ``(C,)`` f32 tensor (m^, or a participation-masked m^).  The
async scheduler's eq. 20 reduction is the ``num_clusters=1`` case over the
fired cluster's ``(g, M)`` stack of client updates.

Dispatch is by the tensor's device: a CPU tensor takes the plain version
(``ref.py``), a CUDA tensor launches the kernel or raises — there is no
fallback.  ``cluster_agg.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .._build import check, load, stream_of
from .ref import cluster_agg_ref

__all__ = ["cluster_agg", "cluster_agg_tree"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _bind():
    lib = load("cluster_agg")
    fn = lib.cluster_agg_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def cluster_agg(w: torch.Tensor, weights: torch.Tensor, num_clusters: int,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """``w (C, M)``; ``weights (C,)``; returns (or fills ``out``) ``(D, M)``."""
    if w.dim() != 2:
        raise ValueError(f"w must be (C, M), got shape {tuple(w.shape)}")
    c, m = w.shape
    d = num_clusters
    if not isinstance(d, int) or d < 1 or c % d:
        raise ValueError(f"C={c} clients do not split into num_clusters={d!r} equal clusters")
    if tuple(weights.shape) != (c,):
        raise ValueError(f"weights {tuple(weights.shape)} inconsistent with C={c}")
    if out is not None and (tuple(out.shape) != (d, m) or out.dtype != w.dtype
                            or out.device != w.device):
        raise ValueError(f"out must be ({d}, {m}) of w's dtype and device")
    if weights.device != w.device:
        raise ValueError("w and weights must lie on one device")
    if w.device.type == "cpu":
        res = cluster_agg_ref(w, weights, d)
        return res if out is None else out.copy_(res)
    if w.device.type != "cuda":
        raise ValueError(f"cluster_agg runs on cpu or cuda tensors, got {w.device}")
    if w.dtype not in _DTYPES:
        raise TypeError(f"cluster_agg kernel supports float32/bfloat16, got {w.dtype}")
    if weights.dtype != torch.float32:
        raise TypeError(f"cluster_agg kernel takes float32 weights, got {weights.dtype}")
    if out is None:
        out = torch.empty((d, m), dtype=w.dtype, device=w.device)
    for name, t in (("w", w), ("weights", weights), ("out", out)):
        if not t.is_contiguous():
            raise ValueError(f"cluster_agg kernel needs a contiguous {name}")
    lib, fn = _bind()
    rc = fn(w.data_ptr(), out.data_ptr(), weights.data_ptr(), c, d, m, _DTYPES[w.dtype],
            stream_of(w.device))
    check(lib, rc, "cluster_agg")
    cluster_agg.launches += 1
    return out


cluster_agg.launches = 0


def cluster_agg_tree(tree: dict, weights: torch.Tensor, num_clusters: int) -> dict:
    """Aggregate every ``(C, ...)`` leaf of a parameter dict into ``(D, ...)``,
    one launch per leaf."""
    out = {}
    for k, w in tree.items():
        res = cluster_agg(w.reshape(w.shape[0], -1), weights, num_clusters)
        out[k] = res.view((num_clusters,) + tuple(w.shape[1:]))
    return out
