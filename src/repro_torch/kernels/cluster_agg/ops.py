"""Intra-cluster weighted aggregation ``(C, M) -> (D, M)`` on tensors and dicts.

Replaces ``repro/kernels/cluster_agg/kernel.py::cluster_agg_kernel`` (TPU, via
``cluster_agg_pallas``) with the CUDA kernel in ``csrc/cluster_agg.cu``.
Bound by bytes: ``(C + D) * M * itemsize`` (W read once, Y written once) per
leaf, less the rows whose weight is 0, which the kernel skips.

Clusters are contiguous blocks of ``g = C / num_clusters`` rows; ``weights``
is a runtime ``(C,)`` f32 tensor (m^, or a participation-masked m^).  The
async scheduler's eq. 20 reduction is the ``num_clusters=1`` case over the
fired cluster's ``(g, M)`` stacks of client updates.

``cluster_agg_tree`` views each ``(C, ...)`` leaf as ``(C, M)`` and launches
once per tree — once per group of ``plan_launches``, which is one launch for
every tree of one dtype and at most ``MAX_LEAVES`` leaves.  ``cluster_agg``
is the one-leaf case.

Dispatch is by the tensor's device: a CPU tensor takes the plain version
(``ref.py``), a CUDA tensor launches the kernel or raises — there is no
fallback.  ``cluster_agg.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .._build import check, load, stream_of
from .._leaves import MAX_LEAVES, leaf_outputs, plan_launches
from .._trace import nbytes, report, traced
from .ref import cluster_agg_ref

__all__ = ["cluster_agg", "cluster_agg_tree", "plan_launches", "MAX_LEAVES"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _bind():
    lib = load("cluster_agg")
    fn = lib.cluster_agg_launch
    fn.argtypes = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check_clusters(c: int, num_clusters) -> None:
    if c < 1 or not isinstance(num_clusters, int) or num_clusters < 1 or c % num_clusters:
        raise ValueError(f"C={c} clients do not split into num_clusters={num_clusters!r} "
                         f"equal clusters")


def _agg(flats: list, outs: list, weights: torch.Tensor, d: int) -> list:
    """``Y = sum over each cluster of weights * W`` for every ``(C, M)``
    tensor of ``flats`` (checked alike and on the weights' device) into
    ``outs`` (a ``(D, M)`` tensor, or None for a new one); returns the
    results."""
    if traced(flats[0] if flats else weights):
        outs = [torch.empty((d, w.shape[1]), dtype=w.dtype, device=w.device) if o is None else o
                for w, o in zip(flats, outs)]
        report("cluster_agg", 2.0 * sum(w.numel() for w in flats), "f32",
               nbytes(*flats, *outs, weights))
        return outs
    if weights.device.type == "cpu":
        res = [cluster_agg_ref(w, weights, d) for w in flats]
        return [r if o is None else o.copy_(r) for r, o in zip(res, outs)]
    if weights.device.type != "cuda":
        raise ValueError(f"cluster_agg runs on cpu or cuda tensors, got {weights.device}")
    if weights.dtype != torch.float32:
        raise TypeError(f"cluster_agg kernel takes float32 weights, got {weights.dtype}")
    if not weights.is_contiguous():
        raise ValueError("cluster_agg kernel needs contiguous weights")
    for w, o in zip(flats, outs):
        if w.dtype not in _DTYPES:
            raise TypeError(f"cluster_agg kernel supports float32/bfloat16, got {w.dtype}")
        if not (w.is_contiguous() and (o is None or o.is_contiguous())):
            raise ValueError("cluster_agg kernel needs a contiguous w and out")
    outs = leaf_outputs([((d, w.shape[1]), w.dtype) for w in flats], outs, weights.device)
    leaves = [(w.dtype, w.shape[1], (w.data_ptr(), o.data_ptr())) for w, o in zip(flats, outs)]
    lib, fn = _bind()
    stream = stream_of(weights.device)
    for dtype, members in plan_launches(leaves):
        rows = []
        for i, vec in members:
            _, m, (w_ptr, o_ptr) = leaves[i]
            rows += (w_ptr, o_ptr, m, vec)
        rc = fn((ctypes.c_longlong * len(rows))(*rows), len(members), weights.data_ptr(),
                weights.shape[0], d, _DTYPES[dtype], stream)
        check(lib, rc, "cluster_agg")
        if any(leaves[i][1] for i, _ in members):  # the launcher skips a launch with no work
            cluster_agg.launches += 1
    return outs


def cluster_agg(w: torch.Tensor, weights: torch.Tensor, num_clusters: int,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """``w (C, M)``; ``weights (C,)``; returns (or fills ``out``) ``(D, M)``."""
    if w.dim() != 2:
        raise ValueError(f"w must be (C, M), got shape {tuple(w.shape)}")
    c, m = w.shape
    d = num_clusters
    _check_clusters(c, d)
    if tuple(weights.shape) != (c,):
        raise ValueError(f"weights {tuple(weights.shape)} inconsistent with C={c}")
    if out is not None and (tuple(out.shape) != (d, m) or out.dtype != w.dtype
                            or out.device != w.device):
        raise ValueError(f"out must be ({d}, {m}) of w's dtype and device")
    if weights.device != w.device:
        raise ValueError("w and weights must lie on one device")
    return _agg([w], [out], weights, d)[0]


cluster_agg.launches = 0


def cluster_agg_tree(tree: dict, weights: torch.Tensor, num_clusters: int) -> dict:
    """Aggregate every ``(C, ...)`` leaf of a parameter dict into ``(D, ...)``.

    Every leaf is checked before any launch: C rows, contiguous, on the
    weights' device (and, on CUDA, float32 or bfloat16).  On CUDA the tree
    takes one launch per group of ``plan_launches``.
    """
    if weights.dim() != 1:
        raise ValueError(f"weights must be (C,), got shape {tuple(weights.shape)}")
    c = weights.shape[0]
    flats = []
    for k, w in tree.items():
        if w.dim() < 1 or w.shape[0] != c:
            raise ValueError(f"weights {tuple(weights.shape)} inconsistent with C="
                             f"{w.shape[0] if w.dim() else None} rows of leaf {k!r} "
                             f"{tuple(w.shape)}")
        if w.device != weights.device:
            raise ValueError(f"leaf {k!r} on {w.device}, the weights on {weights.device}: "
                             f"w and weights must lie on one device")
        if not w.is_contiguous():
            raise ValueError(f"cluster_agg_tree needs contiguous leaves; {k!r} is not")
        flats.append(w.view(c, w.numel() // c) if c else w)
    _check_clusters(c, num_clusters)
    res = _agg(flats, [None] * len(flats), weights, num_clusters)
    return {k: r.view((num_clusters,) + tuple(w.shape[1:])) for (k, w), r in zip(tree.items(), res)}
