"""Launch planning for the kernels that take a table of leaves by value.

``fused_transition``, ``sgd_update``, ``cluster_agg``, ``gossip_mix`` and
``normalized_update`` launch once per parameter tree: up to ``MAX_LEAVES``
leaves of one dtype travel in one launch's parameters (``LeafTable`` in
their ``csrc/*.cu``).  ``plan_launches`` groups a tree's leaves into such
launches.  It is a pure function of the leaves' dtypes, sizes and
addresses, so the CPU tests reach it without a card.  ``leaf_outputs``
allocates a tree call's new outputs so that each can take vector stores.
"""
from __future__ import annotations

import math
from collections.abc import Sequence

import torch

__all__ = ["MAX_LEAVES", "plan_launches", "leaf_outputs"]

MAX_LEAVES = 64  # kMaxLeaves in the CUDA sources: the table stays under 4 KB
VEC_BYTES = 16   # one vector load or store


def plan_launches(leaves: Sequence[tuple[torch.dtype, int, Sequence[int]]]
                  ) -> list[tuple[torch.dtype, list[tuple[int, bool]]]]:
    """Group leaves into launches of one dtype and at most ``MAX_LEAVES`` each.

    ``leaves`` holds ``(dtype, m, addresses)`` per leaf: its dtype, its
    elements a row (``M`` of a ``(C, M)`` transition leaf, the element count
    of an SGD leaf) and the base addresses of its operands.  Returns
    ``[(dtype, [(leaf index, vector flag), ...]), ...]``: dtypes in the order
    they first appear, each leaf once and in order within its dtype.  The
    flag says whether the leaf can take 16-byte vectors: every address
    aligned to 16 bytes and ``m`` a multiple of the vector.
    """
    by_dtype: dict[torch.dtype, list[tuple[int, bool]]] = {}
    for i, (dtype, m, addresses) in enumerate(leaves):
        vec = m % (VEC_BYTES // dtype.itemsize) == 0 and all(a % VEC_BYTES == 0
                                                             for a in addresses)
        by_dtype.setdefault(dtype, []).append((i, vec))
    return [(dtype, members[s:s + MAX_LEAVES])
            for dtype, members in by_dtype.items()
            for s in range(0, len(members), MAX_LEAVES)]


def leaf_outputs(specs: Sequence[tuple[tuple[int, ...], torch.dtype]], outs: Sequence,
                 device) -> list:
    """``outs`` with each None replaced by a new tensor of its ``(shape,
    dtype)`` in ``specs``, on ``device``: views of one buffer per dtype (one
    allocation, not one a leaf), each starting on a 16-byte boundary so that
    the kernels' vector paths stay open."""
    def padded(n: int, dtype: torch.dtype) -> int:
        lanes = VEC_BYTES // dtype.itemsize
        return -(-n // lanes) * lanes

    sizes: dict = {}
    for (shape, dtype), o in zip(specs, outs):
        if o is None:
            sizes[dtype] = sizes.get(dtype, 0) + padded(math.prod(shape), dtype)
    bufs = {dt: torch.empty(n, dtype=dt, device=device) for dt, n in sizes.items()}
    used = dict.fromkeys(sizes, 0)
    res = []
    for (shape, dtype), o in zip(specs, outs):
        if o is None:
            n, at = math.prod(shape), used[dtype]
            o = bufs[dtype][at:at + n].view(shape)
            used[dtype] = at + padded(n, dtype)
        res.append(o)
    return res
