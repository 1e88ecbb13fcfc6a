"""Carry parameters between the JAX package and the port through numpy.

Both packages keep one layout (HWIO conv kernels, ``(din, dout)`` fc
weights, an optional leading ``(C,)`` client axis), so conversion is a
per-leaf copy.  The JAX side hands over ``{name: np.ndarray}``
(``jax.tree.map(np.asarray, tree)``); no JAX is imported here.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_numpy", "params_to_numpy"]


def _leaf(v, device) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(v))
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16, which torch cannot read
        return torch.tensor(a.astype(np.float32), device=device).to(torch.bfloat16)
    return torch.tensor(a, device=device)


def params_from_numpy(tree: dict, device) -> dict[str, torch.Tensor]:
    """``{name: array}`` -> ``{name: tensor}`` on ``device`` (copied, contiguous)."""
    return {k: _leaf(v, device) for k, v in tree.items()}


def params_to_numpy(params: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """``{name: tensor}`` -> ``{name: np.ndarray}`` (bf16 comes back as float32)."""
    out = {}
    for k, v in params.items():
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            v = v.float()
        out[k] = v.numpy()
    return out
