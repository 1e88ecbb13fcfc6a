"""Carry parameters between the JAX package and the port through numpy.

Both packages keep one layout (HWIO conv kernels, ``(din, dout)`` fc
weights, an optional leading ``(C,)`` client axis), so conversion is a
per-leaf copy.  The JAX side hands over ``{name: np.ndarray}``
(``jax.tree.map(np.asarray, tree)``); no JAX is imported here.  The LM's
nested tree crosses as dotted names: ``flatten_params`` turns
``{"blocks": {"pos0": {"attn": {"wq": a}}}}`` into ``{"blocks.pos0.attn.wq":
a}``, the port's layout, and ``unflatten_params`` undoes it.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_numpy", "params_to_numpy", "flatten_params", "unflatten_params"]


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


def flatten_params(nested: dict, prefix: str = "") -> dict:
    """Nested dicts of arrays -> ``{dotted name: array}`` (leaves as they are)."""
    out = {}
    for k, v in nested.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten_params(v, f"{name}."))
        else:
            out[name] = v
    return out


def unflatten_params(flat: dict) -> dict:
    """``{dotted name: array}`` -> nested dicts (the inverse of ``flatten_params``)."""
    out: dict = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out
