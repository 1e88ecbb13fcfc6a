"""Carry parameters between the JAX package and the port through numpy.

Both packages keep one layout (HWIO conv kernels, ``(din, dout)`` fc
weights, an optional leading ``(C,)`` client axis), so conversion is a
per-leaf copy.  The JAX side hands over ``{name: np.ndarray}``
(``jax.tree.map(np.asarray, tree)``); no JAX is imported here.  The LM's
nested tree crosses as dotted names: ``flatten_params`` turns
``{"blocks": {"pos0": {"attn": {"wq": a}}}}`` into ``{"blocks.pos0.attn.wq":
a}``, the port's layout, and ``unflatten_params`` undoes it.
``store_from_numpy`` loads a reference ``HostOffloadStore``'s state (its
cluster stack and its host rows) into a bound port store, so both stores
hold the same clients' states.  ``opt_state_from_numpy`` carries an
optimizer's state: SGD's ``()``, momentum's tree, or an ``AdamState`` (the
reference's, leaves as numpy arrays) into the port's ``optim.AdamState``.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_numpy", "params_to_numpy", "flatten_params", "unflatten_params",
           "store_from_numpy", "opt_state_from_numpy"]


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


def store_from_numpy(store, cluster_models: dict, host_rows: dict | None = None) -> None:
    """Write a reference ``HostOffloadStore``'s state into a bound port store.

    ``cluster_models`` is its ``(D, ...)`` cluster stack as ``{name: array}``
    (``jax.tree.map(np.asarray, store.cluster_models)``); ``host_rows`` maps a
    client to its stored leaves (client mode, ``store._host``), listed in the
    checkpoint layer's leaf order, which both packages share.  The port's
    tensors are written in place, so the store's buffers keep their addresses.
    """
    for k, v in cluster_models.items():
        dst = store.cluster_models[k]
        dst.copy_(_leaf(v, dst.device).to(dst.dtype))
    for c, leaves in (host_rows or {}).items():
        store._host.put(int(c), [np.asarray(x) for x in leaves])


def opt_state_from_numpy(state, device):
    """A reference optimizer state as numpy (``jax.tree.map(np.asarray,
    state)``) -> the port's: ``()`` stays ``()``, a (nested) dict of arrays
    becomes the port's flat ``{dotted name: tensor}``, and an ``AdamState``
    (any tuple with fields ``step``, ``m``, ``v``) ``optim.AdamState``, its
    step an int32 tensor; every dtype kept (bf16 moments stay bf16)."""
    if isinstance(state, dict):
        return params_from_numpy(flatten_params(state), device)
    if getattr(state, "_fields", None) == ("step", "m", "v"):
        from .optim import AdamState

        return AdamState(step=_leaf(state.step, device),
                         m=opt_state_from_numpy(state.m, device),
                         v=opt_state_from_numpy(state.v, device))
    if isinstance(state, tuple) and not state:
        return ()
    raise TypeError(f"an optimizer state is (), a dict of arrays or an AdamState; got "
                    f"{type(state).__name__}")
