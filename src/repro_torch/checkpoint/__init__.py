"""Checkpointing: save and restore training state, in the reference's format.

The port's ``repro.checkpoint``.  A checkpoint is a directory
``step_<8 digits>/`` holding ``manifest.json`` (step, metadata, leaf names,
shapes and dtypes) and one ``leaf_<5 digits>.npy`` per leaf, written under
``<dir>.tmp`` and renamed into place.  bfloat16 is widened to float32 on
disk (numpy has no bf16), as the reference does.

Leaf names and leaf order are the JAX package's: a dict's keys are taken in
sorted order (JAX's pytree order), a dotted key of the port's flat trees
(``"blocks.pos0.attn.wq"``, see ``repro_torch.convert``) is the nested path
``blocks/pos0/attn/wq``, sequence entries are named by index, a
``NamedTuple``'s (an ``optim.AdamState``) by ``.field`` in field order
(``opt/.step``, ``opt/.m/w``), and path parts join with ``/``.  So a
checkpoint the reference wrote restores into the port and one the port
wrote restores in the reference, leaf for leaf.  The
manifest's ``treedef`` is a string of the port's, which neither side reads
back: restore rebuilds the structure of the template it is given.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
    "flatten_with_names",
    "host_leaf",
    "save_leaves",
    "load_leaves",
]

_SEP = "/"


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic, int, float, bool))


def _nest(tree: dict) -> dict:
    """A dict's dotted keys as nested dicts (JAX's layout of the LM trees)."""
    if not any(isinstance(k, str) and "." in k for k in tree):
        return tree
    out: dict = {}
    for name, v in tree.items():
        *path, leaf = str(name).split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _walk(tree, path: tuple, out: list) -> None:
    if _is_leaf(tree):
        out.append((path, tree))
    elif isinstance(tree, dict):
        nested = _nest(tree)
        for k in sorted(nested):
            _walk(nested[k], path + (str(k),), out)
    elif _is_namedtuple(tree):
        for f in tree._fields:
            _walk(getattr(tree, f), path + ("." + f,), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _walk(v, path + (str(i),), out)
    elif tree is not None:
        raise TypeError(f"checkpoint trees hold tensors, arrays, scalars, dicts, lists "
                        f"and tuples; got {type(tree).__name__}")


def _paths(tree) -> list[tuple[tuple, Any]]:
    out: list = []
    _walk(tree, (), out)
    return out


def flatten_with_names(tree) -> list[tuple[str, Any]]:
    """``(path-name, leaf)`` per leaf, in the reference's leaf order and naming."""
    return [(_SEP.join(path) or "leaf", leaf) for path, leaf in _paths(tree)]


def host_leaf(leaf) -> np.ndarray:
    """One leaf on the host in the on-disk representation: bfloat16 (a torch
    tensor or an ml_dtypes array) widened to float32, as the reference."""
    if isinstance(leaf, torch.Tensor):  # a copy, never a view of the tensor
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.to("cpu", copy=True).numpy()
    arr = np.asarray(leaf)
    return arr.astype(np.float32) if arr.dtype.name == "bfloat16" else arr


def save_leaves(path: str, named: list[tuple[str, Any]]) -> None:
    """Serialize named leaves to one ``.npz`` record (the reference's encoding)."""
    arrays = {f"{i:05d}:{name}": host_leaf(leaf) for i, (name, leaf) in enumerate(named)}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_leaves(path: str) -> list[np.ndarray]:
    """Inverse of ``save_leaves``: the leaves in their original order."""
    with np.load(path) as z:
        return [z[k] for k in sorted(z.files)]


def save_checkpoint(directory: str, state, step: int, metadata: Optional[dict] = None) -> str:
    """Atomically write ``state`` under ``directory/step_<step>``; returns the path."""
    dest = os.path.join(directory, f"step_{step:08d}")
    tmp = dest + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    paths = _paths(state)
    manifest = {"step": step, "metadata": metadata or {},
                "treedef": "repro_torch:" + ",".join(_SEP.join(p) for p, _ in paths),
                "leaves": []}
    for i, (path, leaf) in enumerate(paths):
        arr = host_leaf(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({"name": _SEP.join(path) or "leaf", "file": fname,
                                   "shape": list(arr.shape), "dtype": str(arr.dtype)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(dest):
        shutil.rmtree(dest)
    os.rename(tmp, dest)
    return dest


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _restored(tmpl, arr: np.ndarray):
    if isinstance(tmpl, torch.Tensor):
        return torch.as_tensor(arr).to(device=tmpl.device, dtype=tmpl.dtype)
    if isinstance(tmpl, np.ndarray):
        return arr.astype(tmpl.dtype)
    return type(tmpl)(arr.item())


def _rebuild(tmpl, it):
    if _is_leaf(tmpl):
        return next(it)
    if isinstance(tmpl, dict):
        nested = _nest(tmpl)
        built = {k: _rebuild(nested[k], it) for k in sorted(nested)}
        if nested is tmpl:
            return {k: built[k] for k in tmpl}
        flat: dict = {}
        for name in tmpl:  # back to the template's dotted keys, in its order
            node = built
            for p in str(name).split("."):
                node = node[p]
            flat[name] = node
        return flat
    if _is_namedtuple(tmpl):
        return type(tmpl)(*[_rebuild(v, it) for v in tmpl])
    if isinstance(tmpl, (list, tuple)):
        return type(tmpl)(_rebuild(v, it) for v in tmpl)
    return tmpl


def restore_checkpoint(directory: str, like, step: Optional[int] = None,
                       row: Optional[int] = None):
    """Restore into the structure of ``like``: ``(state, manifest)``.

    Each leaf takes its template's dtype and device (tensors) or dtype
    (arrays); the count, names and shapes must match the manifest's.  With
    ``row``, each leaf is read memory-mapped and only ``[row:row + 1]`` of
    its first axis is kept, as a rank of a client mesh restores its own
    client of a stacked checkpoint into its ``(1, ...)`` row."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    src = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(src, "manifest.json")) as f:
        manifest = json.load(f)
    paths = _paths(like)
    if len(paths) != len(manifest["leaves"]):
        raise ValueError(f"checkpoint has {len(manifest['leaves'])} leaves, "
                         f"template has {len(paths)}")
    out = []
    for entry, (path, tmpl) in zip(manifest["leaves"], paths):
        name = _SEP.join(path) or "leaf"
        if entry["name"] != name:
            raise ValueError(f"checkpoint leaf {entry['name']!r} where the template has {name!r}")
        arr = np.load(os.path.join(src, entry["file"]), mmap_mode=None if row is None else "r")
        if row is not None:
            arr = np.array(arr[row:row + 1])
        if tuple(arr.shape) != tuple(np.shape(tmpl)):
            raise ValueError(f"shape mismatch for {name}: {arr.shape} vs {tuple(np.shape(tmpl))}")
        out.append(_restored(tmpl, arr))
    return _rebuild(like, iter(out)), manifest
