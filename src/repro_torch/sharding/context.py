"""The activation-sharding context: the port's ``repro.sharding.context``.

Model code (``repro_torch.models``) does not name a mesh.  The step builders
of ``launch.steps`` open this context while a step runs, so that layers can
pin an activation's layout where the default propagation would pick a bad
one, and learn the model axis's size::

    with activation_sharding(device_mesh, batch_axes=("data",), model_axis="model"):
        logits, cache = model.prefill(params, batch)   # DTensor params and batch

    x = constrain_batch(x)        # shard dim 0 over the batch axes
    x = constrain_dim(x, 2)       # shard dim 2 over the model axis

The state is thread-local, as the reference's.  A constraint on a
``DTensor`` is a ``redistribute`` to ``Shard(dim)`` on the named axes and
``Replicate()`` on the others (the reference's ``with_sharding_constraint``
of a ``PartitionSpec`` that names only them), with the reference's guard: a
dimension the axes' sizes do not divide is left as it is.  A plain tensor,
or any tensor without a context, passes through unchanged.  A constraint
places the work and never changes a value.

Inside the context, plain tensors that meet a ``DTensor`` in an op count as
replicated (``torch.distributed.tensor.experimental.implicit_replication``):
the positions, masks and constants a layer makes need no mesh of their own.

``on_submesh`` and ``from_local_on`` are the port's partial ``shard_map``:
the first views a ``DTensor``'s local shard as a ``DTensor`` on the
sub-mesh of some of its dimensions (its placements there kept), so code
runs by hand over the others (``manual``) and by DTensor over these; the
second lays a local result back out on the whole mesh.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

_STATE = threading.local()
# implicit replication is one process-wide switch, which its context manager
# turns off on exit: contexts nested on one thread, or opened by a backward
# on the engine's thread inside the step's, leave it to the outermost
_REPLICATING = {"depth": 0, "cm": None}
_LOCK = threading.Lock()

__all__ = ["activation_sharding", "constrain_batch", "constrain_dim", "current",
           "model_axis_size", "is_dtensor", "on_submesh", "from_local_on", "mesh_axis_sizes",
           "mesh_coord", "restored", "replicate_model"]


def current():
    """The open context as a dict (``mesh``, ``batch_axes``, ``model_axis``,
    ``moe_shard_map``), or ``None``."""
    return getattr(_STATE, "ctx", None)


def mesh_axis_sizes(device_mesh) -> dict:
    """``{dimension name: size}`` of a ``DeviceMesh``."""
    return dict(zip(device_mesh.mesh_dim_names, device_mesh.mesh.shape))


def mesh_coord(mesh, names) -> int:
    """This rank's row-major index over the mesh dimensions ``names`` (the
    order in which a DTensor sharded over several of them lays out one
    tensor dimension)."""
    sizes = mesh_axis_sizes(mesh)
    idx = 0
    for n in names:
        idx = idx * sizes[n] + mesh.get_local_rank(n)
    return idx


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


@contextlib.contextmanager
def activation_sharding(mesh, batch_axes: tuple, model_axis: str = "model",
                        moe_shard_map: bool = True):
    """Open the context on ``mesh`` (a ``DeviceMesh``).  ``moe_shard_map=False``:
    the MoE layer must not take its per-shard branch (the federated train
    step, where a client's tokens are already shard-local for the dispatch,
    as in the reference)."""
    from torch.distributed.tensor.experimental import implicit_replication

    prev = current()
    _STATE.ctx = {"mesh": mesh, "batch_axes": tuple(batch_axes),
                  "model_axis": model_axis, "moe_shard_map": moe_shard_map}
    with _LOCK:
        _REPLICATING["depth"] += 1
        if _REPLICATING["depth"] == 1:
            _REPLICATING["cm"] = implicit_replication()
            _REPLICATING["cm"].__enter__()
    try:
        yield
    finally:
        _STATE.ctx = prev
        with _LOCK:
            _REPLICATING["depth"] -= 1
            if _REPLICATING["depth"] == 0:
                _REPLICATING["cm"].__exit__(None, None, None)
                _REPLICATING["cm"] = None


@contextlib.contextmanager
def restored(state):
    """Re-open a context that ``current()`` returned (``None``: none) on this
    thread, for a backward that recomputes what ran under it."""
    if state is None:
        prev = current()
        _STATE.ctx = None
        try:
            yield
        finally:
            _STATE.ctx = prev
        return
    with activation_sharding(state["mesh"], state["batch_axes"], state["model_axis"],
                             state["moe_shard_map"]):
        yield


def _constrain(x, dim: int, axes: list):
    """``x`` redistributed to ``Shard(dim)`` on ``axes``, replicated on the
    mesh's other dimensions (a no-op for a plain tensor or an indivisible
    dimension)."""
    from torch.distributed.tensor import Replicate, Shard

    if not is_dtensor(x) or not axes:
        return x
    mesh = x.device_mesh
    sizes = mesh_axis_sizes(mesh)
    axes = [a for a in axes if a in sizes]
    div = 1
    for a in axes:
        div *= sizes[a]
    if not axes or x.shape[dim] % div:
        return x
    dim = dim % x.dim()
    want = tuple(Shard(dim) if a in axes else Replicate() for a in mesh.mesh_dim_names)
    return x if tuple(x.placements) == want else x.redistribute(mesh, want)


def constrain_batch(x, batch_dim: int = 0):
    """Pin ``x``'s ``batch_dim`` to the context's batch axes (no-op without
    a context, on a plain tensor, or when the dimension cannot shard)."""
    ctx = current()
    if ctx is None:
        return x
    return _constrain(x, batch_dim, list(ctx["batch_axes"]))


def model_axis_size() -> int:
    """Size of the context's model axis (1 without a context)."""
    ctx = current()
    if ctx is None:
        return 1
    return mesh_axis_sizes(ctx["mesh"]).get(ctx["model_axis"], 1)


def constrain_dim(x, dim: int, axis: Optional[str] = None):
    """Pin one dimension of ``x`` to a mesh axis (default: the model axis);
    no-op without a context, on a plain tensor, or when it cannot shard."""
    ctx = current()
    if ctx is None:
        return x
    return _constrain(x, dim, [axis or ctx["model_axis"]])


def replicate_model(x):
    """``x`` whole over the context's model axis, forward and backward: a
    ``Partial`` summed or a shard gathered, and the gradient summed (or, for
    a sharded ``x``, the rank's shard of it); its other placements kept.  The model code puts it around every
    sublayer of the residual stream (Megatron's ``f`` and ``g``): at its
    input, where the forward is a no-op and the backward sums the partial
    gradients of the rank's shards; at its output, where the forward sums
    the rank's partial results.  A layer's products with its model-sharded
    weights then run on the rank's shard of the weight and of the hidden
    activation, forward and backward, never on weights gathered whole (the
    reference partitioner's plan).  No-op without a context or on a plain
    tensor."""
    ctx = current()
    if ctx is None or not is_dtensor(x):
        return x
    names = list(x.device_mesh.mesh_dim_names)
    if ctx["model_axis"] not in names:
        return x
    return _Whole.apply(x, names.index(ctx["model_axis"]))


def _whole_on(x, i: int):
    """``x`` (a DTensor) with mesh dimension ``i`` replicated."""
    from torch.distributed.tensor import Replicate

    if isinstance(x.placements[i], Replicate):
        return x
    want = tuple(Replicate() if j == i else p for j, p in enumerate(x.placements))
    return x.redistribute(x.device_mesh, want)


class _Whole(torch.autograd.Function):
    """``replicate_model``'s op on mesh dimension ``i`` (fixed at the
    forward: a backward may run on another thread, outside the context).
    The gradient of a sharded ``x`` is its shard of the whole gradient (a
    gathered vocabulary's), any other ``x``'s is whole."""

    @staticmethod
    def forward(ctx, x, i):
        from torch.distributed.tensor import Shard

        ctx.i = i
        ctx.shard = x.placements[i] if isinstance(x.placements[i], Shard) else None
        return _whole_on(x, i).view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.shard is None:
            return _whole_on(g, ctx.i), None
        want = tuple(ctx.shard if j == ctx.i else p for j, p in enumerate(g.placements))
        return g.redistribute(g.device_mesh, want), None


def on_submesh(x, names: tuple):
    """``x`` (a ``DTensor``) as a ``DTensor`` on its mesh's sub-mesh of the
    dimensions ``names``, its placements there kept: over the mesh's other
    dimensions (manual, where each rank computes on its own) ``x`` is
    gathered whole, and its gradient there is the sum of the ranks'
    (``Partial``), as ``shard_map``'s for a replicated operand.  A plain
    tensor passes through."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    dims = list(mesh.mesh_dim_names)
    whole = tuple(p if n in names else Replicate() for n, p in zip(dims, x.placements))
    if whole != tuple(x.placements):
        x = x.redistribute(mesh, whole)
    grad = tuple(p if n in names else Partial() for n, p in zip(dims, whole))
    local = x.to_local(grad_placements=grad)
    if not names:
        return local
    sub = mesh[tuple(names)] if len(names) > 1 else mesh[names[0]]
    return DTensor.from_local(local, sub, tuple(whole[dims.index(n)] for n in names),
                              run_check=False)


def from_local_on(local, mesh, placements: tuple):
    """A rank's local result laid out on ``mesh`` with ``placements`` (a
    ``DTensor`` on a sub-mesh gives its local shard first)."""
    from torch.distributed.tensor import DTensor

    if is_dtensor(local):
        local = local.to_local()
    return DTensor.from_local(local, mesh, placements, run_check=False)
