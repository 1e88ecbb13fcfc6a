"""Client and cluster meshes: the port's ``repro.launch.mesh``, its first part.

``resolve_client_mesh`` and ``resolve_cluster_mesh`` turn a run's ``mesh``
field into a mesh or ``None``, by the reference's rule over the CUDA
devices (``torch.cuda.device_count()``):

* ``None`` gives ``None``: the stacked client axis stays on one device, and
  the collective transition runs there (``core.backends.CollectiveBackend``);
* ``"auto"`` gives ``None`` when there are fewer devices than clients (or
  cluster replicas), as the reference's does;
* ``"auto"`` with enough devices, or a mesh object, raises
  ``NotImplementedError``: one client a device needs the process-group
  collectives of ROADMAP.md §1 item 4, which are not ported.  A mesh is
  never emulated quietly.

The reference's production and test meshes (``make_production_mesh``,
``make_test_mesh``, ``mesh_axes_for``) serve ``sharding/`` and the dry run,
which are queued with it.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_client_mesh", "resolve_cluster_mesh", "describe_resolution"]

_NOT_PORTED = ("one {what} a device runs on process-group collectives, which are not "
               "ported yet (ROADMAP.md §1 item 4, 'process-group collectives')")


def resolve_client_mesh(spec, num_clients: int, axis_name: str = "data", what: str = "client"):
    """Resolve a run-config ``mesh`` field: ``None`` or a raise.

    ``None`` -> ``None``.  ``"auto"`` -> ``None`` when the host has fewer CUDA
    devices than ``num_clients``; with enough devices it would build a mesh,
    and raises ``NotImplementedError`` instead.  Any other string raises
    ``ValueError`` (as the reference's), any other object
    ``NotImplementedError``.
    """
    if spec is None:
        return None
    if isinstance(spec, str):
        if spec != "auto":
            raise ValueError(f"mesh must be None, 'auto', or a mesh, got {spec!r}")
        n = torch.cuda.device_count()
        if n < num_clients:
            return None
        raise NotImplementedError(
            f"mesh='auto' over {n} CUDA devices for {num_clients} {what}s "
            f"(axis {axis_name!r}): " + _NOT_PORTED.format(what=what))
    raise NotImplementedError(f"mesh={spec!r}: " + _NOT_PORTED.format(what=what))


def resolve_cluster_mesh(spec, num_clusters: int, axis_name: str = "cluster"):
    """Resolve a serving ``mesh`` field, as :func:`resolve_client_mesh` with
    the axis spanning cluster replicas instead of clients."""
    return resolve_client_mesh(spec, num_clusters, axis_name, what="cluster replica")


def describe_resolution(spec, num_clients: int) -> str:
    """One line saying how ``spec`` resolves for ``num_clients`` clients."""
    resolve_client_mesh(spec, num_clients)  # raises for what it cannot honour
    if spec is None:
        return "mesh=none: the stacked client axis stays on one device"
    return (f"mesh=auto resolved to none: {torch.cuda.device_count()} CUDA device(s) for "
            f"{num_clients} clients, so the stacked client axis stays on one device")
