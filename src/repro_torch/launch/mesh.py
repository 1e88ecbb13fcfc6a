"""Client and cluster meshes over ``torch.distributed``: the port's ``repro.launch.mesh``.

A :class:`ClientMesh` is the port's counterpart of the reference's 1-D
``jax.sharding.Mesh`` over the client axis: one client a rank of the
default process group.  It holds the group, the axis name, the axis size
(the world size), this rank's index (its client) and this rank's device
(``cuda:<LOCAL_RANK>``, or the CPU for ``gloo`` runs).  The collective
backend runs its exchanges over it as point-to-point messages
(``core.aggregation.ppermute``).

``resolve_client_mesh`` and ``resolve_cluster_mesh`` turn a run's ``mesh``
field into a mesh or ``None``:

* ``None`` gives ``None``: the stacked client axis stays on one device, and
  the collective transition runs there;
* ``"auto"`` with an initialized process group gives the mesh over it
  (``ValueError`` unless its world size is the client count);
* ``"auto"`` without a group gives ``None`` when there are fewer CUDA
  devices than clients, as the reference's does, and raises ``ValueError``
  naming ``torchrun`` with enough of them.  That is a stated deviation: one
  JAX process drives every device, one torch process drives one, so a mesh
  needs one process a client, which only the launcher can start;
* a ``ClientMesh`` is checked (its size is the client count) and passed
  through.

The reference's production and test meshes (``make_production_mesh``,
``make_test_mesh``, ``mesh_axes_for``) wait for ROADMAP.md §1 item 4's
'steps' and 'dryrun'.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch

__all__ = ["ClientMesh", "make_client_mesh", "resolve_client_mesh", "make_cluster_mesh",
           "resolve_cluster_mesh", "describe_resolution"]

_LAUNCH = ("one process a {what}: torchrun --nproc-per-node {n} -m "
           "repro_torch.launch.train ... --mesh auto")


@dataclasses.dataclass(frozen=True)
class ClientMesh:
    """One client a rank: the process group, the axis and this rank's place."""

    group: Any               # a torch.distributed ProcessGroup (the default one)
    axis_name: str
    size: int                # clients on the axis == the group's world size
    index: int               # this rank's client
    device: torch.device     # where this rank's client state lives

    @property
    def backend(self) -> str:
        import torch.distributed as dist

        return dist.get_backend(self.group)


def _mesh_device(device) -> torch.device:
    """``device`` for this rank: ``None`` or an index-free ``"cuda"`` is
    ``cuda:<LOCAL_RANK>``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run a "
                               "client mesh on the CPU (gloo)")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def make_client_mesh(num_clients: int, axis_name: str = "data", device=None,
                     what: str = "client") -> ClientMesh:
    """The mesh over the initialized default process group, one client a rank.

    Raises ``ValueError`` when no group is initialized or its world size is
    not ``num_clients``, naming the launch that gives one rank a client.
    """
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            f"a {what} mesh needs an initialized process group of {num_clients} ranks, "
            f"have none; launch " + _LAUNCH.format(what=what, n=num_clients))
    world = dist.get_world_size()
    if world != num_clients:
        raise ValueError(
            f"a {what} mesh needs one rank a {what}: the process group has {world} "
            f"rank(s) for {num_clients} {what}s; launch " + _LAUNCH.format(what=what,
                                                                          n=num_clients))
    return ClientMesh(group=dist.group.WORLD, axis_name=axis_name, size=world,
                      index=dist.get_rank(), device=_mesh_device(device))


def resolve_client_mesh(spec, num_clients: int, axis_name: str = "data", device=None,
                        what: str = "client"):
    """Resolve a run-config ``mesh`` field into a :class:`ClientMesh` or ``None``
    (the rules of the module docstring)."""
    import torch.distributed as dist

    if spec is None:
        return None
    if isinstance(spec, ClientMesh):
        if spec.size != num_clients:
            raise ValueError(f"mesh axis {spec.axis_name!r} has size {spec.size}, need one "
                             f"rank a {what} ({num_clients})")
        return spec
    if spec != "auto":
        raise ValueError(f"mesh must be None, 'auto', or a ClientMesh, got {spec!r}")
    if dist.is_available() and dist.is_initialized():
        return make_client_mesh(num_clients, axis_name, device, what)
    n = torch.cuda.device_count()
    if n < num_clients:
        return None
    raise ValueError(
        f"mesh='auto' over {n} CUDA devices for {num_clients} {what}s (axis "
        f"{axis_name!r}) needs a process group; launch " + _LAUNCH.format(what=what,
                                                                         n=num_clients))


def make_cluster_mesh(num_clusters: int, axis_name: str = "cluster", device=None) -> ClientMesh:
    """The cluster-replica twin of :func:`make_client_mesh` (one replica a rank)."""
    return make_client_mesh(num_clusters, axis_name, device, what="cluster replica")


def resolve_cluster_mesh(spec, num_clusters: int, axis_name: str = "cluster", device=None):
    """Resolve a serving ``mesh`` field, as :func:`resolve_client_mesh` with
    the axis spanning cluster replicas instead of clients."""
    return resolve_client_mesh(spec, num_clusters, axis_name, device, what="cluster replica")


def describe_resolution(spec, num_clients: int, device=None) -> str:
    """One line saying how ``spec`` resolves for ``num_clients`` clients."""
    mesh = resolve_client_mesh(spec, num_clients, device=device)  # raises what it cannot honour
    if spec is None:
        return "mesh=none: the stacked client axis stays on one device"
    if mesh is None:
        return (f"mesh=auto resolved to none: {torch.cuda.device_count()} CUDA device(s) for "
                f"{num_clients} clients, so the stacked client axis stays on one device")
    return (f"mesh=auto resolved to a client mesh: {mesh.size} ranks over "
            f"{mesh.backend}, one client a rank (rank {mesh.index} on {mesh.device})")
