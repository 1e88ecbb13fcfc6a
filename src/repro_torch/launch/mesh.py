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

``make_test_mesh`` is the reference's test mesh: a
``torch.distributed.device_mesh.DeviceMesh`` with dimensions ``("pod",)
"data", "model"`` over the initialized group (``torchrun --nproc-per-node
N`` gives one of N ranks), which the step builders of ``launch.steps`` take;
``mesh_axes_for`` names its axes for the sharding rules, and
``ClientMesh.from_device_mesh`` is the client mesh of one of its dimensions
(a subgroup).

``make_production_mesh`` is the reference's production mesh, ``(16, 16)``
``("data", "model")`` or ``(2, 16, 16)`` ``("pod", "data", "model")``, over a
fake process group of 256 or 512 ranks (``torch.distributed``'s ``fake``
backend: this process is rank 0, every collective returns at once), for
the dry run (``launch.dryrun``), which traces one rank's step on it.  Its
shapes are the reference's, so the sharding rules lay every leaf out as
the reference's do.  On nodes of 8 H100s a ``model`` axis of 16 spans two
nodes: in row-major rank order its groups cross the network, and
``roofline.analysis`` charges them to it.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch

__all__ = ["ClientMesh", "make_client_mesh", "resolve_client_mesh", "make_cluster_mesh",
           "resolve_cluster_mesh", "describe_resolution", "make_test_mesh", "mesh_axes_for",
           "make_production_mesh", "on_fake_group"]

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

    @classmethod
    def from_device_mesh(cls, device_mesh, axis_name: str = "data") -> "ClientMesh":
        """The client mesh of ``device_mesh``'s ``axis_name`` dimension: its
        group (a subgroup of the default one), its size, this rank's
        coordinate there and the mesh's device for this rank."""
        from ..sharding.context import mesh_axis_sizes

        dev = torch.device(device_mesh.device_type)
        if on_fake_group(device_mesh):
            dev = torch.device("meta")  # a dry run's mesh: nothing runs
        elif dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        return cls(group=device_mesh.get_group(axis_name), axis_name=axis_name,
                   size=mesh_axis_sizes(device_mesh)[axis_name],
                   index=device_mesh.get_local_rank(axis_name), device=dev)


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


def make_test_mesh(data: int = 2, model: int = 2, pod: int | None = None, device=None):
    """A ``DeviceMesh`` of ``(pod,) data, model`` ranks over the initialized
    default process group, row-major in rank order, as the reference's
    ``jax.make_mesh``.  ``device=None`` means ``cuda:<LOCAL_RANK>`` (nccl);
    ``"cpu"`` gives a gloo mesh.  Raises ``ValueError`` naming the launch
    when no group is initialized or its world size is not the mesh's."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    shape = (pod, data, model) if pod else (data, model)
    names = ("pod", "data", "model") if pod else ("data", "model")
    n = 1
    for x in shape:
        n *= x
    launch = _LAUNCH.format(what="mesh device", n=n)
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs an initialized process "
                         f"group of {n} ranks, have none; launch " + launch)
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {n} ranks: the process "
                         f"group has {world} rank(s); launch " + launch)
    dev = _mesh_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return DeviceMesh(dev.type, torch.arange(n).reshape(shape), mesh_dim_names=names)


def on_fake_group(device_mesh) -> bool:
    """Whether ``device_mesh`` lies over a fake process group (the dry run's):
    nothing runs there, so what a step builds for it goes on ``meta``, and
    no device is touched."""
    import torch.distributed as dist

    return dist.get_backend(device_mesh.get_group(0)) == "fake"


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The reference's production mesh over a fake process group of 256
    (or 512 with ``multi_pod``) ranks, started here unless one of that size
    is (``ValueError`` for a group of another size).  ``device`` names the
    mesh's device type: ``"cuda"`` where CUDA exists, else ``"cpu"``, by
    default.  Nothing runs on the device: the fake group exchanges nothing
    and its ranks are not processes."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for x in shape:
        n *= x
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    elif dist.get_world_size() != n:
        raise ValueError(f"the production mesh needs a process group of {n} ranks, the "
                         f"initialized one has {dist.get_world_size()}")
    dev = device or ("cuda" if torch.cuda.is_available() else "cpu")
    return DeviceMesh(torch.device(dev).type, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def mesh_axes_for(device_mesh):
    """The sharding rules' axis names of a test or production mesh."""
    from ..sharding.context import mesh_axis_sizes
    from ..sharding.rules import MeshAxes

    sizes = mesh_axis_sizes(device_mesh)
    return MeshAxes(model="model", data="data", pod="pod" if "pod" in sizes else None,
                    model_size=sizes["model"])
