"""Synchronous SD-FEEL: the single-iteration step and the federated layout spec.

The port's ``repro.core.sdfeel``:

* ``FLSpec``: C clients in D uniform contiguous clusters, the topology by
  name, the protocol periods and the aggregation ``impl``;
* ``build_fl_train_step``: one SD-FEEL *iteration* on the stacked client
  axis, the local SGD step of every client then the Lemma-1 transition of a
  fixed event (``local``/``intra``/``inter``).  ``impl="dense"`` applies the
  transition with the dense backend, ``impl="gossip"`` with the collective
  backend (hypercube all-reduce and ring gossip, ``backends.py``).  With
  ``microbatch > 1`` each client's gradient is the mean of its micro-batch
  gradients, accumulated in f32; with ``participation=True`` the step takes
  the round's ``(C,)`` weights;
* ``init_stacked``.

The reference lowers this step under ``jit`` with the client axis sharded
over its ``data`` mesh axis.  ``mesh`` takes what
``launch.mesh.resolve_client_mesh`` takes, or a ``DeviceMesh``.  On a client
mesh (one client a rank of a process group) ``params`` and ``opt_state`` are
this rank's ``(1, ...)`` row, the step takes the rank's row of the fleet's
batch, and the transition exchanges with the other ranks: the collective
backend's messages (``impl="gossip"``), or the dense product of the gathered
rows (any other impl, ``DenseBackend(mesh=)``); the loss is the fleet's,
all-gathered.  Without a mesh the client axis is stacked on one device, as
the reference runs it under ``vmap``; there the port also runs
``impl="gossip"``, where the reference raises (a stated deviation).

On a ``DeviceMesh`` (``launch.steps.build_train``) the leaves are DTensors
of the ``(C, ...)`` stack, laid out by ``sharding.param_pspecs`` with the
client dimension on ``client_axis`` and each client's leaves on the mesh's
other axes (tensor-parallel on ``model``, FSDP or data-parallel ones).
With ``client_axis`` as long as the client count a rank holds one client:
its gradient is ``torch.autograd.grad`` of the loss on DTensors of the
sub-mesh of the other axes, and the dense transition gathers the local
shards' rows over the client axis and applies the rank's column
(``aggregation.dense_transition_on_mesh``; the transition is linear and
elementwise across parameters, so it runs on local shards).  With
``client_axis`` of size 1 the stack stays on the rank, the clients step one
after another, and the transition is the ``fused_transition`` kernel on the
local shards (its plain version on the CPU).  A size ``1 < n < C`` raises
``ValueError`` (a stated deviation: the reference would hold several
clients a device), and so does ``impl="gossip"``, whose collective backend
runs on a client mesh only.
"""
from __future__ import annotations

import dataclasses

import torch

from .protocol import SDFEELConfig

__all__ = ["FLSpec", "build_fl_train_step", "init_stacked"]


@dataclasses.dataclass(frozen=True)
class FLSpec:
    """Federated layout: C clients in D uniform clusters, protocol periods."""

    num_clients: int
    num_clusters: int
    tau1: int = 2
    tau2: int = 1
    alpha: int = 2
    learning_rate: float = 0.01
    impl: str = "dense"       # dense | pallas (the kernel backend) | gossip
    topology: str = "ring"

    @property
    def cluster_size(self) -> int:
        if self.num_clients % self.num_clusters:
            raise ValueError("clients must divide evenly into clusters")
        return self.num_clients // self.num_clusters

    def protocol(self) -> SDFEELConfig:
        from .protocol import ClusterSpec
        from .topology import TOPOLOGIES

        return SDFEELConfig(
            clusters=ClusterSpec.uniform(self.num_clients, self.num_clusters),
            topology=TOPOLOGIES[self.topology](self.num_clusters),
            tau1=self.tau1,
            tau2=self.tau2,
            alpha=self.alpha,
            learning_rate=self.learning_rate,
        )


def build_fl_train_step(model, opt, fl: FLSpec, event: str = "inter", mesh=None,
                        param_specs=None, microbatch: int = 1, participation: bool = False,
                        device=None, client_axis: str = "data"):
    """Returns ``train_step(params, opt_state, batch[, weights]) -> (params,
    opt_state, loss)``.

    ``params`` and ``opt_state`` carry a leading client axis of size
    ``fl.num_clients``, ``batch`` values are ``(C, per_client_batch, ...)``
    and ``loss`` is the fleet's mean loss, a 0-d device tensor.  ``event``
    fixes the Lemma-1 transition the step applies.  ``fl.impl == "gossip"``
    takes the collective backend (a ring of at least 3 clusters, as the
    reference checks); any other impl the dense one.  ``microbatch`` splits
    each client's batch into that many chunks (it must divide the batch) and
    steps on the mean of their gradients, with f32 accumulators: the same
    SGD step as one batch, in a fraction of the activation memory.  With
    ``participation=True`` the step takes a ``(C,)`` ``weights`` tensor, the
    round's intra-cluster weights, for its transition.  On a client mesh
    ``params``/``opt_state`` are the rank's ``(1, ...)`` row and ``batch``
    and ``weights`` the fleet's.  On a ``DeviceMesh`` (the module
    docstring) every operand is a DTensor of the fleet's and the loss a
    plain 0-d tensor; ``client_axis`` names the client dimension.
    ``param_specs`` (the reference's sharding of a mesh's leaves) is not
    used: the leaves carry their layout.  ``device=None`` means ``"cuda"``.
    """
    from torch.distributed.device_mesh import DeviceMesh

    from ..launch.mesh import resolve_client_mesh
    from .aggregation import fleet_mean_losses, mesh_rows
    from .backends import DenseBackend, resolve_backend
    from .device import resolve_device
    from .local_update import build_local_update, per_client_update

    if isinstance(mesh, DeviceMesh):
        return _build_on_device_mesh(model, opt, fl, event, mesh, client_axis, microbatch,
                                     participation)
    device = resolve_device(device)
    mesh = resolve_client_mesh(mesh, fl.num_clients, device=device)
    if mesh is not None:
        device = mesh.device
    proto = fl.protocol()
    if fl.impl == "gossip" and event != "local":
        if fl.topology != "ring" or fl.num_clusters < 3:
            raise ValueError("gossip impl supports ring topologies with >= 3 clusters")
        backend = resolve_backend("collective", proto.clusters, proto.P(), fl.alpha,
                                  device=device, mesh=mesh)
    elif mesh is not None:
        # a rank's row of the dense product over the gathered rows
        backend = DenseBackend(proto.clusters, proto.P(), fl.alpha, mesh=mesh)
    else:
        backend = resolve_backend("dense", proto.clusters, proto.P(), fl.alpha, device=device)

    if microbatch > 1:
        grad_and_value = torch.func.grad_and_value(model.loss)

        def client_grads(p, b):
            # gradient accumulation: the mean of the micro-gradients is the
            # gradient of the mean loss, with 1/microbatch the activations
            chunks = {k: x.reshape((microbatch, x.shape[0] // microbatch) + x.shape[1:])
                      for k, x in b.items()}
            loss = torch.zeros((), dtype=torch.float32, device=device)
            acc = {k: torch.zeros(x.shape, dtype=torch.float32, device=device)
                   for k, x in p.items()}
            for i in range(microbatch):
                g, l = grad_and_value(p, {k: x[i] for k, x in chunks.items()})
                loss = loss + l
                acc = {k: acc[k] + g[k] for k in acc}
            scale = 1.0 / microbatch
            return {k: v * scale for k, v in acc.items()}, loss * scale

        vgrads = torch.func.vmap(client_grads)
        update = per_client_update(opt)

        def local_update(params, opt_state, batch):
            grads, loss = vgrads(params, batch)
            params, opt_state = update(params, grads, opt_state)
            return params, opt_state, loss
    else:
        # one micro-batch: the shared batched stage
        local_update = build_local_update(model, opt, backend=backend)

    def train_step_p(params, opt_state, batch, weights=None):
        if mesh is not None:
            batch = mesh_rows(batch, mesh)
        params, opt_state, loss = local_update(params, opt_state, batch)
        params = backend.transition(params, event, weights=weights)
        loss = loss.mean() if mesh is None else fleet_mean_losses(loss, mesh)[0]
        return params, opt_state, loss

    def train_step(params, opt_state, batch):
        return train_step_p(params, opt_state, batch)

    return train_step_p if participation else train_step


def _client_grads(model, params: dict, batch: dict, microbatch: int):
    """(gradients, loss) of one client's DTensor leaves on ``batch``: the
    mean over ``microbatch`` equal chunks of the batch, by
    ``torch.autograd.grad`` (``torch.func`` does not take DTensors)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    names = list(leaves)
    grads, loss = None, 0.0
    for i in range(microbatch):
        chunk = {k: _chunk(x, i, microbatch) for k, x in batch.items()}
        l = model.loss(leaves, chunk)
        g = torch.autograd.grad(l, [leaves[k] for k in names])
        g = {k: gi.float() if gi.dtype != torch.float32 and microbatch > 1 else gi
             for k, gi in zip(names, g)}
        grads = g if grads is None else {k: grads[k] + g[k] for k in names}
        loss = loss + l.detach()
    if microbatch > 1:
        grads = {k: v * (1.0 / microbatch) for k, v in grads.items()}
        loss = loss * (1.0 / microbatch)
    return grads, loss


def _chunk(x, i: int, n: int):
    """The ``i``-th of ``n`` equal chunks of a (DTensor) batch leaf's local
    rows, on the same mesh and placements (each rank chunks its own rows)."""
    if n == 1:
        return x
    from torch.distributed.tensor import DTensor

    local = x.to_local()
    rows = local.shape[0] // n
    return DTensor.from_local(local[i * rows:(i + 1) * rows], x.device_mesh, x.placements,
                              run_check=False)


def _build_on_device_mesh(model, opt, fl: FLSpec, event: str, mesh, client_axis: str,
                          microbatch: int, participation: bool):
    """``build_fl_train_step`` on a ``DeviceMesh`` (the module docstring)."""
    from torch.distributed.tensor import DTensor, Shard
    from torch.utils._pytree import tree_leaves, tree_map

    from ..launch.mesh import ClientMesh, on_fake_group
    from .aggregation import fleet_mean_losses
    from .backends import CudaBackend, DenseBackend

    if fl.impl == "gossip":
        raise ValueError("impl='gossip' (the collective backend) runs on a ClientMesh; a "
                         "DeviceMesh step applies the transition as a matrix: "
                         "fused_transition on a rank's stack, or the dense product of the "
                         "gathered rows with one client a rank")
    names = list(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.mesh.shape))
    n, c = sizes[client_axis], fl.num_clients
    if n not in (1, c):
        raise ValueError(
            f"mesh axis {client_axis!r} has size {n} for {c} clients: the step holds one "
            f"client a rank (size {c}) or the whole stack on each rank (size 1); "
            f"{n} is a stated deviation from the reference, which holds {c // n} a device")
    ci = names.index(client_axis)
    rest = tuple(x for x in names if x != client_axis)
    if not rest:
        raise ValueError(f"a DeviceMesh step needs an axis beside {client_axis!r} (the model "
                         f"axis), got {tuple(names)}")
    sub = mesh[rest] if len(rest) > 1 else mesh[rest[0]]
    device = torch.device(mesh.device_type)
    if on_fake_group(mesh):
        device = torch.device("meta")  # a dry run's mesh: nothing runs
    elif device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    proto = fl.protocol()
    if n == 1:
        cmesh = None
        backend = CudaBackend(proto.clusters, proto.P(), fl.alpha, device=device)
    else:
        cmesh = ClientMesh.from_device_mesh(mesh, client_axis)
        backend = DenseBackend(proto.clusters, proto.P(), fl.alpha, mesh=cmesh)

    def row_placements(x):
        """A stacked DTensor leaf's placements without the client dimension, on
        the sub-mesh of the other axes (a dimension index one lower)."""
        pl = [p for i, p in enumerate(x.placements) if i != ci]
        return tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p for p in pl)

    def client_view(x, row):
        """Client ``row`` of a stacked DTensor leaf's local shard, as a DTensor
        on the sub-mesh of the other axes."""
        return DTensor.from_local(x.to_local()[row], sub, row_placements(x), run_check=False)

    def stacked_local(x, *rows):
        """The rank's clients' ``rows`` back in the layout of ``x``'s local
        shard (a gradient may come back Partial)."""
        pl = row_placements(x)
        return torch.stack([r.redistribute(sub, pl).to_local() for r in rows])

    def as_stacked(x, local):
        return DTensor.from_local(local.contiguous(), mesh, x.placements, run_check=False)

    def train_step_p(params, opt_state, batch, weights=None):
        first = next(iter(params.values()))
        n_local = first.to_local().shape[0]
        if any(x.ndim == 0 for x in tree_leaves(opt_state)):
            raise ValueError("a 0-d optimizer state leaf has no client axis to map over: "
                             "init the state per client (torch.func.vmap(opt.init)), as "
                             "the reference's vmap(opt.update) requires")
        new_rows, states = [], []
        losses = []
        for r in range(n_local):
            p = {k: client_view(v, r) for k, v in params.items()}
            b = {k: client_view(v, r) for k, v in batch.items()}
            grads, loss = _client_grads(model, p, b, microbatch)
            # client r's own row of every state leaf, as the reference's vmap
            new, state = opt.update(p, grads, tree_map(lambda x: client_view(x, r), opt_state))
            new_rows.append(new)
            states.append(state)
            losses.append(loss.full_tensor() if isinstance(loss, DTensor) else loss)
        local = backend.transition(
            {k: stacked_local(v, *[row[k] for row in new_rows]) for k, v in params.items()},
            event, weights=weights)
        out = {k: as_stacked(params[k], v) for k, v in local.items()}
        opt_state = tree_map(lambda x, *rs: as_stacked(x, stacked_local(x, *rs)), opt_state,
                             *states)
        losses = torch.stack(losses).float()
        loss = (losses.mean() if n == 1 else fleet_mean_losses(losses, cmesh)[0])
        return out, opt_state, loss

    def train_step(params, opt_state, batch):
        return train_step_p(params, opt_state, batch)

    return train_step_p if participation else train_step


def init_stacked(model, num_clients: int, seed, device) -> dict:
    """Identical initial model replicated on the client axis."""
    from .runtime import stacked_init

    return stacked_init(model, num_clients, seed, device)
