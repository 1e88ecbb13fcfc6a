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

The reference lowers this step under ``shard_map`` with one client a device
of its ``data`` mesh axis.  ``mesh`` takes what
``launch.mesh.resolve_client_mesh`` takes.  On a client mesh (one client a
rank of a process group) ``params`` and ``opt_state`` are this rank's ``(1,
...)`` row, the step takes the rank's row of the fleet's batch and the
collective backend exchanges with the other ranks; the loss is the fleet's,
all-gathered.  Without a mesh the client axis is stacked on one device, as
the reference runs it under ``vmap``; there the port also runs
``impl="gossip"``, where the reference raises (a stated deviation).
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
                        device=None):
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
    (``impl="gossip"`` only) ``params``/``opt_state`` are the rank's ``(1,
    ...)`` row and ``batch`` and ``weights`` the fleet's.  ``param_specs``
    (the reference's sharding of a mesh's leaves) is not used: a rank holds
    its client whole.  ``device=None`` means ``"cuda"``.
    """
    from ..launch.mesh import resolve_client_mesh
    from .aggregation import fleet_mean_losses, mesh_rows
    from .backends import resolve_backend
    from .device import resolve_device
    from .local_update import build_local_update

    device = resolve_device(device)
    mesh = resolve_client_mesh(mesh, fl.num_clients, device=device)
    if mesh is not None:
        device = mesh.device
        if fl.impl != "gossip":
            raise ValueError(f"impl={fl.impl!r} on a client mesh: a rank holds one client, "
                             f"so the step runs impl='gossip' (the collective backend)")
    proto = fl.protocol()
    if fl.impl == "gossip" and event != "local":
        if fl.topology != "ring" or fl.num_clusters < 3:
            raise ValueError("gossip impl supports ring topologies with >= 3 clusters")
        backend = resolve_backend("collective", proto.clusters, proto.P(), fl.alpha,
                                  device=device, mesh=mesh)
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

        def local_update(params, opt_state, batch):
            grads, loss = vgrads(params, batch)
            params, opt_state = opt.update(params, grads, opt_state)
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


def init_stacked(model, num_clients: int, seed, device) -> dict:
    """Identical initial model replicated on the client axis."""
    from .runtime import stacked_init

    return stacked_init(model, num_clients, seed, device)
