"""Per-cluster personalized serving: one engine, D model replicas, hot swap.

The port's ``repro.serving.federated``.  In SD-FEEL the per-cluster models
differ between inter-cluster aggregations, so every request is served by its
own cluster's model.  The ``D`` replicas live as one stacked ``(D, ...)``
parameter dict (the layout the round engine trains and
``FederationRuntime.cluster_params()`` returns):

* :class:`FederatedServer`, the static-drain engine.  Requests bucket by
  ``(cluster, padded_len)``, so a batch never mixes clusters; it runs on its
  cluster's leaves, views into the stack.
* :class:`ContinuousFederatedServer`, the slot-pool engine.  Every slot
  carries its cluster index, so slots of different clusters decode side by
  side in one program: each op that reads weights runs once a cluster over
  all slots and each slot keeps its own cluster's result (no slot gathers a
  copy of a replica).  On a cluster mesh (``mesh=``, one rank a cluster
  of the default process group) each rank holds its cluster's replica and
  the whole pool, prefills its cluster's admissions, decodes every slot on
  its replica and keeps its own slots' tokens; one collective a step (and
  an admission) gives every rank every slot's tokens, so the pool runs as
  the off-mesh one does, bit for bit.

Weights hot-swap from a live runtime through :class:`ReplicaBuffer`:
``publish`` validates the new stack and stages a copy of it, and the server
flips at a weight boundary.  The flip copies the staged tree into the
active buffer, whose tensors keep their addresses for the server's life, so
the decode chunk's CUDA graph (captured over those addresses) reads the new
weights and never memory the swap freed: one graph serves every swap.  For
the static engine the boundary is the next batch; for the continuous one
it is the first admission boundary with an empty pool: a pending publish
closes admission, in-flight slots finish on the weights they prefilled
with, the buffer flips, and admission reopens on the new weights.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from .engine import BatchServer, ContinuousServer, Request, _bucket_len

__all__ = ["FederatedServer", "ContinuousFederatedServer", "ReplicaBuffer"]


def _copy_tree(tree: dict) -> dict:
    """Own the buffers: the schedulers update their stacks in place."""
    return {k: v.detach().clone() for k, v in tree.items()}


class ReplicaBuffer:
    """The active stacked ``(D, ...)`` replica dict and a staged one (with
    ``row``, a cluster mesh rank's: that ``(1, ...)`` row of each).

    ``stage`` rejects a stack with another cluster count or non-finite
    leaves before anything changes, then keeps a copy of it; ``flip`` copies
    the staged copy into the active tensors in place.  When to flip is the
    server's policy (batch boundary or drained slot pool)."""

    def __init__(self, stack: dict, row: Optional[int] = None):
        self.num_clusters = int(next(iter(stack.values())).shape[0])
        self._row = row
        self._active = _copy_tree(self._mine(stack))
        self._staged = None
        self.swaps = 0

    def _mine(self, stack: dict) -> dict:
        """The stack, or on a cluster mesh its ``(1, ...)`` row ``row``."""
        if self._row is None:
            return stack
        return {k: v[self._row:self._row + 1] for k, v in stack.items()}

    @property
    def pending(self) -> bool:
        return self._staged is not None

    @property
    def active_stack(self) -> dict:
        return self._active

    def stage(self, stack: dict) -> None:
        d = int(next(iter(stack.values())).shape[0])
        if d != self.num_clusters:
            raise ValueError(f"published stack has {d} clusters, server has {self.num_clusters}")
        if set(stack) != set(self._active):
            raise ValueError("published stack's leaves differ from the server's")
        for name, leaf in stack.items():
            if not bool(torch.isfinite(leaf).all()):
                raise ValueError(f"published stack has non-finite values at {name!r}; "
                                 f"keeping last-good weights")
        self._staged = _copy_tree(self._mine(stack))

    def flip(self) -> bool:
        if self._staged is None:
            return False
        for k, v in self._active.items():
            v.copy_(self._staged[k])
        self._staged = None
        self.swaps += 1
        return True


class _FederatedMixin:
    """Shared publish/sync/routing surface over a :class:`ReplicaBuffer`."""

    _buf: ReplicaBuffer
    _runtime = None
    rejected = 0

    @property
    def num_clusters(self) -> int:
        return self._buf.num_clusters

    @property
    def swaps(self) -> int:
        return self._buf.swaps

    @property
    def active_params(self) -> dict:
        """The stacked dict decode is currently running against."""
        return self._buf.active_stack

    def publish(self, cluster_params: dict) -> None:
        """Stage a new stacked dict; it becomes active at the next weight
        boundary (batch for the static engine, drained slot pool for the
        continuous one).  A stack with non-finite leaves raises
        ``ValueError`` and leaves the served weights as they are."""
        self._buf.stage(cluster_params)

    def sync_from(self, runtime=None) -> bool:
        """Publish the attached (or given) runtime's current cluster models.

        Returns True on success.  If the source raises while giving its
        stack, or gives a non-finite or misshapen one, nothing is staged,
        the server keeps its last-good weights, ``rejected`` counts it and
        False is returned.  A missing runtime is a ``ValueError``."""
        rt = runtime or self._runtime
        if rt is None:
            raise ValueError("no runtime attached; pass one or construct with runtime=")
        try:
            self.publish(rt.cluster_params())
        except Exception:
            self.rejected += 1
            return False
        return True

    def _check_cluster(self, req: Request) -> None:
        if req.cluster_id is None:
            raise ValueError("federated serving requests must carry a cluster_id")
        if not 0 <= req.cluster_id < self.num_clusters:
            raise ValueError(f"cluster_id {req.cluster_id} out of range [0, {self.num_clusters})")

    @staticmethod
    def _resolve_stack(cluster_params, runtime) -> dict:
        if cluster_params is None:
            if runtime is None:
                raise ValueError("need cluster_params or a runtime to pull them from")
            cluster_params = runtime.cluster_params()
        return cluster_params


class FederatedServer(_FederatedMixin, BatchServer):
    """Static-drain serving over stacked per-cluster replicas.

    ``cluster_params`` is a dict whose leaves carry a leading ``(D, ...)``
    cluster axis, or pass ``runtime=`` and the stack is pulled from it;
    ``sync_from()`` then republishes at round boundaries."""

    def __init__(self, model, cluster_params=None, *, runtime=None, max_batch: int = 8,
                 length_buckets: tuple[int, ...] = (32, 64, 128), temperature: float = 0.0,
                 seed: int = 0, cache_len=None, reorder_window=None, max_head_skips: int = 4,
                 graph=None):
        cluster_params = self._resolve_stack(cluster_params, runtime)
        self._buf = ReplicaBuffer(cluster_params)
        super().__init__(model, self._buf.active_stack, max_batch=max_batch,
                         length_buckets=length_buckets, temperature=temperature, seed=seed,
                         cache_len=cache_len, reorder_window=reorder_window,
                         max_head_skips=max_head_skips, graph=graph)
        self._runtime = runtime
        self.rejected = 0

    def _begin_batch(self, batch) -> None:
        self._buf.flip()

    # -- routing -------------------------------------------------------------
    def submit(self, req: Request):
        self._check_cluster(req)
        super().submit(req)

    def _batch_key(self, req: Request):
        return (req.cluster_id, _bucket_len(req.prompt.shape[-1], self.buckets))

    def _batch_params(self, batch) -> dict:
        d = batch[0].cluster_id
        return {k: w[d] for k, w in self._buf.active_stack.items()}


class ContinuousFederatedServer(_FederatedMixin, ContinuousServer):
    """Continuous slot-pool serving over stacked per-cluster replicas.

    Slots are cluster-heterogeneous: one decode program serves any cluster
    mix the Zipf trace produces.  A pending publish closes admission,
    in-flight slots drain on their prefill-time weights, and the buffer
    flips at the first admission boundary with an empty pool.

    ``mesh`` (None, ``"auto"`` or a ``launch.mesh.ClientMesh`` of D ranks,
    resolved by ``launch.mesh.resolve_cluster_mesh`` on ``mesh_axis``) puts
    one replica a rank: rank ``d`` keeps row ``d`` of the stack (the
    ``(1, ...)`` row of ``sharding.replica_pspecs``), and ``publish`` stages
    each rank's row of the new stack, which every rank checks whole so
    that all decide alike.  Every rank runs the same slot loop on the same
    requests; see the module docstring.  ``graph`` resolves by the rank's
    device, as off the mesh: on a CUDA rank the decode chunk replays from a
    CUDA graph with its token all-reduce captured inside, and every rank
    warms up, captures and replays at the same calls (its pool and replica
    row are allocated once, alike on every rank, so its chunk's key never
    changes); prefill and admission stay eager."""

    _stacked = True

    def __init__(self, model, cluster_params=None, *, runtime=None, mesh=None,
                 mesh_axis: str = "cluster", max_batch: int = 8,
                 length_buckets: tuple[int, ...] = (32, 64, 128), gen_cap: int = 64,
                 chunk_steps: int = 8, temperature: float = 0.0, seed: int = 0,
                 graph=None):
        from ..launch.mesh import resolve_cluster_mesh

        cluster_params = self._resolve_stack(cluster_params, runtime)
        num_clusters = int(next(iter(cluster_params.values())).shape[0])
        device = next(iter(cluster_params.values())).device
        self.mesh = resolve_cluster_mesh(mesh, num_clusters, mesh_axis, device=device)
        share = own = None
        if self.mesh is not None:
            own = self.mesh.index
            share = functools.partial(_share_tokens, group=self.mesh.group)
        self._buf = ReplicaBuffer(cluster_params, row=own)
        super().__init__(model, None, max_batch=max_batch, length_buckets=length_buckets,
                         gen_cap=gen_cap, chunk_steps=chunk_steps, temperature=temperature,
                         seed=seed, graph=graph, share=share, own=own)
        self._runtime = runtime
        self.rejected = 0

    # -- weight hooks ---------------------------------------------------------
    def _weights(self):
        return self._buf.active_stack

    def _cluster_index(self, req: Request):
        return req.cluster_id

    def _admission_open(self) -> bool:
        # a pending publish closes admission: in-flight slots drain on the
        # weights they prefilled with, new requests wait for the flip
        return not self._buf.pending

    def _at_admission_boundary(self) -> None:
        if self._buf.pending and not self._occupied:
            self._buf.flip()

    def _prefills(self, req: Request) -> bool:
        return self.mesh is None or req.cluster_id == self.mesh.index

    def _replica(self, d):
        return d if self.mesh is None else 0

    def submit(self, req: Request):
        self._check_cluster(req)
        super().submit(req)


def _share_tokens(tok: torch.Tensor, mine: torch.Tensor, *, group) -> torch.Tensor:
    """Every rank's ``tok`` where it is ``mine`` there: each slot is one
    rank's, whose token the others take (a sum over ranks of the tokens
    each keeps, zeros elsewhere; one all-reduce)."""
    import torch.distributed as dist

    out = torch.where(mine, tok, torch.zeros_like(tok))
    dist.all_reduce(out, group=group)
    return out
