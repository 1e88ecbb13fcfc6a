"""Aggregation operators: the Lemma-1 transition, dense and structured.

Two forms of ``W <- W @ T_k`` on a dict of client-stacked ``(C, ...)``
tensors:

* ``dense``: ``apply_transition_dense``, one product against the ``C x C``
  transition matrix (``V B`` or ``V P^alpha B``), and
  ``dense_gossip_reference``, the eq. 4 oracle on ``(D, ...)`` cluster
  models.
* ``gossip``: the reference's collective form, written for one device that
  holds the whole stacked client axis:

  - intra-cluster aggregation is the weighted hypercube all-reduce
    (``hypercube_cluster_allreduce``), log2(g) exchanges with the partner
    ``i ^ step`` inside each contiguous group of ``g`` clients;
  - inter-cluster aggregation is ``alpha`` rounds of ring gossip
    (``ring_gossip``), each an exchange with the neighbours ``cluster_size``
    clients to the left and to the right.

  The reference runs each exchange as a ``lax.ppermute`` over a mesh axis,
  or, without a mesh, under ``vmap(axis_name=...)``, which lowers it to a
  gather along the client axis.  Here each exchange is that gather: a fixed
  permutation of dim 0 (``index_select`` for the hypercube, ``roll`` for the
  ring), with the reference's arithmetic: ``x * weight`` promotes a bf16
  leaf to f32, each gossip round is ``wl * left + ws * y + wr * right`` in
  f32, and the caller casts back to the leaf's dtype once.

On a client mesh (``launch.mesh.ClientMesh``, one client a rank of a
``torch.distributed`` process group) the same arithmetic runs per rank, as
the reference's runs per device under ``shard_map``: every ``lax.ppermute``
is ``ppermute``, one batch of point-to-point messages
(``dist.batch_isend_irecv``) in which each rank sends to its destination and
receives from its source.  ``hypercube_allreduce_on_mesh`` and
``ring_gossip_on_mesh`` take this rank's ``(1, ...)`` row, leaf by leaf.
The consensus is ``fleet_weighted_sum`` (an all-reduce of ``m_i x_i``), the
cluster models ``cluster_sums_on_mesh``; ``gather_rows_to_host`` brings the
rows to one rank's host for a checkpoint, and ``gather_rows`` all-gathers
them into the ``(C, ...)`` stack on every rank.  The dense transition on a
mesh is ``dense_transition_on_mesh``: the rows gathered, then this rank's
column of the Lemma-1 matrix applied, as XLA's gather does for the
reference's dense step on a sharded client axis.  A mesh's peers are named
by their global rank, so it may span any group (a ``DeviceMesh``'s ``data``
dimension among them).

``backends.CollectiveBackend`` is the scheduler-facing interface over the
gossip form, ``DenseBackend`` over the dense one.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "apply_transition_dense",
    "dense_gossip_reference",
    "stack_clients",
    "unstack_clients",
    "hypercube_cluster_allreduce",
    "ring_gossip",
    "ring_mixing_weights",
    "ppermute",
    "hypercube_allreduce_on_mesh",
    "ring_gossip_on_mesh",
    "gather_rows",
    "dense_transition_on_mesh",
    "fleet_weighted_sum",
    "cluster_sums_on_mesh",
    "gather_rows_to_host",
    "mesh_rows",
    "own_rows",
    "fleet_mean_losses",
]


def stack_clients(trees: list[dict]) -> dict:
    """[tree_0 .. tree_{C-1}] -> dict of tensors with a leading client axis."""
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def unstack_clients(stacked: dict, num_clients: int) -> list[dict]:
    return [{k: v[i] for k, v in stacked.items()} for i in range(num_clients)]


def apply_transition_dense(stacked: dict, t_matrix: torch.Tensor) -> dict:
    """W <- W @ T_k on a (C, ...) stacked dict (paper Lemma 1).

    ``t_matrix[j, d]`` is the weight of client j's model in client d's new
    model; the parameters' dtype is preserved (mixing in f32)."""
    t = t_matrix.float()
    return {
        k: torch.tensordot(t, w.float(), dims=([0], [0])).to(w.dtype)
        for k, w in stacked.items()
    }


def dense_gossip_reference(cluster_models: dict, p_matrix: torch.Tensor, alpha: int) -> dict:
    """Y <- Y @ P^alpha on (D, ...) cluster-stacked models (eq. 4 oracle)."""
    p_a = torch.linalg.matrix_power(p_matrix.float(), alpha)
    return apply_transition_dense(cluster_models, p_a)


# --------------------------------------------------------------------------
# Structured collective form, on the stacked client axis
# --------------------------------------------------------------------------

def _rows(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A ``(C,)`` vector shaped to broadcast over ``like``'s rows."""
    return v.view((v.shape[0],) + (1,) * (like.dim() - 1))


def _check_hypercube(cluster_size: int, axis_size: int) -> None:
    if cluster_size < 1 or (cluster_size & (cluster_size - 1)):
        raise ValueError(
            f"cluster_size={cluster_size} must be a power of two for the "
            f"hypercube all-reduce (XOR partners); use the dense backend for "
            f"other cluster sizes (backend='auto' falls back automatically)"
        )
    if axis_size % cluster_size:
        raise ValueError(
            f"cluster_size={cluster_size} must divide axis_size={axis_size}"
        )


def hypercube_cluster_allreduce(x: torch.Tensor, cluster_size: int,
                                weight: torch.Tensor) -> torch.Tensor:
    """Weighted all-reduce within contiguous groups of ``cluster_size`` rows.

    Intra-cluster aggregation (eq. 2-3): every row of a cluster ends up with
    ``sum_{i in cluster} weight_i * x_i`` (``weight_i = m^_i``, a ``(C,)``
    f32 tensor), in f32.  ``cluster_size`` must be a power of two and divide
    the row count; row ``i`` belongs to cluster ``i // cluster_size``, so the
    XOR partners never cross a cluster.  Each of the log2(g) steps adds the
    partner's partial sum, ``acc + acc[i ^ step]``, as the reference's
    ``acc + ppermute(acc)``.
    """
    axis_size = x.shape[0]
    _check_hypercube(cluster_size, axis_size)
    acc = x * _rows(weight, x)
    idx = torch.arange(axis_size, device=x.device)
    step = 1
    while step < cluster_size:
        acc = acc.add_(torch.index_select(acc, 0, idx ^ step))
        step <<= 1
    return acc


def _scaled_roll(y: torch.Tensor, shift: int, w: torch.Tensor) -> torch.Tensor:
    """``roll(y, shift, 0) * w``, in the roll's own memory where the product
    keeps its dtype (the same rounding, one leaf-sized copy fewer)."""
    r = torch.roll(y, shift, 0)
    return r.mul_(w) if torch.promote_types(r.dtype, w.dtype) == r.dtype else r * w


def ring_gossip(y: torch.Tensor, cluster_size: int, w_left: torch.Tensor,
                w_self: torch.Tensor, w_right: torch.Tensor, alpha: int) -> torch.Tensor:
    """``alpha`` rounds of ring gossip (eq. 4 with a ring topology).

    Each row holds its cluster's aggregated model ``y`` (identical within a
    cluster after ``hypercube_cluster_allreduce``).  One round::

        y_d <- w_left[d] * y_{d-1} + w_self[d] * y_d + w_right[d] * y_{d+1}

    with the neighbours ``cluster_size`` rows away on either side.  ``w_*``
    are the per-cluster ``(D,)`` columns of the eq-(5) mixing matrix, f32
    tensors on ``y``'s device.  Every round is computed in f32 and rounded to
    ``y``'s dtype (f32 after the all-reduce); the caller casts to the leaf's
    dtype.
    """
    axis_size = y.shape[0]
    if axis_size // cluster_size < 2:
        raise ValueError("ring gossip needs >= 2 clusters")
    cluster = torch.arange(axis_size, device=y.device) // cluster_size
    wl, ws, wr = (_rows(w[cluster], y) for w in (w_left, w_self, w_right))
    for _ in range(alpha):
        # receive from the left: row i gets row i - cluster_size (a roll by
        # +cluster_size); from the right: row i + cluster_size.  The f32
        # weights promote each product, so a bf16 y is rounded once a round
        out = _scaled_roll(y, cluster_size, wl)
        out.add_(ws * y)
        y = out.add_(_scaled_roll(y, -cluster_size, wr)).to(y.dtype)
    return y


def ring_mixing_weights(p_matrix: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Extract (w_left, w_self, w_right) columns from a ring mixing matrix.

    For cluster d the eq-(4) update uses column d of P: contributions from
    d-1 (left), d (self) and d+1 (right).  Raises if P has support off the
    ring stencil.
    """
    d = p_matrix.shape[0]
    w_left = np.zeros(d)
    w_self = np.zeros(d)
    w_right = np.zeros(d)
    stencil = np.zeros_like(p_matrix, dtype=bool)
    for col in range(d):
        left, right = (col - 1) % d, (col + 1) % d
        w_left[col] = p_matrix[left, col]
        w_self[col] = p_matrix[col, col]
        w_right[col] = p_matrix[right, col]
        stencil[[left, col, right], col] = True
    if np.any(np.abs(np.where(stencil, 0.0, p_matrix)) > 1e-12):
        raise ValueError("mixing matrix has support outside the ring stencil")
    return w_left, w_self, w_right


# --------------------------------------------------------------------------
# The same form on a client mesh: one client a rank, point-to-point messages
# --------------------------------------------------------------------------

def _global(mesh, rank: int) -> int:
    """The global rank of ``mesh``'s ``rank``-th member: ``torch.distributed``
    names a peer by its rank in the default group, whatever group a message
    goes through (a mesh over a subgroup, as a ``DeviceMesh``'s ``data``
    dimension, has members whose ranks differ from their index)."""
    import torch.distributed as dist

    return dist.get_global_rank(mesh.group, rank)


def _exchange(mesh, pairs: list) -> list:
    """One output per ``(tensor, perm)`` of ``pairs``, where ``perm`` lists
    ``(source, destination)`` ranks, with all of their messages in one
    ``batch_isend_irecv``.  A rank that is its own partner copies; a rank
    that no pair names as a destination gets zeros, as ``lax.ppermute``
    gives."""
    import torch.distributed as dist

    me, group = mesh.index, mesh.group
    ops, outs = [], []
    for x, perm in pairs:
        x = x.contiguous()
        out = None
        for src, dst in perm:
            if src == me and dst == me:
                out = x.clone()
            elif src == me:
                ops.append(dist.P2POp(dist.isend, x, _global(mesh, dst), group))
            elif dst == me:
                out = torch.empty_like(x)
                ops.append(dist.P2POp(dist.irecv, out, _global(mesh, src), group))
        outs.append(torch.zeros_like(x) if out is None else out)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return outs


def ppermute(x, mesh, perm):
    """``lax.ppermute`` over a client mesh: rank ``dst`` receives rank ``src``'s
    ``x`` for every ``(src, dst)`` pair of ``perm``.

    ``x`` is a tensor or a dict of tensors (a tree: one batch of messages for
    all of its leaves).  Each rank sends to its destination and receives from
    its source in one ``dist.batch_isend_irecv``; a rank that is its own
    partner copies.
    """
    perm = [(int(s), int(d)) for s, d in perm]
    if isinstance(x, torch.Tensor):
        return _exchange(mesh, [(x, perm)])[0]
    return dict(zip(x, _exchange(mesh, [(v, perm) for v in x.values()])))


def hypercube_allreduce_on_mesh(x: torch.Tensor, mesh, cluster_size: int,
                                weight: torch.Tensor) -> torch.Tensor:
    """Weighted all-reduce within contiguous groups of ``cluster_size`` ranks.

    The reference's per-device ``hypercube_cluster_allreduce``: ``x`` is this
    rank's model (any shape), ``weight`` its 0-d f32 ``m^_i``; ``acc = x *
    weight`` in f32, then log2(g) exchanges with the partner ``i ^ step``,
    each adding the partner's partial sum.  Every rank of a cluster ends up
    with ``sum_{i in cluster} m^_i x_i``, in f32.
    """
    axis_size = mesh.size
    _check_hypercube(cluster_size, axis_size)
    # JAX promotes a bf16 model by the f32 weight; torch would keep the
    # dimensioned operand's dtype, so the promotion is written out
    acc = x.to(torch.promote_types(x.dtype, weight.dtype)) * weight
    step = 1
    while step < cluster_size:
        acc = acc + ppermute(acc, mesh, [(i, i ^ step) for i in range(axis_size)])
        step <<= 1
    return acc


def ring_gossip_on_mesh(y: torch.Tensor, mesh, cluster_size: int, w_left: torch.Tensor,
                        w_self: torch.Tensor, w_right: torch.Tensor, alpha: int) -> torch.Tensor:
    """``alpha`` rounds of ring gossip, the reference's per-device ``ring_gossip``.

    ``y`` is this rank's cluster model (the same on every rank of a cluster
    after the all-reduce); ``w_*`` are the ``(D,)`` columns of the eq-(5)
    mixing matrix, of which this rank reads its cluster's entries.  One round
    receives the models ``cluster_size`` ranks to the left and to the right
    (both exchanges in one batch of messages) and forms ``wl * left + ws * y
    + wr * right`` in f32, rounded to ``y``'s dtype.
    """
    axis_size = mesh.size
    if axis_size // cluster_size < 2:
        raise ValueError("ring gossip needs >= 2 clusters")
    cluster = mesh.index // cluster_size
    wl, ws, wr = w_left[cluster], w_self[cluster], w_right[cluster]
    ct = torch.promote_types(y.dtype, wl.dtype)  # as above: JAX's promotion
    from_left = [((i - cluster_size) % axis_size, i) for i in range(axis_size)]
    from_right = [((i + cluster_size) % axis_size, i) for i in range(axis_size)]
    for _ in range(alpha):
        left, right = _exchange(mesh, [(y, from_left), (y, from_right)])
        y = (wl * left.to(ct) + ws * y.to(ct) + wr * right.to(ct)).to(y.dtype)
    return y


def gather_rows(tree: dict, mesh, out: dict | None = None) -> dict:
    """Every rank's ``(1, ...)`` rows all-gathered into the ``(C, ...)`` stack,
    in rank order, on every rank: into ``out``'s tensors when given (an
    offload store's buffer, which every rank holds already), else new ones.
    Every rank then holds the whole fleet: the schedulers' reductions use
    ``fleet_weighted_sum`` and ``cluster_sums_on_mesh``, checkpoints
    ``gather_rows_to_host``."""
    import torch.distributed as dist

    out = {} if out is None else out
    for k, v in tree.items():
        if k not in out:
            out[k] = torch.empty((mesh.size,) + tuple(v.shape[1:]), dtype=v.dtype,
                                 device=v.device)
        dist.all_gather(list(out[k].split(1)), v.contiguous(), group=mesh.group)
    return out


def dense_transition_on_mesh(row: dict, mesh, t_matrix: torch.Tensor) -> dict:
    """``W <- W @ T`` on a client mesh: this rank's ``(1, ...)`` row of the
    result, ``sum_j T[j, index] W_j``, leaf by leaf.  Each leaf's rows are
    all-gathered into the ``(C, ...)`` stack and mixed in f32 by this rank's
    column of the ``(C, C)`` matrix, then cast to the leaf's dtype, the
    arithmetic of ``apply_transition_dense`` for one output row."""
    col = t_matrix.float()[:, mesh.index:mesh.index + 1]
    out = {}
    for k, v in row.items():
        stack = gather_rows({k: v}, mesh)[k]
        out[k] = torch.tensordot(col, stack.float(), dims=([0], [0])).to(v.dtype)
    return out


def fleet_weighted_sum(tree: dict, mesh, weights: torch.Tensor) -> dict:
    """``sum_i w_i x_i`` over the ranks' ``(1, ...)`` rows, in f32, the same on
    every rank: each rank scales its row by its own entry of the ``(C,)``
    ``weights`` and the products are all-reduced, leaf by leaf, so a rank
    holds one model beside its row, never the fleet."""
    import torch.distributed as dist

    w = weights[mesh.index].float()
    out = {}
    for k, v in tree.items():
        acc = v[0].float() * w
        dist.all_reduce(acc, group=mesh.group)
        out[k] = acc
    return out


def cluster_sums_on_mesh(tree: dict, mesh, cluster_size: int, weights: torch.Tensor) -> dict:
    """The ``(D, ...)`` stack of ``sum_{i in d} w_i x_i``, in f32, on every rank:
    the hypercube all-reduce within each cluster, then each cluster's first
    rank broadcasts its sum, leaf by leaf."""
    import torch.distributed as dist

    d_count = mesh.size // cluster_size
    own = mesh.index // cluster_size
    w = weights[mesh.index].float()
    out = {}
    for k, v in tree.items():
        y = hypercube_allreduce_on_mesh(v[0], mesh, cluster_size, w)
        stack = torch.empty((d_count,) + tuple(y.shape), dtype=y.dtype, device=y.device)
        for d in range(d_count):
            if d == own:
                stack[d].copy_(y)
            dist.broadcast(stack[d], src=_global(mesh, d * cluster_size), group=mesh.group)
        out[k] = stack
    return out


def gather_rows_to_host(tree: dict, mesh, dst: int = 0) -> dict | None:
    """The ``(C, ...)`` stack of the ranks' rows on rank ``dst``'s host, in the
    rows' dtype, leaf by leaf (None on the other ranks): each rank sends its
    row and ``dst`` receives them one at a time into one device buffer, so
    no device holds more than a leaf's row beside its own (for a
    checkpoint)."""
    import torch.distributed as dist

    out = {} if mesh.index == dst else None
    for k, v in tree.items():
        v = v.contiguous()
        if out is None:
            dist.send(v, _global(mesh, dst), group=mesh.group)
            continue
        host = torch.empty((mesh.size,) + tuple(v.shape[1:]), dtype=v.dtype, device="cpu")
        host[dst].copy_(v[0])
        buf = torch.empty_like(v)
        for r in range(mesh.size):
            if r != dst:
                dist.recv(buf, _global(mesh, r), group=mesh.group)
                host[r].copy_(buf[0])
        out[k] = host
    return out


def mesh_rows(tree: dict, mesh, dim: int = 0) -> dict:
    """This rank's client of a stacked tree: ``[index:index + 1]`` along
    ``dim`` (a view)."""
    i = mesh.index
    return {k: v.narrow(dim, i, 1) for k, v in tree.items()}


def own_rows(tree: dict, mesh) -> dict:
    """The ``(C, ...)`` tree as a rank holds it: its rows, copied, on a mesh;
    the tree itself without one (``mesh=None``)."""
    if mesh is None:
        return tree
    return {k: v.clone() for k, v in mesh_rows(tree, mesh).items()}


def fleet_mean_losses(local: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's ``(n,)`` losses of ``n`` iterations -> the fleet's mean loss
    of each iteration, ``(n,)``, the same on every rank: gathered to ``(C,
    n)``, each iteration's ``(C,)`` column averaged as one process averages
    its ``(C,)`` client losses."""
    fleet = gather_rows({"l": local[None]}, mesh)["l"].T.contiguous()
    return torch.stack([row.mean() for row in fleet])
