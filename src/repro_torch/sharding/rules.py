"""Per-architecture partition specs for the production meshes.

The port's ``repro.sharding.rules``: Megatron-style tensor parallelism on the
``model`` axis inside every client replica; the federated client axis lives
on ``data`` (and each client's batch is data-parallel over ``pod`` when
present).

Rules (leaf-name driven, applied to the core shape; the scan-block leading
dim and the FL client stacking dim are prepended as None / client axis)::

  embed (V, d)            -> ("model", None)      vocab-sharded
  head  (d, V)            -> (None, "model")
  attn wq / wo            -> head-sharded iff num_heads % model_size == 0,
                             else replicated (gemma2's 8 heads vs 16-way axis)
  attn wk / wv            -> replicated (kv_heads < model_size in every
                             assigned config; KV projections are small)
  mlp w_gate/w_up (d, f)  -> (None, "model");  w_down (f, d) -> ("model", None)
  moe  w_gate/w_up(E,d,f) -> (None, None, "model"); w_down -> (None,"model",None)
  moe  w_router           -> replicated
  mamba w_z/w_x (d, di)   -> (None, "model");  out_proj (di, d) -> ("model", None)
  mamba conv_x/bias_x/norm_scale (di dim) -> ("model",)
  mamba w_b/w_c/w_dt, A_log/D/dt_bias, small convs -> replicated
  norms                    -> replicated

Divisibility is checked before sharding a dimension; a dimension that does
not divide falls back to replication.

The trees are the port's: flat dicts under dotted names
(``convert.flatten_params``), whose leaves need only a ``.shape``; pass
``CausalLM.param_shapes()`` (meta-device tensors) to get the specs of a
published width without allocating it.  A spec is a :class:`Spec`, a plain
tuple with one entry a dimension: a mesh-axis name, a tuple of names, or
``None``.  ``to_placements`` maps a spec onto a
``torch.distributed.device_mesh.DeviceMesh`` as DTensor placements, and
``distribute_params`` lays a tree out with ``distribute_tensor``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..models.config import ArchConfig

__all__ = ["MeshAxes", "Spec", "param_pspecs", "batch_pspecs", "cache_pspecs",
           "replica_pspecs", "describe_sharding", "to_placements", "distribute_params"]


class Spec(tuple):
    """A partition spec: per dimension a mesh-axis name, a tuple of names,
    or ``None`` (replicated), as the reference's ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    model: str = "model"
    data: str = "data"
    pod: Optional[str] = None           # present on the multi-pod mesh
    model_size: int = 16

    @property
    def batch_axes(self) -> tuple:
        return (self.pod, self.data) if self.pod else (self.data,)


def _divisible(dim: int, size: int) -> bool:
    return dim % size == 0


def _core_spec(path_names: list[str], shape: tuple[int, ...], cfg: ArchConfig,
               ax: MeshAxes) -> Spec:
    """The spec of a core (unstacked) parameter leaf (full rank)."""
    name = path_names[-1]
    ms = ax.model_size
    m = ax.model
    nd = len(shape)
    rep = Spec(*([None] * nd))

    def shard_dim(i):
        spec = [None] * nd
        spec[i] = m
        return Spec(*spec)

    def shard_last():
        return shard_dim(nd - 1)

    heads_shardable = cfg.num_heads and _divisible(cfg.num_heads, ms)

    if name == "embed":
        if nd == 3:   # audio: (K, V, d)
            return shard_dim(1) if _divisible(shape[1], ms) else rep
        return shard_dim(0) if _divisible(shape[0], ms) else rep
    if name == "head":
        if nd == 3:   # audio: (K, d, V)
            return shard_dim(2) if _divisible(shape[2], ms) else rep
        return shard_dim(1) if _divisible(shape[1], ms) else rep
    if name in ("wq", "bq"):
        return shard_last() if heads_shardable else rep
    if name == "wo":
        return shard_dim(0) if heads_shardable else rep
    if name in ("wk", "wv", "bk", "bv", "w_router"):
        return rep
    if name in ("w_gate", "w_up"):
        return shard_last() if _divisible(shape[-1], ms) else rep
    if name == "w_down":
        i = nd - 2  # (f, d) or (E, f, d)
        return shard_dim(i) if _divisible(shape[i], ms) else rep
    if name in ("w_z", "w_x"):
        return shard_dim(1) if _divisible(shape[1], ms) else rep
    if name == "out_proj":
        return shard_dim(0) if _divisible(shape[0], ms) else rep
    if name in ("conv_x", "bias_x", "norm_scale"):
        return shard_last() if _divisible(shape[-1], ms) else rep
    # w_b/w_c/w_dt, conv_b/c, bias_b/c, A_log, D, dt_bias, ln_* -> replicated
    return rep


def param_pspecs(cfg: ArchConfig, params_shape: dict, ax: MeshAxes,
                 client_axis: Optional[str] = None,
                 fsdp_axis: Optional[str] = None, fsdp_size: int = 1) -> dict:
    """Specs of a parameter tree (pass ``CausalLM.param_shapes()``).

    ``client_axis``: prepend a federated client dim sharded on this axis
    (params stacked ``(C, ...)``), the FL train step's layout.
    ``fsdp_axis``: additionally shard each leaf's first free (not
    model-sharded, divisible) dimension on this axis, the FSDP-within-cluster
    variant for the largest members (grok, jamba).
    """

    def one(name, leaf):
        names = name.split(".")
        shape = tuple(leaf.shape)
        core_shape = shape
        prefix: list = []
        if client_axis:
            prefix.append(client_axis)
            core_shape = core_shape[1:]
        if "blocks" in names:
            prefix.append(None)  # scan-stack dim
            core_shape = core_shape[1:]
        core = _core_spec(names, core_shape, cfg, ax)
        if fsdp_axis and core_shape:
            entries = list(core)
            for i, (dim, sp) in enumerate(zip(core_shape, entries)):
                if sp is None and dim % fsdp_size == 0 and dim >= fsdp_size:
                    entries[i] = fsdp_axis
                    break
            core = Spec(*entries)
        return Spec(*prefix, *core)

    return {k: one(k, v) for k, v in params_shape.items()}


def replica_pspecs(stack: dict, axis: str) -> dict:
    """Specs sharding a stacked ``(D, ...)`` replica tree on its leading axis.

    The serving path's layout: per-cluster model replicas one per ``axis``
    index, everything inside a replica replicated.  For tensor-parallel
    replicas compose with :func:`param_pspecs` via ``client_axis=axis``
    instead, the training path's layout, so both sides agree.
    """
    return {k: Spec(axis, *([None] * (len(v.shape) - 1))) for k, v in stack.items()}


def batch_pspecs(cfg: ArchConfig, batch_shape: dict, ax: MeshAxes,
                 step: str, federated: bool = False, batch_div: int = 1) -> dict:
    """Specs for a step's data inputs (see ``configs.shapes.input_specs``).

    ``batch_div``: the product of the batch-axis sizes (a batch dim that
    does not divide is replicated, as long_500k's batch of 1)."""
    batch_spec = ax.batch_axes if len(ax.batch_axes) > 1 else ax.batch_axes[0]

    def one(name, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        if name.split(".")[-1] == "pos":
            return Spec()
        if step == "train" and federated:
            # leading client dim -> data; per-client batch dim -> pod
            return Spec(ax.data, ax.pod, *([None] * (nd - 2)))
        if shape and shape[0] % max(batch_div, 1) == 0:
            return Spec(batch_spec, *([None] * (nd - 1)))
        return Spec(*([None] * nd))

    return {k: one(k, v) for k, v in batch_shape.items()}


def cache_pspecs(cfg: ArchConfig, cache_shape: dict, ax: MeshAxes,
                 seq_axes: tuple, batch_axes: tuple) -> dict:
    """Specs for decode caches (``CausalLM.init_cache``'s layout).

    KV leaves: ``posI.k``/``posI.v`` (nblocks, B, Sc, Hkv, hd), ``posI.pos``
    (nblocks, Sc).  Mamba leaves: ``ssm`` (nblocks, B, H, N, P), ``conv_*``
    (nblocks, B, W-1, ch).  ``seq_axes`` shard the cache's sequence dim,
    ``batch_axes`` its batch dim.
    """
    seq_spec = seq_axes[0] if len(seq_axes) == 1 else (tuple(seq_axes) or None)
    batch_spec = batch_axes[0] if len(batch_axes) == 1 else (tuple(batch_axes) or None)

    def one(key, leaf):
        name = key.split(".")[-1]
        shape = tuple(leaf.shape)
        if name == "pos":
            return Spec(None, seq_spec)
        if name in ("k", "v"):
            return Spec(None, batch_spec, seq_spec, None, None)
        if name == "ssm":
            # shard SSD heads on model if divisible
            hspec = ax.model if _divisible(shape[2], ax.model_size) else None
            return Spec(None, batch_spec, hspec, None, None)
        if name.startswith("conv"):
            chspec = ax.model if _divisible(shape[-1], ax.model_size) else None
            return Spec(None, batch_spec, None, chspec)
        return Spec()

    return {k: one(k, v) for k, v in cache_shape.items()}


def describe_sharding(cfg: ArchConfig, specs: dict) -> dict:
    """Summary counts: how many leaves are sharded vs replicated."""
    total = len(specs)
    sharded = sum(1 for s in specs.values() if any(a is not None for a in s))
    return {"leaves": total, "model_sharded": sharded, "replicated": total - sharded}


def to_placements(spec: Spec, device_mesh) -> tuple:
    """DTensor placements of ``spec`` on ``device_mesh``: ``Shard(i)`` on each
    mesh dimension that tensor dimension ``i`` names, ``Replicate()`` on the
    others (an axis of the spec that the mesh lacks is not sharded)."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis in device_mesh.mesh_dim_names:
        dims = [i for i, e in enumerate(spec)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def distribute_params(params: dict, specs: dict, device_mesh) -> dict:
    """Lay ``params`` out on ``device_mesh`` by ``specs``, as DTensors (every
    rank passes the same full tensors)."""
    from torch.distributed.tensor import distribute_tensor

    return {k: distribute_tensor(v, device_mesh, to_placements(specs[k], device_mesh))
            for k, v in params.items()}
