"""Step builders: the train, prefill and serve steps on a ``DeviceMesh``.

The port's ``repro.launch.steps``.  Each builder returns ``(step_fn,
abstract_args)``: ``abstract_args`` are meta-device tensors
(``CausalLM.param_shapes()``, ``configs.shapes.input_specs``, a meta
``init_cache``), so a caller can build a step and size its operands without
allocating them.  A step takes its operands as DTensors laid out by
``sharding.param_pspecs``, ``batch_pspecs`` and ``cache_pspecs`` on the mesh
(the reference's ``in_shardings``; a plain tensor, the same full tensor on
every rank, is laid out on the way in by ``sharding.distribute_params``)
and runs the model under ``sharding.activation_sharding`` as the
reference does.  The
specs a step lays out by are its ``specs`` attribute.

Where the reference donates the KV cache, ``build_serve``'s step writes the
cache it is given in place: pass the DTensors a previous step returned.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .. import optim
from ..configs.shapes import InputShape, input_specs
from ..core.sdfeel import FLSpec, build_fl_train_step
from ..models import CausalLM
from ..models.config import ArchConfig
from ..sharding import (
    MeshAxes, activation_sharding, batch_pspecs, cache_pspecs, distribute_params,
    make_decode_impl, param_pspecs,
)
from ..sharding.context import mesh_axis_sizes
from .mesh import mesh_axes_for

__all__ = ["default_fl_spec", "build_train", "build_prefill", "build_serve"]


def default_fl_spec(mesh, impl: str = "dense") -> FLSpec:
    """Clients = data-axis size; 4 clusters on a ring (>=4 clients)."""
    c = mesh_axis_sizes(mesh)["data"]
    d = 4 if c % 4 == 0 and c >= 8 else max(2, c // 2)
    return FLSpec(num_clients=c, num_clusters=d, tau1=2, tau2=1, alpha=2, impl=impl)


def _stacked_shapes(model: CausalLM, num_clients: int) -> dict:
    """The ``(C, ...)`` client-stacked leaves as meta tensors."""
    return {k: v[None].expand((num_clients,) + tuple(v.shape))
            for k, v in model.param_shapes().items()}


def _axes_tuple(axes) -> tuple:
    if axes is None:
        return ()
    return tuple(axes) if isinstance(axes, tuple) else (axes,)


def _derived_mesh(mesh, shape: tuple, names: tuple):
    """A mesh of the same ranks in another shape (made on every rank)."""
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(mesh.device_type, mesh.mesh.reshape(shape), mesh_dim_names=names)


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

def build_train(cfg: ArchConfig, shape: InputShape, mesh, fl: Optional[FLSpec] = None,
                event: str = "inter", variant: str = "default",
                microbatch: int = 1):
    """SD-FEEL federated train step for one protocol iteration:
    ``step(params, opt_state, batch) -> (params, opt_state, loss)``.

    variant="default": params are client-stacked (C = data-axis size, one
    replica a data index, tensor-parallel on ``model``); each client's batch
    is data-parallel over ``pod``.  variant="fsdp": the data axis is
    re-factored into (cluster=4, fsdp=data/4) on a mesh derived from the
    same ranks: 4 clients (one an edge cluster), each replica sharded
    (ZeRO-3) over its fsdp sub-axis, the batch data-parallel over fsdp
    (and pod).  variant="pod": clients = pods, each replica sharded over
    its pod's (data, model) ranks.  The step returns new parameters (the
    reference donates the old ones; here they are freed with the caller's
    references).  The transition is a matrix on any mesh: ``fl.impl`` may
    not be ``"gossip"``.
    """
    sizes = mesh_axis_sizes(mesh)
    fsdp_kwargs = {}
    if variant == "pod":
        if "pod" not in sizes:
            raise ValueError("variant='pod' requires the multi-pod mesh")
        ax = MeshAxes(model="model", data="pod", pod="data", model_size=sizes["model"])
        fl = fl or FLSpec(num_clients=sizes["pod"], num_clusters=sizes["pod"], tau1=2, tau2=1,
                          alpha=2, impl="dense")
        fsdp_kwargs = dict(fsdp_axis="data", fsdp_size=sizes["data"])
    elif variant == "fsdp":
        data_sz, model_sz = sizes["data"], sizes["model"]
        n_cluster, n_fsdp = 4, data_sz // 4
        if "pod" in sizes:
            mesh = _derived_mesh(mesh, (sizes["pod"], n_cluster, n_fsdp, model_sz),
                                 ("pod", "cluster", "fsdp", "model"))
            batch_sub = ("pod", "fsdp")
        else:
            mesh = _derived_mesh(mesh, (n_cluster, n_fsdp, model_sz),
                                 ("cluster", "fsdp", "model"))
            batch_sub = "fsdp"
        ax = MeshAxes(model="model", data="cluster", pod=batch_sub, model_size=model_sz)
        fl = fl or FLSpec(num_clients=n_cluster, num_clusters=n_cluster, tau1=2, tau2=1,
                          alpha=2, impl="dense")
        fsdp_kwargs = dict(fsdp_axis="fsdp", fsdp_size=n_fsdp)
    elif variant == "default":
        ax = mesh_axes_for(mesh)
        fl = fl or default_fl_spec(mesh)
    else:
        raise ValueError(f"variant must be 'default', 'fsdp' or 'pod', got {variant!r}")
    model = CausalLM(cfg)
    opt = optim.sgd(fl.learning_rate)

    params_shape = _stacked_shapes(model, fl.num_clients)
    pspecs = param_pspecs(cfg, params_shape, ax, client_axis=ax.data, **fsdp_kwargs)
    opt_shape = ()  # SGD keeps no state
    batch_shape = input_specs(cfg, shape, num_clients=fl.num_clients)
    bspecs = batch_pspecs(cfg, batch_shape, ax, "train", federated=True)
    inner = build_fl_train_step(model, opt, fl, event=event, mesh=mesh, microbatch=microbatch,
                                client_axis=ax.data)
    pod_axes = _axes_tuple(ax.pod)

    def step(params, opt_state, batch):
        params = distribute_params(params, pspecs, mesh)
        batch = distribute_params(batch, bspecs, mesh)
        # moe_shard_map=False: a client's tokens are already shard-local for
        # the dispatch, as in the reference's train step
        with activation_sharding(mesh, pod_axes, ax.model, moe_shard_map=False):
            return inner(params, opt_state, batch)

    step.specs = {"params": pspecs, "batch": bspecs}
    return step, (params_shape, opt_shape, batch_shape)


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def _batch_div(mesh, ax: MeshAxes) -> int:
    sizes = mesh_axis_sizes(mesh)
    return math.prod(sizes[a] for a in ax.batch_axes)


def build_prefill(cfg: ArchConfig, shape: InputShape, mesh):
    """``step(params, batch) -> (last logits, caches)``, the batch over the
    batch axes and the model tensor-parallel on ``model``."""
    ax = mesh_axes_for(mesh)
    model = CausalLM(cfg, long_context=shape.long_context)
    params_shape = model.param_shapes()
    pspecs = param_pspecs(cfg, params_shape, ax)
    batch_shape = input_specs(cfg, shape)
    bspecs = batch_pspecs(cfg, batch_shape, ax, "prefill", batch_div=_batch_div(mesh, ax))

    def prefill_step(params, batch):
        params = distribute_params(params, pspecs, mesh)
        batch = distribute_params(batch, bspecs, mesh)
        with activation_sharding(mesh, ax.batch_axes, ax.model):
            return model.prefill(params, batch)

    prefill_step.specs = {"params": pspecs, "batch": bspecs}
    prefill_step.model = model
    return prefill_step, (params_shape, batch_shape)


# ---------------------------------------------------------------------------
# serve (decode)
# ---------------------------------------------------------------------------

def build_serve(cfg: ArchConfig, shape: InputShape, mesh):
    """One-token decode against a ``seq_len`` KV/SSM cache:
    ``step(params, cache, token, pos) -> (logits, cache)``, the cache
    written in place through ``sharding.make_decode_impl``."""
    ax = mesh_axes_for(mesh)
    batch = shape.global_batch
    batch_div = _batch_div(mesh, ax)
    if batch % batch_div == 0 and batch >= batch_div:
        batch_axes = ax.batch_axes        # decode_32k: batch over (pod,) data
        seq_axes = (ax.model,)            # cache sequence over model
    else:
        batch_axes = ()                   # long_500k: a batch of 1 replicated
        seq_axes = ax.batch_axes + (ax.model,)
    heads_shardable = bool(cfg.num_heads) and cfg.num_heads % ax.model_size == 0
    decode_impl = make_decode_impl(mesh, seq_axes=seq_axes, batch_axes=batch_axes,
                                   gather_heads=heads_shardable, model_axis=ax.model)
    model = CausalLM(cfg, long_context=shape.long_context, decode_impl=decode_impl)
    params_shape = model.param_shapes()
    pspecs = param_pspecs(cfg, params_shape, ax)
    with torch.device("meta"):
        cache_shape = model.init_cache(batch, shape.seq_len)
    cspecs = cache_pspecs(cfg, cache_shape, ax, seq_axes=seq_axes, batch_axes=batch_axes)
    batch_shape = input_specs(cfg, shape)
    bspecs = batch_pspecs(cfg, batch_shape, ax, "decode", batch_div=batch_div)

    def serve_step(params, cache, token, pos):
        params = distribute_params(params, pspecs, mesh)
        cache = distribute_params(cache, cspecs, mesh)
        token = distribute_params({"token": token}, bspecs, mesh)["token"]
        if hasattr(pos, "full_tensor"):
            pos = pos.full_tensor()
        with activation_sharding(mesh, batch_axes, ax.model):
            return model.decode_step(params, token, cache, pos)

    serve_step.specs = {"params": pspecs, "cache": cspecs, "token": bspecs["token"]}
    serve_step.model = model
    serve_step.seq_axes, serve_step.batch_axes = seq_axes, batch_axes
    return serve_step, (params_shape, cache_shape, batch_shape["token"], batch_shape["pos"])
