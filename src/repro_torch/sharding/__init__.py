"""Per-architecture sharding over ``torch.distributed`` device meshes.

The port's ``repro.sharding``: ``rules.py`` (``MeshAxes``, ``param_pspecs``,
``replica_pspecs``, ``batch_pspecs``, ``cache_pspecs``,
``describe_sharding``) gives each leaf a ``Spec``, which ``to_placements``
maps to DTensor placements on a ``DeviceMesh``, and ``distribute_params``
applies; ``context.py`` is the activation-sharding context
the step builders open (``activation_sharding``, ``constrain_batch``,
``constrain_dim``, ``model_axis_size``); ``decode.py`` the sequence-sharded
decode (``make_decode_impl``).  The reference's ``compat.py`` has no
counterpart: it papers over JAX versions' ``shard_map`` signatures.
"""
from .context import activation_sharding, constrain_batch, constrain_dim, model_axis_size
from .decode import make_decode_impl
from .rules import (
    MeshAxes, Spec, batch_pspecs, cache_pspecs, describe_sharding, distribute_params,
    param_pspecs, replica_pspecs, to_placements,
)

__all__ = [
    "MeshAxes", "Spec", "param_pspecs", "batch_pspecs", "cache_pspecs", "replica_pspecs",
    "describe_sharding", "to_placements", "distribute_params",
    "activation_sharding", "constrain_batch", "constrain_dim", "model_axis_size",
    "make_decode_impl",
]
