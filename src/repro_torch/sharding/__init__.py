"""Per-architecture sharding rules over ``torch.distributed`` device meshes.

The port's ``repro.sharding``: ``rules.py`` (``MeshAxes``, ``param_pspecs``,
``replica_pspecs``, ``batch_pspecs``, ``cache_pspecs``,
``describe_sharding``) gives each leaf a ``Spec``, which ``to_placements``
maps to DTensor placements on a ``DeviceMesh`` and ``distribute_params``
applies.  The reference's ``compat.py`` has no counterpart: it papers over
JAX versions' ``shard_map`` signatures.  Its ``context.py`` (activation
sharding constraints) and ``decode.py`` (the sequence-sharded decode) wait
for ROADMAP.md §1 item 4's 'steps' and 'decode_impl'.
"""
from .rules import (
    MeshAxes, Spec, batch_pspecs, cache_pspecs, describe_sharding, distribute_params,
    param_pspecs, replica_pspecs, to_placements,
)

__all__ = [
    "MeshAxes", "Spec", "param_pspecs", "batch_pspecs", "cache_pspecs", "replica_pspecs",
    "describe_sharding", "to_placements", "distribute_params",
]
