"""Sequence-sharded decode attention with log-sum-exp merging.

The port's ``repro.sharding.decode``.  Decode shapes keep KV caches of up to
524,288 tokens; one device cannot hold (or stream) them, so the cache's
sequence dimension is sharded across mesh axes (``model`` for decode_32k;
``data`` x ``model``, plus ``pod`` on a multi-pod mesh, for long_500k).
Each rank holds its ``(B_l, Sc_l, Hkv, hd)`` shard and:

  1. writes the new token's K/V into its slot, in place, *iff* it owns the
     ring-buffer position ``q_pos % Sc`` (a gated write, as the one-device
     decode's);
  2. computes partial attention stats (acc, l, m) over its local chunk
     (``models.layers.decode_attention_stats``);
  3. merges across shards with the online-softmax identity::

         m* = max_shards m ;  l* = sum l * exp(m - m*) ;
         acc* = sum acc * exp(m - m*) ;  out = acc* / l*

     as an ``all_reduce(MAX)`` and two ``all_reduce(SUM)`` over the group
     that spans the sequence axes.

Shards are numbered row-major over ``seq_axes`` (``context.mesh_coord``,
the reference's ``_flat_shard_index``), the order in which a ``DTensor``
sharded over several mesh dimensions lays out one tensor dimension.  Query heads are
tensor-sharded on ``model``; with ``gather_heads`` the single token's query
is all-gathered over ``model`` first.  The per-rank body runs under
``torch.distributed.tensor.experimental.local_map`` (the counterpart of the
reference's ``shard_map``) on plain local tensors.

The contract is the reference's: one position row ``(Sc,)`` shared by the
batch.  The slot pool's per-row positions (``(B, Sc)``) are ROADMAP.md §1
item 4's 'mesh serving'.
"""
from __future__ import annotations

import math

import torch

from ..models.layers import decode_attention_stats
from .context import mesh_axis_sizes, mesh_coord

__all__ = ["make_decode_impl"]


def seq_group(mesh, axes: tuple):
    """The process group of this rank's ranks along ``axes`` (all of the
    mesh's other coordinates fixed): the mesh's own group for one axis,
    else one subgroup a combination of the other coordinates, made on
    every rank in the same order."""
    import torch.distributed as dist

    if len(axes) == 1:
        return mesh.get_group(axes[0])
    names = list(mesh.mesh_dim_names)
    keep = [names.index(a) for a in axes]
    rest = [i for i in range(len(names)) if i not in keep]
    ranks = mesh.mesh.permute(rest + keep).reshape(-1, math.prod(mesh.mesh.shape[i]
                                                                for i in keep))
    group, _ = dist.new_subgroups_by_enumeration([r.tolist() for r in ranks])
    return group


def _placements(mesh, spec: dict):
    """DTensor placements on ``mesh``: ``spec`` maps an axis name to the
    tensor dimension it shards; the other axes replicate."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(spec[a]) if a in spec else Replicate() for a in mesh.mesh_dim_names)


def make_decode_impl(mesh, *, seq_axes: tuple, batch_axes: tuple, gather_heads: bool,
                     model_axis: str = "model"):
    """Build a decode-attention impl for ``CausalLM(decode_impl=...)`` on
    ``mesh`` (a ``DeviceMesh``; make it on every rank, as it may make
    process groups).

    Contract (``models.transformer``'s decode)::

        fn(q1, k_cache, v_cache, slot_pos, q_pos, k_new, v_new,
           *, window, logit_cap) -> (out, k_cache, v_cache, slot_pos)

    with q1 ``(B, Hq, hd)``; caches ``(B, Sc, Hkv, hd)`` and ``slot_pos``
    ``(Sc,)``, DTensors laid out by ``cache_pspecs`` and written in place
    (the returned ones share their storage); ``q_pos`` a 0-d tensor.
    """
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    sizes = mesh_axis_sizes(mesh)
    seq_axes, batch_axes = tuple(seq_axes), tuple(batch_axes)
    n_seq = math.prod(sizes[a] for a in seq_axes)
    group = seq_group(mesh, seq_axes) if n_seq > 1 else None
    shard = mesh_coord(mesh, seq_axes)
    n_heads = sizes[model_axis] if gather_heads else 1
    head_group = mesh.get_group(model_axis) if n_heads > 1 else None

    def along(dim_b, dim_s=None, dim_h=None):
        spec = {a: dim_b for a in batch_axes}
        if dim_s is not None:
            spec.update({a: dim_s for a in seq_axes})
        if dim_h is not None:
            spec[model_axis] = dim_h
        return _placements(mesh, spec)

    cache_pl = along(0, 1)
    in_pl = (along(0, dim_h=1 if gather_heads else None), cache_pl, cache_pl,
             _placements(mesh, {a: 0 for a in seq_axes}), None, along(0), along(0))
    out_pl = (along(0), cache_pl, cache_pl, _placements(mesh, {a: 0 for a in seq_axes}))

    def local(q, kc, vc, sp, qp, kn, vn, window, logit_cap):
        if head_group is not None:
            parts = [torch.empty_like(q) for _ in range(n_heads)]
            dist.all_gather(parts, q.contiguous(), group=head_group)
            q = torch.cat(parts, dim=1)
        b_l, sc_l = kc.shape[0], kc.shape[1]
        sc = sc_l * n_seq
        local_slot = (qp % sc).to(torch.int64) - shard * sc_l
        in_range = (local_slot >= 0) & (local_slot < sc_l)
        safe = local_slot.clamp(0, sc_l - 1)
        rows = torch.arange(b_l, device=kc.device)
        for buf, new, index in ((kc, kn, (rows, safe.expand(b_l))),
                                (vc, vn, (rows, safe.expand(b_l))),
                                (sp, qp.reshape(1).to(sp.dtype), (safe.reshape(1),))):
            new = new.to(buf.dtype)
            buf[index] = torch.where(in_range, new, buf[index])
        acc, l, m = decode_attention_stats(q, kc, vc, sp, qp, window=window,
                                           logit_cap=logit_cap)
        if group is not None:
            m_g = m.clone()
            dist.all_reduce(m_g, op=dist.ReduceOp.MAX, group=group)
            corr = torch.exp(m - m_g)
            l = l * corr
            acc = acc * corr[..., None]
            dist.all_reduce(l, group=group)
            dist.all_reduce(acc, group=group)
        out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
        return out, kc, vc, sp

    def impl(q1, k_cache, v_cache, slot_pos, q_pos, k_new, v_new, *, window, logit_cap):
        sc = k_cache.shape[1]
        if sc % n_seq:
            raise ValueError(f"cache length {sc} not divisible by {n_seq} seq shards")
        if slot_pos.dim() != 1:
            raise NotImplementedError(
                "per-row cache positions (the slot pool's) on a sharded decode are not "
                "ported yet (ROADMAP.md §1 item 4, 'Multi-device and launch': 'mesh "
                "serving'); the sharded decode takes one position row shared by the batch")
        q_pos = torch.as_tensor(q_pos).reshape(())
        if q_pos.dim() == 0 and hasattr(q_pos, "placements"):
            q_pos = q_pos.redistribute(mesh, (Replicate(),) * mesh.ndim).to_local()
        fn = local_map(lambda *a: local(*a, window, logit_cap), out_placements=out_pl,
                       in_placements=in_pl, device_mesh=mesh, redistribute_inputs=True)
        return fn(q1, k_cache, v_cache, slot_pos, q_pos, k_new, v_new)

    return impl
