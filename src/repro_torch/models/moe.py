"""Mixture-of-Experts layer: top-k router and sort-based capacity dispatch.

The port's ``repro.models.moe``.  The (token, expert) assignments are
sorted by expert id (a stable sort, so each expert's slots keep token
order) and gathered into fixed ``(num_experts, capacity)`` buffers; the
expert GEMMs run on those buffers, and a gather through the inverse
permutation combines each token's top-k outputs.  Assignments past an
expert's capacity are dropped, and the router's Switch-style aux loss
balances the load.

Every op keeps its shape fixed and reads nothing back to the host, so the
layer runs under ``torch.func.vmap`` (clients, and examples for ``S > 1``)
and inside a CUDA graph's capture: the per-expert counts are a compare and
sum (``torch.bincount`` reads its max back), the inverse permutation an
out-of-place ``scatter``, and no boolean mask selects a ragged subset.
The reference computes the layer in plain ``jnp``, with no Pallas kernel;
here the expert GEMMs are ``torch.einsum`` products.

On ``DTensor`` operands (``launch.steps``) the layer runs as the reference's
``shard_map`` branch (``_moe_on_mesh``): when the activation-sharding
context allows it (``moe_shard_map``) and the batch divides the context's
batch axes, each batch shard routes, dispatches and combines its own
examples, and the aux loss is the mean over those axes.  Routing and the
dispatch run on each rank's local tensors; the expert GEMMs run as DTensor
products on the sub-mesh of the other axes (the model axis, where the
experts' ``d_ff`` is sharded).  Without the branch a prefill keeps the
batch shards it has (each example routes on its own), and a decode
gathers its batch, which routes as one token set.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["moe_mlp", "init_moe_params", "router_topk", "moe_capacity"]


def router_topk(x: torch.Tensor, w_router: torch.Tensor, k: int):
    """Returns (expert_ids (T, k), combine_weights (T, k), aux_loss, probs)."""
    logits = torch.einsum("td,de->te", x.float(), w_router.float())
    probs = torch.softmax(logits, dim=-1)
    weights, ids = torch.topk(probs, k, dim=-1)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance loss: E * sum_e f_e * P_e, with f_e the
    # share of assignments routed to expert e (a one-hot count)
    e = w_router.shape[1]
    experts = torch.arange(e, device=ids.device)
    assign = (ids[..., None] == experts).sum(1).to(probs.dtype)
    f_e = assign.mean(dim=0) / k
    p_e = probs.mean(dim=0)
    aux = e * torch.sum(f_e * p_e)
    return ids, weights, aux, probs


def _route(xt: torch.Tensor, w_router: torch.Tensor, k: int, capacity: int):
    """Routing and slot bookkeeping for one flat token set. xt: (T, d) ->
    (src_tok (E, cap) token of each expert slot, valid (E, cap), slot_flat
    (T * k,) slot of each (token, choice) or E * cap when dropped, combine
    weights (T, k) f32 with the dropped ones zeroed, aux)."""
    t = xt.shape[0]
    e = w_router.shape[1]
    dev = xt.device
    ids, weights, aux, _ = router_topk(xt, w_router, k)

    flat_e = ids.reshape(t * k)
    flat_tok = torch.arange(t * k, device=dev) // k      # token of each assignment
    order = torch.argsort(flat_e, stable=True)
    se, stok = flat_e[order], flat_tok[order]

    counts = (se[:, None] == torch.arange(e, device=dev)).sum(0)
    offsets = torch.cumsum(counts, 0) - counts          # start of each expert's run
    pos_in_expert = torch.arange(t * k, device=dev) - offsets[se]
    keep_sorted = pos_in_expert < capacity

    # gather dispatch: slot c of expert e holds the token of its c-th assignment
    slots = torch.arange(capacity, device=dev)
    valid = slots[None, :] < torch.clamp(counts, max=capacity)[:, None]
    src_tok = stok[torch.clamp(offsets[:, None] + slots[None, :], 0, t * k - 1)]

    # gather combine: the slot of assignment (t, k) through the inverse
    # permutation (an out-of-place scatter of the sorted slots)
    slot_sorted = torch.where(keep_sorted, se * capacity + pos_in_expert,
                              torch.full((), e * capacity, dtype=se.dtype, device=dev))
    slot_flat = torch.zeros_like(slot_sorted).scatter(0, order, slot_sorted)
    keep_flat = slot_flat < e * capacity
    return src_tok, valid, slot_flat, weights * keep_flat.reshape(t, k).float(), aux.float()


def _dispatch(xt: torch.Tensor, src_tok: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """buf (E, cap, d): xt's token of each slot, zeros in the empty slots."""
    return torch.where(valid[..., None], xt[src_tok],
                       torch.zeros((), dtype=xt.dtype, device=xt.device))


def _experts(buf: torch.Tensor, params: dict) -> torch.Tensor:
    """The expert GEMMs on (..., E, cap, d) slots, SiLU in f32."""
    dt = buf.dtype
    gate = torch.einsum("...ecd,edf->...ecf", buf, params["w_gate"].to(dt))
    up = torch.einsum("...ecd,edf->...ecf", buf, params["w_up"].to(dt))
    hidden = F.silu(gate.float()).to(dt) * up
    return torch.einsum("...ecf,efd->...ecd", hidden, params["w_down"].to(dt))


def _combine(expert_out: torch.Tensor, slot_flat: torch.Tensor, w: torch.Tensor):
    """(E, cap, d) expert outputs -> (T, d): each token's k slots weighted
    by ``w`` (T, k) in the activation dtype; a dropped choice reads the zero
    row past the last slot."""
    e, cap, d = expert_out.shape
    t, k = w.shape
    padded = torch.cat([expert_out.reshape(e * cap, d),
                        torch.zeros((1, d), dtype=expert_out.dtype, device=expert_out.device)])
    per_assign = padded[slot_flat].reshape(t, k, d)
    return torch.einsum("tkd,tk->td", per_assign, w.to(expert_out.dtype))


def moe_capacity(tokens: int, k: int, e: int, capacity_factor: float) -> int:
    """Slots an expert takes for ``tokens`` tokens: Python's ``round`` of
    ``tokens * k / e * capacity_factor``, at least ``min(tokens, 16)``."""
    return int(max(1, round(tokens * k / e * capacity_factor), min(tokens, 16)))


def moe_mlp(x: torch.Tensor, params: dict, *, num_experts_per_tok: int,
            capacity_factor: float, capacity: Optional[int] = None):
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar).

    For ``S > 1`` each example routes, dispatches and combines on its own
    (the reference's ``vmap`` over the batch), with the aux loss averaged
    over examples; the expert GEMMs run once on the ``(B, E, cap, d)``
    slots, so each expert weight's gradient is one product summed over the
    examples, not one per example.  For ``S == 1`` (decode) the batch is one
    flat token set.  ``capacity``, the slots an expert takes, defaults to
    ``moe_capacity``'s; at the token count no choice is dropped."""
    from ..sharding.context import is_dtensor

    if is_dtensor(x):
        return _moe_on_mesh(x, params, num_experts_per_tok=num_experts_per_tok,
                            capacity_factor=capacity_factor, capacity=capacity)
    b, s, d = x.shape
    e = params["w_router"].shape[1]
    k = num_experts_per_tok
    vmap = torch.func.vmap
    if s > 1:
        capacity = capacity or moe_capacity(s, k, e, capacity_factor)
        src_tok, valid, slot_flat, w, aux = vmap(
            lambda xe: _route(xe, params["w_router"], k, capacity))(x)
        expert_out = _experts(vmap(_dispatch)(x, src_tok, valid), params)
        return vmap(_combine)(expert_out, slot_flat, w), aux.mean()
    t = b * s
    capacity = capacity or moe_capacity(t, k, e, capacity_factor)
    xt = x.reshape(t, d)
    src_tok, valid, slot_flat, w, aux = _route(xt, params["w_router"], k, capacity)
    out = _combine(_experts(_dispatch(xt, src_tok, valid), params), slot_flat, w)
    return out.reshape(b, s, d), aux


def _moe_on_mesh(x, params: dict, *, num_experts_per_tok: int, capacity_factor: float,
                 capacity: Optional[int]):
    """``moe_mlp`` of a DTensor ``x``, manual over the batch axes (the
    reference's ``shard_map`` over them) and by DTensor over the others."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from ..sharding.context import current, from_local_on, mesh_axis_sizes, on_submesh

    mesh = x.device_mesh
    names = list(mesh.mesh_dim_names)
    sizes = mesh_axis_sizes(mesh)
    b, s, _ = x.shape
    manual = []
    if s > 1:
        # each example routes on its own: the batch shards x has stay manual
        manual = [n for n, p in zip(names, x.placements)
                  if isinstance(p, Shard) and p.dim == 0]
        ctx = current()
        if ctx is not None and ctx["moe_shard_map"]:
            axes = [a for a in ctx["batch_axes"] if sizes.get(a, 1) > 1]
            div = 1
            for a in axes:
                div *= sizes[a]
            if axes and b % div == 0:
                manual = axes
    want = tuple(Shard(0) if n in manual else Replicate() for n in names)
    if tuple(x.placements) != want:
        x = x.redistribute(mesh, want)
    auto = tuple(n for n in names if n not in manual)
    n_manual = 1
    for n in manual:
        n_manual *= sizes[n]
    xl = x.to_local()
    local = {n: on_submesh(w, auto) for n, w in params.items()}
    router = local.pop("w_router")
    router = router.full_tensor() if hasattr(router, "full_tensor") else router
    k = num_experts_per_tok
    e = router.shape[1]

    def experts(buf):
        if not auto:
            return _experts(buf, local)
        sub = local["w_gate"].device_mesh
        out = _experts(from_local_on(buf, sub, (Replicate(),) * len(auto)), local)
        return out.redistribute(sub, (Replicate(),) * len(auto)).to_local()

    vmap = torch.func.vmap
    if s > 1:
        cap = capacity or moe_capacity(s, k, e, capacity_factor)
        src_tok, valid, slot_flat, w, aux = vmap(lambda xe: _route(xe, router, k, cap))(xl)
        out = vmap(_combine)(experts(vmap(_dispatch)(xl, src_tok, valid)), slot_flat, w)
        aux = aux.mean()
    else:
        t = b * s
        cap = capacity or moe_capacity(t, k, e, capacity_factor)
        xt = xl.reshape(t, -1)
        src_tok, valid, slot_flat, w, aux = _route(xt, router, k, cap)
        out = _combine(experts(_dispatch(xt, src_tok, valid)), slot_flat, w).reshape(xl.shape)
    out = from_local_on(out, mesh, want)
    # the mean over the batch shards: each rank's share, summed
    aux = from_local_on(aux / n_manual, mesh,
                        tuple(Partial() if n in manual else Replicate() for n in names))
    return out, aux.redistribute(mesh, (Replicate(),) * len(names))


def init_moe_params(gen: torch.Generator, d_model: int, d_ff: int, num_experts: int,
                    dtype) -> dict:
    """Router (f32 in every dtype) and stacked expert weights, names relative
    to ``ffn``."""
    s_in, s_ff = d_model ** -0.5, d_ff ** -0.5

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, dtype=torch.float32) * scale

    return {
        "w_router": normal((d_model, num_experts), s_in),
        "w_gate": normal((num_experts, d_model, d_ff), s_in).to(dtype),
        "w_up": normal((num_experts, d_model, d_ff), s_in).to(dtype),
        "w_down": normal((num_experts, d_ff, d_model), s_ff).to(dtype),
    }
