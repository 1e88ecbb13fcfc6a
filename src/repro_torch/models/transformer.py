"""Decoder-only causal LM for every architecture family of the reference.

The port's ``repro.models.transformer.CausalLM`` for full-sequence training
(``forward``, ``loss``).  Parameters are a flat dict of dotted names, the
reference's nested tree flattened (``convert.flatten_params``): ``embed``,
``ln_final``, ``head`` (unless tied) and per-layer leaves such as
``blocks.pos0.attn.wq``, ``blocks.pos0.ffn.w_router`` (MoE) or
``blocks.pos4.mamba.A_log`` (SSM).  The stack is ``num_scan_blocks``
homogeneous blocks of ``scan_period`` layers, each position with its fixed
kind (attention or mamba mixer; dense, MoE or no FFN); every block leaf
keeps the block axis as axis 0, and ``_run_stack`` is a Python loop over it
(the reference's ``lax.scan``), summing the MoE layers' router aux losses.
Under ``torch.func.vmap`` over clients the client axis is hidden, so block
``i`` is still ``params[name][i]``.

Attention runs through ``models.layers.causal_attention`` with
``cfg.attn_impl``; MoE FFNs through ``models.moe.moe_mlp``; mamba mixers
through ``models.mamba.mamba_forward``.  Modalities as in the reference:
``frontend_embeds`` replace the first ``F`` token embeddings (VLM, whose
loss masks those positions), and audio sums ``(B, K, S)`` codebook tokens'
embeddings and emits ``K`` heads of logits.

``cfg.remat`` runs each block through ``_Remat``, an ``autograd.Function``
that keeps only the block's input (policy ``"full"``), or also the products
without batch dimensions (``"dots"``, ``dots_saved``), and recomputes the
rest of the block in its backward (the reference's ``jax.checkpoint``).  Serving: ``init_cache``,
``prefill`` (the caches of a full-sequence pass, through the flash forward
with ``attn_impl="cuda"``), ``decode_hidden`` and ``decode_step`` (one token a
row against ring-buffer KV caches and mamba states, written in place, plain
PyTorch); the decode also takes the clusters' models of a ``(D, ...)``
stack with a cluster index a row.

On a mesh (``launch.steps``: DTensor leaves under
``sharding.activation_sharding``) the same code runs as DTensor ops; the
embedding, attention and MoE take their per-rank forms (``models.layers``,
``models.moe``), and a head count the model axis does not divide runs the
attention sequence-parallel (the reference's ``shard_chunk``; with
``attn_impl="plain"`` only, as 'flash rows' of ROADMAP.md §1 item 4 waits).
``CausalLM(decode_impl=)`` takes ``sharding.make_decode_impl``'s
sequence-sharded decode, which writes each rank's cache shard in place; a
gated or cluster-routed decode through it raises, as no path of the
reference takes one (ROADMAP.md §1 item 4, 'decode_impl').
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from .config import ArchConfig
from .layers import (
    causal_attention, decode_attention, dense, embedding, gated_mlp, init_dense, rms_norm, rope,
    saved_products, softcap,
)
from .mamba import init_mamba_cache, init_mamba_params, mamba_decode_step, mamba_forward
from .moe import init_moe_params, moe_mlp

__all__ = ["CausalLM", "dots_saved"]


def dots_saved(cfg: ArchConfig) -> list:
    """The products remat's ``"dots"`` policy keeps from a block's forward,
    in the order the block takes them: ``"posI.<weight>"`` for the product
    of a layer's input with that weight (``layers.dense``).  See
    ``_Remat``."""
    names = []
    for i in range(cfg.scan_period):
        if cfg.layer_kind(i) == "attn":
            names += [f"pos{i}.attn.{w}" for w in ("wq", "wk", "wv", "wo")]
        else:
            names += [f"pos{i}.mamba.{w}" for w in ("w_z", "w_x", "w_b", "w_c", "w_dt",
                                                      "out_proj")]
        if cfg.d_ff:
            names += ([f"pos{i}.ffn.w_router"] if cfg.is_moe_layer(i) else
                      [f"pos{i}.ffn.{w}" for w in ("w_gate", "w_up", "w_down")])
    return names if _reads_last_product(cfg) else names[:-1]


def _reads_last_product(cfg: ArchConfig) -> bool:
    """Whether a block's backward reads its last product's value: a post-norm
    reads it, and an MoE router's softmax; the down or output projection
    that only the block's residual add takes is not read."""
    last = cfg.scan_period - 1
    return cfg.use_post_norm or bool(cfg.d_ff and cfg.is_moe_layer(last))


def _audio(cfg: ArchConfig) -> bool:
    return cfg.modality == "audio" and cfg.num_codebooks > 1


def _init_layer(gen: torch.Generator, cfg: ArchConfig, idx_in_period: int) -> dict:
    """The leaves of the layer at ``idx_in_period``, names relative to
    ``blocks.posI``: its mixer (attention or mamba) and FFN (dense or MoE)."""
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = cfg.param_dtype
    p = {"ln_mix": torch.ones(d, dtype=dt)}
    if cfg.layer_kind(idx_in_period) == "attn":
        p["attn.wq"] = init_dense(gen, d, hq * hd, dt)
        p["attn.wk"] = init_dense(gen, d, hkv * hd, dt)
        p["attn.wv"] = init_dense(gen, d, hkv * hd, dt)
        p["attn.wo"] = init_dense(gen, hq * hd, d, dt)
        if cfg.qkv_bias:
            p["attn.bq"] = torch.zeros(hq * hd, dtype=dt)
            p["attn.bk"] = torch.zeros(hkv * hd, dtype=dt)
            p["attn.bv"] = torch.zeros(hkv * hd, dtype=dt)
    else:
        p.update({f"mamba.{k}": v for k, v in init_mamba_params(gen, cfg).items()})
    if cfg.use_post_norm:
        p["ln_mix_post"] = torch.ones(d, dtype=dt)
    if cfg.d_ff:
        p["ln_ffn"] = torch.ones(d, dtype=dt)
        if cfg.is_moe_layer(idx_in_period):
            ffn = init_moe_params(gen, d, cfg.d_ff, cfg.num_experts, dt)
        else:
            ffn = {"w_gate": init_dense(gen, d, cfg.d_ff, dt),
                   "w_up": init_dense(gen, d, cfg.d_ff, dt),
                   "w_down": init_dense(gen, cfg.d_ff, d, dt)}
        p.update({f"ffn.{k}": v for k, v in ffn.items()})
        if cfg.use_post_norm:
            p["ln_ffn_post"] = torch.ones(d, dtype=dt)
    return p


def _sub(p: dict, prefix: str) -> dict:
    """The leaves of ``p`` under ``prefix``, with the prefix dropped."""
    return {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}


def _qkv(p: dict, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor):
    """q (B, S, Hq, hd), k and v (B, S, Hkv, hd), rotated at ``positions``
    ((S,) shared or (B, S) a row)."""
    b, s, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = dense(x, p["attn.wq"], p.get("attn.bq")).reshape(b, s, hq, hd)
    k = dense(x, p["attn.wk"], p.get("attn.bk")).reshape(b, s, hkv, hd)
    v = dense(x, p["attn.wv"], p.get("attn.bv")).reshape(b, s, hkv, hd)
    return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta), v


def _attention(p: dict, x: torch.Tensor, cfg: ArchConfig, *, window: Optional[int],
               positions: torch.Tensor, return_cache: bool = False):
    """Full-sequence attention: (out, the layer's cache or None).  The cache
    holds the last ``min(window, S)`` positions' k, v (param dtype) and their
    positions (int32), as the reference's prefill."""
    from ..sharding.context import model_axis_size

    b, s, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    # a head count the model axis does not divide shards the query rows
    # instead (sequence-parallel attention, the reference's shard_chunk)
    ms = model_axis_size()
    out = causal_attention(q, k, v, window=window, logit_cap=cfg.attn_logit_softcap,
                           impl=cfg.attn_impl, chunk=cfg.attn_chunk,
                           shard_chunk=ms > 1 and cfg.num_heads % ms != 0)
    cache = None
    if return_cache:
        sc = min(window, s) if window is not None else s
        cache = {"k": k[:, s - sc:].to(cfg.param_dtype), "v": v[:, s - sc:].to(cfg.param_dtype),
                 "pos": positions[s - sc:].to(torch.int32)}
    return dense(out.reshape(b, s, cfg.num_heads * cfg.head_dim), p["attn.wo"]), cache


def _finish_layer(p: dict, x: torch.Tensor, mix: torch.Tensor, cfg: ArchConfig,
                  idx_in_period: int, capacity: Optional[int] = None):
    """The mixer's post-norm and residual, then the FFN (dense or MoE, its
    experts ``capacity`` slots each) with its norms and residual: (x, router
    aux loss or None)."""
    aux = None
    if cfg.use_post_norm:
        mix = rms_norm(mix, p["ln_mix_post"], cfg.norm_eps)
    x = x + mix
    if cfg.d_ff:
        h = rms_norm(x, p["ln_ffn"], cfg.norm_eps)
        if cfg.is_moe_layer(idx_in_period):
            out, aux = moe_mlp(h, _sub(p, "ffn."), num_experts_per_tok=cfg.num_experts_per_tok,
                               capacity_factor=cfg.moe_capacity_factor, capacity=capacity)
        else:
            out = gated_mlp(h, _sub(p, "ffn."))
        if cfg.use_post_norm:
            out = rms_norm(out, p["ln_ffn_post"], cfg.norm_eps)
        x = x + out
    return x, aux


def _apply_layer(p: dict, x: torch.Tensor, cfg: ArchConfig, idx_in_period: int, *,
                 long_context: bool, positions: torch.Tensor, return_cache: bool = False):
    """One layer (mixer + optional FFN), pre-norm, optional post-norms, over a
    full sequence.  Returns (x, router aux loss or None for a layer without
    MoE, the layer's cache when ``return_cache`` else None)."""
    h = rms_norm(x, p["ln_mix"], cfg.norm_eps)
    if cfg.layer_kind(idx_in_period) == "attn":
        mix, cache = _attention(p, h, cfg, positions=positions, return_cache=return_cache,
                                window=cfg.window_for_layer(idx_in_period, long_context))
    else:
        mix, (h_final, tails) = mamba_forward(_sub(p, "mamba."), h, cfg)
        cache = ({"ssm": h_final, "conv_x": tails["x"], "conv_b": tails["b"],
                  "conv_c": tails["c"]} if return_cache else None)
    x, aux = _finish_layer(p, x, mix, cfg, idx_in_period)
    return x, aux, cache


# ---------------------------------------------------------------------------
# Activation checkpointing
# ---------------------------------------------------------------------------

class _Remat(torch.autograd.Function):
    """A block run without keeping its activations: the forward saves only
    the block's input and leaves; the backward recomputes the block under
    ``torch.func.vjp`` and pulls the cotangents through it.

    ``torch.utils.checkpoint`` relies on saved-tensor hooks, which
    ``torch.func.grad`` refuses; this Function has a ``setup_context`` and a
    generated vmap rule, so it runs under ``vmap(grad_and_value)`` over the
    clients and inside a captured round.  ``fn(x, positions, leaves) -> (x,
    aux)``, the aux an f32 scalar (zeros for a block without MoE); every
    tensor ``fn`` reads comes in as an input (a tensor it closed over would
    belong to a transform level the generated vmap rule has left).

    ``dots`` is ``None`` for policy ``"full"``.  For ``"dots"`` (the
    reference's ``dots_with_no_batch_dims_saveable``) the forward also keeps
    the products ``layers.dense`` takes (``layers.saved_products``) and
    returns them as extra outputs, which the generated vmap rule carries
    over the client axis; the recomputation then takes each back through
    ``layers._Product`` instead of multiplying again, and recomputes the
    rest.  The reference's policy sees one client's products (its
    ``jax.checkpoint`` lies inside the ``vmap``), so it keeps the products
    without batch dimensions of their own: every projection, attention's
    q, k, v and output, the gated MLP's gate, up and down, the MoE router's
    logits, mamba's z, x, B, C and dt projections and its output projection
    (``dots_saved`` lists a block's).  Attention's per-head products and
    the flash op, the MoE's expert GEMMs (an expert axis) and combine, and
    the SSD products are recomputed.  As in the reference, a product whose
    value the backward never reads is not kept (``dots`` False: the
    block's last product, a down or output projection that only the
    residual add takes); the recomputation puts zeros in its place.  The
    gradients are those of ``"full"`` and of remat off, bit for bit.

    On a mesh (DTensor operands, no ``torch.func`` transform around the
    step) the backward recomputes the block under autograd instead, in the
    activation-sharding context the forward ran in (the engine may run a
    backward on another thread): ``torch.func.vjp`` would hand the kernels
    functorch-wrapped local shards."""

    generate_vmap_rule = True

    @staticmethod
    def forward(fn, dots, x, positions, *leaves):
        if dots is None:
            return fn(x, positions, leaves)
        with saved_products() as tape:
            out = fn(x, positions, leaves)
        kept = tape.saved if dots else tape.saved[:-1]
        return (*out, *kept)

    @staticmethod
    def setup_context(ctx, inputs, output):
        from ..sharding.context import current

        fn, _, x, positions, *leaves = inputs
        ctx.fn = fn
        ctx.sharding = current()
        ctx.n_leaves = len(leaves)
        kept = output[2:]
        ctx.mark_non_differentiable(*kept)
        ctx.save_for_backward(x, positions, *leaves, *kept)

    @staticmethod
    def backward(ctx, dx, daux, *_):
        from ..sharding.context import is_dtensor, restored

        x, positions, *rest = ctx.saved_tensors
        leaves, kept = rest[:ctx.n_leaves], rest[ctx.n_leaves:]
        fn = ctx.fn
        replay = saved_products(kept) if kept else contextlib.nullcontext()
        if is_dtensor(x):
            ins = [t.detach().requires_grad_() for t in (x, *leaves)]
            with restored(ctx.sharding), torch.enable_grad(), replay:
                outs = fn(ins[0], positions, ins[1:])
            keep = [(o, g) for o, g in zip(outs, (dx, daux)) if o.requires_grad]
            grads = torch.autograd.grad([o for o, _ in keep], ins, [g for _, g in keep],
                                        allow_unused=True)
            return (None, None, grads[0], None, *grads[1:])
        # torch.func.grad differentiates with create_graph=True, which would
        # record the recomputation for a second derivative and keep every
        # recomputed block alive; detached operands keep it to this call
        # (vjp's own level still differentiates them, with the formulas the
        # block's backward takes without remat), and the flash op has no
        # second derivative anyway
        inputs = [t.detach() for t in (x, *leaves)]
        with replay:
            _, pull = torch.func.vjp(lambda x_, *ls: fn(x_, positions, ls), *inputs)
        dx, *dleaves = pull((dx.detach(), daux.detach()))
        return (None, None, dx, None, *dleaves)


# ---------------------------------------------------------------------------
# Decode: one token a row against the caches
# ---------------------------------------------------------------------------

def _where(mask: Optional[torch.Tensor], a, b):
    """``a`` where ``mask`` (a (B,) row mask, or a scalar) else ``b``, leaf by
    leaf over tensors, tuples and dicts."""
    if isinstance(a, dict):
        return {k: _where(mask, v, b[k]) for k, v in a.items()}
    if isinstance(a, (tuple, list)):
        return type(a)(_where(mask, x, y) for x, y in zip(a, b))
    if mask.dim():
        mask = mask.reshape(mask.shape + (1,) * (a.dim() - 1))
    return torch.where(mask, a, b)


def _route(fn, plist: list, sel: Optional[list]):
    """``fn(p)`` for one model's leaves ``p``; over the clusters' models
    ``plist``, every row takes its own cluster's result (``sel[d]`` the rows
    of cluster ``d``): one pass over all rows a cluster, each reading that
    cluster's weights as they lie in the stack, no gathered copy."""
    out = fn(plist[0])
    for d in range(1, len(plist)):
        out = _where(sel[d], fn(plist[d]), out)
    return out


def _clusters(params, cluster: Optional[torch.Tensor]):
    """(the models' leaves as a list, each cluster's row mask or None):
    ``params`` one model's leaves, or a list of the clusters' with
    ``cluster`` (B,) naming each row's."""
    plist = list(params) if isinstance(params, (list, tuple)) else [params]
    return plist, (None if len(plist) == 1 else [cluster == d for d in range(len(plist))])


def _write(buf: torch.Tensor, index: tuple, new: torch.Tensor,
           gate: Optional[torch.Tensor]) -> None:
    """``buf[index] = new`` in place, where ``gate`` (a scalar bool tensor)
    allows, else the old values are written back."""
    new = new.to(buf.dtype)
    if gate is not None:
        new = torch.where(gate, new, buf[index])
    buf[index] = new


_MAMBA_CACHE = ("ssm", "conv_x", "conv_b", "conv_c")


class CausalLM:
    """Functional causal LM over flat parameter dicts."""

    def __init__(self, cfg: ArchConfig, long_context: bool = False, decode_impl=None):
        if cfg.remat_policy not in ("full", "dots"):
            raise ValueError(f"remat_policy must be 'full' or 'dots', got {cfg.remat_policy!r}")
        self.cfg = cfg
        self.long_context = long_context
        self.decode_impl = decode_impl

    # -- init ---------------------------------------------------------------
    def init(self, gen: torch.Generator) -> dict:
        """Fresh parameters drawn from ``gen`` (CPU), in ``cfg.param_dtype``
        (the MoE router and the mamba ``A_log``, ``D``, ``dt_bias`` in f32)."""
        cfg = self.cfg
        dt = cfg.param_dtype
        v, d = cfg.padded_vocab, cfg.d_model
        shape = (cfg.num_codebooks, v, d) if _audio(cfg) else (v, d)
        params = {"embed": (torch.randn(shape, generator=gen) * 0.02).to(dt)}
        for pos in range(cfg.scan_period):
            layers = [_init_layer(gen, cfg, pos) for _ in range(cfg.num_scan_blocks)]
            for name in layers[0]:
                params[f"blocks.pos{pos}.{name}"] = torch.stack([lp[name] for lp in layers])
        params["ln_final"] = torch.ones(d, dtype=dt)
        if not cfg.tie_embeddings:
            if _audio(cfg):
                params["head"] = (torch.randn((cfg.num_codebooks, d, v), generator=gen)
                                  * d ** -0.5).to(dt)
            else:
                params["head"] = init_dense(gen, d, v, dt)
        return params

    def param_shapes(self) -> dict:
        """The leaves of ``init`` as meta-device tensors: names, shapes and
        dtypes at any width, with no storage (the counterpart of the
        reference's ``jax.eval_shape(model.init, key)``)."""
        with torch.device("meta"):
            return self.init(torch.Generator())

    # -- embedding / head -----------------------------------------------------
    def embed_tokens(self, params: dict, tokens: torch.Tensor,
                     frontend_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens (B, S), or (B, K, S) codebooks for audio -> (B, S, d); the
        first ``F`` positions replaced by ``frontend_embeds`` (B, F, d)."""
        cfg = self.cfg
        if _audio(cfg):
            x = embedding(tokens[:, 0], params["embed"][0]).to(cfg.act_dtype)
            for k in range(1, cfg.num_codebooks):
                x = x + embedding(tokens[:, k], params["embed"][k]).to(cfg.act_dtype)
        else:
            x = embedding(tokens, params["embed"])  # (B, S, d)
        x = x.to(cfg.act_dtype)
        if cfg.embed_scale:
            # the scale rounded to the activations' dtype, as the reference's,
            # as a Python number: a CUDA graph's capture may copy nothing in
            x = x * float(torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype))
        if frontend_embeds is not None:
            f = frontend_embeds.shape[1]
            x = torch.cat([frontend_embeds.to(x.dtype), x[:, f:]], dim=1)
        return x

    def logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """f32 logits (B, S, V), or (B, S, K, V) for audio."""
        cfg = self.cfg
        if cfg.tie_embeddings:
            out = torch.einsum("bsd,vd->bsv", x, params["embed"].to(x.dtype))
        elif _audio(cfg):
            out = torch.einsum("bsd,kdv->bskv", x, params["head"].to(x.dtype))
        else:
            out = dense(x, params["head"])
        return softcap(out.float(), cfg.final_logit_softcap)

    # -- stack ------------------------------------------------------------------
    def _run_stack(self, params: dict, x: torch.Tensor, positions: torch.Tensor, *,
                   return_cache: bool = False):
        """(x, the MoE layers' aux losses summed (an f32 scalar), the caches
        as ``{"posI.<leaf>": (nblocks, ...)}`` when ``return_cache`` else
        None).  With ``cfg.remat`` each block runs through ``_Remat``."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        # each stacked leaf split once along the block axis: its gradient is
        # then one stack of the blocks' gradients (one squeeze, a view, for a
        # single block), where an index per block would add a zero-padded
        # full-size gradient per block
        nb = cfg.num_scan_blocks
        blocks = {k: (w.unbind(0) if nb > 1 else (w.squeeze(0),))
                  for k, w in params.items() if k.startswith("blocks.")}
        names = sorted(blocks)
        remat = cfg.remat and not return_cache
        dots = _reads_last_product(cfg) if cfg.remat_policy == "dots" else None

        def block_fn(x, positions, leaves):
            p_all = dict(zip(names, leaves))
            total = torch.zeros((), dtype=torch.float32, device=x.device)
            caches = {}
            for pos in range(cfg.scan_period):
                p = _sub(p_all, f"blocks.pos{pos}.")
                x, a, c = _apply_layer(p, x, cfg, pos, long_context=self.long_context,
                                       positions=positions, return_cache=return_cache)
                if a is not None:
                    total = total + a
                for n, t in (c or {}).items():
                    caches[f"pos{pos}.{n}"] = t
            return x, total, caches

        per_block = []
        for i in range(nb):
            leaves = tuple(blocks[k][i] for k in names)
            if remat:
                x, a = _Remat.apply(lambda *args: block_fn(*args)[:2], dots, x, positions,
                                    *leaves)[:2]
                c = None
            else:
                x, a, c = block_fn(x, positions, leaves)
            aux = aux + a
            per_block.append(c)
        caches = None
        if return_cache:
            caches = {n: torch.stack([c[n] for c in per_block]) for n in per_block[0]}
        return x, aux, caches

    # -- public API -------------------------------------------------------------
    def forward(self, params: dict, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """batch: {tokens (B, S) or (B, K, S), frontend_embeds?} -> (f32
        logits over the padded vocabulary, router aux loss)."""
        tokens = batch["tokens"]
        x = self.embed_tokens(params, tokens, batch.get("frontend_embeds"))
        positions = torch.arange(tokens.shape[-1], device=x.device)
        x, aux, _ = self._run_stack(params, x, positions)
        x = rms_norm(x, params["ln_final"], self.cfg.norm_eps)
        return self.logits(params, x), aux

    def loss(self, params: dict, batch: dict) -> torch.Tensor:
        """Mean next-token negative log-likelihood over ``logits[..., :vocab_size]``
        (masked by ``loss_mask``, or past the frontend's ``F`` positions), plus
        ``router_aux_coef`` times the aux loss in a model with MoE layers."""
        cfg = self.cfg
        logits, aux = self.forward(params, batch)
        if _audio(cfg):
            logits = logits.transpose(1, 2)  # (B, S, K, V) -> (B, K, S, V), as labels
        logp = torch.log_softmax(logits[..., : cfg.vocab_size], dim=-1)
        labels = batch["labels"].long()
        nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
        mask = batch.get("loss_mask")
        if mask is None and cfg.frontend_tokens:
            keep = torch.arange(nll.shape[-1], device=nll.device) >= cfg.frontend_tokens
            mask = torch.broadcast_to(keep.float(), nll.shape)
        if mask is not None:
            nll = nll * mask
            out = nll.sum() / torch.clamp(mask.sum(), min=1.0)
        else:
            out = nll.mean()
        if cfg.num_experts:
            out = out + cfg.router_aux_coef * aux
        return out

    # -- caches -------------------------------------------------------------------
    def init_cache(self, batch_size: int, cache_len: int, device=None) -> dict:
        """Empty caches ``{"posI.<leaf>": (nblocks, ...)}``: an attention
        layer's ``k``/``v`` (nblocks, B, Sc, Hkv, hd) in the param dtype and
        ``pos`` (nblocks, Sc) int32 (-1 = empty), Sc = ``cache_len`` or the
        layer's window if smaller (a ring buffer); a mamba layer's
        ``init_mamba_cache`` leaves."""
        cfg = self.cfg
        nb, dt = cfg.num_scan_blocks, cfg.param_dtype
        out = {}
        for i in range(cfg.scan_period):
            if cfg.layer_kind(i) == "mamba":
                layer = init_mamba_cache(cfg, batch_size, dt, device)
            else:
                window = cfg.window_for_layer(i, self.long_context)
                sc = min(window, cache_len) if window is not None else cache_len
                kv = (batch_size, sc, cfg.num_kv_heads, cfg.head_dim)
                layer = {"k": torch.zeros(kv, dtype=dt, device=device),
                         "v": torch.zeros(kv, dtype=dt, device=device),
                         "pos": torch.full((sc,), -1, dtype=torch.int32, device=device)}
            for n, t in layer.items():
                out[f"pos{i}.{n}"] = t[None].repeat((nb,) + (1,) * t.dim())
        return out

    def prefill(self, params: dict, batch: dict) -> tuple[torch.Tensor, dict]:
        """Full-sequence prefill: (the last position's logits (B, 1, V...),
        the caches of ``init_cache``'s layout, attention ones ``min(window,
        S)`` long)."""
        tokens = batch["tokens"]
        x = self.embed_tokens(params, tokens, batch.get("frontend_embeds"))
        positions = torch.arange(tokens.shape[-1], device=x.device)
        x, _, caches = self._run_stack(params, x, positions, return_cache=True)
        x = rms_norm(x, params["ln_final"], self.cfg.norm_eps)
        return self.logits(params, x[:, -1:, :]), caches

    def decode_hidden(self, params, token: torch.Tensor, cache: dict, pos, *,
                      cluster: Optional[torch.Tensor] = None,
                      gate: Optional[torch.Tensor] = None, per_row: bool = False):
        """``decode_step`` up to and including the final norm: (x (B, 1, d),
        cache).

        ``params`` is one model's leaves, or a list of the clusters' (views
        into a ``(D, ...)`` stack) with ``cluster`` (B,) naming each row's:
        every op that reads weights then runs once a cluster over all rows
        and each row keeps its own cluster's result.  ``pos`` is the token's
        position, an int, a scalar tensor or one a row (B,); the cache's
        ``pos`` leaves are (nblocks, Sc) shared or (nblocks, B, Sc) a row.
        The cache is written in place (the returned dict is ``cache``);
        ``gate`` (a scalar bool tensor) writes the old values back where it
        is False.  ``per_row`` decodes each row as a batch of its own (the
        slot pool's semantics): an MoE layer gives every expert room for
        all B rows, so no row's expert choice is dropped or depends on the
        other rows; without it the batch routes as one token set, as the
        reference's ``decode_step``."""
        cfg = self.cfg
        plist, sel = _clusters(params, cluster)
        tok = token[..., None]  # (B, 1), or (B, K, 1) for audio
        x = _route(lambda p: self.embed_tokens(p, tok), plist, sel)
        b, dev = x.shape[0], x.device
        q_pos = torch.as_tensor(pos, device=dev).to(torch.int32)
        q_pos = q_pos.expand(b) if q_pos.dim() == 0 else q_pos
        capacity = b if per_row else None
        for i in range(cfg.num_scan_blocks):
            for li in range(cfg.scan_period):
                prefix = f"blocks.pos{li}."
                layer = [{k[len(prefix):]: w[i] for k, w in p.items() if k.startswith(prefix)}
                         for p in plist]
                x = self._decode_layer(layer, sel, x, li, cache, i, q_pos, gate, capacity)
        x = _route(lambda p: rms_norm(x, p["ln_final"], cfg.norm_eps), plist, sel)
        return x, cache

    def _decode_layer(self, plist: list, sel, x: torch.Tensor, li: int, cache: dict,
                      block: int, q_pos: torch.Tensor, gate,
                      capacity: Optional[int]) -> torch.Tensor:
        """Layer ``li`` of block ``block`` for one token a row (an MoE FFN's
        experts ``capacity`` slots each); its cache is written in place."""
        cfg = self.cfg
        b = x.shape[0]
        pre = f"pos{li}."
        if cfg.layer_kind(li) == "attn":
            q, k, v = _route(lambda p: _qkv(p, rms_norm(x, p["ln_mix"], cfg.norm_eps), cfg,
                                            q_pos[:, None]), plist, sel)
            k_c, v_c, pos_c = (cache[pre + n][block] for n in ("k", "v", "pos"))
            window = cfg.window_for_layer(li, self.long_context)
            if self.decode_impl is not None:
                if gate is not None or sel is not None:
                    raise NotImplementedError(
                        "a gated or cluster-routed decode through decode_impl (the slot "
                        "pool's, the federated servers') is not ported: no path of the "
                        "reference takes it (ROADMAP.md §1 item 4, 'Multi-device and "
                        "launch': 'decode_impl', its slot-pool forms filed as not needed)")
                # the sharded decode writes its cache shards in place
                o = self.decode_impl(q[:, 0], k_c, v_c, pos_c, q_pos[0], k[:, 0], v[:, 0],
                                     window=window, logit_cap=cfg.attn_logit_softcap)[0]
            else:
                # the ring buffer: position q lands in slot q % Sc
                slot = (q_pos % k_c.shape[1]).long()
                rows = torch.arange(b, device=x.device)
                _write(k_c, (rows, slot), k[:, 0], gate)
                _write(v_c, (rows, slot), v[:, 0], gate)
                if pos_c.dim() == 1:  # one position row shared by the batch
                    _write(pos_c, (slot[:1],), q_pos[:1], gate)
                else:
                    _write(pos_c, (rows, slot), q_pos, gate)
                o = decode_attention(q[:, 0], k_c, v_c, pos_c, q_pos, window=window,
                                     logit_cap=cfg.attn_logit_softcap)
            o = o.reshape(b, 1, cfg.num_heads * cfg.head_dim)

            def mixed(p):
                return dense(o, p["attn.wo"])
        else:
            layer_cache = {n: cache[pre + n][block] for n in _MAMBA_CACHE}
            mix, new = _route(lambda p: mamba_decode_step(
                _sub(p, "mamba."), rms_norm(x, p["ln_mix"], cfg.norm_eps), cfg, layer_cache),
                plist, sel)
            for n, t in new.items():
                buf = layer_cache[n]
                buf.copy_(t if gate is None else torch.where(gate, t.to(buf.dtype), buf))

            def mixed(p):
                return mix
        return _route(lambda p: _finish_layer(p, x, mixed(p), cfg, li, capacity)[0], plist, sel)

    def decode_step(self, params, token: torch.Tensor, cache: dict, pos, *,
                    cluster: Optional[torch.Tensor] = None,
                    gate: Optional[torch.Tensor] = None, per_row: bool = False):
        """token: (B,), or (B, K) for audio; pos: the token's position.
        Returns (logits (B, 1, V) or (B, 1, K, V), cache written in place);
        keywords as ``decode_hidden``'s."""
        x, cache = self.decode_hidden(params, token, cache, pos, cluster=cluster, gate=gate,
                                      per_row=per_row)
        plist, sel = _clusters(params, cluster)
        return _route(lambda p: self.logits(p, x), plist, sel), cache
