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
embeddings and emits ``K`` heads of logits.  ``remat`` raises
``NotImplementedError``; ``prefill``, ``init_cache`` and ``decode_step``
come with the serving slice.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .config import ArchConfig
from .layers import causal_attention, dense, gated_mlp, init_dense, rms_norm, rope, softcap
from .mamba import init_mamba_params, mamba_forward
from .moe import init_moe_params, moe_mlp

__all__ = ["CausalLM"]


def _check_ported(cfg: ArchConfig) -> None:
    if cfg.remat:
        raise NotImplementedError(
            f"{cfg.name}: remat=True (ROADMAP.md queue 1, 'remat': activation "
            f"checkpointing under torch.func) is not ported yet")


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


def _attention(p: dict, x: torch.Tensor, cfg: ArchConfig, *, window: Optional[int],
               positions: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = dense(x, p["attn.wq"], p.get("attn.bq")).reshape(b, s, hq, hd)
    k = dense(x, p["attn.wk"], p.get("attn.bk")).reshape(b, s, hkv, hd)
    v = dense(x, p["attn.wv"], p.get("attn.bv")).reshape(b, s, hkv, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    out = causal_attention(q, k, v, window=window, logit_cap=cfg.attn_logit_softcap,
                           impl=cfg.attn_impl, chunk=cfg.attn_chunk)
    return dense(out.reshape(b, s, hq * hd), p["attn.wo"])


def _apply_layer(p: dict, x: torch.Tensor, cfg: ArchConfig, idx_in_period: int, *,
                 long_context: bool, positions: torch.Tensor):
    """One layer (mixer + optional FFN), pre-norm, optional post-norms.
    Returns (x, router aux loss, or None for a layer without MoE)."""
    aux = None
    h = rms_norm(x, p["ln_mix"], cfg.norm_eps)
    if cfg.layer_kind(idx_in_period) == "attn":
        mix = _attention(p, h, cfg, window=cfg.window_for_layer(idx_in_period, long_context),
                         positions=positions)
    else:
        mix, _ = mamba_forward(_sub(p, "mamba."), h, cfg)
    if cfg.use_post_norm:
        mix = rms_norm(mix, p["ln_mix_post"], cfg.norm_eps)
    x = x + mix
    if cfg.d_ff:
        h = rms_norm(x, p["ln_ffn"], cfg.norm_eps)
        if cfg.is_moe_layer(idx_in_period):
            out, aux = moe_mlp(h, _sub(p, "ffn."), num_experts_per_tok=cfg.num_experts_per_tok,
                               capacity_factor=cfg.moe_capacity_factor)
        else:
            out = gated_mlp(h, _sub(p, "ffn."))
        if cfg.use_post_norm:
            out = rms_norm(out, p["ln_ffn_post"], cfg.norm_eps)
        x = x + out
    return x, aux


class CausalLM:
    """Functional causal LM over flat parameter dicts."""

    def __init__(self, cfg: ArchConfig, long_context: bool = False):
        _check_ported(cfg)
        self.cfg = cfg
        self.long_context = long_context

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

    # -- embedding / head -----------------------------------------------------
    def embed_tokens(self, params: dict, tokens: torch.Tensor,
                     frontend_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens (B, S), or (B, K, S) codebooks for audio -> (B, S, d); the
        first ``F`` positions replaced by ``frontend_embeds`` (B, F, d)."""
        cfg = self.cfg
        if _audio(cfg):
            x = F.embedding(tokens[:, 0], params["embed"][0]).to(cfg.act_dtype)
            for k in range(1, cfg.num_codebooks):
                x = x + F.embedding(tokens[:, k], params["embed"][k]).to(cfg.act_dtype)
        else:
            x = F.embedding(tokens, params["embed"])  # (B, S, d)
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
    def _run_stack(self, params: dict, x: torch.Tensor, positions: torch.Tensor):
        """(x, the MoE layers' aux losses summed, an f32 scalar)."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        # each stacked leaf split once along the block axis: its gradient is
        # then one stack of the blocks' gradients (one squeeze, a view, for a
        # single block), where an index per block would add a zero-padded
        # full-size gradient per block
        nb = cfg.num_scan_blocks
        blocks = {k: (w.unbind(0) if nb > 1 else (w.squeeze(0),))
                  for k, w in params.items() if k.startswith("blocks.")}
        for i in range(nb):
            for pos in range(cfg.scan_period):
                prefix = f"blocks.pos{pos}."
                p = {k[len(prefix):]: w[i] for k, w in blocks.items() if k.startswith(prefix)}
                x, a = _apply_layer(p, x, cfg, pos, long_context=self.long_context,
                                    positions=positions)
                if a is not None:
                    aux = aux + a
        return x, aux

    # -- public API -------------------------------------------------------------
    def forward(self, params: dict, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """batch: {tokens (B, S) or (B, K, S), frontend_embeds?} -> (f32
        logits over the padded vocabulary, router aux loss)."""
        tokens = batch["tokens"]
        x = self.embed_tokens(params, tokens, batch.get("frontend_embeds"))
        positions = torch.arange(tokens.shape[-1], device=x.device)
        x, aux = self._run_stack(params, x, positions)
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
