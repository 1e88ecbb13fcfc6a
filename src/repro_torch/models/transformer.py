"""Decoder-only causal LM for the dense text architectures.

The port's ``repro.models.transformer.CausalLM`` for full-sequence training
(``forward``, ``loss``).  Parameters are a flat dict of dotted names, the
reference's nested tree flattened (``convert.flatten_params``): ``embed``,
``ln_final``, ``head`` (unless tied) and per-layer leaves such as
``blocks.pos0.attn.wq``.  The stack is ``num_scan_blocks`` homogeneous
blocks of ``scan_period`` layers; every block leaf keeps the block axis as
axis 0, and ``_run_stack`` is a Python loop over it (the reference's
``lax.scan``).  Under ``torch.func.vmap`` over clients the client axis is
hidden, so block ``i`` is still ``params[name][i]``.

Attention runs through ``models.layers.causal_attention`` with
``cfg.attn_impl``.  MoE and Mamba layers, other modalities and ``remat``
raise ``NotImplementedError``; ``prefill``, ``init_cache`` and
``decode_step`` come with the serving slice.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .config import ArchConfig
from .layers import causal_attention, dense, gated_mlp, init_dense, rms_norm, rope, softcap

__all__ = ["CausalLM"]


def _check_ported(cfg: ArchConfig) -> None:
    why = None
    if cfg.modality != "text" or cfg.num_codebooks > 1 or cfg.frontend_tokens:
        why = f"modality {cfg.modality!r} (ROADMAP.md queue 1, 'Model families')"
    elif cfg.num_experts:
        why = "MoE layers (ROADMAP.md queue 1, 'Model families')"
    elif any(cfg.layer_kind(i) != "attn" for i in range(cfg.scan_period)):
        why = "Mamba layers (ROADMAP.md queue 1, 'Model families')"
    elif cfg.remat:
        why = ("remat=True (ROADMAP.md queue 1, 'remat': activation checkpointing "
               "under torch.func)")
    if why is not None:
        raise NotImplementedError(f"{cfg.name}: {why} is not ported yet")


def _init_layer(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """One dense attention layer's leaves, names relative to ``blocks.posI``."""
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = cfg.param_dtype
    p = {"ln_mix": torch.ones(d, dtype=dt)}
    p["attn.wq"] = init_dense(gen, d, hq * hd, dt)
    p["attn.wk"] = init_dense(gen, d, hkv * hd, dt)
    p["attn.wv"] = init_dense(gen, d, hkv * hd, dt)
    p["attn.wo"] = init_dense(gen, hq * hd, d, dt)
    if cfg.qkv_bias:
        p["attn.bq"] = torch.zeros(hq * hd, dtype=dt)
        p["attn.bk"] = torch.zeros(hkv * hd, dtype=dt)
        p["attn.bv"] = torch.zeros(hkv * hd, dtype=dt)
    if cfg.use_post_norm:
        p["ln_mix_post"] = torch.ones(d, dtype=dt)
    if cfg.d_ff:
        p["ln_ffn"] = torch.ones(d, dtype=dt)
        p["ffn.w_gate"] = init_dense(gen, d, cfg.d_ff, dt)
        p["ffn.w_up"] = init_dense(gen, d, cfg.d_ff, dt)
        p["ffn.w_down"] = init_dense(gen, cfg.d_ff, d, dt)
        if cfg.use_post_norm:
            p["ln_ffn_post"] = torch.ones(d, dtype=dt)
    return p


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
                 long_context: bool, positions: torch.Tensor) -> torch.Tensor:
    """One layer (attention + optional gated FFN), pre-norm, optional post-norms."""
    h = rms_norm(x, p["ln_mix"], cfg.norm_eps)
    mix = _attention(p, h, cfg, window=cfg.window_for_layer(idx_in_period, long_context),
                     positions=positions)
    if cfg.use_post_norm:
        mix = rms_norm(mix, p["ln_mix_post"], cfg.norm_eps)
    x = x + mix
    if cfg.d_ff:
        h = rms_norm(x, p["ln_ffn"], cfg.norm_eps)
        out = gated_mlp(h, {k[4:]: p[k] for k in ("ffn.w_gate", "ffn.w_up", "ffn.w_down")})
        if cfg.use_post_norm:
            out = rms_norm(out, p["ln_ffn_post"], cfg.norm_eps)
        x = x + out
    return x


class CausalLM:
    """Functional causal LM over flat parameter dicts."""

    def __init__(self, cfg: ArchConfig, long_context: bool = False):
        _check_ported(cfg)
        self.cfg = cfg
        self.long_context = long_context

    # -- init ---------------------------------------------------------------
    def init(self, gen: torch.Generator) -> dict:
        """Fresh parameters drawn from ``gen`` (CPU), in ``cfg.param_dtype``."""
        cfg = self.cfg
        dt = cfg.param_dtype
        v = cfg.padded_vocab
        params = {"embed": (torch.randn((v, cfg.d_model), generator=gen) * 0.02).to(dt)}
        for pos in range(cfg.scan_period):
            layers = [_init_layer(gen, cfg) for _ in range(cfg.num_scan_blocks)]
            for name in layers[0]:
                params[f"blocks.pos{pos}.{name}"] = torch.stack([lp[name] for lp in layers])
        params["ln_final"] = torch.ones(cfg.d_model, dtype=dt)
        if not cfg.tie_embeddings:
            params["head"] = init_dense(gen, cfg.d_model, v, dt)
        return params

    # -- embedding / head -----------------------------------------------------
    def embed_tokens(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = F.embedding(tokens, params["embed"]).to(cfg.act_dtype)  # (B, S, d)
        if cfg.embed_scale:
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
        return x

    def logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.tie_embeddings:
            out = torch.einsum("bsd,vd->bsv", x, params["embed"].to(x.dtype))
        else:
            out = dense(x, params["head"])
        return softcap(out.float(), cfg.final_logit_softcap)

    # -- stack ------------------------------------------------------------------
    def _run_stack(self, params: dict, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        for i in range(cfg.num_scan_blocks):
            for pos in range(cfg.scan_period):
                prefix = f"blocks.pos{pos}."
                p = {k[len(prefix):]: w[i] for k, w in params.items() if k.startswith(prefix)}
                x = _apply_layer(p, x, cfg, pos, long_context=self.long_context,
                                 positions=positions)
        return x

    # -- public API -------------------------------------------------------------
    def forward(self, params: dict, batch: dict) -> torch.Tensor:
        """batch: {tokens (B, S)} -> f32 logits (B, S, padded_vocab)."""
        tokens = batch["tokens"]
        x = self.embed_tokens(params, tokens)
        positions = torch.arange(tokens.shape[-1], device=x.device)
        x = self._run_stack(params, x, positions)
        x = rms_norm(x, params["ln_final"], self.cfg.norm_eps)
        return self.logits(params, x)

    def loss(self, params: dict, batch: dict) -> torch.Tensor:
        """Mean next-token negative log-likelihood over ``logits[..., :vocab_size]``."""
        logits = self.forward(params, batch)[..., : self.cfg.vocab_size]
        logp = torch.log_softmax(logits, dim=-1)
        labels = batch["labels"].long()
        nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
        mask = batch.get("loss_mask")
        if mask is not None:
            nll = nll * mask
            return nll.sum() / torch.clamp(mask.sum(), min=1.0)
        return nll.mean()
