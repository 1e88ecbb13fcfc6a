"""Assigned input shapes and meta-device input specs for the dry run.

The port's ``repro.configs.shapes``.  Four shapes::

    train_4k     seq_len=4096    global_batch=256   -> train step
    prefill_32k  seq_len=32768   global_batch=32    -> prefill step
    decode_32k   seq_len=32768   global_batch=128   -> serve step (1 new token)
    long_500k    seq_len=524288  global_batch=1     -> serve step, sub-quadratic

``input_specs`` returns meta-device tensors of the inputs' shapes and dtypes
(no storage; the reference's ``jax.ShapeDtypeStruct``), covering every model
input, the stubbed modality frontends included.  ``make_concrete_batch``
draws a concrete batch of those specs from numpy, with the reference's
draws, so one seed gives the reference's integers.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import numpy as np
import torch

from ..models.config import ArchConfig

__all__ = ["InputShape", "SHAPES", "input_specs", "make_concrete_batch"]

StepKind = Literal["train", "prefill", "decode"]


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    step: StepKind
    long_context: bool = False


SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode", long_context=True),
}


def _token_shape(cfg: ArchConfig, batch: int, seq: int) -> tuple[int, ...]:
    if cfg.modality == "audio" and cfg.num_codebooks > 1:
        return (batch, cfg.num_codebooks, seq)
    return (batch, seq)


def _meta(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: InputShape, num_clients: Optional[int] = None) -> dict:
    """Meta-device tensors for the step's data inputs.

    For ``train`` the leading axis is the client axis (federated replicas)
    and tokens are ``(C, per_client_batch, S)``; ``num_clients`` (default 1)
    must divide ``global_batch``.
    """
    i32 = torch.int32
    s, b = shape.seq_len, shape.global_batch
    if shape.step == "train":
        c = num_clients or 1
        if b % c:
            raise ValueError(f"global_batch {b} % num_clients {c} != 0")
        per = b // c
        tok = _token_shape(cfg, per, s)
        specs = {"tokens": _meta((c,) + tok, i32), "labels": _meta((c,) + tok, i32)}
        if cfg.frontend_tokens:
            specs["frontend_embeds"] = _meta((c, per, cfg.frontend_tokens, cfg.d_model),
                                             cfg.param_dtype)
        return specs
    if shape.step == "prefill":
        specs = {"tokens": _meta(_token_shape(cfg, b, s), i32)}
        if cfg.frontend_tokens:
            specs["frontend_embeds"] = _meta((b, cfg.frontend_tokens, cfg.d_model),
                                             cfg.param_dtype)
        return specs
    # decode: one new token per sequence and the current position (the cache
    # is passed separately)
    tok = (b, cfg.num_codebooks) if cfg.modality == "audio" and cfg.num_codebooks > 1 else (b,)
    return {"token": _meta(tok, i32), "pos": _meta((), i32)}


def make_concrete_batch(cfg: ArchConfig, shape: InputShape, rng_seed: int = 0,
                        num_clients: Optional[int] = None, device=None) -> dict:
    """A concrete batch of ``input_specs``' shapes and dtypes on ``device``
    (``None``: the card), drawn from ``numpy.random.default_rng(rng_seed)``
    in the reference's order: integers below the vocabulary for tokens and
    labels, ``seq_len - 1`` for ``pos``, a normal draw (through f32) for
    frontend embeddings."""
    from ..core.device import resolve_device

    device = resolve_device(device)
    rng = np.random.default_rng(rng_seed)
    out = {}
    for k, spec in input_specs(cfg, shape, num_clients).items():
        if spec.dtype == torch.int32:
            hi = cfg.vocab_size if k in ("tokens", "labels", "token") else max(shape.seq_len, 1)
            arr = (rng.integers(0, hi, size=tuple(spec.shape)).astype(np.int32) if spec.dim()
                   else np.asarray(shape.seq_len - 1, dtype=np.int32))
            out[k] = torch.from_numpy(arr).to(device)
        else:
            arr = rng.normal(size=tuple(spec.shape)).astype(np.float32)
            out[k] = torch.from_numpy(arr).to(device=device, dtype=spec.dtype)
    return out
