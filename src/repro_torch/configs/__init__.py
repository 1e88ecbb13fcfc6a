"""Registry of the architectures the port runs: the dense text configs.

The port's ``repro.configs`` for the federated-LM slice: ``granite-8b``,
``qwen2.5-3b`` (QKV bias), ``command-r-35b`` and ``gemma2-2b`` (local/global
windows, logit softcaps, post norms, embed scale, tied embeddings), with
the reference's published widths.  The MoE, SSM, hybrid, VLM and audio
families are named but raise ``NotImplementedError`` until their slice.
"""
from __future__ import annotations

import importlib

from ..models.config import ArchConfig

__all__ = ["ARCH_NAMES", "get_config"]

_MODULES = {
    "granite-8b": "granite_8b",
    "command-r-35b": "command_r_35b",
    "qwen2.5-3b": "qwen2_5_3b",
    "gemma2-2b": "gemma2_2b",
}
# the reference's other architectures, and where ROADMAP.md queues them
_NOT_PORTED = {
    "grok-1-314b": "MoE",
    "mixtral-8x7b": "MoE",
    "mamba2-780m": "SSM",
    "jamba-1.5-large-398b": "hybrid",
    "pixtral-12b": "VLM",
    "musicgen-large": "audio",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} ({_NOT_PORTED[name]} family) is not ported yet "
            f"(ROADMAP.md queue 1, 'Model families')"
        )
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCH_NAMES}")
    mod = importlib.import_module(f"{__name__}.{_MODULES[name]}")
    return mod.CONFIG
