"""Registry of the architectures the port runs: the reference's ten.

The port's ``repro.configs``, with the reference's published widths: the
dense text configs (``granite-8b``, ``qwen2.5-3b``, ``command-r-35b``,
``gemma2-2b``), the MoE configs (``mixtral-8x7b``, ``grok-1-314b``), the
SSM ``mamba2-780m``, the hybrid ``jamba-1.5-large-398b``, the VLM
``pixtral-12b`` and the audio ``musicgen-large``.
"""
from __future__ import annotations

import importlib

from ..models.config import ArchConfig
from .shapes import SHAPES, InputShape, input_specs, make_concrete_batch

__all__ = ["ARCH_NAMES", "get_config", "all_configs", "SHAPES", "InputShape", "input_specs",
           "make_concrete_batch"]

_MODULES = {
    "grok-1-314b": "grok_1_314b",
    "granite-8b": "granite_8b",
    "pixtral-12b": "pixtral_12b",
    "command-r-35b": "command_r_35b",
    "mamba2-780m": "mamba2_780m",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "qwen2.5-3b": "qwen2_5_3b",
    "musicgen-large": "musicgen_large",
    "mixtral-8x7b": "mixtral_8x7b",
    "gemma2-2b": "gemma2_2b",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCH_NAMES}")
    mod = importlib.import_module(f"{__name__}.{_MODULES[name]}")
    return mod.CONFIG


def all_configs() -> dict[str, ArchConfig]:
    return {name: get_config(name) for name in ARCH_NAMES}
