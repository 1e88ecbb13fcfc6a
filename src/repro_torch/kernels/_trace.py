"""The kernel wrappers' traced calls.

On a tensor without data (a ``meta`` tensor, or a ``FakeTensorMode``'s) a
wrapper launches nothing: it returns outputs of its kernel's shapes and
dtypes and reports the kernel's work (flops by peak class, bytes it moves)
to the counters listening here (``roofline.trace.StepCounter``), so a
traced step counts the program the card runs, not the plain versions.
The branch is taken before a wrapper's CPU/CUDA dispatch and only for such
tensors: a real CPU tensor still takes the plain version, a real CUDA
tensor still launches the kernel or raises.
"""
from __future__ import annotations

import torch

__all__ = ["traced", "report", "nbytes", "LISTENERS"]

# counters that take ``kernel(name, flops, flop_class, nbytes)`` calls
LISTENERS: list = []


def traced(t: torch.Tensor) -> bool:
    """Whether ``t`` holds no data (meta, or a fake tensor)."""
    if t.is_meta:
        return True
    from torch._subclasses.fake_tensor import is_fake

    return is_fake(t)


def report(kernel: str, flops: float, flop_class: str, nbytes: float) -> None:
    """Hand one traced call's work to every listening counter."""
    for listener in LISTENERS:
        listener.kernel(kernel, flops, flop_class, nbytes)


def nbytes(*tensors) -> int:
    """The bytes of ``tensors``' elements."""
    return sum(t.numel() * t.element_size() for t in tensors)
