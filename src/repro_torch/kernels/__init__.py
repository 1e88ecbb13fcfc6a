"""Hand-written CUDA kernels for Hopper (sm_90a), one per TPU kernel ported.

Each kernel ships as ``<name>/{csrc/*.cu, ops.py, ref.py}``: the CUDA source
(built with ``nvcc`` at first use and bound with ctypes, see ``_build.py``),
the wrapper that dispatches by device and counts launches, and the plain
PyTorch version that CPU tensors take and the card is checked against.
"""
from .fused_sgd import sgd_update, sgd_update_ref, sgd_update_tree
from .fused_transition import fused_transition, fused_transition_ref, fused_transition_tree

__all__ = [
    "sgd_update", "sgd_update_ref", "sgd_update_tree",
    "fused_transition", "fused_transition_ref", "fused_transition_tree",
]
