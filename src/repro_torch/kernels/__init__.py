"""Hand-written CUDA kernels for Hopper (sm_90a), one per TPU kernel ported.

Each kernel ships as ``<name>/{csrc/*.cu, ops.py, ref.py}``: the CUDA source
(built with ``nvcc`` at first use and bound with ctypes, see ``_build.py``),
the wrapper that dispatches by device and counts launches, and the plain
PyTorch version that CPU tensors take and the card is checked against.
"""
from .cluster_agg import cluster_agg, cluster_agg_ref, cluster_agg_tree
from .flash_attention import (
    flash_attention, flash_attention_bwd, flash_attention_bwd_ref, flash_attention_fwd,
    flash_attention_fwd_ref,
)
from .fused_sgd import (
    normalized_update, normalized_update_ref, normalized_update_tree, sgd_update, sgd_update_ref,
    sgd_update_tree,
)
from .fused_transition import fused_transition, fused_transition_ref, fused_transition_tree
from .gossip_mix import gossip_mix, gossip_mix_ref, gossip_mix_tree

__all__ = [
    "sgd_update", "sgd_update_ref", "sgd_update_tree",
    "normalized_update", "normalized_update_ref", "normalized_update_tree",
    "fused_transition", "fused_transition_ref", "fused_transition_tree",
    "gossip_mix", "gossip_mix_ref", "gossip_mix_tree",
    "cluster_agg", "cluster_agg_ref", "cluster_agg_tree",
    "flash_attention", "flash_attention_fwd", "flash_attention_bwd",
    "flash_attention_fwd_ref", "flash_attention_bwd_ref",
]
