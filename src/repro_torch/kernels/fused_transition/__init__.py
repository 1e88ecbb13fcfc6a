from .ops import fused_transition, fused_transition_tree
from .ref import fused_transition_ref

__all__ = ["fused_transition", "fused_transition_tree", "fused_transition_ref"]
