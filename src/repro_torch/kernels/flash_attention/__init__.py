from .ops import MAX_HEAD_DIM, flash_attention, flash_attention_bwd, flash_attention_fwd, route
from .ref import flash_attention_bwd_ref, flash_attention_fwd_ref

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_fwd_ref", "flash_attention_bwd_ref", "MAX_HEAD_DIM", "route"]
