from .ops import MAX_D, gossip_mix, gossip_mix_tree
from .ref import gossip_mix_ref

__all__ = ["gossip_mix", "gossip_mix_tree", "gossip_mix_ref", "MAX_D"]
