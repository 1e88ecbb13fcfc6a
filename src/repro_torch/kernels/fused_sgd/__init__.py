from .ops import normalized_update, sgd_update, sgd_update_tree
from .ref import normalized_update_ref, sgd_update_ref

__all__ = ["sgd_update", "sgd_update_tree", "sgd_update_ref",
           "normalized_update", "normalized_update_ref"]
