from .ops import sgd_update, sgd_update_tree
from .ref import sgd_update_ref

__all__ = ["sgd_update", "sgd_update_tree", "sgd_update_ref"]
