from .ops import cluster_agg, cluster_agg_tree
from .ref import cluster_agg_ref

__all__ = ["cluster_agg", "cluster_agg_tree", "cluster_agg_ref"]
