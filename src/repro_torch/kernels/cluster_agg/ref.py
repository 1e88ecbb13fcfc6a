"""Plain PyTorch version of the intra-cluster aggregation kernel."""
import torch


def cluster_agg_ref(w: torch.Tensor, weights: torch.Tensor, num_clusters: int) -> torch.Tensor:
    """(C, M) -> (D, M): ``Y[d] = sum_{i in d} weights[i] W[i]`` over contiguous
    clusters of ``C / num_clusters`` rows, accumulated in f32."""
    c, m = w.shape
    g = c // num_clusters
    wf = w.float().reshape(num_clusters, g, m)
    wt = weights.float().reshape(num_clusters, g)
    return torch.einsum("dgm,dg->dm", wf, wt).to(w.dtype)
