"""Plain PyTorch version of the gossip mixing kernel."""
import torch


def gossip_mix_ref(y: torch.Tensor, p: torch.Tensor, alpha: int = 1) -> torch.Tensor:
    """``Y @ P^alpha`` on (D, M) with column convention new[d] = sum_j p[j, d] y[j],
    accumulated in f32 and cast back to ``y.dtype``."""
    out = y.float()
    pf = p.float()
    for _ in range(alpha):
        out = pf.T @ out
    return out.to(y.dtype)
