"""Plain PyTorch version of the fused Lemma-1 transition kernel."""
import torch


def fused_transition_ref(w: torch.Tensor, vt: torch.Tensor, p: torch.Tensor,
                         bt: torch.Tensor, alpha: int = 1) -> torch.Tensor:
    """B^T (P^T)^alpha V^T W on (C, M), accumulated in f32."""
    y = vt.float() @ w.float()
    pf = p.float()
    for _ in range(alpha):
        y = pf.T @ y
    return (bt.float() @ y).to(w.dtype)
