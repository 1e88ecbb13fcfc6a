"""Plain PyTorch version of the fused SGD kernel."""
import torch


def sgd_update_ref(w: torch.Tensor, g: torch.Tensor, lr: float) -> torch.Tensor:
    """``w - lr * g`` in f32, cast back to ``w.dtype``."""
    return (w.float() - lr * g.float()).to(w.dtype)
