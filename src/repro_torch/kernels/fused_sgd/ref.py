"""Plain PyTorch versions of the fused-SGD kernels."""
import torch


def sgd_update_ref(w: torch.Tensor, g: torch.Tensor, lr: float) -> torch.Tensor:
    """``w - lr * g`` in f32, cast back to ``w.dtype``."""
    return (w.float() - lr * g.float()).to(w.dtype)


def normalized_update_ref(w_final: torch.Tensor, w_start: torch.Tensor, inv_theta) -> torch.Tensor:
    """``(w_final - w_start) * inv_theta`` in f32, cast back to ``w_final.dtype``.

    ``inv_theta`` is a float (every element), or an (R,) tensor with one
    factor per row of (R, ...) operands.
    """
    diff = w_final.float() - w_start.float()
    if isinstance(inv_theta, torch.Tensor):
        inv_theta = inv_theta.float().reshape((-1,) + (1,) * (diff.dim() - 1))
    return (diff * inv_theta).to(w_final.dtype)
