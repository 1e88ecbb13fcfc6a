"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8 experts top-2, sliding-window attention.  [arXiv:2401.04088]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=32000,
    num_heads=32,
    num_kv_heads=8,
    num_experts=8,
    num_experts_per_tok=2,
    sliding_window=4096,      # natively sub-quadratic decode state
    rope_theta=1_000_000.0,
)
