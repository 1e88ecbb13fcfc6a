"""granite-8b [dense] — 36L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=49152; llama-arch, code.  [arXiv:2405.04324]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    d_ff=14336,
    vocab_size=49152,
    num_heads=32,
    num_kv_heads=8,
    long_context_window=8192,
    rope_theta=10_000.0,
)
