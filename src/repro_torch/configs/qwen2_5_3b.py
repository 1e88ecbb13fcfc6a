"""qwen2.5-3b [dense] — 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936; QKV bias.  [hf:Qwen/Qwen2.5-3B]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    d_ff=11008,
    vocab_size=151936,
    num_heads=16,
    num_kv_heads=2,
    qkv_bias=True,
    long_context_window=8192,
    rope_theta=1_000_000.0,
)
