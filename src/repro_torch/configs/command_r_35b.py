"""command-r-35b [dense] — 40L d_model=8192 64H (GQA kv=8) d_ff=22528
vocab=256000; GQA, no-bias.  [hf:CohereForAI/c4ai-command-r-v01]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    d_ff=22528,
    vocab_size=256000,
    num_heads=64,
    num_kv_heads=8,
    long_context_window=8192,
    rope_theta=8_000_000.0,
)
