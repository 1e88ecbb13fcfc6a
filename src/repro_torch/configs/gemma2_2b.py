"""gemma2-2b [dense] — 26L d_model=2304 8H (GQA kv=4) d_ff=9216
vocab=256000; local/global alternating attention, logit softcaps.
[arXiv:2408.00118]

head_dim=256.  long_500k runs the documented long-context variant: global
layers capped to a 131072-token sliding window.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    d_ff=9216,
    vocab_size=256000,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    local_global_alternating=True,
    local_window=4096,
    long_context_window=131072,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    use_post_norm=True,
    embed_scale=True,
    tie_embeddings=True,
    rope_theta=10_000.0,
)
