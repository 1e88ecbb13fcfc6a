"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072,
MoE 8 experts top-2.  [hf:xai-org/grok-1]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    d_ff=32768,
    vocab_size=131072,
    num_heads=48,
    num_kv_heads=8,
    num_experts=8,
    num_experts_per_tok=2,
    attn_logit_softcap=30.0,     # grok-1 uses attention logit capping
    long_context_window=8192,    # long_500k sliding-window variant (full attn otherwise)
    rope_theta=10_000.0,
)
