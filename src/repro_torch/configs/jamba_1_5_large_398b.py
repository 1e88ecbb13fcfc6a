"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16 experts top-2; Mamba+attention 1:7
interleave.  [arXiv:2403.19887]

Layer pattern (period 8): attention at offset 4, mamba elsewhere; MoE FFN on
every second layer (period 2) as in the Jamba paper.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    d_ff=24576,
    vocab_size=65536,
    num_heads=64,
    num_kv_heads=8,
    num_experts=16,
    num_experts_per_tok=2,
    moe_layer_period=2,
    attn_layer_period=8,
    attn_layer_offset=4,
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=128,         # 128 SSD heads (d_inner=16384)
    ssm_chunk=128,
)
