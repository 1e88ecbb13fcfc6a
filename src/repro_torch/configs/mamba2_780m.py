"""mamba2-780m [ssm] — 48L d_model=1536, attention-free, vocab=50280,
ssm_state=128, SSD (state-space duality).  [arXiv:2405.21060]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    d_ff=0,                  # pure mamba blocks, no FFN
    vocab_size=50280,        # padded to 50432 for sharding
    num_heads=0,
    num_kv_heads=0,
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,         # 48 SSD heads (d_inner=3072)
    ssm_chunk=128,
    tie_embeddings=True,
)
