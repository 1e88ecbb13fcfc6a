"""pixtral-12b [vlm] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072; pixtral-ViT + mistral-nemo backbone.  [hf:mistralai/Pixtral-12B-2409]

The vision tower is a stub: the caller supplies ``frontend_embeds``, 256
precomputed patch embeddings that replace the first 256 token positions
(loss-masked).
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    modality="vision",
    frontend_tokens=256,
    num_layers=40,
    d_model=5120,
    d_ff=14336,
    vocab_size=131072,
    num_heads=32,
    num_kv_heads=8,
    long_context_window=8192,
    rope_theta=1_000_000.0,
)
