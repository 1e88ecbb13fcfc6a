"""musicgen-large [audio] — 48L d_model=2048 32H (kv=32, i.e. MHA)
d_ff=8192 vocab=2048; decoder-only over EnCodec tokens.  [arXiv:2306.05284]

The EnCodec codec is a stub: tokens arrive as a (B, K=4, S)
codebook grid; embeddings are summed over codebooks and K output heads emit
per-codebook logits (the delay-pattern bookkeeping lives in the codec stub).
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    modality="audio",
    num_codebooks=4,
    num_layers=48,
    d_model=2048,
    d_ff=8192,
    vocab_size=2048,
    num_heads=32,
    num_kv_heads=32,
    long_context_window=8192,
    rope_theta=10_000.0,
)
