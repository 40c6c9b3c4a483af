"""musicgen-medium — [audio] decoder-only over EnCodec tokens.
[arXiv:2306.05284; hf]  4 codebooks x vocab 2048, summed codebook embeddings
+ per-codebook heads; delay-pattern interleaving stubbed (frontend stub)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium", family="audio", n_layers=48, d_model=1536,
    n_heads=24, n_kv_heads=24, d_ff=6144, vocab=2048,
    frontend="audio_codebooks", n_codebooks=4)
