"""zamba2-1.2b — [hybrid] Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; hf]  38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000
ssm_state=64; one *shared* GQA block applied every 6 layers."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid", n_layers=38, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab=32000, ssm_state=64,
    mamba_version=2, ssm_expand=2, mamba_headdim=64, attn_every=6)
