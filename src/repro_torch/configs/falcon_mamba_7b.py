"""falcon-mamba-7b — [ssm] Mamba1, attention-free. [arXiv:2410.05355; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b", family="ssm", n_layers=64, d_model=4096,
    n_heads=1, n_kv_heads=1, d_ff=0, vocab=65024, ssm_state=16,
    mamba_version=1, ssm_expand=2)
