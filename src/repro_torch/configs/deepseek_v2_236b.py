"""deepseek-v2-236b — [moe] MLA (kv_lora=512) + 2 shared / 160 routed top-6.
[arXiv:2405.04434; hf]  Decode caches the compressed 512+64 latent (absorbed
matmuls) — the MLA serving design."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b", family="moe", n_layers=60, d_model=5120,
    n_heads=128, n_kv_heads=128, d_ff=1536, vocab=102400,
    n_experts=160, n_shared_experts=2, moe_top_k=6, d_ff_expert=1536,
    kv_lora_rank=512, q_lora_rank=1536, qk_rope_dim=64, qk_nope_dim=128,
    v_head_dim=128)
