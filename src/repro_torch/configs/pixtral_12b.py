"""pixtral-12b — [vlm] pixtral-ViT + Mistral-NeMo backbone.
[hf:mistralai/Pixtral-12B-2409; unverified]  Vision frontend is a stub:
input_specs() supplies precomputed patch embeddings (see DESIGN.md §5)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b", family="vlm", n_layers=40, d_model=5120,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=131072, head_dim=128,
    frontend="vision_stub", n_patches=256)
