"""Architecture configuration schema for the assigned model pool.

A field-for-field copy of the reference's ``configs/base.py``: the port
imports nothing of the reference package."""
from __future__ import annotations

import dataclasses

__all__ = ["ArchConfig"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    qkv_bias: bool = False

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # --- MLA (DeepSeek-V2) ---------------------------------------------------
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    # --- SSM (Mamba) ---------------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    mamba_version: int = 1
    mamba_headdim: int = 64
    ssm_chunk: int = 128
    attn_q_chunk: int = 4096
    attn_k_chunk: int = 2048

    # --- hybrid (zamba2) -------------------------------------------------------
    attn_every: int = 0          # shared attention block every N layers

    # --- modality frontends (stubs per the brief) ------------------------------
    frontend: str = "none"       # none | vision_stub | audio_codebooks
    n_codebooks: int = 0         # musicgen EnCodec codebooks
    n_patches: int = 0           # pixtral precomputed patch embeddings

    # --- numerics / training ----------------------------------------------------
    dtype: str = "bfloat16"
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    remat: bool = True
    z_loss_coef: float = 1e-4

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return max(self.d_inner // self.mamba_headdim, 1)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def is_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def effective_vocab(self) -> int:
        return self.vocab

    def param_count(self) -> int:
        """Approximate N for MODEL_FLOPS = 6 N D accounting (dense count)."""
        d, L, V = self.d_model, self.n_layers, self.vocab
        emb = V * d * (self.n_codebooks or 1)
        per_layer = 0
        if self.family in ("ssm", "hybrid"):
            di, s = self.d_inner, self.ssm_state
            per_layer += d * 2 * di + di * self.ssm_conv + di * s * 2 + di * d
            if self.mamba_version == 1:
                dt_rank = max(d // 16, 1)
                per_layer += di * (dt_rank + 2 * s) + dt_rank * di
            else:
                G = 1
                per_layer += d * (2 * G * s + self.ssm_heads)
        if self.family == "hybrid" and self.attn_every:
            pass  # shared attn counted once below
        if self.family not in ("ssm",):
            if self.is_mla:
                qd = self.qk_nope_dim + self.qk_rope_dim
                per_attn = (d * (self.q_lora_rank or d) // (1 if self.q_lora_rank else 1))
                per_attn = (d * self.q_lora_rank + self.q_lora_rank * self.n_heads * qd
                            if self.q_lora_rank else d * self.n_heads * qd)
                per_attn += d * (self.kv_lora_rank + self.qk_rope_dim)
                per_attn += self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                per_attn += self.n_heads * self.v_head_dim * d
            else:
                per_attn = d * self.n_heads * self.hd + 2 * d * self.n_kv_heads * self.hd \
                    + self.n_heads * self.hd * d
            if self.family == "hybrid":
                shared_attn = per_attn  # one shared block
            else:
                per_layer += per_attn
        if self.is_moe:
            per_layer += (self.n_experts + self.n_shared_experts) * 3 * d * self.d_ff_expert
            per_layer += d * self.n_experts
        elif self.d_ff > 0:
            per_layer += 3 * d * self.d_ff
        total = emb + L * per_layer + d * V * (self.n_codebooks or 1)
        if self.family == "hybrid" and self.attn_every:
            total += shared_attn
        return int(total)

    def active_param_count(self) -> int:
        """N_active for MoE MODEL_FLOPS accounting."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        routed_all = self.n_layers * self.n_experts * 3 * d * self.d_ff_expert
        routed_active = self.n_layers * self.moe_top_k * 3 * d * self.d_ff_expert
        return int(full - routed_all + routed_active)
