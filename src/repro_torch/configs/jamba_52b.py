"""jamba-v0.1-52b — Mamba+attention 1:7 hybrid with MoE [arXiv:2403.19887].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.  Jamba block = 8
layers: attention at index 3, Mamba elsewhere; MoE (16 experts top-2) on
every other layer, dense MLP otherwise.  4 scanned groups of 8.
"""
from repro_torch.models.config import ATTN, MAMBA, MLP, MOE, ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    arch_type="hybrid",
    d_model=4096,
    vocab_size=65536,
    block_pattern=(
        (MAMBA, MLP), (MAMBA, MOE), (MAMBA, MLP), (ATTN, MOE),
        (MAMBA, MLP), (MAMBA, MOE), (MAMBA, MLP), (MAMBA, MOE),
    ),
    num_groups=4,                      # 32 layers, attn:mamba = 1:7
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    moe_d_ff=14336,
    num_experts=16,
    num_experts_per_tok=2,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    ssm_chunk=256,
    source="arXiv:2403.19887",
)
