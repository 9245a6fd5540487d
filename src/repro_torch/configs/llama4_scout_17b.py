"""llama4-scout-17b-a16e — MoE 16e top-1, early fusion, iRoPE chunked
attention [hf:meta-llama/Llama-4-Scout-17B-16E].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048.  Every layer is
MoE (16 routed experts top-1 + 1 shared expert).  Attention interleave:
3 chunked-local (8192) layers then 1 global (NoPE/global) layer — the
chunked layers make long_500k decode sub-quadratic in cache size.
"""
from repro_torch.models.config import ATTN, ATTN_GLOBAL, MOE, ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    arch_type="moe",
    d_model=5120,
    vocab_size=202048,
    block_pattern=((ATTN, MOE), (ATTN, MOE), (ATTN, MOE),
                   (ATTN_GLOBAL, MOE)),
    num_groups=12,                     # 48 layers
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    moe_d_ff=8192,
    num_experts=16,
    num_experts_per_tok=1,
    num_shared_experts=1,
    attn_chunk=8192,
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
