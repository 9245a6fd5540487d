"""qwen2.5-32b — dense GQA, QKV bias [hf:Qwen/Qwen2.5-0.5B family scaling].

64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064.
"""
from repro_torch.models.config import ATTN, MLP, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    arch_type="dense",
    d_model=5120,
    vocab_size=152064,
    block_pattern=((ATTN, MLP),),
    num_groups=64,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    attn_bias=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen2.5-0.5B",
)
