"""qwen1.5-110b — dense, QKV bias [hf:Qwen/Qwen1.5-0.5B family scaling].

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064.
"""
from repro_torch.models.config import ATTN, MLP, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    arch_type="dense",
    d_model=8192,
    vocab_size=152064,
    block_pattern=((ATTN, MLP),),
    num_groups=80,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=49152,
    attn_bias=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen1.5-0.5B",
)
