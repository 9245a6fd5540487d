"""phi4-mini-3.8b — dense RoPE/SwiGLU/GQA with 200k vocab
[arXiv:2412.08905].

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064, tied embeddings.
"""
from repro_torch.models.config import ATTN, MLP, ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    arch_type="dense",
    d_model=3072,
    vocab_size=200064,
    block_pattern=((ATTN, MLP),),
    num_groups=32,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    tie_embeddings=True,
    source="arXiv:2412.08905",
)
