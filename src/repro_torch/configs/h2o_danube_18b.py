"""h2o-danube-1.8b — llama/mistral mix with sliding-window attention
[arXiv:2401.16818].

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, SWA window 4096.
The sliding window makes 500k-context decode sub-quadratic (ring KV cache
of window size).
"""
from repro_torch.models.config import ATTN, MLP, ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    arch_type="dense",
    d_model=2560,
    vocab_size=32000,
    block_pattern=((ATTN, MLP),),
    num_groups=24,
    num_heads=32,
    num_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    sliding_window=4096,
    source="arXiv:2401.16818",
)
