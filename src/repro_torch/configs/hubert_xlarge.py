"""hubert-xlarge — encoder-only audio transformer [arXiv:2106.07447].

48L d_model=1280 16H d_ff=5120 vocab=504 (masked-prediction codebook).
The conv waveform feature extractor is a stub per the assignment:
`input_specs` provides (B, frames, 512) frame embeddings; the model owns
the learned 512→1280 projection.  Bidirectional attention, GELU MLP,
LayerNorm (wav2vec2 family).  Encoder-only ⇒ no decode shapes.
"""
from repro_torch.models.config import ATTN, MLP, ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    arch_type="audio",
    d_model=1280,
    vocab_size=504,
    block_pattern=((ATTN, MLP),),
    num_groups=48,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    mlp_act="gelu",
    norm="layernorm",
    causal=False,
    encoder_only=True,
    frontend="audio",
    frontend_dim=512,
    source="arXiv:2106.07447",
)
