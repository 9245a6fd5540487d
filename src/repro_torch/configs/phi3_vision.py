"""phi-3-vision-4.2b — phi3-mini decoder + CLIP vision stub
[hf:microsoft/Phi-3-vision-128k-instruct].

32L d_model=3072 32H (MHA kv=32) d_ff=8192 vocab=32064.  The CLIP ViT-L/14
tower is a stub per the assignment: `input_specs` provides (B, 576, 1024)
patch embeddings; the model owns the 2-layer MLP projector 1024→3072.
Image tokens are prefixed to text (early fusion); loss over text only.
"""
from repro_torch.models.config import ATTN, MLP, ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    arch_type="vlm",
    d_model=3072,
    vocab_size=32064,
    block_pattern=((ATTN, MLP),),
    num_groups=32,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    frontend="vision",
    frontend_dim=1024,
    num_image_tokens=576,
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)
