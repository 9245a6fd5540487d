"""deepseek-v2-lite-16b — MLA + fine-grained MoE [arXiv:2405.04434].

27L d_model=2048 16H d_ff(moe)=1408 vocab=102400.  MLA: kv_lora_rank=512,
decoupled rope dim 64, qk_nope/v head dim 128.  MoE: 64 routed experts
top-6 + 2 shared experts (per the V2-Lite model card; the scaled V2 uses
160 routed — noted in DESIGN.md).  The model card's single leading dense
layer is regularized to MoE so the 27 layers scan uniformly (DESIGN.md
§Arch-applicability).
"""
from repro_torch.models.config import MLA, MOE, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    arch_type="moe",
    d_model=2048,
    vocab_size=102400,
    block_pattern=((MLA, MOE),),
    num_groups=27,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    kv_lora_rank=512,
    rope_head_dim=64,
    v_head_dim=128,
    d_ff=10944,
    moe_d_ff=1408,
    num_experts=64,
    num_experts_per_tok=6,
    num_shared_experts=2,
    source="arXiv:2405.04434",
)
