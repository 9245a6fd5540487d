"""Model configuration.

One config dataclass drives every assigned architecture: the per-layer
composition is declared as a *block pattern* — a repeating group of
(mixer, ffn) pairs — so a single scan-based decoder stack covers dense,
MoE, SSM, hybrid, audio and VLM backbones.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

# Mixer kinds.
ATTN = "attn"          # softmax attention (GQA / MHA, optional SWA / chunked)
ATTN_GLOBAL = "attn_global"  # full attention even when cfg.sliding_window set
MLA = "mla"            # DeepSeek multi-head latent attention
MAMBA = "mamba"        # Mamba-1 selective SSM
MLSTM = "mlstm"        # xLSTM matrix-memory LSTM
SLSTM = "slstm"        # xLSTM scalar-memory LSTM

# FFN kinds.
MLP = "mlp"            # dense MLP (swiglu / gelu per cfg.mlp_act)
MOE = "moe"            # mixture-of-experts
NONE = "none"          # no FFN (xLSTM blocks carry their own projections)

SUBQUADRATIC_MIXERS = (MAMBA, MLSTM, SLSTM)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                      # dense | moe | ssm | hybrid | audio | vlm
    d_model: int
    vocab_size: int
    # Block pattern: a group of (mixer, ffn) pairs repeated `num_groups`
    # times.  total layers == len(block_pattern) * num_groups.
    block_pattern: Tuple[Tuple[str, str], ...]
    num_groups: int

    # ---- attention ----
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    attn_bias: bool = False             # qwen-style QKV bias
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None       # SWA width (h2o-danube)
    attn_chunk: Optional[int] = None           # llama4 chunked-local width
    causal: bool = True                 # False for encoder-only (hubert)
    attn_logit_softcap: Optional[float] = None

    # ---- MLA (deepseek) ----
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    v_head_dim: int = 0                 # defaults to head_dim

    # ---- FFN ----
    d_ff: int = 0
    mlp_act: str = "swiglu"             # swiglu | gelu

    # ---- MoE ----
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0                   # expert hidden size (may differ from d_ff)
    moe_capacity_factor: float = 1.25
    moe_group_size: int = 512           # GShard dispatch group (tokens)
    router_aux_coef: float = 0.01

    # ---- mamba ----
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 0              # 0 -> ceil(d_model/16)
    ssm_chunk: int = 256                # chunkwise scan length (memory fit)

    # ---- xlstm ----
    xlstm_proj_factor: float = 2.0      # block up-projection
    xlstm_conv: int = 4                 # causal conv width in mLSTM block

    # ---- embedding / head ----
    tie_embeddings: bool = False
    encoder_only: bool = False
    frontend: Optional[str] = None      # None | "audio" | "vision"
    frontend_dim: int = 0               # stub embedding dim (512 audio / 1024 clip)
    num_image_tokens: int = 0           # vlm: patch tokens prefixed to text

    # ---- numerics / memory ----
    norm: str = "rmsnorm"               # rmsnorm | layernorm
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"             # activation/compute dtype
    param_dtype: str = "float32"
    remat: str = "block"                # none | block (checkpoint scan bodies)

    # provenance
    source: str = ""

    # ------------------------------------------------------------------
    @property
    def num_layers(self) -> int:
        return len(self.block_pattern) * self.num_groups

    @property
    def kv_groups(self) -> int:
        return max(1, self.num_heads // max(1, self.num_kv_heads))

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(1, self.num_heads))

    @property
    def resolved_v_head_dim(self) -> int:
        return self.v_head_dim or self.resolved_head_dim

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def resolved_dt_rank(self) -> int:
        return self.mamba_dt_rank or -(-self.d_model // 16)

    @property
    def has_decode(self) -> bool:
        return not self.encoder_only

    @property
    def subquadratic(self) -> bool:
        """True if the model supports O(seq) decode memory at 500k context."""
        mixers = {m for m, _ in self.block_pattern}
        # hybrid archs (jamba): a minority of attention layers hold a full
        # cache but the dominant state is SSM; long-context capable with
        # the cache sharded over sequence.
        if mixers & set(SUBQUADRATIC_MIXERS):
            return True
        for m in mixers:
            if m in (ATTN, ATTN_GLOBAL):
                if self.sliding_window is None and self.attn_chunk is None:
                    return False
            if m == MLA:
                return False
        return True

    def validate(self) -> None:
        assert self.num_groups >= 1 and self.block_pattern
        for mixer, ffn in self.block_pattern:
            assert mixer in (ATTN, ATTN_GLOBAL, MLA, MAMBA, MLSTM, SLSTM), mixer
            assert ffn in (MLP, MOE, NONE), ffn
            if ffn == MOE:
                assert self.num_experts > 0 and self.num_experts_per_tok > 0
        if any(m in (ATTN, ATTN_GLOBAL) for m, _ in self.block_pattern):
            assert self.num_heads > 0 and self.num_kv_heads > 0
            assert self.num_heads % self.num_kv_heads == 0


def uniform_pattern(mixer: str, ffn: str, layers_per_group: int = 1
                    ) -> Tuple[Tuple[str, str], ...]:
    return tuple((mixer, ffn) for _ in range(layers_per_group))
