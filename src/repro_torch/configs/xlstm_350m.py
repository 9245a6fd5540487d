"""xlstm-350m — sLSTM + mLSTM blocks [arXiv:2405.04517].

24L d_model=1024 4H d_ff=0 vocab=50304.  Blocks carry their own up/down
projections (proj factor 2), so there is no separate FFN.  Mix: 3 mLSTM :
1 sLSTM per group of 4 (an xLSTM[7:1]-like mostly-mLSTM mix; the paper's
350M configuration is mLSTM-dominant).
"""
from repro_torch.models.config import MLSTM, NONE, SLSTM, ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    arch_type="ssm",
    d_model=1024,
    vocab_size=50304,
    block_pattern=((MLSTM, NONE), (MLSTM, NONE), (MLSTM, NONE),
                   (SLSTM, NONE)),
    num_groups=6,                      # 24 layers
    num_heads=4,
    num_kv_heads=4,
    xlstm_proj_factor=2.0,
    xlstm_conv=4,
    source="arXiv:2405.04517",
)
