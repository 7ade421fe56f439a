"""xLSTM-1.3B — sLSTM + mLSTM residual blocks [arXiv:2405.04517; unverified]

48 layers, d_model 2048, 4 heads (kv=4), d_ff=0 (blocks carry their own
up/down projections), vocab 50304.  Block ratio mLSTM:sLSTM = 7:1
(the paper's xLSTM[7:1] notation), i.e. every 8th block is sLSTM.
"""
from repro_torch.configs.base import ModelConfig, MLSTM, SLSTM, register


@register("xlstm-1.3b")
def config() -> ModelConfig:
    pattern = tuple(([MLSTM] * 7 + [SLSTM]) * 6)   # 48 layers
    return ModelConfig(
        name="xlstm-1.3b",
        family="ssm",
        num_layers=48,
        block_pattern=pattern,
        d_model=2048,
        num_heads=4,
        num_kv_heads=4,
        head_dim=512,               # d_model / heads for the mLSTM memory
        d_ff=0,                     # no separate FFN block
        vocab_size=50_304,
        activation="gelu_mlp",
        norm="layernorm",
        mlstm_proj_factor=2.0,
        slstm_proj_factor=4.0 / 3.0,
        source="[arXiv:2405.04517; unverified] xLSTM[7:1]",
    )
