from repro_torch.configs.base import (  # noqa: F401
    ATTN, LOCAL_ATTN, MLA, MLSTM, RGLRU, SLSTM, SHAPES,
    MLAConfig, MoEConfig, ModelConfig, ShapeConfig,
    get_config, list_archs, register, shape_applicable,
)
