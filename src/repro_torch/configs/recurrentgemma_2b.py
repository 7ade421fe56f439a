"""RecurrentGemma-2B — Griffin hybrid: RG-LRU recurrent blocks + local attention, 1:2
[arXiv:2402.19427; hf:google/recurrentgemma-2b]

26 layers, pattern (recurrent, recurrent, local-attn) repeating; MQA (kv=1),
GeGLU FFN 7680, d_model 2560, 10 heads (head_dim 256), vocab 256000,
local attention window 2048, logit softcap 30.
"""
from repro_torch.configs.base import ModelConfig, RGLRU, LOCAL_ATTN, register


@register("recurrentgemma-2b")
def config() -> ModelConfig:
    # 26 = 8 * (rec, rec, attn) + (rec, rec)
    pattern = tuple(([RGLRU, RGLRU, LOCAL_ATTN] * 9)[:26])
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        num_layers=26,
        block_pattern=pattern,
        d_model=2560,
        num_heads=10,
        num_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab_size=256_000,
        activation="gelu",          # GeGLU
        norm="rmsnorm",
        local_window=2048,
        lru_width=2560,
        conv1d_width=4,
        logit_softcap=30.0,
        tie_embeddings=True,
        source="[arXiv:2402.19427; hf] RG-LRU + local attn 1:2",
    )
