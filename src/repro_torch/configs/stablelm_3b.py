"""StableLM-3B — dense MHA transformer [hf:stabilityai/stablelm-2-1_6b lineage; unverified]

32 layers, d_model 2560, 32 heads (kv=32, i.e. full MHA), d_ff 6912,
vocab 50304, partial-rotary RoPE (25%), LayerNorm.
"""
from repro_torch.configs.base import ModelConfig, register


@register("stablelm-3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-3b",
        family="dense",
        num_layers=32,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        head_dim=80,
        d_ff=6912,
        vocab_size=50_304,
        activation="silu",
        norm="layernorm",
        rope_fraction=0.25,
        source="[hf:stabilityai; unverified] dense MHA",
    )
