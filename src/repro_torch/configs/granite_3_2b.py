"""Granite-3.0-2B — dense GQA transformer [hf:ibm-granite/granite-3.0-2b-base]

40 layers, d_model 2048, 32 heads (GQA kv=8), d_ff 8192, vocab 49155,
SwiGLU, RMSNorm, RoPE, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig, register


@register("granite-3-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b",
        family="dense",
        num_layers=40,
        d_model=2048,
        num_heads=32,
        num_kv_heads=8,
        head_dim=64,
        d_ff=8192,
        vocab_size=49_155,
        activation="silu",
        norm="rmsnorm",
        tie_embeddings=True,
        source="[hf:ibm-granite/granite-3.0-2b-base; hf] GQA",
    )
