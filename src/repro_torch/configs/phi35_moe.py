"""Phi-3.5-MoE (42B total / 6.6B active) [hf:microsoft/Phi-3.5-MoE-instruct]

32 layers, d_model 4096, 32 heads (GQA kv=8), 16 experts top-2 with
d_ff 6400 each (SwiGLU), vocab 32064, LayerNorm.  The port's copy of the
JAX package's ``configs/phi35_moe.py``, both registrations.
"""
import dataclasses

from repro_torch.configs.base import MoEConfig, ModelConfig, register


@register("phi3.5-moe-42b-a6.6b")
def config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b",
        family="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=6400,
        vocab_size=32_064,
        activation="silu",
        norm="layernorm",
        moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=6400),
        source="[hf:microsoft/Phi-3.5-MoE-instruct; hf] 16 experts top-2",
    )


@register("phi3.5-moe-rms")
def config_rms() -> ModelConfig:
    """Phi-3.5-MoE shape with RMSNorm: the MoE config the executed serve
    path serves (its norm member is RMSNorm only, so the LayerNorm variant
    above is refused)."""
    return dataclasses.replace(
        config(), name="phi3.5-moe-rms", norm="rmsnorm",
        source="phi3.5-moe-42b-a6.6b with rmsnorm (executed-serve variant)")
