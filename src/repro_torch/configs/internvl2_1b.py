"""InternVL2-1B — InternViT-300M frontend + Qwen2-0.5B LM backbone
[arXiv:2404.16821; hf:OpenGVLab/InternVL2-1B]

Backbone only (the ViT frontend is a stub that supplies precomputed patch
embeddings, ``batch["pixel_embeds"]``): 24 layers, d_model 896, 14 heads
(GQA kv=2), d_ff 4864, vocab 151655, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig, register


@register("internvl2-1b")
def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b",
        family="vlm",
        num_layers=24,
        d_model=896,
        num_heads=14,
        num_kv_heads=2,
        head_dim=64,
        d_ff=4864,
        vocab_size=151_655,
        activation="silu",
        norm="rmsnorm",
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        frontend="vision_stub",
        num_image_tokens=256,
        source="[arXiv:2404.16821; hf] InternViT(stub) + InternLM2/Qwen2 backbone",
    )
