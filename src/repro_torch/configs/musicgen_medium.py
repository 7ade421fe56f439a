"""MusicGen-medium — decoder-only LM over EnCodec tokens [arXiv:2306.05284; hf]

48 layers, d_model 1536, 24 heads (MHA kv=24), d_ff 6144 (gelu MLP),
vocab 2048 per codebook, 4 parallel codebooks (delay interleaving pattern).
The EnCodec frontend is a stub: a batch holds the codebook token ids
(B, 4, S) directly.
"""
from repro_torch.configs.base import ModelConfig, register


@register("musicgen-medium")
def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        family="audio",
        num_layers=48,
        d_model=1536,
        num_heads=24,
        num_kv_heads=24,
        head_dim=64,
        d_ff=6144,
        vocab_size=2048,
        activation="gelu_mlp",
        norm="layernorm",
        frontend="audio_stub",
        num_codebooks=4,
        source="[arXiv:2306.05284; hf] decoder-only over EnCodec tokens",
    )
