"""Minitron-8B — pruned Nemotron-4 [arXiv:2407.14679; hf:nvidia/Minitron-8B-Base]

32 layers, d_model 4096, 32 heads (GQA kv=8), d_ff 16384, vocab 256000,
squared-ReLU MLP (non-gated), LayerNorm, RoPE.
"""
from repro_torch.configs.base import ModelConfig, register


@register("minitron-8b")
def config() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b",
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=256_000,
        activation="relu2_mlp",
        norm="layernorm",
        source="[arXiv:2407.14679; hf] pruned nemotron",
    )
