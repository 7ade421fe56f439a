"""StarCoder2-7B — dense GQA code LM [arXiv:2402.19173; hf:bigcode/starcoder2-7b]

32 layers, d_model 4608, 36 heads (GQA kv=4), d_ff 18432, vocab 49152,
RoPE, gelu MLP (non-gated), LayerNorm.
"""
from repro_torch.configs.base import ModelConfig, register


@register("starcoder2-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b",
        family="dense",
        num_layers=32,
        d_model=4608,
        num_heads=36,
        num_kv_heads=4,
        head_dim=128,
        d_ff=18432,
        vocab_size=49_152,
        activation="gelu_mlp",
        norm="layernorm",
        rope_theta=100_000.0,
        source="[arXiv:2402.19173; hf] GQA + RoPE",
    )
