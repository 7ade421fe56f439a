"""DeepSeek-V2-236B — MLA + fine-grained MoE [arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2]

60 layers, d_model 5120, 128 heads, MLA (kv_lora 512, q_lora 1536,
nope 128 + rope 64 head dims, v 128), vocab 102400.
MoE: 160 routed experts (d_ff 1536) top-6 + 2 shared experts; first layer
is a dense FFN (d_ff 12288).  ~236B total / ~21B active parameters.
"""
from repro_torch.configs.base import MLA, MLAConfig, MoEConfig, ModelConfig
from repro_torch.configs.base import register


@register("deepseek-v2-236b")
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        num_layers=60,
        block_pattern=tuple([MLA] * 60),
        d_model=5120,
        num_heads=128,
        num_kv_heads=128,          # per assignment table; MLA stores one latent
        head_dim=192,              # qk nope 128 + rope 64
        d_ff=1536,                 # routed-expert hidden dim (per assignment)
        vocab_size=102_400,
        activation="silu",
        norm="rmsnorm",
        moe=MoEConfig(
            num_experts=160,
            top_k=6,
            d_ff_expert=1536,
            num_shared_experts=2,
            d_ff_shared=2 * 1536,
        ),
        moe_layer_overrides={0: "dense"},
        dense_d_ff_first=12288,
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                      qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
        source="[arXiv:2405.04434; hf] MLA kv_lora=512, 2 shared + 160 routed top-6",
    )
