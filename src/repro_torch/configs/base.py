"""Model/config system of the PyTorch port.

A copy of the JAX package's ``configs/base.py`` (same fields, same
``reduced()`` derivation, same registry), kept here so the port imports
nothing of the reference.  The fields stay identical so a config prints,
compares and derives exactly like its reference twin.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Optional

# ---------------------------------------------------------------------------
# Block kinds
# ---------------------------------------------------------------------------
ATTN = "attn"          # global self-attention (GQA/MQA/MHA)
LOCAL_ATTN = "local"   # sliding-window self-attention
MLA = "mla"            # DeepSeek-V2 multi-head latent attention
RGLRU = "rglru"        # RecurrentGemma RG-LRU recurrent block
MLSTM = "mlstm"        # xLSTM matrix-memory LSTM block
SLSTM = "slstm"        # xLSTM scalar-memory LSTM block

SEQ_MIX_KINDS = (ATTN, LOCAL_ATTN, MLA, RGLRU, MLSTM, SLSTM)
# Kinds with O(1)-per-token decode state (no KV cache growth): allow 500k ctx.
SUBQUADRATIC_KINDS = (RGLRU, MLSTM, SLSTM, LOCAL_ATTN)


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int            # routed experts
    top_k: int
    d_ff_expert: int            # per-expert hidden dim
    num_shared_experts: int = 0
    d_ff_shared: int = 0        # hidden dim of the shared expert(s), total
    router_noise: float = 0.0
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int                         # dense-FFN hidden dim
    vocab_size: int

    # block pattern; if None, [ATTN] * num_layers
    block_pattern: tuple[str, ...] | None = None

    head_dim: int = 0                 # 0 => d_model // num_heads
    activation: str = "silu"          # silu | gelu | gelu_mlp | relu2_mlp
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0        # fraction of head_dim that is rotated
    local_window: int = 2048          # for LOCAL_ATTN blocks
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    moe: Optional[MoEConfig] = None
    moe_layer_overrides: dict = field(default_factory=dict)
    dense_d_ff_first: int = 0
    mla: Optional[MLAConfig] = None

    # recurrent cores
    lru_width: int = 0
    conv1d_width: int = 4
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0

    # modality frontend stubs
    frontend: str = "none"            # none | vision_stub | audio_stub
    num_image_tokens: int = 256
    num_codebooks: int = 1

    dtype: str = "bfloat16"
    source: str = ""                  # provenance note

    # ---------------- derived ----------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def pattern(self) -> tuple[str, ...]:
        if self.block_pattern is not None:
            if len(self.block_pattern) != self.num_layers:
                raise ValueError(f"{self.name}: block_pattern has "
                                 f"{len(self.block_pattern)} entries for "
                                 f"{self.num_layers} layers")
            return self.block_pattern
        return tuple([ATTN] * self.num_layers)

    @property
    def is_moe(self) -> bool:
        return self.moe is not None

    @property
    def supports_long_context(self) -> bool:
        """True iff every sequence-mixing block is sub-quadratic (O(1)/O(w)
        state)."""
        return all(k in SUBQUADRATIC_KINDS for k in self.pattern)

    def moe_layer(self, idx: int) -> bool:
        if self.moe is None:
            return False
        return self.moe_layer_overrides.get(idx, "moe") == "moe"

    # ------------- parameter counting (for 6ND model flops) -------------
    def param_count(self) -> int:
        from repro_torch.models import lm  # local import to avoid cycles
        return lm.count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models import lm
        return lm.count_params(self, active_only=True)

    # ------------- smoke-size derivation -------------
    def reduced(self) -> "ModelConfig":
        """A tiny config of the same family: keeps one run of every distinct
        block kind so smoke tests exercise every code path."""
        seen: list[str] = []
        for k in self.pattern:
            if k not in seen:
                seen.append(k)
        new_pat = tuple(seen[:3]) if seen else (ATTN,)
        n_heads = min(self.num_heads, 4)
        n_kv = max(1, min(self.num_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        moe = None
        overrides = {}
        if self.moe is not None:
            moe = MoEConfig(num_experts=4, top_k=min(2, self.moe.top_k),
                            d_ff_expert=64,
                            num_shared_experts=min(1, self.moe.num_shared_experts),
                            d_ff_shared=64 if self.moe.num_shared_experts else 0)
            overrides = {0: "dense"} if 0 in self.moe_layer_overrides else {}
        mla = None
        if self.mla is not None:
            mla = MLAConfig(kv_lora_rank=32, q_lora_rank=48,
                            qk_nope_head_dim=16, qk_rope_head_dim=8,
                            v_head_dim=16)
        return replace(
            self,
            name=self.name + "-smoke",
            num_layers=len(new_pat),
            block_pattern=new_pat,
            d_model=64,
            num_heads=n_heads,
            num_kv_heads=n_kv,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            dense_d_ff_first=128 if self.dense_d_ff_first else 0,
            vocab_size=512,
            moe=moe,
            moe_layer_overrides=overrides,
            mla=mla,
            lru_width=64 if self.lru_width else 0,
            local_window=32,
            num_image_tokens=8,
        )


# ---------------------------------------------------------------------------
# Input shapes (the same set for every LM arch)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig,
                     shape: ShapeConfig) -> tuple[bool, str]:
    """(applicable, reason-if-not). long_500k needs sub-quadratic seq
    mixing.  The reason is the reference's text, word for word."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("full-attention arch: 500k dense KV decode is out of "
                       "scope per assignment (needs sub-quadratic "
                       "attention); see DESIGN.md §6")
    return True, ""


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> list[str]:
    _load_all()
    return sorted(_REGISTRY)


def _load_all():
    from repro_torch.configs import (  # noqa: F401
        deepseek_v2_236b, granite_3_2b, internvl2_1b, minitron_8b,
        musicgen_medium, phi35_moe, recurrentgemma_2b, stablelm_3b,
        starcoder2_7b, xlstm_1_3b)
