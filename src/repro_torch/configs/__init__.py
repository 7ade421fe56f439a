from repro_torch.configs.base import (ATTN, ModelConfig, get_config,  # noqa: F401
                                     list_archs, register)
