"""Configuration dataclasses and the --arch registry."""
from repro_torch.configs.base import (  # noqa: F401
    ATTN, ATTN_LOCAL, RGLRU, RWKV, FedKTConfig, ModelConfig, MoEConfig,
    TrainConfig)
from repro_torch.configs.registry import (ARCH_IDS, get_config,  # noqa: F401
                                          get_smoke)
