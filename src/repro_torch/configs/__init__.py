"""Configuration dataclasses and the --arch registry."""
from repro_torch.configs.base import (  # noqa: F401
    ATTN, ATTN_LOCAL, INPUT_SHAPES, RGLRU, RWKV, FedKTConfig, InputShape,
    MeshConfig, ModelConfig, MoEConfig, TrainConfig)
from repro_torch.configs.registry import (  # noqa: F401
    ARCH_IDS, get_config, get_smoke, long_context_variant)
