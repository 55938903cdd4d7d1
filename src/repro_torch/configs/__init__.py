"""Configuration dataclasses and the --arch registry."""
from repro_torch.configs.base import (FedKTConfig, ModelConfig,  # noqa: F401
                                      TrainConfig)
from repro_torch.configs.registry import (ARCH_IDS, get_config,  # noqa: F401
                                          get_smoke)
