"""Configuration dataclasses (the FedKT round's only, in this slice)."""
from repro_torch.configs.base import FedKTConfig  # noqa: F401
