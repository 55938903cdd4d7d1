"""Decoder LMs for serving: layers, the transformer and ``Model``."""
from repro_torch.models.registry import Model  # noqa: F401
