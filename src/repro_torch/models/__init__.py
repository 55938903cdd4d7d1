"""Language models for serving and training: layers, the decoder
transformer, the encoder-decoder and ``Model``."""
from repro_torch.models.registry import Model, build  # noqa: F401
