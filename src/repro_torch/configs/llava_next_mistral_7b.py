"""llava-next-mistral-7b [vlm] — anyres tiling, mistral backbone.
[hf:llava-hf/llava-v1.6-mistral-7b-hf]

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.

The vision tower (CLIP-ViT) and its projector are a stub: a caller
passes ``embeds`` of shape (batch, frontend_embeds, d_model), the
pre-projected anyres patch embeddings (2x2 tiles + a base view of 576
patches each = 2880), which the model prepends to the token embeddings.
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32_000,
    pattern=(ATTN,),
    mlp="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    frontend_embeds=2880,   # anyres: 5 tiles x 576 patches, pre-projected
)

SMOKE = CONFIG.replace(
    name="llava-smoke", num_layers=2, d_model=256, num_heads=8,
    num_kv_heads=4, d_ff=512, vocab_size=512, frontend_embeds=16,
)
