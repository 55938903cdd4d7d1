"""phi4-mini-3.8b [dense] — RoPE, SwiGLU, GQA.  [arXiv:2412.08905]

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064.
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=200_064,
    pattern=(ATTN,),
    mlp="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    tie_embeddings=True,
)

# Reduced same-family variant for CPU smoke tests.
SMOKE = CONFIG.replace(
    name="phi4-mini-smoke", num_layers=2, d_model=256, num_heads=8,
    num_kv_heads=4, d_ff=512, vocab_size=512,
)
