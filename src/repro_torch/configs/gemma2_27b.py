"""gemma2-27b [dense] — local+global alternating attention, logit softcap.
[arXiv:2408.00118]

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000.
"""
from repro_torch.configs.base import ATTN, ATTN_LOCAL, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256_000,
    pattern=(ATTN_LOCAL, ATTN),   # alternating local/global
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    mlp="gelu",
    norm="rmsnorm",
    post_norm=True,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    name="gemma2-smoke", num_layers=2, d_model=256, num_heads=8,
    num_kv_heads=4, head_dim=32, d_ff=512, vocab_size=512, window=64,
)
