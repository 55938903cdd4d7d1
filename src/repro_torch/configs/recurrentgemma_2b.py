"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 2:1 pattern.
[arXiv:2402.19427]

26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000.
Pattern: (recurrent, recurrent, local-attn) tiled; 26 = 8*3 + 2 leaves a
two-recurrent-layer tail, matching Griffin's layout.
"""
from repro_torch.configs.base import ATTN_LOCAL, RGLRU, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    d_ff=7680,
    vocab_size=256_000,
    pattern=(RGLRU, RGLRU, ATTN_LOCAL),
    window=2048,
    mlp="gelu",
    norm="rmsnorm",
    rglru_conv_width=4,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    name="recurrentgemma-smoke", num_layers=3, d_model=256, num_heads=4,
    num_kv_heads=1, d_ff=512, vocab_size=512, window=64,
)
