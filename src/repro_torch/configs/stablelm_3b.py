"""stablelm-3b [dense] — parallel block, partial rotary, LayerNorm.
[hf:stabilityai/stablelm-2-1_6b]

32L d_model=2560 32H (MHA kv=32) d_ff=6912 vocab=50304.
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=6912,
    vocab_size=50_304,
    pattern=(ATTN,),
    mlp="swiglu",
    norm="layernorm",
    rope_pct=0.25,
    parallel_block=True,
)

SMOKE = CONFIG.replace(
    name="stablelm-smoke", num_layers=2, d_model=256, num_heads=8,
    num_kv_heads=8, d_ff=512, vocab_size=512,
)
