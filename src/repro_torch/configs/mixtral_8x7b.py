"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention.
[arXiv:2401.04088]

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, MoE 8e top-2.
"""
from repro_torch.configs.base import ATTN_LOCAL, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32_000,
    pattern=(ATTN_LOCAL,),     # mistral-style SWA
    window=4096,
    mlp="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=1.25),
)

SMOKE = CONFIG.replace(
    name="mixtral-smoke", num_layers=2, d_model=256, num_heads=8,
    num_kv_heads=4, d_ff=512, vocab_size=512, window=64,
    moe=MoEConfig(num_experts=4, top_k=2, capacity_factor=1.5),
)
