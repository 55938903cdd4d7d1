"""deepseek-moe-16b [moe] — 2 shared + 64 routed top-6, fine-grained experts.
[arXiv:2401.06066]

28L d_model=2048 16H (MHA kv=16) d_ff=1408 (per expert) vocab=102400.
First layer uses a dense FFN (8x expert width ~ the paper's 10944).
"""
from repro_torch.configs.base import ATTN, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102_400,
    pattern=(ATTN,),
    mlp="swiglu",
    norm="rmsnorm",
    moe=MoEConfig(
        num_experts=64, top_k=6, num_shared_experts=2,
        capacity_factor=1.25, first_k_dense=1, dense_ff_mult=8,
    ),
)

SMOKE = CONFIG.replace(
    name="deepseek-moe-smoke", num_layers=2, d_model=256, num_heads=8,
    num_kv_heads=8, d_ff=128, vocab_size=512,
    moe=MoEConfig(num_experts=4, top_k=2, num_shared_experts=1,
                  capacity_factor=1.5, first_k_dense=1, dense_ff_mult=4),
)
