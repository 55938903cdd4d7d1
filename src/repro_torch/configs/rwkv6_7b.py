"""rwkv6-7b [ssm] — Finch: attention-free, data-dependent decay.
[arXiv:2404.05892]

32L d_model=4096 d_ff=14336 vocab=65536.  64 WKV heads of dim 64.
"""
from repro_torch.configs.base import RWKV, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    num_layers=32,
    d_model=4096,
    num_heads=64,             # wkv heads = d_model / rwkv_head_dim
    num_kv_heads=64,
    d_ff=14336,
    vocab_size=65_536,
    pattern=(RWKV,),
    mlp="relu2",              # rwkv channel-mix uses squared relu
    norm="layernorm",
    rwkv_head_dim=64,
)

SMOKE = CONFIG.replace(
    name="rwkv6-smoke", num_layers=2, d_model=256, num_heads=4,
    num_kv_heads=4, d_ff=512, vocab_size=512,
)
