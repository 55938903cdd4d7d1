"""granite-20b [dense] — llama-arch code model, MQA (kv=1).
[arXiv:2405.04324]

52L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49_152,
    pattern=(ATTN,),
    mlp="gelu",
    norm="layernorm",
)

SMOKE = CONFIG.replace(
    name="granite-smoke", num_layers=2, d_model=256, num_heads=8,
    num_kv_heads=1, d_ff=512, vocab_size=512,
)
