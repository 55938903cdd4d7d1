"""whisper-tiny [audio] — encoder-decoder, conv/mel frontend stubbed.
[arXiv:2212.04356]

4L (enc) + 4L (dec) d_model=384 6H (MHA kv=6) d_ff=1536 vocab=51865.

The mel-spectrogram + conv1d feature extractor is stubbed, as in the
reference: callers pass ``frames`` of shape (batch, 1500, d_model), the
frames the conv frontend would produce for a 30 s window.
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    num_layers=4,                # decoder layers
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51_865,
    pattern=(ATTN,),
    mlp="gelu",
    norm="layernorm",
    is_encoder_decoder=True,
    num_encoder_layers=4,
    encoder_seq_len=1500,
    frontend_embeds=1500,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    name="whisper-smoke", num_layers=2, d_model=128, num_heads=4,
    num_kv_heads=4, d_ff=256, vocab_size=512, num_encoder_layers=2,
    encoder_seq_len=64, frontend_embeds=64,
)
