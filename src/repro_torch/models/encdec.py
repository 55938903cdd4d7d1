"""Whisper-style encoder-decoder LM (``repro.models.encdec``): the audio
backbone, with its frontend stubbed.

The caller passes ``frames`` (B, encoder_seq_len, d_model): what the
mel + conv frontend would produce.  The encoder is a non-causal
transformer over the frames; the decoder a causal transformer whose
every layer also attends the encoder output (cross attention).  Both
take sinusoidal positions and no RoPE, as in the reference (whose
decoder table has 32,768 + 8 rows, so that its 32k decode shape has
positions).

Parameters: an ``EncDec`` module with the reference's leaf names —
``embed.table``, ``enc`` (a list of layers: norm1, attn, norm2, ffn),
``enc_norm``, ``dec`` (norm1, attn, norm_x, xattn, norm2, ffn) and
``final_norm``; the LM head is the embedding, tied — or the float32
tree of the same names (``transformer.view``).  A cache is {"self": one
{"k", "v"} (B, L, KV, dh) a decoder layer, "cross": one {"k", "v"} (B,
Se, KV, dh) a decoder layer}: the cross K/V are computed once, at the
prefill, and never grow.

On the card the encoder (Se x Se, non-causal), the decoder's
self-attention (P x P, causal) and its cross attention (P x Se,
non-causal) launch the flash-attention kernel at a prefill; a decode
step (one query row) takes the plain path for both, as in the
reference.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import prng
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.tree_util import tree_map

# rows of the decoder's position table (the reference's 32_768 + 8)
DEC_POSITIONS = 32_768 + 8


def _sinusoid_f32(S, D):
    """The (S, D) float32 table: sin of pos / 10000^(2i / D) on the even
    columns, cos on the odd ones, computed on the host.  The divisor is
    raised in float64 and rounded once to float32: torch's float32
    ``pow`` is an ulp off the rounded value at a few widths (384
    among them), which moves an angle of position 1500 by 4e-6."""
    pos = torch.arange(S, dtype=torch.float32)[:, None]
    dim = torch.arange(0, D, 2, dtype=torch.float32)[None, :]
    div = (10_000.0 ** (dim / D).double()).float()
    ang = pos / div
    pe = torch.zeros((S, D), dtype=torch.float32)
    pe[:, 0::2] = torch.sin(ang)
    # (D + 1) // 2 columns in the reference, D // 2 odd columns here:
    # the same for every even width, which is all the reference takes
    pe[:, 1::2] = torch.cos(ang[:, :D // 2])
    return pe


def _sinusoid(S, D, dtype, device):
    """``_sinusoid_f32(S, D)`` cast to ``dtype`` on ``device``, built once
    per (S, D, dtype, device): the decoder's table is sliced at every
    decode step.  On the meta device (a dry-run's trace) an empty table
    of that shape, made anew at each call, so that no trace finds one
    that an earlier trace built."""
    if device.type == "meta":
        return torch.empty((S, D), dtype=dtype, device=device)
    return _sinusoid_table(S, D, dtype, device)


@functools.lru_cache(maxsize=None)
def _sinusoid_table(S, D, dtype, device):
    """Made outside inference mode, so that a table first built by a
    serving step can also be read by a training step."""
    with torch.inference_mode(False):
        return _sinusoid_f32(S, D).to(dtype).to(device)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
class EncLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device, generator=None):
        super().__init__()
        self.norm1 = L.Norm(cfg, device)
        self.attn = L.Attn(cfg, device, generator)
        self.norm2 = L.Norm(cfg, device)
        self.ffn = L.MLP(cfg, device, generator)


class DecLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device, generator=None):
        super().__init__()
        self.norm1 = L.Norm(cfg, device)
        self.attn = L.Attn(cfg, device, generator)
        self.norm_x = L.Norm(cfg, device)
        self.xattn = L.Attn(cfg, device, generator)
        self.norm2 = L.Norm(cfg, device)
        self.ffn = L.MLP(cfg, device, generator)


class EncDec(nn.Module):
    """The parameters of one encoder-decoder LM."""

    def __init__(self, cfg: ModelConfig, device, generator=None):
        super().__init__()
        self.embed = L.Embed(cfg, device, generator)
        self.enc = nn.ModuleList(EncLayer(cfg, device, generator)
                                 for _ in range(cfg.num_encoder_layers))
        self.enc_norm = L.Norm(cfg, device)
        self.dec = nn.ModuleList(DecLayer(cfg, device, generator)
                                 for _ in range(cfg.num_layers))
        self.final_norm = L.Norm(cfg, device)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device


def init_params(cfg: ModelConfig, generator: torch.Generator, device):
    """Random parameters at ``cfg``'s widths, drawn on ``device`` from
    ``generator`` (which must live on that device)."""
    return EncDec(cfg, device, generator)


def init_tree(cfg: ModelConfig, key, device):
    """A parameter tree in ``cfg.param_dtype`` drawn from the threefry
    ``key`` as the reference's ``init_params`` draws it:
    ``split(key, 4)``; keys[0] split over the encoder layers (each split
    in two: attn, ffn),
    keys[1] over the decoder layers (each split in three: attn, xattn,
    ffn), keys[2] the embedding, keys[3] unused."""
    ks = prng.split(key, 4)
    enc = []
    for k in prng.split(ks[0], cfg.num_encoder_layers):
        k1, k2 = prng.split(k)
        enc.append({"norm1": L._norm_np(cfg), "attn": L._attn_np(cfg, k1),
                    "norm2": L._norm_np(cfg), "ffn": L._mlp_np(cfg, k2)})
    dec = []
    for k in prng.split(ks[1], cfg.num_layers):
        k1, k2, k3 = prng.split(k, 3)
        dec.append({"norm1": L._norm_np(cfg), "attn": L._attn_np(cfg, k1),
                    "norm_x": L._norm_np(cfg), "xattn": L._attn_np(cfg, k2),
                    "norm2": L._norm_np(cfg), "ffn": L._mlp_np(cfg, k3)})
    tree = {"embed": {"table": L._normal(ks[2], (cfg.vocab_size,
                                                 cfg.d_model), 0.02)},
            "enc": enc, "enc_norm": L._norm_np(cfg), "dec": dec,
            "final_norm": L._norm_np(cfg)}
    dt = L.dtype_of(cfg.param_dtype)
    return tree_map(lambda a: torch.from_numpy(a).to(device, dt), tree)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------
def encode(cfg: ModelConfig, params, frame_embeds):
    """frame_embeds: (B, Se, D) from the stubbed frontend.  Returns the
    encoder output (B, Se, D) in ``cfg.dtype``.  ``params`` as the
    forward reads them (a module or ``transformer.view`` of a tree)."""
    x = frame_embeds.to(L.dtype_of(cfg.dtype))
    x = x + _sinusoid(x.shape[1], x.shape[2], x.dtype, x.device)[None]
    for lp in params.enc:
        h, _ = L.attn_apply(cfg, lp.attn, L.apply_norm(cfg, lp.norm1, x),
                            mode="train", causal=False, use_rope=False)
        x = x + h
        x = x + L.mlp_apply(cfg, lp.ffn, L.apply_norm(cfg, lp.norm2, x))
    return L.apply_norm(cfg, params.enc_norm, x)


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------
def _cross_all(cfg: ModelConfig, params, enc_out):
    return [L.cross_kv(cfg, lp.xattn, enc_out) for lp in params.dec]


def init_dec_cache(cfg: ModelConfig, batch, cache_len, enc_out=None,
                   params=None, dtype=None, device="cpu"):
    """Zero self-attention caches of ``cache_len`` slots, and the cross
    K/V of every decoder layer: from ``enc_out`` (with ``params``), or
    zeros of the encoder's length."""
    dtype = dtype or L.dtype_of(cfg.dtype)
    dev = enc_out.device if enc_out is not None else device
    self_c = [L.init_attn_cache(cfg, batch, cache_len, dtype, dev)
              for _ in range(cfg.num_layers)]
    if enc_out is not None:
        cross = _cross_all(cfg, params, enc_out)
    else:
        cross = [L.init_attn_cache(cfg, batch, cfg.encoder_seq_len, dtype,
                                   dev) for _ in range(cfg.num_layers)]
    return {"self": self_c, "cross": cross}


def grow_cache(cfg: ModelConfig, cache, extra_tokens: int):
    """Grows every decoder self-attention cache by ``extra_tokens``
    slots.  The cross K/V cover the fixed encoder sequence and never
    grow."""
    grown = [L.grow_attn_cache(c, c["k"].shape[L.ATTN_CACHE_LEN_AXIS]
                               + extra_tokens) for c in cache["self"]]
    return {"self": grown, "cross": cache["cross"]}


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------
def _dec_layer(cfg, lp, x, xkv, *, mode, cache, pos):
    h, new_cache = L.attn_apply(cfg, lp.attn, L.apply_norm(cfg, lp.norm1, x),
                                mode=mode, cache=cache, pos=pos,
                                use_rope=False)
    x = x + h
    x = x + L.cross_attn_apply(cfg, lp.xattn,
                               L.apply_norm(cfg, lp.norm_x, x), xkv)
    x = x + L.mlp_apply(cfg, lp.ffn, L.apply_norm(cfg, lp.norm2, x))
    return x, new_cache


def decode_forward(cfg: ModelConfig, params, tokens, enc_out=None, *,
                   mode="train", cache=None, pos=None, remat=False):
    """The decoder.  Returns (hidden (B, S, D), new_cache, aux = 0.0).

    train / prefill: the cross K/V come from ``enc_out`` (a prefill
    without one attends zero K/V, as the reference's zero cache does);
    decode: from ``cache["cross"]``, and ``pos`` (an int) is the
    position of the new token.  "prefill" returns a fresh cache (S
    self-attention slots a layer, and the cross K/V); "decode" writes
    the self-attention caches in place.  ``remat`` (train mode, with
    gradients) recomputes each decoder layer in the backward, as the
    reference checkpoints its decoder body; the encoder is not
    recomputed."""
    B, S = tokens.shape
    x = params.embed.table[tokens.long()]
    pe = _sinusoid(DEC_POSITIONS, cfg.d_model, x.dtype, x.device)
    # dynamic_slice_in_dim clamps the start so that S rows fit
    base = min(max(0 if pos is None else int(pos), 0), DEC_POSITIONS - S)
    x = x + pe[base:base + S][None]

    if mode == "decode":
        if cache is None:
            raise ValueError("decode requires an existing cache")
        xkv_all = cache["cross"]
    elif enc_out is not None:
        xkv_all = _cross_all(cfg, params, enc_out)
    elif mode == "prefill":
        xkv_all = init_dec_cache(cfg, B, 0, dtype=x.dtype,
                                 device=x.device)["cross"]
    else:
        raise ValueError("train mode needs the encoder output (frames)")

    new_self = []
    for i, lp in enumerate(params.dec):
        sc = cache["self"][i] if mode == "decode" else None
        if remat and mode == "train" and torch.is_grad_enabled():
            x, nc = checkpoint(
                lambda x, lp=lp, xkv=xkv_all[i]: _dec_layer(
                    cfg, lp, x, xkv, mode=mode, cache=None, pos=pos),
                x, use_reentrant=False, preserve_rng_state=False)
        else:
            x, nc = _dec_layer(cfg, lp, x, xkv_all[i], mode=mode, cache=sc,
                               pos=pos)
        new_self.append(nc)
    new_cache = {"self": new_self, "cross": xkv_all} \
        if mode in ("prefill", "decode") else None
    return L.apply_norm(cfg, params.final_norm, x), new_cache, 0.0
