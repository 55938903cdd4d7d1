"""Decoder LM (``repro.models.transformer``) for the attention and
recurrent archs.

A model is: embed -> one block per layer (an ``nn.ModuleList``, in
place of the reference's ``lax.scan`` over stacked periods plus its
unrolled tail) -> final norm -> (tied) LM head.  Layer i has kind
``cfg.layer_kinds[i]``: attention (global or sliding-window), RG-LRU or
RWKV.  MoE blocks are not ported yet and raise ``NotImplementedError``.

A cache is a list with one dict per layer: {"k", "v"}, each (B, L, KV,
dh), for attention; {"h", "conv"} for RG-LRU; {"wkv", "shift_t",
"shift_c"} for RWKV.  ``convert.lm_cache_from_reference`` maps the
reference's stacked cache onto it.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ATTN, ATTN_LOCAL, RGLRU, RWKV, \
    ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import rglru as R
from repro_torch.models import rwkv as W

ATTN_KINDS = (ATTN, ATTN_LOCAL)


def _check_ported(cfg: ModelConfig):
    if cfg.moe is not None:
        raise NotImplementedError("MoE blocks (models/moe.py) are not "
                                  "ported yet")
    bad = sorted({k for k in cfg.pattern
                  if k not in ATTN_KINDS + (RGLRU, RWKV)})
    if bad:
        raise NotImplementedError(f"{bad} blocks are not ported yet")
    if cfg.is_encoder_decoder or cfg.frontend_embeds:
        raise NotImplementedError("encoder-decoder and frontend models are "
                                  "not ported yet")
    has_mlp = any(k != RWKV for k in cfg.pattern)
    if (has_mlp and cfg.mlp not in ("swiglu", "gelu")) \
            or cfg.parallel_block or cfg.rope_pct != 1.0:
        raise NotImplementedError(
            f"mlp={cfg.mlp!r}, parallel_block, partial rotary are not "
            "ported yet: only the ported archs' layers (swiglu/gelu MLPs, "
            "sequential blocks, full rotary) are")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
class Block(nn.Module):
    """One layer of kind ``kind``, with the reference's subtree names:
    norm1, norm2 and attn or rglru, then ffn (and gemma2's post-norms);
    an RWKV layer holds norm1, norm2 and tm (time- and channel-mix)."""

    def __init__(self, cfg: ModelConfig, kind, device, generator=None):
        super().__init__()
        self.norm1 = L.Norm(cfg, device)
        self.norm2 = L.Norm(cfg, device)
        if kind == RWKV:
            self.tm = W.RWKV(cfg, device, generator)
            return
        if kind in ATTN_KINDS:
            self.attn = L.Attn(cfg, device, generator)
        else:
            self.rglru = R.RGLRU(cfg, device, generator)
        self.ffn = L.MLP(cfg, device, generator)
        if cfg.post_norm:
            self.post_norm1 = L.Norm(cfg, device)
            self.post_norm2 = L.Norm(cfg, device)


class Embed(nn.Module):
    def __init__(self, cfg: ModelConfig, device, generator=None):
        super().__init__()
        self.table = L.dense((cfg.vocab_size, cfg.d_model),
                             L.dtype_of(cfg.dtype), device, generator,
                             scale=0.02)


class LMHead(nn.Module):
    def __init__(self, cfg: ModelConfig, device, generator=None):
        super().__init__()
        self.w = L.dense((cfg.d_model, cfg.vocab_size),
                         L.dtype_of(cfg.dtype), device, generator,
                         scale=0.02)


class Transformer(nn.Module):
    """The parameters of one decoder LM."""

    def __init__(self, cfg: ModelConfig, device, generator=None):
        super().__init__()
        _check_ported(cfg)
        self.embed = Embed(cfg, device, generator)
        self.blocks = nn.ModuleList(
            Block(cfg, kind, device, generator) for kind in cfg.layer_kinds)
        self.final_norm = L.Norm(cfg, device)
        if not cfg.tie_embeddings:
            self.lm_head = LMHead(cfg, device, generator)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device


def init_params(cfg: ModelConfig, generator: torch.Generator, device):
    """Random parameters at ``cfg``'s widths, drawn on ``device`` from
    ``generator`` (which must live on that device)."""
    return Transformer(cfg, device, generator)


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------
def _init_layer_cache(cfg: ModelConfig, kind, batch, cache_len, dtype,
                      device):
    if kind == RGLRU:
        return R.init_rglru_state(cfg, batch, dtype, device)
    if kind == RWKV:
        return W.init_rwkv_state(cfg, batch, dtype, device)
    return L.init_attn_cache(
        cfg, batch, min(cache_len, cfg.window) if kind == ATTN_LOCAL
        else cache_len, dtype, device)


def init_cache(cfg: ModelConfig, batch, cache_len, dtype=None,
               device="cpu") -> List[dict]:
    """Zero caches: global layers linear at ``cache_len``, sliding-window
    layers as ``min(cache_len, window)``-slot rings, recurrent layers
    their zero state."""
    dtype = dtype or L.dtype_of(cfg.dtype)
    return [_init_layer_cache(cfg, kind, batch, cache_len, dtype, device)
            for kind in cfg.layer_kinds]


def grow_cache(cfg: ModelConfig, cache, extra_tokens: int):
    """Grows every KV cache by ``extra_tokens`` decode slots.  A
    sliding-window layer's linear prefill cache longer than the window
    becomes a ``window``-slot ring (last ``window`` keys, position p at
    slot p % window); shorter ones grow up to the window.  Recurrent
    state has no length axis and passes through untouched."""
    out = []
    for kind, c in zip(cfg.layer_kinds, cache):
        if kind not in ATTN_KINDS:
            out.append(c)
            continue
        cur = c["k"].shape[L.ATTN_CACHE_LEN_AXIS]
        if kind == ATTN_LOCAL:
            if cur > cfg.window:
                out.append(L.ring_attn_cache(c, cfg.window, cur))
            else:
                out.append(L.grow_attn_cache(
                    c, min(cur + extra_tokens, cfg.window)))
        else:
            out.append(L.grow_attn_cache(c, cur + extra_tokens))
    return out


def insert_cache(cfg: ModelConfig, slot_cache, prefill_cache, slots, plens):
    """Writes a padded-bucket prefill's per-request KV into rows of the
    persistent slot cache, in place; returns ``slot_cache``.

    ``prefill_cache`` is the linear cache of a (b, Pb) bucket prefill
    (every layer holds Pb entries, pads included).  ``slots`` (b,) names
    each request's destination row; a row whose slot is out of range
    (the bucket's padding rows use ``num_slots``) is dropped, as the
    reference's ``mode="drop"`` scatter does.  ``plens`` (b,) are the
    TRUE prompt lengths: a sliding-window layer whose ring is shorter
    than Pb keeps each request's last ``L`` real keys (positions from
    max(plen - L, 0)), rolled so position p sits at slot p % L.  Rows
    shorter than the slot length are zero-filled past Pb.  ``slots``
    and ``plens`` are host integers (numpy or lists).
    """
    bad = sorted({k for k in cfg.layer_kinds if k not in ATTN_KINDS})
    if bad:
        raise ValueError(f"insert_cache: {bad} blocks have no insertable KV")
    slots = np.asarray(slots).reshape(-1)
    plens = np.asarray(plens).reshape(-1)
    keep = [i for i, s in enumerate(slots)
            if 0 <= s < slot_cache[0]["k"].shape[0]]
    if not keep:
        return slot_cache
    device = slot_cache[0]["k"].device
    idx = torch.as_tensor(slots[keep], device=device)
    src_rows = torch.as_tensor(keep, device=device)
    for kind, dst, src in zip(cfg.layer_kinds, slot_cache, prefill_cache):
        for name in ("k", "v"):
            d, s = dst[name], src[name]
            Pb, Lc = s.shape[1], d.shape[1]
            if Pb <= Lc:      # linear prefix fits: zero-fill the tail
                d[idx, :Pb] = s[src_rows].to(d.dtype)
                d[idx, Pb:] = 0
                continue
            if kind != ATTN_LOCAL:
                raise ValueError("insert_cache: global cache shorter than "
                                 "a prompt bucket")
            for i in keep:    # ring-convert with the request's true length
                start = int(np.clip(plens[i] - Lc, 0, Pb - Lc))
                d[int(slots[i])] = torch.roll(
                    s[i, start:start + Lc], start, dims=0).to(d.dtype)
    return slot_cache


# ---------------------------------------------------------------------------
# Blocks and forward
# ---------------------------------------------------------------------------
def _apply_block(cfg: ModelConfig, kind, bp: Block, x, *, mode, cache,
                 pos):
    if kind == RWKV:
        n1 = L.apply_norm(cfg, bp.norm1, x)
        y, st = W.rwkv_time_mix(cfg, bp.tm, n1, state=cache)
        x = x + y
        n2 = L.apply_norm(cfg, bp.norm2, x)
        y2, st_c = W.rwkv_channel_mix(cfg, bp.tm, n2, state=cache)
        new_cache = None if cache is None else {
            "wkv": st["wkv"], "shift_t": st["shift_t"], "shift_c": st_c}
        return x + y2, new_cache

    n1 = L.apply_norm(cfg, bp.norm1, x)
    if kind in ATTN_KINDS:
        y, new_cache = L.attn_apply(cfg, bp.attn, n1, kind=kind, mode=mode,
                                    cache=cache, pos=pos)
    else:
        y, new_cache = R.rglru_apply(cfg, bp.rglru, n1, mode=mode,
                                     state=cache)
    if cfg.post_norm:
        y = L.apply_norm(cfg, bp.post_norm1, y)
    x = x + y
    m = L.mlp_apply(cfg, bp.ffn, L.apply_norm(cfg, bp.norm2, x))
    if cfg.post_norm:
        m = L.apply_norm(cfg, bp.post_norm2, m)
    return x + m, new_cache


def forward(cfg: ModelConfig, params: Transformer, tokens, *, mode="train",
            cache=None, pos=None):
    """Returns (hidden (B, S, D), new_cache).  tokens: (B, S) integer
    tensor.  "prefill" returns a fresh cache: a linear KV cache of S
    entries per attention layer, the final state of each recurrent one
    (run from a zero state, as the reference's prefill is); "decode"
    updates the KV caches in place and returns the list with the new
    recurrent states."""
    x = params.embed.table[tokens.long()]
    serve = mode in ("prefill", "decode")
    if mode == "decode" and cache is None:
        raise ValueError("decode requires an existing cache")
    new_cache = [] if serve else None
    B = x.shape[0]
    for i, (kind, bp) in enumerate(zip(cfg.layer_kinds, params.blocks)):
        if mode == "decode":
            c = cache[i]
        elif mode == "prefill" and kind not in ATTN_KINDS:
            c = _init_layer_cache(cfg, kind, B, 0, x.dtype, x.device)
        else:
            c = None
        x, nc = _apply_block(cfg, kind, bp, x, mode=mode, cache=c, pos=pos)
        if serve:
            new_cache.append(nc)
    return L.apply_norm(cfg, params.final_norm, x), new_cache


# ---------------------------------------------------------------------------
# LM head
# ---------------------------------------------------------------------------
def _head_w(cfg: ModelConfig, params: Transformer):
    if cfg.tie_embeddings:
        return params.embed.table.T
    return params.lm_head.w


def _softcap(cfg, logits):
    if cfg.final_softcap > 0:
        return cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def logits_fn(cfg: ModelConfig, params: Transformer, hidden):
    """Full float32 logits — for decode-sized (B, 1, D) hidden states."""
    w = _head_w(cfg, params).to(hidden.dtype)
    return _softcap(cfg, (hidden @ w).float())
