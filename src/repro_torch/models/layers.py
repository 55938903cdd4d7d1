"""Shared transformer layers: RMS and layer norms, RoPE (with
stablelm's partial rotary), GQA self-attention, the encoder-decoder's
cross attention and the four MLPs (``repro.models.layers``).

Parameters live in small ``nn.Module``s whose attribute names are the
reference's dict keys (``attn.wq``, ``ffn.w_up``, ``norm1.scale``...),
with the same orientation: a matrix is (in, out) and is applied as
``x @ W``.  The reference keeps parameters in ``cfg.param_dtype`` and
casts every matrix (and the embedding table) to ``cfg.dtype`` at each
use, while norm scales stay float32 at use; the port stores matrices
in ``cfg.dtype`` once, which gives the same values and halves the
weight bytes each bf16 decode step reads.  Norm parameters stay in
``cfg.param_dtype``.  Compute runs in ``cfg.dtype`` with float32 norms,
RoPE and softmax.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import prng
from repro_torch.configs.base import ATTN, ATTN_LOCAL, ModelConfig
from repro_torch.kernels import ops
from repro_torch.tree_util import tree_map


def dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


def _param(t):
    return nn.Parameter(t, requires_grad=False)


def dense(shape, dtype, device, generator=None, scale=None):
    """A (fan_in, fan_out) matrix, normal with std fan_in^-0.5 (or
    ``scale``), drawn in float32 and stored in ``dtype``; uninitialised
    when there is no generator (a conversion fills it)."""
    if generator is None:
        return _param(torch.empty(shape, dtype=dtype, device=device))
    scale = shape[0] ** -0.5 if scale is None else scale
    w = torch.randn(shape, generator=generator, device=device) * scale
    return _param(w.to(dtype))


# ---------------------------------------------------------------------------
# Threefry draws: the reference's init functions, split for split
# ---------------------------------------------------------------------------
def _normal(key, shape, scale, device=None):
    """``prng.normal(key, shape) * scale`` in float32: a numpy array, or
    with ``device`` a tensor drawn there (``prng.normal_tensor``)."""
    if device is None:
        return prng.normal(key, shape) * np.float32(scale)
    return prng.normal_tensor(key, shape, device) * float(np.float32(scale))


def _dense(key, shape, scale=None, device=None):
    return _normal(key, shape, shape[0] ** -0.5 if scale is None else scale,
                   device)


def _norm_np(cfg):
    p = {"scale": np.ones((cfg.d_model,), np.float32)}
    if cfg.norm == "layernorm":
        p["bias"] = np.zeros((cfg.d_model,), np.float32)
    return p


def _attn_np(cfg, key, device=None):
    dh, D = cfg.head_dim_, cfg.d_model
    k1, k2, k3, k4 = prng.split(key, 4)
    return {"wq": _dense(k1, (D, cfg.num_heads * dh), device=device),
            "wk": _dense(k2, (D, cfg.num_kv_heads * dh), device=device),
            "wv": _dense(k3, (D, cfg.num_kv_heads * dh), device=device),
            "wo": _dense(k4, (cfg.num_heads * dh, D), device=device)}


def _mlp_np(cfg, key, d_ff=None, device=None):
    d_ff = d_ff or cfg.d_ff
    k1, k2, k3 = prng.split(key, 3)
    p = {"w_up": _dense(k1, (cfg.d_model, d_ff), device=device),
         "w_down": _dense(k2, (d_ff, cfg.d_model), device=device)}
    if cfg.mlp in GATED_MLPS:
        p["w_gate"] = _dense(k3, (cfg.d_model, d_ff), device=device)
    return p


def _param_tensors(cfg: ModelConfig, tree):
    """A tree of float32 numpy draws as tensors in ``cfg.param_dtype``,
    as the reference's init functions return them."""
    dt = dtype_of(cfg.param_dtype)
    return tree_map(lambda a: torch.from_numpy(a).to(dt), tree)


def dense_init(key, shape, dtype, scale=None):
    """A (fan_in, fan_out) matrix drawn from the threefry ``key`` as
    ``repro.models.layers.dense_init`` draws it (normal, std fan_in^-0.5
    or ``scale``; ``prng.normal`` is within 2.5e-7 of
    ``jax.random.normal``), in ``dtype`` (a torch dtype or its name)."""
    dt = dtype_of(dtype) if isinstance(dtype, str) else dtype
    return torch.from_numpy(_dense(key, shape, scale)).to(dt)


def init_norm(cfg: ModelConfig):
    return _param_tensors(cfg, _norm_np(cfg))


def init_attn(cfg: ModelConfig, key, cross=False):
    """{"wq", "wk", "wv", "wo"} from ``key``; ``cross`` changes nothing
    (the encoder output has the decoder's width), as in the
    reference."""
    return _param_tensors(cfg, _attn_np(cfg, key))


def init_mlp(cfg: ModelConfig, key, d_ff: Optional[int] = None):
    return _param_tensors(cfg, _mlp_np(cfg, key, d_ff))


class Embed(nn.Module):
    """The token embedding table (vocab, d_model), in ``cfg.dtype``."""

    def __init__(self, cfg: ModelConfig, device, generator=None):
        super().__init__()
        self.table = dense((cfg.vocab_size, cfg.d_model), dtype_of(cfg.dtype),
                           device, generator, scale=0.02)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
class Norm(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        pd = dtype_of(cfg.param_dtype)
        self.scale = _param(torch.ones(cfg.d_model, dtype=pd, device=device))
        if cfg.norm == "layernorm":
            self.bias = _param(torch.zeros(cfg.d_model, dtype=pd,
                                           device=device))


def apply_norm(cfg: ModelConfig, p: Norm, x):
    """RMS norm, or layer norm with scale and bias (``cfg.norm``), in
    float32, back in x's dtype."""
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p.scale.float() + p.bias.float()
    else:
        ms = (xf ** 2).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps) * p.scale.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def apply_rope(x, positions, theta: float, pct: float = 1.0):
    """x: (B, S, N, dh); positions: (S,) shared across the batch, or
    (B, S) per-row absolute positions (continuous-batching decode, where
    every cache slot sits at its own position).  ``pct`` < 1 rotates
    only the first ``int(dh * pct)`` (rounded down to even) channels of
    each head and passes the rest through, as stablelm does."""
    rot = int(x.shape[-1] * pct)
    rot -= rot % 2
    if rot == 0:
        return x
    half = rot // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    if positions.dim() == 2:                     # (B, S) per-row
        ang = positions[..., None].float() * freqs
        cos = torch.cos(ang)[:, :, None, :]      # (B, S, 1, half)
        sin = torch.sin(ang)[:, :, None, :]
    else:
        ang = positions.reshape(-1, 1).float() * freqs
        cos = torch.cos(ang)[None, :, None, :]   # (1, S, 1, half)
        sin = torch.sin(ang)[None, :, None, :]
    x1f, x2f = x[..., :half].float(), x[..., half:rot].float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    if rot == x.shape[-1]:
        return out.to(x.dtype)
    return torch.cat([out.to(x.dtype), x[..., rot:]], dim=-1)


# ---------------------------------------------------------------------------
# Attention block (GQA / MQA / local / softcap); cross attention
# ---------------------------------------------------------------------------
class Attn(nn.Module):
    def __init__(self, cfg: ModelConfig, device, generator=None):
        super().__init__()
        dh, dt = cfg.head_dim_, dtype_of(cfg.dtype)
        D, H, KV = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
        self.wq = dense((D, H * dh), dt, device, generator)
        self.wk = dense((D, KV * dh), dt, device, generator)
        self.wv = dense((D, KV * dh), dt, device, generator)
        self.wo = dense((H * dh, D), dt, device, generator)


# A layer's KV cache is {"k", "v"}, each (B, L, KV, dh): the length axis
# is axis 1 (the reference tags it as axis -3 from the end).
ATTN_CACHE_LEN_AXIS = 1


def init_attn_cache(cfg: ModelConfig, batch, cache_len, dtype, device):
    shape = (batch, cache_len, cfg.num_kv_heads, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def grow_attn_cache(cache, target_len):
    """Pads one {"k","v"} cache with zeros to ``target_len`` along the
    length axis (no-op if already that long)."""
    def pad(t):
        cur = t.shape[ATTN_CACHE_LEN_AXIS]
        if cur >= target_len:
            return t
        return F.pad(t, (0, 0, 0, 0, 0, target_len - cur))
    return {n: pad(t) for n, t in cache.items()}


def ring_attn_cache(cache, window, cur):
    """Converts a linear prefill cache holding positions [0, cur) with
    ``cur > window`` into a ``window``-slot ring: keeps the last
    ``window`` keys, rolled so the key for position p sits at slot
    p % window."""
    shift = cur % window
    return {n: torch.roll(t[:, cur - window:cur], shift, dims=1)
            for n, t in cache.items()}


def attn_apply(cfg: ModelConfig, p: Attn, x, *, kind=ATTN, mode="train",
               cache=None, pos=None, causal=True, use_rope=True):
    """Self-attention.  Returns (y, new_cache).

    mode: "train" (no cache) | "prefill" (returns the populated linear
    cache) | "decode" (x is (B, 1, D); ``cache`` holds cache_len
    entries; ``pos`` is the absolute position of the new token — an int
    shared by the batch, or a (B,) integer tensor of PER-ROW positions).
    Decode writes the new key and value into ``cache`` in place and
    returns it (the reference returns an updated copy).  The
    encoder-decoder runs its encoder with ``causal=False`` and both
    stacks with ``use_rope=False`` (sinusoidal positions instead).
    """
    B, S, D = x.shape
    dh = cfg.head_dim_
    window = cfg.window if kind == ATTN_LOCAL else 0
    q = (x @ p.wq).reshape(B, S, cfg.num_heads, dh)
    k = (x @ p.wk).reshape(B, S, cfg.num_kv_heads, dh)
    v = (x @ p.wv).reshape(B, S, cfg.num_kv_heads, dh)

    if mode in ("train", "prefill"):
        if use_rope:
            positions = torch.arange(S, device=x.device)
            q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_pct)
            k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_pct)
        o = ops.attention(q, k, v, causal=causal, window=window,
                          softcap=cfg.attn_softcap)
        new_cache = {"k": k, "v": v} if mode == "prefill" else None
    else:  # decode
        per_row = torch.is_tensor(pos) and pos.dim() == 1
        if use_rope:
            positions = (pos[:, None] if per_row else
                         torch.full((1,), int(pos), device=x.device))
            q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_pct)
            k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_pct)
        ck, cv = cache["k"], cache["v"]
        Lc = ck.shape[1]
        ring = window > 0 and Lc <= window
        if per_row:
            # dynamic_update_slice clamps an out-of-range start
            slot = pos % Lc if ring else pos.clamp(0, Lc - 1)
            rows = torch.arange(B, device=x.device)
            ck[rows, slot] = k[:, 0].to(ck.dtype)
            cv[rows, slot] = v[:, 0].to(cv.dtype)
        else:
            slot = int(pos) % Lc if ring else min(max(int(pos), 0), Lc - 1)
            ck[:, slot] = k[:, 0].to(ck.dtype)
            cv[:, slot] = v[:, 0].to(cv.dtype)
        # Ring mode: every live slot is inside the window by
        # construction, so no window mask (it would mask wrapped slots);
        # the causal mask with q_offset=pos is exact for pos < Lc.
        o = ops.attention(q, ck.to(x.dtype), cv.to(x.dtype), causal=causal,
                          window=0 if ring else window,
                          softcap=cfg.attn_softcap, q_offset=pos)
        new_cache = cache

    y = o.reshape(B, S, cfg.num_heads * dh) @ p.wo
    return y, new_cache


def cross_attn_apply(cfg: ModelConfig, p: Attn, x, kv_cache):
    """Encoder-decoder cross attention (whisper): the decoder's queries
    over ``kv_cache`` {"k", "v"} (B, Se, KV, dh), computed once from the
    encoder output (``cross_kv``); non-causal, no RoPE.  A prefill (S >
    1) on the card launches the flash-attention kernel over the Se
    keys; a decode step (S == 1) takes the plain path, as in the
    reference."""
    B, S, D = x.shape
    dh = cfg.head_dim_
    q = (x @ p.wq).reshape(B, S, cfg.num_heads, dh)
    o = ops.attention(q, kv_cache["k"].to(x.dtype),
                      kv_cache["v"].to(x.dtype), causal=False)
    return o.reshape(B, S, cfg.num_heads * dh) @ p.wo


def cross_kv(cfg: ModelConfig, p: Attn, enc_out):
    """Cross-attention K/V {"k", "v"} (B, Se, KV, dh) of one decoder
    layer, from the encoder output (B, Se, D)."""
    B, S, _ = enc_out.shape
    dh = cfg.head_dim_
    k = (enc_out @ p.wk).reshape(B, S, cfg.num_kv_heads, dh)
    v = (enc_out @ p.wv).reshape(B, S, cfg.num_kv_heads, dh)
    return {"k": k, "v": v}


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
GATED_MLPS = ("swiglu", "geglu")


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, device, generator=None,
                 d_ff: Optional[int] = None):
        super().__init__()
        d_ff = d_ff or cfg.d_ff
        dt = dtype_of(cfg.dtype)
        self.w_up = dense((cfg.d_model, d_ff), dt, device, generator)
        self.w_down = dense((d_ff, cfg.d_model), dt, device, generator)
        if cfg.mlp in GATED_MLPS:
            self.w_gate = dense((cfg.d_model, d_ff), dt, device, generator)


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp_apply(cfg: ModelConfig, p: MLP, x):
    """swiglu, geglu (gated), gelu or relu2, by ``cfg.mlp``."""
    up = x @ p.w_up
    if cfg.mlp == "swiglu":
        h = F.silu(x @ p.w_gate) * up
    elif cfg.mlp == "geglu":
        h = gelu(x @ p.w_gate) * up
    elif cfg.mlp == "gelu":
        h = gelu(up)
    elif cfg.mlp == "relu2":
        h = F.relu(up) ** 2
    else:
        raise ValueError(cfg.mlp)
    return h @ p.w_down
